"""GraphLAM, HiLAM and HiLAMParallel under the bf16 policy against the
JAX package on the CPU: forward and every master's gradient, from the
same numpy variables and input, on a 32x32 grid (GraphLAM's multimesh
lattices 8², 4², 2²; the hierarchies' 8², 2²). The port runs its stencil
and corner-hop stages through StencilMessageFn and CornerHopFn at their
bf16 boundary (fp32 inside, rounded where the Pallas kernels round); the
JAX package on the CPU takes its XLA formulas in bf16. The bars are
``test_torch_bf16.py``'s, relative to the JAX package's own bf16 error."""

import numpy as np
import pytest
import torch

from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu_torch.models import graph as port_graph
from tests.test_torch_bf16 import F_IN, F_OUT, MESHGRID, check_against_jax

#: (model, settings): the multimesh needs three levels, the hierarchies
#: run every kind of stage at two
CASES = {
    "GraphLAM": dict(hidden_dims=8, processor_layers=1, mesh_levels=3),
    "HiLAM": dict(hidden_dims=8, processor_layers=1, mesh_levels=2, mesh_aggr="mean"),
    "HiLAMParallel": dict(hidden_dims=8, processor_layers=1, mesh_levels=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_model_bf16_matches_jax(name):
    settings = CASES[name]
    js = jax_graph.GraphModelSettings(**settings)
    jm = getattr(jax_graph, name)(num_input_features=F_IN, num_output_features=F_OUT,
                                  input_shape=(1024,), settings=js,
                                  graph=jax_graph.build_graph_artifacts(MESHGRID, js))
    ps = port_graph.GraphModelSettings(**settings)
    pm = getattr(port_graph, name)(F_IN, F_OUT, (1024,), ps,
                                   port_graph.build_graph_artifacts(MESHGRID, ps))
    x = np.random.default_rng(1).standard_normal((2, 1024, F_IN)).astype(np.float32)
    check_against_jax(name, jm, pm, x)
