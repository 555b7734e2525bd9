"""GraphLAM in the port against the JAX package: the same variables
(converted by ``convert.params_from_jax``) and the same inputs through
both forwards, and ``Trainer.predict`` on the Dummy dataset end to end.

Bar: 1e-4. The port sums in another order than XLA across 3 mesh
levels, the processor layers and their LayerNorms."""

import jax
import numpy as np
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import graph as port_graph

SMALL = {"hidden_dims": 16, "processor_layers": 2, "mesh_levels": 3}
TOL = dict(rtol=1e-4, atol=1e-4)
F_IN, F_OUT = 9, 2


@pytest.fixture(scope="module")
def small_graphlam():
    """The JAX GraphLAM on a 32x32 grid (lattices 8², 4², 2²), its
    variables and an input batch."""
    mg = np.stack(
        np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
    ).astype(np.float32)
    settings = jax_graph.GraphModelSettings(**SMALL)
    model = jax_graph.GraphLAM(
        num_input_features=F_IN, num_output_features=F_OUT, input_shape=(1024,),
        settings=settings, graph=jax_graph.build_graph_artifacts(mg, settings),
    )
    x = np.random.default_rng(0).standard_normal((2, 1024, F_IN)).astype(np.float32)
    variables = model.init(jax.random.key(0), x)
    return mg, model, jax.tree.map(np.asarray, variables), x


def _port_model(mg):
    settings = port_graph.GraphModelSettings(**SMALL)
    return port_graph.GraphLAM(
        F_IN, F_OUT, (1024,), settings, port_graph.build_graph_artifacts(mg, settings)
    )


def test_params_from_jax_fills_every_parameter(small_graphlam):
    mg, _, variables, _ = small_graphlam
    model = _port_model(mg)
    state = params_from_jax(variables)
    assert set(state) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert state[k].shape == p.shape, k
    # Dense kernels are transposed, the scanned processor axis is split
    kernel = variables["params"]["processor"]["block"]["edge"]["w_e"]["kernel"]
    np.testing.assert_array_equal(
        state["processor.1.block.edge.w_e.weight"].numpy(), kernel[1].T
    )


def test_graphlam_forward_matches_jax(small_graphlam):
    mg, model, variables, x = small_graphlam
    want = np.asarray(model.apply(variables, x))
    port = _port_model(mg)
    port.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1024, F_OUT)
    np.testing.assert_allclose(got, want, **TOL)


def test_graphlam_unfused_path_matches_jax(small_graphlam):
    """hidden_layers=2 takes the unfused formulas in both packages."""
    mg, _, _, x = small_graphlam
    args = dict(SMALL, hidden_layers=2)
    js = jax_graph.GraphModelSettings(**args)
    jm = jax_graph.GraphLAM(
        num_input_features=F_IN, num_output_features=F_OUT, input_shape=(1024,),
        settings=js, graph=jax_graph.build_graph_artifacts(mg, js),
    )
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(1), x))
    ps = port_graph.GraphModelSettings(**args)
    port = port_graph.GraphLAM(
        F_IN, F_OUT, (1024,), ps, port_graph.build_graph_artifacts(mg, ps)
    )
    port.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


def test_gather_table_path_is_not_ported(small_graphlam):
    """The name predates the gather-table path's port: ``use_lattice:
    false`` now builds GraphLAM on that path, which computes the JAX
    package's lattice-path output from the same variables
    (tests/test_torch_gather.py holds it against the JAX table path)."""
    mg, model, variables, x = small_graphlam
    settings = port_graph.GraphModelSettings(**SMALL, use_lattice=False)
    port = port_graph.GraphLAM(
        F_IN, F_OUT, (1024,), settings, port_graph.build_graph_artifacts(mg, settings)
    )
    assert port.table_path
    port.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(model.apply(variables, x)), **TOL)


@pytest.fixture(scope="module")
def dummy_predictions():
    """JAX Trainer.predict on Dummy (params from module.init_state), and
    the port's from the same converted params, on the CPU."""
    settings = dict(model_name="GraphLAM", settings_init_args=SMALL,
                    training_strategy="diff_ar")
    _, _, jax_test = jax_get_datasets("dummy", 2, 1, 3)
    jax_module = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**settings), jax_test.dataset_info
    )
    state = jax_module.init_state(jax.random.key(0), 1)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        want = jax_training.Trainer(
            jax_training.TrainerConfig(batch_size=8, save_path=tmp)
        ).predict(jax_module, jax_test, state)

    _, _, port_test = port_get_datasets("dummy", 2, 1, 3)
    port_module = port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**settings), port_test.dataset_info, device="cpu"
    )
    got = port_training.Trainer(
        port_training.TrainerConfig(batch_size=8, device="cpu")
    ).predict(port_module, port_test, params_from_jax(jax.tree.map(np.asarray, state.params)))
    return want, got


def test_predict_matches_jax_on_dummy(dummy_predictions):
    want, got = dummy_predictions
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.names == w.names
        assert g.feature_names == w.feature_names
        assert g.shape == (8, 3, 64 * 64, 1)
        np.testing.assert_allclose(g.array, np.asarray(w.array), **TOL)


def test_predict_outputs_are_denormalized_and_finite(dummy_predictions):
    _, got = dummy_predictions
    for g in got:
        assert isinstance(g.array, np.ndarray)
        assert np.isfinite(g.array).all()
        assert g.array.std() > 0
