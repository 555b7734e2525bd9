"""``py4cast_tpu_torch.export`` on the CPU, and what the trainer writes
with it: a ``torch.export`` program of a grid model's forward, saved,
reloaded and run.

- HalfUNet at 16x16 (``num_filters`` 8, depth 2: tests/test_export.py's
  case) from the JAX package's variables: the reloaded program against
  the eager port within rtol 1e-5 / atol 1e-6 (the same operations, so
  in fact bit for bit here), and against the JAX package's
  ``model.apply`` within 1e-4 of scale (the port sums in another order).
- A small Segformer and a small UNetRPP with ``attention_code: pallas``:
  their programs hold the attention kernel's custom op
  (``p4t::short_kv_attention_fwd``), which on the CPU runs the plain
  version; reloaded within rtol 1e-5 / atol 1e-6.
- ``Trainer.fit`` with ``trainer.profiler: jax`` writes a torch.profiler
  trace under <save_path>/profile, and ``_log_model`` writes
  model/forward.pt2 for a grid model and none for a graph model."""

import jax
import numpy as np
import pytest
import torch

from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets
from py4cast_tpu_torch.export import export_forward, load_and_infer
from py4cast_tpu_torch.models import unet as port_unet
from py4cast_tpu_torch.testing import _small_module
from py4cast_tpu_torch.training import (
    AutoRegressiveModule,
    Trainer,
    TrainerConfig,
    TrainingSettings,
)

TOL = dict(rtol=1e-5, atol=1e-6)
JAX_BAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as every port test file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_halfunet_export_reloads_and_matches_eager_and_jax(tmp_path):
    settings = dict(num_filters=8, depth=2)
    jm = jax_unet.HalfUNet(num_input_features=5, num_output_features=3, input_shape=(16, 16),
                           settings=jax_unet.HalfUNetSettings(**settings))
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 5)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x)
    rng = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    want_jax = np.asarray(jax.jit(jm.apply)(variables, x))

    model = port_unet.HalfUNet(5, 3, (16, 16), port_unet.HalfUNetSettings(**settings)).eval()
    params = params_from_jax(variables)
    model.load_state_dict(params, strict=True)
    dest = export_forward(model, params, (16, 16), tmp_path / "halfunet.pt2")
    assert dest.exists() and dest.stat().st_size > 0

    got = load_and_infer(dest, x).numpy()
    with torch.no_grad():
        eager = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, eager, **TOL)
    scale = max(1.0, float(np.abs(want_jax).max()))
    assert float(np.abs(got - want_jax).max()) <= JAX_BAR * scale


#: a Segformer (head dim 16, K/V of 16 tokens at stage 1) and a UNetRPP on
#: the attention kernel, cut in width and depth for the CPU
ATTENTION_MODELS = {
    "Segformer": ({"dims": [16, 32], "heads": [1, 2], "ff_expansion": [2, 2],
                   "reduction_ratio": [4, 1], "num_layers": 1, "decoder_dim": 16}, (32, 32)),
    "UNetRPP": ({"hidden_size": 32, "depths": [1, 1, 1, 1], "num_heads_encoder": 2,
                 "num_heads_decoder": 2, "encoder_proj_sizes": [8, 8, 8, 8],
                 "decoder_proj_size": 8, "attention_code": "pallas"}, (32, 32)),
}


@pytest.mark.parametrize("name", sorted(ATTENTION_MODELS))
def test_attention_models_export_the_kernel_op(name, tmp_path):
    args, grid = ATTENTION_MODELS[name]
    module, _ = _small_module(name, args, grid, "cpu")
    params = module.init_params(torch.Generator().manual_seed(0))
    dest = export_forward(module.model, params, grid, tmp_path / f"{name}.pt2")
    program = torch.export.load(dest)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "p4t.short_kv_attention_fwd.default" in targets, sorted(targets)

    x = np.random.default_rng(2).standard_normal(
        (1, *grid, module.num_input_features)).astype(np.float32)
    got = load_and_infer(dest, x).numpy()
    with torch.no_grad():
        eager = torch.func.functional_call(module.model, params, (torch.from_numpy(x),))
    np.testing.assert_allclose(got, eager.numpy(), **TOL)


def test_fit_traces_with_the_profiler_and_logs_the_program(tmp_path):
    """A one-batch HalfUNet fit with profiler "jax": a trace under
    <save_path>/profile that names the fit's convolutions, and
    model/forward.pt2 beside signature.json, which reloads and runs."""
    train_ds, val_ds, _ = get_datasets("dummy", 2, 1, 1)
    module = AutoRegressiveModule(
        TrainingSettings(model_name="HalfUNet", settings_init_args={"num_filters": 4, "depth": 2},
                         num_warmup_steps=2),
        train_ds.dataset_info, device="cpu")
    save = tmp_path / "run"
    Trainer(TrainerConfig(max_epochs=1, batch_size=4, limit_train_batches=1,
                          limit_val_batches=1, save_path=str(save), logging_enabled=False,
                          num_workers=1, device="cpu", profiler="jax")).fit(
        module, train_ds, val_ds)
    traces = list((save / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    assert "aten::convolution" in traces[0].read_text()

    program = save / "model" / "forward.pt2"
    assert (save / "model" / "signature.json").exists() and program.exists()
    x = np.zeros((1, *module.model.input_shape, module.num_input_features), np.float32)
    assert load_and_infer(program, x).shape == (1, *module.model.input_shape,
                                                module.num_output_features)


def test_log_model_writes_no_program_for_a_graph_model(tmp_path):
    """The graph models get signature.json alone, as in the JAX package."""
    module, _ = _small_module("GraphLAM", {"hidden_dims": 8, "processor_layers": 1,
                                           "mesh_levels": 2}, (16, 16), "cpu")
    state = module.init_state(torch.Generator().manual_seed(0), 1)
    trainer = Trainer(TrainerConfig(save_path=str(tmp_path), device="cpu"))
    trainer._log_model(module, state)
    assert (tmp_path / "model" / "signature.json").exists()
    assert not (tmp_path / "model" / "forward.pt2").exists()
