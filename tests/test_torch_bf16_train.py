"""The trainer under the bf16 policy (``precision: bf16``) on the CPU:
three AdamW steps of GraphLAM and HalfUNet against the JAX package's
bf16 module, the fp32 masters and optimizer state, ``Trainer.predict``
with fp32 outputs, a bf16 checkpoint that resumes as an unbroken run,
the batch dtypes (``downscaling_only`` keeps its forcing fp32), the
rollout's fp32 carry against the JAX package's, and a CLI fit in bf16.

Loss bar, as the forward bar of ``test_torch_bf16.py``: each step's
|port − jax_bf16| ≤ max(2·d, 2⁻⁷) of the fp32 loss, d the largest
|jax_bf16 − fp32| relative to it over the three steps. The fp32 losses
are the port's fp32 module's, which ``test_torch_train.py`` and
``test_torch_halfunet.py`` hold within 1e-4 of the JAX package's: a
second JAX train step compiled in fp32 would double the file's cost."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import rollout as jax_rollout
from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu_torch import cli
from py4cast_tpu_torch import rollout as port_rollout
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.checkpoint import CheckpointManager
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
ULP = 2.0 ** -7
BATCH = 8  # the JAX tests' 8 virtual CPU devices split the batch
MODELS = {
    "GraphLAM": {"hidden_dims": 8, "processor_layers": 1, "mesh_levels": 3},
    "HalfUNet": {"num_filters": 8, "depth": 3},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    """The Dummy datasets of both packages (bit-identical samples)."""
    return jax_get_datasets("dummy", 2, 2, 2), port_get_datasets("dummy", 2, 2, 2)


def _settings(model, precision="bf16", **kw):
    return dict(model_name=model, settings_init_args=dict(MODELS[model]),
                training_strategy="diff_ar", num_pred_steps_train=2, num_pred_steps_val_test=2,
                num_warmup_steps=1, precision=precision, **kw)


def _port_module(data, model="HalfUNet", **kw):
    _, (port_train, _, _) = data
    return port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**_settings(model, **kw)), port_train.dataset_info,
        device="cpu")


def _batches(loader, n):
    return [b for _, b in zip(range(n), loader)]


def _jax_run(data, model, precision, n):
    """n AdamW steps of the JAX module: (its initial params as numpy, the
    final state, the losses)."""
    (jax_train, _, _), _ = data
    jm = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**_settings(model, precision)), jax_train.dataset_info)
    state = jm.init_state(jax.random.key(0), n)
    init = jax.tree.map(np.asarray, state.params)
    losses = []
    for jb in _batches(jax_train.loader(batch_size=BATCH, num_workers=1), n):
        state, loss = jm.train_step(state, jb, jax.random.key(2))
        losses.append(float(loss))
    return init, state, losses


@pytest.mark.parametrize("model", sorted(MODELS))
def test_adamw_step_losses_match_jax_bf16(data, model):
    """Three AdamW steps (2 AR steps a batch) from the JAX module's
    params: the port's bf16 losses track the JAX package's bf16 losses
    within the loss bar, and the masters and AdamW's moments stay fp32."""
    _, (port_train, _, _) = data
    init, state16, j16 = _jax_run(data, model, "bf16", 3)
    losses = {}
    for precision in ("32", "bf16"):
        pm = _port_module(data, model, precision=precision)
        pstate = pm.init_state(None, 3, params_from_jax(init))
        losses[precision] = [float(pm.train_step(pstate, pb)) for pb in
                             _batches(port_train.loader(batch_size=BATCH, num_workers=1), 3)]
    j16, p32, p16 = map(np.asarray, (j16, losses["32"], losses["bf16"]))
    d = float(np.max(np.abs(j16 - p32) / np.abs(p32)))
    err = float(np.max(np.abs(p16 - j16) / np.abs(p32)))
    print(f"{model}: losses port bf16 {p16}, jax bf16 {j16}, fp32 {p32}; "
          f"port vs jax bf16 {err:.3e}, jax bf16 vs fp32 {d:.3e}")
    assert err <= max(2 * d, ULP)
    assert pstate.step == 3 and len(set(p16.tolist())) == 3
    assert all(p.dtype == torch.float32 for p in pstate.params.values())
    for p in pstate.params.values():
        assert all(v.dtype == torch.float32 for v in pstate.optimizer.state[p].values()
                   if torch.is_tensor(v) and v.is_floating_point())
    # the JAX package's own bf16 test: its masters survive a step in fp32
    assert {np.asarray(a).dtype for a in jax.tree.leaves(state16.params)} == {
        np.dtype(np.float32)}


def test_predict_returns_fp32_from_a_bf16_module(data):
    """Trainer.predict in bf16: de-normalized fp32 predictions, finite,
    within bf16's reach of the fp32 module's on the same params."""
    _, (_, _, port_test) = data
    pm16, pm32 = _port_module(data), _port_module(data, precision="32")
    params = pm32.init_params(torch.Generator().manual_seed(0))
    trainer = port_training.Trainer(port_training.TrainerConfig(
        batch_size=BATCH, device="cpu", num_workers=1))
    got = trainer.predict(pm16, port_test, params)
    want = trainer.predict(pm32, port_test, params)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.array.dtype == np.float32 and np.isfinite(g.array).all()
        assert g.names == w.names and g.feature_names == w.feature_names
        scale = float(np.abs(w.array).max())
        assert float(np.abs(g.array - w.array).max()) <= 0.05 * scale


def test_batch_arrays_follow_the_jax_batch_dtypes(data):
    """Inputs and forcing in bf16, targets fp32, as the JAX package's
    batch_arg_dtypes; downscaling_only keeps its forcing (the coarse
    state the predictions add to) and so its inputs in fp32."""
    _, (port_train, _, _) = data
    pm = _port_module(data)
    batch = _batches(port_train.loader(batch_size=2, num_workers=1), 1)[0]
    inputs, forcing, outputs = pm._batch_arrays(batch, with_outputs=True)
    assert (inputs.dtype, forcing.dtype, outputs.dtype) == (BF16, BF16, torch.float32)
    np.testing.assert_array_equal(
        forcing.float().numpy(), torch.from_numpy(batch.forcing.array).to(BF16).float().numpy())
    pm.settings = dataclasses.replace(pm.settings, training_strategy="downscaling_only")
    assert pm.batch_arg_dtypes() == (torch.float32,) * 3
    assert {t.dtype for t in pm._batch_arrays(batch, with_outputs=True)} == {torch.float32}
    assert _port_module(data, precision="32").batch_arg_dtypes() == (torch.float32,) * 3


def test_bf16_checkpoint_resumes_as_an_unbroken_run(data, tmp_path):
    """Two steps, save, restore into a fresh state, two more: the same
    masters and AdamW moments bit for bit as four unbroken steps."""
    _, (port_train, _, _) = data
    pm = _port_module(data)
    batches = _batches(port_train.loader(batch_size=2, num_workers=1), 4)
    unbroken = pm.init_state(torch.Generator().manual_seed(0), 4)
    for b in batches:
        pm.train_step(unbroken, b)
    first = pm.init_state(torch.Generator().manual_seed(0), 4)
    for b in batches[:2]:
        pm.train_step(first, b)
    CheckpointManager(tmp_path).save_last(first)
    resumed = pm.init_state(torch.Generator().manual_seed(9), 4)
    CheckpointManager(tmp_path).restore("last", resumed)
    for b in batches[2:]:
        pm.train_step(resumed, b)
    assert resumed.step == unbroken.step == 4
    for k, p in unbroken.params.items():
        q = resumed.params[k]
        assert p.dtype == q.dtype == torch.float32
        assert torch.equal(p, q), k
        assert torch.equal(unbroken.optimizer.state[p]["exp_avg_sq"],
                           resumed.optimizer.state[q]["exp_avg_sq"]), k


def test_bf16_casts_hold_under_checkpointing_and_dropout(data):
    """UNetRPP (width 16) in bf16 with a dropout rate: loss_and_grads with
    use_checkpointing (the forward recomputed in the backward, the params
    cast again, the dropout generator made again inside the call) gives
    the same loss and gradients bit for bit, all fp32."""
    _, (port_train, _, _) = data
    small = {"hidden_size": 16, "num_heads_encoder": 2, "num_heads_decoder": 2,
             "depths": [1, 1], "encoder_proj_sizes": [8, 4], "decoder_proj_size": 8,
             "dropout_rate": 0.3, "attention_code": "flash_attn"}
    batch = _batches(port_train.loader(batch_size=2, num_workers=1), 1)[0]
    results = []
    for checkpointing in (False, True):
        pm = port_training.AutoRegressiveModule(port_training.TrainingSettings(
            model_name="UNetRPP", settings_init_args=small, precision="bf16",
            num_pred_steps_train=2, use_checkpointing=checkpointing),
            port_train.dataset_info, device="cpu")
        assert pm._dropout_active
        params = pm.init_params(torch.Generator().manual_seed(0))
        results.append(pm.loss_and_grads(params, batch))
    (l0, g0), (l1, g1) = results
    assert l0.dtype == torch.float32 and torch.equal(l0, l1)
    for k in g0:
        assert g0[k].dtype == torch.float32 and torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("strategy,inter", [("scaled_ar", 2), ("diff_ar", 1),
                                            ("downscaling_only", 1)])
def test_rollout_keeps_an_fp32_carry_as_jax(strategy, inter):
    """The rollout on bf16 inputs and forcing (fp32 for downscaling_only),
    with a linear model that casts x to bf16 and returns fp32, as
    ``_model_apply`` does: the fp32 carry, the statics cast to the
    forcing's dtype and the predictions back to the carry's dtype give
    the JAX rollout's fp32 predictions (bf16 products summed in fp32)."""
    rng = np.random.default_rng(5)
    b, n_in, n, f, ff, s, t = 2, 2, 12, 3, 4, 2, 3
    food = np.float32 if strategy == "downscaling_only" else jnp.bfloat16
    inputs, forcing, outputs = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, n_in, n, f), (b, t, n, ff), (b, t, n, f)))
    statics = rng.standard_normal((n, s)).astype(np.float32)
    border = (rng.uniform(size=(n, 1)) > 0.7).astype(np.float32)
    mean = (rng.standard_normal(f) * 0.1).astype(np.float32)
    std = rng.uniform(0.5, 1.5, f).astype(np.float32)
    k_in = (0 if strategy == "downscaling_only" else n_in * f) + s + ff
    w = (rng.standard_normal((k_in, f)) * 0.2).astype(np.float32)
    kw = dict(strategy=strategy, num_inter_steps=inter, num_input_steps=n_in,
              common_features_idx=(0, 1, 2) if strategy == "downscaling_only" else ())
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = jax_rollout.rollout(
        lambda x: jnp.dot(x.astype(jnp.bfloat16), jw,
                          preferred_element_type=jnp.float32),
        jnp.asarray(inputs).astype(food), jnp.asarray(forcing).astype(food),
        jnp.asarray(outputs), jnp.asarray(statics), jnp.asarray(border),
        jnp.asarray(mean), jnp.asarray(std), jax_rollout.RolloutConfig(**kw), t)
    pfood = torch.float32 if strategy == "downscaling_only" else BF16
    tw = torch.from_numpy(w).to(BF16)
    got = port_rollout.rollout(
        lambda x: (x.to(BF16).float() @ tw.float()),
        torch.from_numpy(inputs).to(pfood), torch.from_numpy(forcing).to(pfood),
        torch.from_numpy(outputs), torch.from_numpy(statics), torch.from_numpy(border),
        torch.from_numpy(mean), torch.from_numpy(std), port_rollout.RolloutConfig(**kw), t)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- CLI
def test_cli_fit_takes_model_precision_bf16(tmp_path):
    """One CLI fit step with --model.precision bf16 (HalfUNet cut to
    width 8): it trains, writes a checkpoint of fp32 masters whose
    manifest records the precision, and test, which rebuilds the module
    from the manifest, runs in bf16 from it."""
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--trainer.device", "cpu", "--data.num_workers", "1",
               "--trainer.save_path", str(tmp_path)]
    assert cli.main(["fit", *configs, "--config", str(ROOT / "config/CLI/model/halfunet.yaml"),
                     "--model.settings_init_args.num_filters", "8", "--model.precision", "bf16",
                     "--trainer.max_epochs", "1", "--trainer.limit_train_batches", "1",
                     "--trainer.limit_val_batches", "1"]) == 0
    manifest = json.loads((tmp_path / "checkpoints" / "manifest.json").read_text())
    # the JAX package's keys: the precision rides in training_settings
    assert manifest["training_settings"]["precision"] == "bf16"
    assert manifest["output_dtype"] == "float32"
    payload = torch.load(tmp_path / "checkpoints" / "last" / "state.pt", map_location="cpu",
                         weights_only=True)
    assert {v.dtype for v in payload["params"].values()} == {torch.float32}
    assert cli.main(["test", *configs, "--trainer.ckpt_path", "last",
                     "--trainer.limit_val_batches", "1"]) == 0
    scores = json.loads((tmp_path / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])
