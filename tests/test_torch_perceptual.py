"""The perceptual loss in the port against the JAX package's on the CPU:
trained features and the fallback pyramid, alone and in a CombinedLoss
with WeightedLoss, values (B, T) and gradients with respect to the
prediction on the same masked fields; the port's copy of the trained
features; the fallback when the file is missing; a HalfUNet fit on
Dummy whose loss includes it; TF32 off around it in train and eval
steps.

Bar: 1e-4 of the largest JAX value (absolute below 1): the same fp32
convolutions, summed in another order."""

import hashlib
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import py4cast_tpu
from py4cast_tpu import losses as jax_losses
from py4cast_tpu_torch import losses
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets

BAR = 1e-4
FEATURES = ("t2m_2_heightAboveGround", "u10_10_heightAboveGround", "z_500_isobaricInhPa")
#: odd sides: the [::2, ::2] subsample between scales keeps the first row
SHAPE = (2, 2, 21, 18, len(FEATURES))
PERCEPTUAL = {"class": "PerceptualLossPy4Cast", "weight": 0.1}
COMBINED = [{"class": "WeightedLoss", "params": {"loss": "MSELoss"}}, PERCEPTUAL]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the fields here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


@pytest.fixture(scope="module")
def info():
    """The DatasetInfo fields the losses read: min/max/mean/std a field
    (the min-max scaling clips part of each field), state weights and
    step-difference stds."""
    return SimpleNamespace(
        stats={n: {"min": lo, "max": hi, "mean": m, "std": s}
               for n, lo, hi, m, s in zip(FEATURES, (-2.0, -1.0, 0.0), (2.5, 1.5, 3.0),
                                          (0.3, -0.2, 1.1), (1.5, 0.8, 2.0))},
        state_weights=dict(zip(FEATURES, (1.0, 0.5, 2.0))),
        diff_stats={n: {"std": s} for n, s in zip(FEATURES, (0.7, 1.3, 2.1))},
    )


@pytest.fixture(scope="module")
def fields():
    """(pred, target, mask, interior) as numpy; a masked patch and one
    masked feature point."""
    rng = np.random.default_rng(0)
    pred = rng.standard_normal(SHAPE).astype(np.float32)
    target = rng.standard_normal(SHAPE).astype(np.float32)
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, :3, :4] = 0.0
    mask[1, 0, 10, 7, 2] = 0.0
    interior = (rng.uniform(size=SHAPE[2:4] + (1,)) > 0.1).astype(np.float32)
    return pred, target, mask, interior


def _jax_value_and_grad(conf, info, fields):
    pred, target, mask, interior = fields
    loss = jax_losses.CombinedLoss(conf)
    loss.prepare(interior, info, FEATURES)

    def total(p):
        value = loss(SimpleNamespace(array=p), SimpleNamespace(array=jnp.asarray(target)),
                     jnp.asarray(mask), interior_mask=jnp.asarray(interior))
        return value.sum(), value

    (_, value), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(pred))
    return np.asarray(value), np.asarray(grad)


def _port_value_and_grad(conf, info, fields):
    pred, target, mask, interior = fields
    loss = losses.CombinedLoss(conf)
    loss.prepare(interior, info, FEATURES)
    p = torch.from_numpy(pred).requires_grad_(True)
    value = loss(SimpleNamespace(array=p), SimpleNamespace(array=torch.from_numpy(target)),
                 torch.from_numpy(mask), interior_mask=torch.from_numpy(interior))
    value.sum().backward()
    return value.detach().numpy(), p.grad.numpy()


@pytest.mark.parametrize("trained", [True, False], ids=["trained", "fallback"])
@pytest.mark.parametrize("combined", [False, True], ids=["alone", "combined"])
def test_perceptual_loss_matches_jax(info, fields, trained, combined):
    """Value (B, T) and d sum / d prediction against the JAX package's."""
    member = {**PERCEPTUAL, "params": {"trained": trained}}
    conf = [COMBINED[0], member] if combined else [member]
    want, want_grad = _jax_value_and_grad(conf, info, fields)
    got, got_grad = _port_value_and_grad(conf, info, fields)
    assert got.shape == want.shape == SHAPE[:2]
    _close(got, want, BAR, "value")
    _close(got_grad, want_grad, BAR, "gradient")
    assert float(np.abs(got_grad).max()) > 0
    # masked points take no gradient
    assert not got_grad[:, :, :3, :4].any()


def test_fallback_pyramid_is_the_jax_draws(info):
    """The fallback kernels are the JAX package's, bit for bit: the same
    numpy draws in the same order, 32 channels a scale, zero biases."""
    jl = jax_losses.PerceptualLossPy4Cast(trained=False, num_scales=4)
    jl.prepare(np.ones((4, 4, 1), np.float32), info, FEATURES)
    pl = losses.PerceptualLossPy4Cast(trained=False, num_scales=4)
    pl.prepare(np.ones((4, 4, 1), np.float32), info, FEATURES)
    assert len(pl.kernels) == 4
    for jk, pk, jb, pb in zip(jl._kernels, pl.kernels, jl._biases, pl.biases):
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert tuple(pl.kernels[1].shape) == (32, 32, 3, 3)


def test_trained_features_are_a_copy_of_the_jax_file(info):
    """The port reads its own copy, byte for byte the JAX package's file."""
    jax_file = Path(py4cast_tpu.__file__).parent / "data" / "perceptual_feats.npz"
    digests = [hashlib.sha256(p.read_bytes()).hexdigest()
               for p in (jax_file, losses.PERCEPTUAL_FEATS)]
    assert digests[0] == digests[1]
    pl = losses.PerceptualLossPy4Cast()
    pl.prepare(np.ones((4, 4, 1), np.float32), info, FEATURES)
    assert [tuple(k.shape) for k in pl.kernels] == [(16, 1, 3, 3), (32, 16, 3, 3),
                                                      (32, 32, 3, 3)]
    assert float(pl.biases[0].abs().max()) > 0


def test_missing_features_file_falls_back_with_a_warning(info, fields, monkeypatch, tmp_path):
    """Without the file, trained=True warns and computes what
    trained=False computes, bit for bit."""
    want, want_grad = _port_value_and_grad([{**PERCEPTUAL, "params": {"trained": False}}],
                                           info, fields)
    monkeypatch.setattr(losses, "PERCEPTUAL_FEATS", tmp_path / "absent.npz")
    with pytest.warns(UserWarning, match="falling back"):
        got, got_grad = _port_value_and_grad([PERCEPTUAL], info, fields)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_grad, want_grad)


def test_perceptual_loss_refuses_graph_layouts(info):
    loss = losses.PerceptualLossPy4Cast()
    loss.prepare(np.ones((30, 1), np.float32), info, FEATURES)
    x = SimpleNamespace(array=torch.zeros(1, 1, 30, len(FEATURES)))
    with pytest.raises(ValueError, match="lat, lon"):
        loss(x, x, torch.ones(1, 1, 30, len(FEATURES)))


def test_fit_with_the_perceptual_loss_trains(tmp_path):
    """A HalfUNet fit on Dummy with [WeightedLoss + 0.1 perceptual]:
    finite train and validation losses, the train loss falls, and test
    scores the same combined loss."""
    train, val, test = port_get_datasets("dummy", 2, 1, 3)
    settings = port_training.TrainingSettings(
        model_name="HalfUNet", settings_init_args={"num_filters": 8, "depth": 2},
        losses=COMBINED, num_warmup_steps=1, learning_rate=3e-3)
    module = port_training.AutoRegressiveModule(settings, train.dataset_info, device="cpu")
    assert isinstance(module.loss.losses[1][0], losses.PerceptualLossPy4Cast)
    trainer = port_training.Trainer(port_training.TrainerConfig(
        max_epochs=2, batch_size=8, limit_train_batches=3, limit_val_batches=1,
        save_path=str(tmp_path), device="cpu", num_workers=1, logging_enabled=False))
    log = []
    trainer._log = lambda tag, value, step: log.append((tag, value))
    state = trainer.fit(module, train, val)
    epoch_losses = [v for t, v in log if t == "mean_loss_epoch/train"]
    assert len(epoch_losses) == 2 and all(np.isfinite(epoch_losses))
    assert epoch_losses[1] < epoch_losses[0]
    assert all(np.isfinite(v) for t, v in log if t.startswith("val"))
    scores = trainer.test(module, test, state)
    assert np.isfinite(scores["test_mean_loss"])


def test_train_and_eval_steps_run_the_loss_with_tf32_off(monkeypatch):
    """The perceptual convolutions run inside the steps'
    exact_reductions: train_step and eval_step (validation and test)
    see TF32 off even when the process turned it on."""
    train, _, _ = port_get_datasets("dummy", 2, 1, 3)
    settings = port_training.TrainingSettings(
        model_name="HalfUNet", settings_init_args={"num_filters": 8, "depth": 2},
        losses=COMBINED)
    module = port_training.AutoRegressiveModule(settings, train.dataset_info, device="cpu")
    seen = []
    features = losses.PerceptualLossPy4Cast._features

    def spy(self, x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return features(self, x)

    monkeypatch.setattr(losses.PerceptualLossPy4Cast, "_features", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    state = module.init_state(torch.Generator().manual_seed(0), 2)
    batch = next(iter(train.loader(batch_size=2, num_workers=1)))
    module.train_step(state, batch)
    module.eval_step(state, batch)
    assert seen == [(False, False)] * 4  # prediction and target, twice
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
