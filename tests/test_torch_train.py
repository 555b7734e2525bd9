"""GraphLAM training in the port against the JAX package, on the CPU:
one train step's gradients (the AR carry crossed: 2 predicted steps),
the losses of three AdamW steps with and without gradient accumulation,
the learning-rate schedule against optax, and the trainer's fit / test /
checkpoint / resume loop on the Dummy dataset.

Bars: gradients 1e-4 of the largest JAX gradient of each parameter
(absolute below 1) — the port sums in another order across levels,
layers, AR steps and LayerNorms; losses 1e-4 relative; the schedule
1e-7, the float32 rounding of optax's value."""

import json
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.checkpoint import CheckpointManager, check_format_version
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets

SMALL = {"hidden_dims": 16, "processor_layers": 2, "mesh_levels": 3}
BATCH = 8  # the JAX tests' 8 virtual CPU devices split the batch
GRAD_BAR = 1e-4
LOSS_RTOL = 1e-4


def _settings(**kw):
    base = dict(model_name="GraphLAM", settings_init_args=dict(SMALL),
                training_strategy="diff_ar", num_pred_steps_train=2,
                num_pred_steps_val_test=2, num_warmup_steps=2)
    base.update(kw)
    return base


def _batches(loader, n):
    out = []
    for i, b in enumerate(loader):
        if i >= n:
            break
        out.append(b)
    return out


@pytest.fixture(scope="module")
def data():
    """The Dummy datasets of both packages (bit-identical samples)."""
    jax_sets = jax_get_datasets("dummy", 2, 2, 2)
    port_sets = port_get_datasets("dummy", 2, 2, 2)
    return jax_sets, port_sets


def _jax_module(data, **kw):
    (jax_train, _, _), _ = data
    return jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**_settings(**kw)),
                                             jax_train.dataset_info)


def _port_module(data, **kw):
    _, (port_train, _, _) = data
    return port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**_settings(**kw)), port_train.dataset_info, device="cpu")


# --------------------------------------------------- (v) one step's gradients
@pytest.fixture(scope="module")
def step_grads(data):
    """JAX value_and_grad of _batch_loss and the port's loss_and_grads,
    from the same initial params, on the first two Dummy train batches."""
    (jax_train, _, _), (port_train, _, _) = data
    jm = _jax_module(data)
    state = jm.init_state(jax.random.key(0), 4)
    buffers = jm.step_buffers()
    fn = jax.jit(jax.value_and_grad(
        lambda p, i, f, o: jm._batch_loss(p, i, f, o, 2, jax.random.key(1), buffers,
                                          train=True)[0]))
    pm = _port_module(data)
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    out = []
    for jb, pb in zip(_batches(jax_train.loader(batch_size=BATCH, num_workers=1), 2),
                      _batches(port_train.loader(batch_size=BATCH, num_workers=1), 2)):
        np.testing.assert_array_equal(np.asarray(jb.outputs.array), pb.outputs.array)
        j_loss, j_grads = fn(state.params, *jm._batch_arrays(jb))
        p_loss, p_grads = pm.loss_and_grads(params, pb)
        out.append((float(j_loss), params_from_jax(jax.tree.map(np.asarray, j_grads)),
                    float(p_loss), p_grads))
    return out


@pytest.mark.parametrize("batch_index", [0, 1])
def test_train_step_gradients_match_jax(step_grads, batch_index):
    j_loss, j_grads, p_loss, p_grads = step_grads[batch_index]
    assert abs(p_loss - j_loss) <= LOSS_RTOL * abs(j_loss)
    assert set(p_grads) == set(j_grads)
    for name, want in j_grads.items():
        got = p_grads[name]
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        assert err <= GRAD_BAR * scale, f"{name}: {err:.3e} > {GRAD_BAR} x {scale:.3g}"


def test_every_parameter_gets_a_gradient(step_grads):
    """Nothing upstream of the kernels is cut off: each processor layer,
    the g2m and m2g hops and the embedders all move."""
    _, _, _, p_grads = step_grads[0]
    for name, g in p_grads.items():
        assert float(g.abs().max()) > 0, name


def test_checkpointed_rollout_gives_the_same_gradients(data, step_grads):
    """use_checkpointing recomputes the forward in the backward."""
    _, (port_train, _, _) = data
    pm = _port_module(data, use_checkpointing=True)
    params = {k: v.detach() for k, v in pm.model.named_parameters()}
    batch = _batches(port_train.loader(batch_size=2, num_workers=1), 1)[0]
    plain = _port_module(data)
    _, want = plain.loss_and_grads(params, batch)
    _, got = pm.loss_and_grads(params, batch)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ (vi) AdamW step losses
@pytest.mark.parametrize("accumulate", [1, 2])
def test_adamw_step_losses_match_jax(data, accumulate):
    """Three optimizer steps (3 x accumulate micro-batches): update 0 runs
    at lr 0 (warmup), so updates 1 and 2 move the weights. Losses are
    compared, not parameters: where a gradient is near 0, Adam's m/sqrt(v)
    turns rounding noise into a full-size step."""
    (jax_train, _, _), (port_train, _, _) = data
    n = 3 * accumulate
    jm = _jax_module(data, accumulate_grad_batches=accumulate)
    state = jm.init_state(jax.random.key(0), n)
    pm = _port_module(data, accumulate_grad_batches=accumulate)
    pstate = pm.init_state(None, n, params_from_jax(jax.tree.map(np.asarray, state.params)))
    j_losses, p_losses = [], []
    for jb, pb in zip(_batches(jax_train.loader(batch_size=BATCH, num_workers=1), n),
                      _batches(port_train.loader(batch_size=BATCH, num_workers=1), n)):
        state, loss = jm.train_step(state, jb, jax.random.key(2))
        j_losses.append(float(loss))
        p_losses.append(float(pm.train_step(pstate, pb)))
    assert pstate.step == 3 and pstate.micro_step == 0
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL)
    # the weights did move after the lr-0 update: the same batch again
    # gives another loss than at the start
    first = _batches(port_train.loader(batch_size=BATCH, num_workers=1), 1)[0]
    again = float(pm.loss_and_grads(pstate, first)[0])
    assert abs(again - p_losses[0]) > 1e-6


# ------------------------------------------------------------ (vii) schedule
@pytest.mark.parametrize("lr,min_lr,warmup,n,accumulate", [
    (1e-3, 3e-7, 3, 12, 1),
    (1e-3, 3e-7, 3, 12, 2),
    (2e-4, 0.0, 0, 7, 1),
    (5e-3, 1e-4, 10, 4, 1),   # decay_steps clamped to warmup + 1
])
def test_schedule_matches_optax(lr, min_lr, warmup, n, accumulate):
    settings = SimpleNamespace(
        accumulate_grad_batches=accumulate, learning_rate=lr, min_learning_rate=min_lr,
        num_warmup_steps=warmup, betas=(0.9, 0.95))
    p = torch.zeros(3, requires_grad=True)
    optimizer, scheduler = port_training.AutoRegressiveModule.make_optimizer(
        SimpleNamespace(settings=settings), {"p": p}, n)
    opt_steps = -(-n // accumulate)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(opt_steps, warmup + 1),
                                              min_lr)
    for step in range(opt_steps + 3):
        assert abs(optimizer.param_groups[0]["lr"] - float(want(step))) <= 1e-7, step
        optimizer.step()
        scheduler.step()
    group = optimizer.param_groups[0]
    assert group["weight_decay"] == port_training.ADAMW_WEIGHT_DECAY == 1e-4
    assert group["eps"] == 1e-8 and group["betas"] == (0.9, 0.95)


# ------------------------------------------------- (viii) fit and checkpoints
class _ListLogger:
    def __init__(self):
        self.rows = []

    def log_scalar(self, tag, value, step):
        self.rows.append((tag, value, step))


@pytest.fixture(scope="module")
def fitted(data, tmp_path_factory):
    """fit for 2 epochs of 2 steps on Dummy (val batch 5: a padded tail),
    then a resume of 2 more epochs from `last`."""
    _, (port_train, port_val, _) = data
    save = tmp_path_factory.mktemp("fit")
    pm = _port_module(data)
    log = _ListLogger()
    trainer = port_training.Trainer(port_training.TrainerConfig(
        max_epochs=2, batch_size=5, limit_train_batches=2, save_path=str(save), device="cpu",
        log_every_n_steps=1, num_workers=1), loggers=[log])
    state = trainer.fit(pm, port_train, port_val)
    first = {"step": state.step, "params": {k: v.detach().clone() for k, v in state.params.items()},
             "logs": list(log.rows)}
    resumed = trainer.fit(pm, port_train, port_val, ckpt_path=str(save / "checkpoints" / "last"))
    return SimpleNamespace(module=pm, trainer=trainer, save=save, first=first, state=resumed,
                           log=log)


def test_fit_writes_last_best_and_manifest(fitted, data):
    ck = fitted.save / "checkpoints"
    assert (ck / "last" / "state.pt").is_file() and (ck / "best" / "state.pt").is_file()
    manifest = json.loads((ck / "manifest.json").read_text())
    assert manifest["framework"] == "py4cast_tpu_torch"
    assert manifest["checkpoint_format"] == 2
    assert set(manifest) == set(_jax_module(data).manifest())
    assert (fitted.save / "model" / "signature.json").is_file()


def test_fit_logs_loss_lr_and_val_loss(fitted):
    tags = [t for t, _, _ in fitted.first["logs"]]
    assert tags.count("train/loss") == 4 and tags.count("lr-AdamW") == 4
    assert tags.count("val_mean_loss") == 2
    assert all(np.isfinite(v) for _, v, _ in fitted.first["logs"])


def test_val_loss_covers_every_real_sample(fitted, data):
    """24 val samples in batches of 5: the padded tail's repeated rows
    must not count. The last epoch's val loss equals the mean over the
    whole set in one unpadded batch."""
    _, (_, port_val, _) = data
    (whole,) = _batches(port_val.loader(batch_size=len(port_val), num_workers=1), 1)
    _, per_step = fitted.module.eval_step(fitted.state, whole)
    val = [v for t, v, _ in fitted.log.rows if t == "val_mean_loss"][-1]
    assert abs(val - float(per_step.mean())) <= 1e-6 * abs(val)


def test_resume_continues_the_optimizer_step(fitted):
    assert fitted.first["step"] == 4
    assert fitted.state.step == 8


def test_restore_brings_back_params_optimizer_and_accumulation(fitted, tmp_path, data):
    _, (port_train, _, _) = data
    pm = fitted.module
    state = pm.init_state(torch.Generator().manual_seed(3), 10)
    batch = _batches(port_train.loader(batch_size=2, num_workers=1), 1)[0]
    pm.train_step(state, batch)
    state.accumulate = 2
    pm.train_step(state, batch)  # a micro-step waiting in .grad
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_last(state)
    other = pm.init_state(torch.Generator().manual_seed(4), 10)
    other.accumulate = 2
    ckpt.restore("last", other)
    assert (other.step, other.micro_step) == (state.step, state.micro_step) == (1, 1)
    for k in state.params:
        assert torch.equal(other.params[k], state.params[k])
        assert torch.equal(other.params[k].grad, state.params[k].grad)
        assert torch.equal(other.optimizer.state[other.params[k]]["exp_avg"],
                           state.optimizer.state[state.params[k]]["exp_avg"])
    assert other.lr == state.lr


def test_early_stopping_ends_the_fit(data, tmp_path):
    _, (port_train, port_val, _) = data
    pm = _port_module(data)
    trainer = port_training.Trainer(port_training.TrainerConfig(
        max_epochs=3, batch_size=8, limit_train_batches=1, limit_val_batches=1,
        early_stopping_patience=0, save_path=str(tmp_path), device="cpu", num_workers=1))
    assert trainer.fit(pm, port_train, port_val).step == 1


def test_test_writes_per_timestep_scores(fitted, data):
    _, (_, _, port_test) = data
    scores = fitted.trainer.test(fitted.module, port_test, fitted.state)
    assert set(scores) == {"timestep_losses/test_step_0", "timestep_losses/test_step_1",
                           "test_mean_loss"}
    assert all(np.isfinite(v) for v in scores.values())
    assert json.loads((fitted.save / "test_scores.json").read_text()) == scores


def test_check_format_version_refuses_old_swinunetr():
    with pytest.raises(ValueError, match="predates"):
        check_format_version({"model_name": "SwinUNetR", "checkpoint_format": 1})
    check_format_version({"model_name": "GraphLAM"})  # format 1, unaffected
    check_format_version({"model_name": "SwinUNetR", "checkpoint_format": 2})


def test_restore_of_an_orbax_directory_raises(fitted, tmp_path):
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    state = fitted.module.init_state(torch.Generator().manual_seed(0), 1)
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(tmp_path / "ck").restore(str(orbax), state)


@pytest.mark.parametrize("key,value", [("mesh_spatial", 2), ("mesh_data_parallel", 4),
                                       ("profiler", "jax")])
def test_trainer_config_refuses_what_one_card_cannot_do(key, value):
    with pytest.raises(ValueError, match="queue 1 item 12"):
        port_training.TrainerConfig(device="cpu", **{key: value})
