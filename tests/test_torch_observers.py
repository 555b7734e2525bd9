"""The port's observers against the JAX package, on the CPU: a tiny
HalfUNet (4 filters, depth 2) on a 24x24 synthetic grid, the JAX
variables converted by ``convert.params_from_jax``, the same batches
(a full one and a padded tail) through both packages:

- ``named_eval_arrays`` keeps the real rows of a padded tail batch;
- each plotter writes the JAX plotter's files, and the score cards'
  JSON values agree;
- ``Trainer.test`` writes a ``test_scores.json`` with the JAX Trainer's
  keys and values, and the same files;
- ``Trainer.fit``'s validation logs the ``val_rmse_psd/*`` and
  ``val_acc/*`` scalars, gated by ``logging_enabled``, ``fast_dev_run``
  and ``plot_period``;
- without matplotlib every score and JSON file is still written, no
  figure is, and the trainer says so once.

Bars, of the largest JAX value (absolute below 1): losses, scores and
ACC 1e-4 (a whole model sums in another order, as in
test_torch_halfunet.py); PSD-Var 1e-3 in log10 units (test_torch_metrics.py
says why)."""

import dataclasses
import json
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from py4cast_tpu import plots as jax_plots
from py4cast_tpu import testing as jax_testing
from py4cast_tpu import training as jax_training
from py4cast_tpu_torch import plots, testing
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax

GRID = (24, 24)
INFO_ARGS = dict(grid_shape=GRID, weather_features=2, forcing_features=6, border_size=2)
SETTINGS = dict(model_name="HalfUNet", settings_init_args={"num_filters": 4, "depth": 2},
                training_strategy="diff_ar", num_pred_steps_val_test=3, num_warmup_steps=1)
BATCH, STEPS, TAIL = 8, 3, 3
BAR = 1e-4
PSD_VAR_LOG10_TOL = 1e-3


def _close(got, want, bar, name=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


def _batches(mod):
    """A full batch and a tail batch padded to 8 with 3 real rows."""
    info = mod.synthetic_dataset_info(**INFO_ARGS)
    full = mod.synthetic_batch(info, batch_size=BATCH, num_pred_steps=STEPS, seed=0)
    tail = mod.synthetic_batch(info, batch_size=BATCH, num_pred_steps=STEPS, seed=1)
    return info, [full, dataclasses.replace(tail, num_valid=TAIL)]


class _Set:
    """A dataset stand-in: its loader yields the given batches."""

    def __init__(self, info, batches):
        self.dataset_info = info
        self.batches = batches

    def loader(self, **_):
        return list(self.batches)


@pytest.fixture(scope="module")
def pair():
    """Both modules (the port's with the JAX variables), both packages'
    batches and the converted parameters."""
    jax_info, jax_batches = _batches(jax_testing)
    port_info, port_batches = _batches(testing)
    for jb, pb in zip(jax_batches, port_batches):
        np.testing.assert_array_equal(np.asarray(jb.outputs.array), pb.outputs.array)
        np.testing.assert_array_equal(np.asarray(jb.forcing.array), pb.forcing.array)
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**SETTINGS), jax_info)
    state = jm.init_state(jax.random.key(0), 2)
    pm = port_training.AutoRegressiveModule(port_training.TrainingSettings(**SETTINGS),
                                            port_info, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    return jm, state, jax_batches, pm, params, port_batches


@pytest.fixture(scope="module")
def eval_arrays(pair):
    """(pred, target, mask) of both packages for each batch."""
    jm, state, jax_batches, pm, params, port_batches = pair
    out = []
    for jb, pb in zip(jax_batches, port_batches):
        jpreds, _ = jm.eval_step(state, jb, jax.random.key(1))
        ppreds, _ = pm.eval_step(params, pb)
        out.append((jm.named_eval_arrays(jpreds, jb), pm.named_eval_arrays(ppreds, pb)))
    for module in (jm, pm):
        module.current_epoch = 0
    return out


@pytest.mark.parametrize("index,rows", [(0, BATCH), (1, TAIL)])
def test_named_eval_arrays_keep_the_real_rows(eval_arrays, index, rows):
    (jp, jt, jmask), (pp, pt, pmask) = eval_arrays[index]
    assert pp.shape == pt.shape == tuple(pmask.shape) == (rows, STEPS, *GRID, 2)
    assert pp.names == jp.names and pp.feature_names == jp.feature_names
    assert isinstance(pp.array, torch.Tensor) and pp.array.device.type == "cpu"
    _close(pp.array.numpy(), np.asarray(jp.array), BAR, "pred")
    np.testing.assert_array_equal(pt.array.numpy(), np.asarray(jt.array))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))


def _run_plotter(kind, package, module, arrays, batches, save):
    """Feed every batch to one plotter of ``package`` and end its epoch."""
    if kind == "state_error":
        p = package.StateErrorPlot({"mae": module.make_scaled_loss("mae"),
                                    "rmse": module.make_scaled_loss("rmse")},
                                   prefix="Test", save_path=save)
    elif kind == "spatial_error":
        p = package.SpatialErrorPlot(prefix="Test", save_path=save)
    elif kind == "timestep":
        p = package.PredictionTimestepPlot(num_samples_to_plot=1, num_features_to_plot=1,
                                           prefix="Test", save_path=save)
    else:
        p = package.PredictionEpochPlot(num_samples_to_plot=2, num_features_to_plot=2,
                                        prefix="Test", save_path=save)
    for batch, (pred, target, mask) in zip(batches, arrays):
        p.update(module, batch, pred, target, mask)
    maps = [np.asarray(m) if not isinstance(m, torch.Tensor) else m.numpy()
            for m in getattr(p, "spatial_loss_maps", [])]
    p.on_step_end(module, label="Test")
    return p, maps


def _files(root):
    return sorted(str(f.relative_to(root)) for f in root.rglob("*") if f.is_file())


@pytest.mark.parametrize("kind", ["state_error", "spatial_error", "timestep", "epoch"])
def test_each_plotter_writes_the_jax_plotters_files(pair, eval_arrays, kind, tmp_path):
    jm, _, jax_batches, pm, _, port_batches = pair
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    _, jmaps = _run_plotter(kind, jax_plots, jm, [e[0] for e in eval_arrays], jax_batches, jdir)
    _, pmaps = _run_plotter(kind, plots, pm, [e[1] for e in eval_arrays], port_batches, pdir)
    assert _files(pdir) == _files(jdir) and _files(pdir)
    if kind == "state_error":
        for name in ("Test_mae_scores.json", "Test_rmse_scores.json"):
            got, want = (json.loads((d / name).read_text()) for d in (pdir, jdir))
            assert list(got) == list(want) and all(len(v) == STEPS for v in got.values())
            _close(list(got.values()), list(want.values()), BAR, name)
    if kind == "spatial_error":
        assert [m.shape for m in pmaps] == [(BATCH, STEPS, *GRID), (TAIL, STEPS, *GRID)]
        for got, want in zip(pmaps, jmaps):
            _close(got, want, BAR, "spatial loss map")


@pytest.fixture(scope="module")
def both_tests(pair, tmp_path_factory):
    """Trainer.test of both packages on the same batches and weights."""
    jm, state, jax_batches, pm, params, port_batches = pair
    jdir, pdir = tmp_path_factory.mktemp("jax_test"), tmp_path_factory.mktemp("port_test")
    want = jax_training.Trainer(jax_training.TrainerConfig(
        batch_size=BATCH, save_path=str(jdir))).test(jm, _Set(jm.dataset_info, jax_batches),
                                                     state)
    got = port_training.Trainer(port_training.TrainerConfig(
        batch_size=BATCH, save_path=str(pdir), device="cpu", num_workers=1)).test(
        pm, _Set(pm.dataset_info, port_batches), params)
    return got, want, pdir, jdir


def test_trainer_test_scores_match_jax(both_tests):
    got, want, pdir, _ = both_tests
    assert json.loads((pdir / "test_scores.json").read_text()) == got
    assert list(got) == list(want)
    names = [f"var{i}_500_isobaricInhPa" for i in range(2)]
    assert {f"test_rmse_psd/{n}" for n in names} | {
        f"test_acc/{n}_step{j}" for n in names for j in range(STEPS)} <= set(got)
    for key in got:
        tol = PSD_VAR_LOG10_TOL if key.startswith("test_rmse_psd/") else BAR
        _close(got[key], want[key], tol, key)


def test_trainer_test_writes_the_jax_trainers_files(both_tests):
    _, _, pdir, jdir = both_tests
    assert _files(pdir) == _files(jdir)
    for name in ("Test_mae_scores.json", "Test_rmse_scores.json"):
        got, want = (json.loads((d / name).read_text()) for d in (pdir, jdir))
        _close(list(got.values()), list(want.values()), BAR, name)


class _Log:
    def __init__(self):
        self.scalars, self.figures = [], []

    def log_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def log_figure(self, tag, fig, step):
        self.figures.append((tag, step))


@pytest.mark.parametrize("config,observed_epochs", [
    ({}, [0, 1]),
    ({"plot_period": 2}, [0]),
    ({"logging_enabled": False}, []),
    ({"fast_dev_run": True}, []),
])
def test_fit_validation_logs_psd_and_acc(pair, tmp_path, config, observed_epochs):
    _, _, _, pm, params, port_batches = pair
    log = _Log()
    data = _Set(pm.dataset_info, port_batches)
    trainer = port_training.Trainer(port_training.TrainerConfig(
        max_epochs=2, batch_size=BATCH, save_path=str(tmp_path), device="cpu", num_workers=1,
        log_every_n_steps=1, num_samples_to_plot=0, **config), loggers=[log])
    trainer.fit(pm, data, data, params=params)
    names = [f"var{i}_500_isobaricInhPa" for i in range(2)]
    want = [f"val_rmse_psd/{n}" for n in names] + [
        f"val_acc/{n}_step{j}" for n in names for j in range(STEPS)]
    val_steps = [s for t, _, s in log.scalars if t == "val_mean_loss"]
    got = [(t, s) for t, _, s in log.scalars if t.startswith(("val_rmse_psd/", "val_acc/"))]
    assert got == [(t, val_steps[e]) for e in observed_epochs for t in want]
    assert all(np.isfinite(v) for _, v, _ in log.scalars)
    figures = {t for t, _ in log.figures}
    if observed_epochs:
        assert {"score_cards/Validation_mae", *(f"val_mean_psd_k/{n}" for n in names)} <= figures
        assert (tmp_path / "Valid_mae_scores.json").is_file()
    else:
        assert not figures


def test_without_matplotlib_scores_and_json_are_written(pair, tmp_path, monkeypatch, capsys,
                                                        both_tests):
    _, _, _, pm, params, port_batches = pair
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    trainer = port_training.Trainer(port_training.TrainerConfig(
        batch_size=BATCH, save_path=str(tmp_path), device="cpu", num_workers=1))
    data = _Set(pm.dataset_info, port_batches)
    scores = trainer.test(pm, data, params)
    trainer.test(pm, data, params)
    assert capsys.readouterr().out.count(plots.NO_FIGURES) == 1
    assert scores == both_tests[0]
    assert _files(tmp_path) == ["Test_mae_scores.json", "Test_rmse_scores.json",
                                "test_scores.json"]
    with tempfile.TemporaryDirectory() as tmp, pytest.raises(ImportError, match="matplotlib"):
        plots.plot_log_psd([1, 2], [1, 2], [1, 2]).savefig(f"{tmp}/x.png")
