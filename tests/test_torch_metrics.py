"""The port's metrics against the JAX package, on the CPU: the DCT-II as
two matrix products against ``jax.scipy.fft.dctn``, the radial binning's
constants and the PSD against ``power_spectral_density`` (even and odd
grids), and PSD-K, PSD-Var and ACC state and ``compute`` values on the
same numpy inputs from a seed, in grid and in graph layout, with a mask
that blanks part of the fields.

Bars, each of the largest JAX value (absolute below 1):
- DCT and PSD 1e-5: fp32 products of 17–24 terms against XLA's FFT;
- ACC 1e-4: the spatial means sum in another order;
- PSD-Var 1e-3 in log10 units: log10(psd + 1e-12) of masked fields
  turns tiny absolute differences of spectra that fall near the eps
  into large ones in log space (1.5e-7 on these inputs, where no bin
  falls that low; the bar is for fields whose spectra do)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.fft import dctn

from py4cast_tpu import metrics as jax_metrics
from py4cast_tpu.testing import synthetic_dataset_info as jax_info
from py4cast_tpu_torch import metrics
from py4cast_tpu_torch.testing import synthetic_dataset_info as port_info

B, T, H, W, F = 2, 3, 24, 20, 3
NAMES = tuple(f"var{i}_500_isobaricInhPa" for i in range(F))
DCT_TOL = 1e-5
ACC_TOL = 1e-4
PSD_VAR_LOG10_TOL = 1e-3


def _close(got, want, bar, name=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


def _rel_close(got, want, bar, name=""):
    """Against the largest value whatever its size (spectra are far
    below 1)."""
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= bar * float(np.abs(want).max()), f"{name}: {err:.3e}"


@pytest.mark.parametrize("shape", [(4, 24, 20), (2, 3, 17, 23), (1, 1, 1, 5)])
def test_dct_2d_matches_jax_dctn(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(dctn(jnp.asarray(x), axes=(-2, -1), norm="ortho"))
    got = metrics.dct_2d(torch.from_numpy(x)).numpy()
    _close(got, want, DCT_TOL, "dct_2d")


@pytest.mark.parametrize("shape", [(24, 20), (17, 23), (64, 80), (3, 3)])
def test_radial_bin_constants_match_jax(shape):
    got = metrics._radial_bin_constants(shape)
    want = jax_metrics._radial_bin_constants(shape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert metrics.psd_rmax(shape) == jax_metrics.psd_rmax(shape)


@pytest.mark.parametrize("shape", [(2, 3, 24, 20), (2, 3, 17, 23)])
def test_power_spectral_density_matches_jax(shape):
    x = np.random.default_rng(shape[-1]).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_metrics.power_spectral_density(jnp.asarray(x)))
    got = metrics.power_spectral_density(torch.from_numpy(x)).numpy()
    _rel_close(got, want, DCT_TOL, "psd")


def test_psd_graph_layout_is_the_grid_layout():
    """(B, T, ngrid, F) unflattens onto the grid before the spectra."""
    x = np.random.default_rng(7).standard_normal((B, T, H, W, F)).astype(np.float32)
    grid = metrics._to_bchw(torch.from_numpy(x), T - 1, (H, W))
    graph = metrics._to_bchw(torch.from_numpy(x.reshape(B, T, H * W, F)), T - 1, (H, W))
    assert torch.equal(grid, graph) and grid.shape == (B, F, H, W)
    np.testing.assert_array_equal(grid.numpy(), np.moveaxis(x[:, T - 1], -1, 1))


def test_radial_binning_repeats_bit_for_bit():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 40, 52)).astype(np.float32))
    a = metrics.radial_bin_dct(x, (40, 52))
    b = metrics.radial_bin_dct(x.clone(), (40, 52))
    assert torch.equal(a, b)


def test_dct_runs_with_tf32_off(monkeypatch):
    """The products run with TF32 off, and the caller's flags come back."""
    seen = []
    real = torch.matmul

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        monkeypatch.setattr(torch, "matmul", spy)
        metrics.dct_2d(torch.ones(2, 8, 8))
        assert seen == [(False, False), (False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# ------------------------------------------------------------------ metrics
@pytest.fixture(scope="module")
def jax_set():
    """One JAX metric of each kind (each jits once for this file)."""
    with pytest.warns(UserWarning, match="climate normals"):
        acc = jax_metrics.MetricACC(jax_info(grid_shape=(H, W), weather_features=F), T)
    return {
        "psd_k": jax_metrics.MetricPSDK("/nonexistent", NAMES, (H, W), pred_step=T - 1),
        "psd_var": jax_metrics.MetricPSDVar(NAMES, (H, W), pred_step=T - 1),
        "acc": acc,
    }


def _port_set(save_path="/nonexistent"):
    info = port_info(grid_shape=(H, W), weather_features=F)
    # climate means away from 0, so ACC's anomalies are not the raw fields
    for i, n in enumerate(NAMES):
        info.stats[n]["mean"] = 0.1 * (i + 1)
    with pytest.warns(UserWarning, match="climate normals"):
        acc = metrics.MetricACC(info, T, device="cpu")
    return {
        "psd_k": metrics.MetricPSDK(save_path, NAMES, (H, W), pred_step=T - 1, device="cpu"),
        "psd_var": metrics.MetricPSDVar(NAMES, (H, W), pred_step=T - 1, device="cpu"),
        "acc": acc,
    }


def _inputs(seed, layout):
    """Two batches of (preds, targets, mask): smooth-ish fields plus
    noise; the mask blanks a block of each sample."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        base = rng.standard_normal((B, T, H, W, F)).astype(np.float32)
        preds = (base + 0.3 * rng.standard_normal(base.shape)).astype(np.float32)
        mask = np.ones_like(base)
        mask[:, :, 3:9, 5:12] = 0.0
        if layout == "graph":
            preds, base, mask = (a.reshape(B, T, H * W, F) for a in (preds, base, mask))
        out.append((preds, base, mask))
    return out


@pytest.fixture(scope="module", params=["grid", "graph"])
def both_states(request, jax_set):
    """Each metric's state after the same two updates in both packages,
    and the port's after a second run of the same updates."""
    layout = request.param
    batches = _inputs(11, layout)
    jax_states = {k: m.init_state() for k, m in jax_set.items()}
    for p, t, m in batches:
        for k, metric in jax_set.items():
            jax_states[k] = metric.update(jax_states[k], jnp.asarray(p), jnp.asarray(t),
                                          jnp.asarray(m))
    port = _port_set()
    runs = []
    for _ in range(2):
        states = {k: m.init_state() for k, m in port.items()}
        for p, t, m in batches:
            for k, metric in port.items():
                states[k] = metric.update(states[k], torch.from_numpy(p), torch.from_numpy(t),
                                          torch.from_numpy(m))
        runs.append(states)
    return layout, port, runs, {k: {n: np.asarray(v) for n, v in s.items()}
                                for k, s in jax_states.items()}


def test_climate_means_come_from_the_stats():
    port = _port_set()
    np.testing.assert_array_equal(port["acc"].climate_means.numpy(),
                                  np.float32([0.1, 0.2, 0.3]))


def test_psd_k_state_matches_jax(both_states):
    _, _, runs, want = both_states
    got = runs[0]["psd_k"]
    for key in ("sum_psd_pred", "sum_psd_target"):
        _rel_close(got[key].numpy(), want["psd_k"][key], DCT_TOL, key)
    assert float(got["step_count"]) == float(want["psd_k"]["step_count"]) == 2.0


def test_psd_var_values_match_jax(both_states, jax_set):
    _, port, runs, want = both_states
    got = port["psd_var"].compute(runs[0]["psd_var"], "val")
    jax_vals = jax_set["psd_var"].compute(want["psd_var"], "val")
    assert list(got) == list(jax_vals) == [f"val_rmse_psd/{n}" for n in NAMES]
    for k in got:
        assert abs(got[k] - jax_vals[k]) <= PSD_VAR_LOG10_TOL, (k, got[k], jax_vals[k])


def test_acc_values_match_jax(both_states, jax_set):
    """The JAX metric's climate means are the synthetic stats' zeros;
    the port's are set to zero here for the comparison."""
    layout, port, runs, _ = both_states
    acc = port["acc"]
    acc.climate_means = torch.zeros_like(acc.climate_means)
    state = acc.init_state()
    jstate = jax_set["acc"].init_state()
    for p, t, m in _inputs(11, layout):
        state = acc.update(state, *(torch.from_numpy(a) for a in (p, t, m)))
        jstate = jax_set["acc"].update(jstate, *(jnp.asarray(a) for a in (p, t, m)))
    got = acc.compute(state, "test")
    want = jax_set["acc"].compute(jstate, "test")
    assert list(got) == list(want)
    assert list(got)[:2] == [f"test_acc/{NAMES[0]}_step0", f"test_acc/{NAMES[0]}_step1"]
    _close([got[k] for k in got], [want[k] for k in want], ACC_TOL, "acc")


def test_acc_with_climate_means_matches_numpy(both_states):
    """Against an fp64 numpy ACC with the port's non-zero climate means."""
    layout, _, runs, _ = both_states
    port = _port_set()
    means = np.float64([0.1, 0.2, 0.3])
    num = np.zeros((T, F))
    for p, t, m in _inputs(11, layout):
        sp = tuple(range(2, p.ndim - 1))
        pa, ta = (p - means) * m, (t - means) * m
        acc = (pa * ta).mean(sp) / np.sqrt((pa**2).mean(sp) * (ta**2).mean(sp) + 1e-12)
        num += acc.mean(0)
    got = port["acc"].compute(runs[0]["acc"], "val")
    want = num / 2
    _close([got[f"val_acc/{n}_step{j}"] for n in NAMES for j in range(T)],
           [want[j, i] for i in range(F) for j in range(T)], ACC_TOL, "acc fp64")


def test_a_second_run_repeats_bit_for_bit(both_states):
    _, _, (first, second), _ = both_states
    for k in first:
        for name in first[k]:
            assert torch.equal(first[k][name], second[k][name]), (k, name)


def test_state_stays_on_the_metric_device(both_states):
    _, _, runs, _ = both_states
    for state in runs[0].values():
        assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in state.values())


def test_psd_k_compute_draws_and_saves_each_feature(both_states, tmp_path):
    _, _, runs, _ = both_states
    psd_k = _port_set(tmp_path)["psd_k"]
    figs = psd_k.compute(runs[0]["psd_k"], "test")
    assert list(figs) == [f"test_mean_psd_k/{n}" for n in NAMES]
    assert sorted(p.name for p in (tmp_path / "test_mean_psd_k").iterdir()) == [
        f"{n}_{T}.png" for n in NAMES]
    from py4cast_tpu_torch.plots import pyplot

    for fig in figs.values():
        pyplot().close(fig)
    assert runs[0]["psd_k"]["sum_psd_pred"].shape == (F, metrics.psd_rmax((H, W)))


def test_psd_k_compute_without_matplotlib_draws_nothing(both_states, tmp_path, monkeypatch):
    _, _, runs, _ = both_states
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert _port_set(tmp_path)["psd_k"].compute(runs[0]["psd_k"], "val") == {}
    assert not (tmp_path / "val_mean_psd_k").exists()


def test_perfect_predictions():
    """PSD-Var 0 and ACC 1 when the prediction is the target."""
    port = _port_set()
    (p, _, m), _ = _inputs(3, "grid")
    x, mask = torch.from_numpy(p), torch.from_numpy(m)
    for key, want, tol in (("psd_var", 0.0, 1e-5), ("acc", 1.0, 1e-4)):
        state = port[key].update(port[key].init_state(), x, x, mask)
        for v in port[key].compute(state).values():
            assert v == pytest.approx(want, abs=tol)


def test_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA"):
        metrics.MetricPSDVar(NAMES, (H, W))
