"""Validation/test metrics: DCT power spectra (PSD-K, PSD-Var) and
anomaly correlation (ACC).

The JAX package's functional accumulators in PyTorch:
``init_state() → {name: tensor}`` on the metric's device,
``update(state, preds, targets, mask) → state`` runs on that device and
never waits for it (no ``.item()``, no ``.cpu()``), and
``compute(state, prefix)`` brings the state to the host and renders
scalars (and, with matplotlib, figures).

The 2-D DCT is an orthonormal DCT-II taken as two matrix products,
``C_H · X · C_Wᵀ``, with the matrices built in float64 and cast to fp32
once per (n, device), run with TF32 off (``utils.exact_fp32``: TF32
keeps about three digits, which would cut the spectra). The radial
binning gathers each bin's points through constant index tables, padded
to the fullest bin, and sums each row in one reduction: the same bits on
every call, where a float ``index_add_`` on the card adds in a varying
order.
"""

from __future__ import annotations

import functools
import warnings
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from py4cast_tpu_torch.utils import exact_fp32, resolve_device, to_host

#: added to a spectrum before its log10 (PSD-Var), as in the JAX package
LOG_EPS = 1e-12


# --------------------------------------------------------------- DCT helpers
@functools.lru_cache(maxsize=32)
def _dct_matrix(n: int, device: torch.device) -> torch.Tensor:
    """The orthonormal DCT-II matrix C (n, n), y = C · x: built in
    float64, stored fp32 on ``device``."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return torch.from_numpy(c.astype(np.float32)).to(device)


@exact_fp32
def dct_2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal type-II DCT over the last two dims."""
    ch = _dct_matrix(x.shape[-2], x.device)
    cw = _dct_matrix(x.shape[-1], x.device)
    return torch.matmul(torch.matmul(ch, x), cw.T)


def dct_var(x: torch.Tensor) -> torch.Tensor:
    """Variance spectrum: fx**2 / n**2."""
    n = x.shape[-1]
    fx = dct_2d(x)
    return fx**2 / (n**2)


def _radial_bin_constants(shape: Tuple[int, int]):
    """The reference's 'double binning': each point of radius r adds the
    flattened spectrum at 2r, and half of it at 2r ± 1, to bin r; radii
    at or past rmax go to an overflow bin that is dropped."""
    h, w = shape
    y, x = np.indices((h, w))
    cx, cy = h // 2, w // 2
    r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2).astype(int)
    rmax = min(x.max(), y.max(), r.max()) // 2
    rr = r.ravel()
    n = h * w
    idx0 = np.clip(2 * rr, 0, n - 1)
    idxm = np.clip(2 * rr - 1, 0, n - 1)
    idxp = np.clip(2 * rr + 1, 0, n - 1)
    valid = rr < rmax
    seg = np.where(valid, rr, rmax)  # invalid points to an overflow bin
    counts = np.bincount(rr[valid], minlength=rmax).astype(np.float32)
    return idx0, idxm, idxp, seg, counts, rmax


@functools.lru_cache(maxsize=32)
def _radial_tables(shape: Tuple[int, int], device: torch.device):
    """(idx0, idxm, idxp) as (rmax, fullest bin) index tables on
    ``device``, row r holding bin r's points in raster order and padded
    with n (a zero appended to the flat spectrum), and the bin counts
    (at least 1) as fp32."""
    idx0, idxm, idxp, seg, counts, rmax = _radial_bin_constants(shape)
    n = shape[0] * shape[1]
    order = np.argsort(seg, kind="stable")  # bin by bin, raster order within one
    starts = np.searchsorted(seg[order], np.arange(rmax))
    sizes = counts.astype(np.int64)
    slot = np.arange(max(1, int(sizes.max(initial=0))))[None, :]
    inside = slot < sizes[:, None]
    pos = np.where(inside, starts[:, None] + slot, 0)
    tables = []
    for idx in (idx0, idxm, idxp):
        t = np.where(inside, idx[order][pos], n)
        tables.append(torch.from_numpy(t.astype(np.int64)).to(device))
    denom = torch.from_numpy(np.maximum(counts, 1.0)).to(device)
    return (*tables, denom)


def radial_bin_dct(dct_sig: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Radially-averaged spectrum, (..., H, W) → (..., Rmax)."""
    t0, tm, tp, denom = _radial_tables(tuple(shape), dct_sig.device)
    flat = dct_sig.reshape(*dct_sig.shape[:-2], -1)
    ext = torch.cat([flat, flat.new_zeros(*flat.shape[:-1], 1)], dim=-1)
    val = ext[..., t0] + 0.5 * ext[..., tm] + 0.5 * ext[..., tp]  # (..., Rmax, width)
    return val.sum(dim=-1) / denom


def power_spectral_density(x: torch.Tensor) -> torch.Tensor:
    """Radially-averaged, batch-averaged PSD; (B, C, H, W) → (C, Rmax)."""
    sig = dct_var(x).mean(dim=0)  # (C, H, W)
    return radial_bin_dct(sig, tuple(x.shape[-2:]))


def psd_rmax(shape: Tuple[int, int]) -> int:
    return int(_radial_bin_constants(shape)[5])


def _to_bchw(arr: torch.Tensor, pred_step: int, grid_shape) -> torch.Tensor:
    """(B, T, *spatial, F) at pred_step → (B, F, H, W); unflattens the
    ngrid dim of GRAPH models."""
    x = arr[:, pred_step]
    if x.ndim == 3:  # (B, ngrid, F)
        x = x.reshape(x.shape[0], grid_shape[0], grid_shape[1], x.shape[-1])
    return x.movedim(-1, 1)


# ------------------------------------------------------------------ metrics
class MetricPSDK:
    """Epoch-averaged radial PSD of prediction and target at one pred
    step; ``compute`` draws one log-log figure a feature (matplotlib)."""

    def __init__(
        self,
        save_path: Path,
        feature_names: Tuple[str, ...],
        grid_shape: Tuple[int, int],
        pred_step: int = 0,
        device="cuda",
    ):
        self.save_path = Path(save_path)
        self.feature_names = tuple(feature_names)
        self.grid_shape = tuple(grid_shape)
        self.pred_step = pred_step
        self.device = resolve_device(device)
        self.rmax = psd_rmax(self.grid_shape)

    def init_state(self):
        c = len(self.feature_names)
        z = functools.partial(torch.zeros, device=self.device)
        return {
            "sum_psd_pred": z((c, self.rmax)),
            "sum_psd_target": z((c, self.rmax)),
            "step_count": z(()),
        }

    def update(self, state, preds, targets, mask):
        p = _to_bchw(preds * mask, self.pred_step, self.grid_shape)
        t = _to_bchw(targets * mask, self.pred_step, self.grid_shape)
        return {
            "sum_psd_pred": state["sum_psd_pred"] + power_spectral_density(p),
            "sum_psd_target": state["sum_psd_target"] + power_spectral_density(t),
            "step_count": state["step_count"] + 1.0,
        }

    def compute(self, state, prefix: str = "val") -> Dict[str, object]:
        """{f"{prefix}_mean_psd_k/{name}": figure}, each also saved as a
        PNG under ``save_path``; empty without matplotlib."""
        from py4cast_tpu_torch.plots import can_draw, plot_log_psd

        if not can_draw():
            return {}
        mean_pred = to_host(state["sum_psd_pred"] / state["step_count"])
        mean_target = to_host(state["sum_psd_target"] / state["step_count"])
        rmax = mean_pred.shape[1]
        k = np.linspace(2 * np.pi / 2.6, rmax * 2 * np.pi / 2.6, rmax)
        out = {}
        for c, name in enumerate(self.feature_names):
            fig = plot_log_psd(
                k,
                mean_pred[c],
                mean_target[c],
                f"PSD for {name} at +{self.pred_step + 1}",
            )
            out[f"{prefix}_mean_psd_k/{name}"] = fig
            dest = self.save_path / f"{prefix}_mean_psd_k" / f"{name}_{self.pred_step + 1}.png"
            dest.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(dest)
        return out


class MetricPSDVar:
    """Epoch-mean RMSE between the log10 PSDs of prediction and target."""

    def __init__(
        self,
        feature_names: Tuple[str, ...],
        grid_shape: Tuple[int, int],
        pred_step: int = 0,
        device="cuda",
    ):
        self.feature_names = tuple(feature_names)
        self.grid_shape = tuple(grid_shape)
        self.pred_step = pred_step
        self.device = resolve_device(device)

    def init_state(self):
        return {
            "sum_rmse": torch.zeros((len(self.feature_names),), device=self.device),
            "step_count": torch.zeros((), device=self.device),
        }

    def update(self, state, preds, targets, mask):
        p = _to_bchw(preds * mask, self.pred_step, self.grid_shape)
        t = _to_bchw(targets * mask, self.pred_step, self.grid_shape)
        psd_p = power_spectral_density(p)
        psd_t = power_spectral_density(t)
        rmse = torch.sqrt(
            torch.mean((torch.log10(psd_t + LOG_EPS) - torch.log10(psd_p + LOG_EPS)) ** 2, dim=1)
        )
        return {
            "sum_rmse": state["sum_rmse"] + rmse,
            "step_count": state["step_count"] + 1.0,
        }

    def compute(self, state, prefix: str = "val") -> Dict[str, float]:
        mean = to_host(state["sum_rmse"] / state["step_count"])
        return {
            f"{prefix}_rmse_psd/{name}": float(mean[i])
            for i, name in enumerate(self.feature_names)
        }


class MetricACC:
    """Spatially-averaged anomaly correlation per feature and pred step,
    against scalar climate normals (the dataset's mean of each field)."""

    def __init__(self, dataset_info, num_pred_steps: int, device="cuda"):
        warnings.warn(
            "ACC uses scalar (non-spatial) climate normals — one value per "
            "field, the dataset's mean."
        )
        names = tuple(dataset_info.output_feature_names)
        self.feature_names = names
        self.num_pred_steps = num_pred_steps
        self.device = resolve_device(device)
        self.climate_means = torch.as_tensor(
            np.asarray(dataset_info.stats.to_array("mean", names), np.float32),
            device=self.device,
        )

    def init_state(self):
        return {
            "sum_acc": torch.zeros((self.num_pred_steps, len(self.feature_names)),
                                   device=self.device),
            "step_count": torch.zeros((), device=self.device),
        }

    def update(self, state, preds, targets, mask):
        sp = tuple(range(2, preds.ndim - 1))
        pa = (preds - self.climate_means) * mask
        ta = (targets - self.climate_means) * mask
        num = torch.mean(pa * ta, dim=sp)
        denom = torch.mean(pa**2, dim=sp) * torch.mean(ta**2, dim=sp)
        acc = torch.mean(num / torch.sqrt(denom + 1e-12), dim=0)  # (T, F)
        return {
            "sum_acc": state["sum_acc"] + acc,
            "step_count": state["step_count"] + 1.0,
        }

    def compute(self, state, prefix: str = "val") -> Dict[str, float]:
        mean = to_host(state["sum_acc"] / state["step_count"])
        return {
            f"{prefix}_acc/{name}_step{j}": float(mean[j, i])
            for i, name in enumerate(self.feature_names)
            for j in range(self.num_pred_steps)
        }
