"""Plotters and figure helpers (observer pattern).

Observers receive ``update(module, batch, prediction, target, mask)``
each eval step, with the port's NamedArrays over tensors on the
module's device, and ``on_step_end(module, label)`` each epoch; figures
go to the trainer's loggers (``log_figure``) and to disk. A plotter
moves to the host only what it draws, and keeps what it accumulates on
the device until the epoch ends.

matplotlib is imported by the functions that draw, never when this
module is imported: a host without it still computes every score and
writes every JSON file, and ``can_draw()`` tells the trainer to say
once that figures were not drawn. Coastlines come from cartopy when it
is importable (``Grid.projection``); plain imshow otherwise.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from py4cast_tpu_torch.utils import to_host

#: printed once by fit and test when matplotlib is missing
NO_FIGURES = (
    "figures not drawn: matplotlib is not installed (score cards, PSD plots, "
    "prediction and spatial-error maps); every score and JSON file is still written"
)


def can_draw() -> bool:
    """Whether matplotlib can be imported here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def pyplot():
    """matplotlib.pyplot on the Agg backend; raises an ImportError that
    names matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is not installed: figures and GIFs need it (pip install matplotlib)"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


@dataclass
class DomainInfo:
    """Geographic domain info used by map plots."""

    grid_limits: List[float]
    projection: object = None


# ------------------------------------------------------------ figure helpers
def plot_error_map(errors: np.ndarray, shortnames, units, title=None,
                   step_duration=1.0):
    """Score-card heatmap: per-variable error vs leadtime.
    errors: (pred_steps, d_f)."""
    plt = pyplot()
    errors_np = np.asarray(errors).T  # (d_f, pred_steps)
    d_f, pred_steps = errors_np.shape
    max_errors = np.maximum(errors_np.max(axis=1, keepdims=True), 1e-12)
    fig, ax = plt.subplots(figsize=(15, 10))
    ax.imshow(
        errors_np / max_errors, cmap="OrRd", vmin=0, vmax=1.0,
        interpolation="none", aspect="auto", alpha=0.8,
    )
    for (j, i), error in np.ndenumerate(errors_np):
        txt = f"{error:.3f}" if error < 9999 else f"{error:.2E}"
        ax.text(i, j, txt, ha="center", va="center")
    if hasattr(step_duration, "total_seconds"):
        step_duration = step_duration.total_seconds() / 3600.0
    ax.set_xticks(np.arange(pred_steps))
    ax.set_xticklabels(
        [f"{step_duration * (i + 1):g}" for i in range(pred_steps)], size=15
    )
    ax.set_xlabel("Lead time (h)", size=15)
    ax.set_yticks(np.arange(d_f))
    ax.set_yticklabels(
        [f"{n} ({u})" for n, u in zip(shortnames, units)], rotation=30, size=15
    )
    if title:
        ax.set_title(title, size=15)
    return fig


def plot_log_psd(k, psd_pred, psd_target, title: str = ""):
    """Prediction and target spectra against wavenumber, log scale."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(15, 10))
    ax.plot(k, psd_pred, label="pred")
    ax.plot(k, psd_target, label="target")
    ax.set_xlabel("k")
    ax.set_ylabel("psd_k")
    ax.legend()
    ax.set_title(title)
    ax.set_yscale("log")
    return fig


def _map_axes(fig, n: int, domain_info: Optional[DomainInfo]):
    proj = domain_info.projection if domain_info else None
    axes = fig.subplots(1, n, subplot_kw={"projection": proj} if proj else None)
    axes = np.atleast_1d(axes)
    if proj is not None:
        for ax in axes:
            try:
                ax.coastlines()
            except Exception:  # noqa: BLE001 — coastlines are decoration
                pass
    return axes


def plot_prediction(pred, target, interior_mask, domain_info: DomainInfo,
                    title=None, vrange=None):
    """Side-by-side ground truth / prediction maps, faded border.
    pred/target: (lat, lon)."""
    plt = pyplot()
    pred = np.asarray(pred)
    target = np.asarray(target)
    if vrange is None:
        vmin = min(pred.min(), target.min())
        vmax = max(pred.max(), target.max())
    else:
        vmin, vmax = float(vrange[0]), float(vrange[1])
    alpha = np.clip(np.asarray(interior_mask), 0.7, 1.0)
    fig = plt.figure(figsize=(13, 7))
    axes = _map_axes(fig, 2, domain_info)
    extent = domain_info.grid_limits if domain_info else None
    for ax, data in zip(axes, (target, pred)):
        im = ax.imshow(
            data, origin="lower", extent=extent, alpha=alpha,
            vmin=vmin, vmax=vmax, cmap="plasma",
        )
    axes[0].set_title("Ground Truth", size=15)
    axes[1].set_title("Prediction", size=15)
    fig.colorbar(im, aspect=30)
    if title:
        fig.suptitle(title, size=20)
    return fig


def plot_spatial_error(error, interior_mask, domain_info: DomainInfo,
                       title=None, vrange=None):
    """Accumulated spatial error map."""
    plt = pyplot()
    error = np.asarray(error)
    vmin, vmax = (
        (error.min(), error.max()) if vrange is None else vrange
    )
    alpha = np.clip(np.asarray(interior_mask), 0.7, 1.0)
    fig = plt.figure(figsize=(5, 4.8))
    (ax,) = _map_axes(fig, 1, domain_info)
    extent = domain_info.grid_limits if domain_info else None
    im = ax.imshow(
        error, origin="lower", extent=extent, alpha=alpha,
        vmin=vmin, vmax=vmax, cmap="OrRd",
    )
    cbar = fig.colorbar(im, aspect=30)
    cbar.formatter.set_powerlimits((-3, 3))
    if title:
        fig.suptitle(title, size=10)
    return fig


def make_gif(paths: List[Path], dest: Path):
    """Concatenate saved PNGs into a GIF."""
    from PIL import Image

    frames = [Image.open(p) for p in paths]
    frames[0].save(
        dest, format="GIF", append_images=frames[1:], save_all=True,
        duration=250, loop=0,
    )


# ------------------------------------------------------------------ plotters
class Plotter(ABC):
    """Observer: update() per eval step, on_step_end() per epoch."""

    @abstractmethod
    def update(self, module, batch, prediction, target, mask) -> None: ...

    @abstractmethod
    def on_step_end(self, module, label: str = "") -> None: ...


def _to_grid(arr: np.ndarray, grid_shape) -> np.ndarray:
    """(B, T, ngrid, F) → (B, T, lat, lon, F) for GRAPH models."""
    if arr.ndim == 4:
        b, t, _, f = arr.shape
        return arr.reshape(b, t, grid_shape[0], grid_shape[1], f)
    return arr


class MapPlot(Plotter):
    """Base for per-sample map plots: GNN reshape, de-normalization and
    the sample budget. Only the samples it plots leave the device; with
    no matplotlib, nothing does."""

    def __init__(self, num_samples_to_plot: int = 1,
                 num_features_to_plot: Optional[int] = None,
                 prefix: str = "Test", save_path: Optional[Path] = None):
        self.num_samples_to_plot = num_samples_to_plot
        self.num_features_to_plot = num_features_to_plot
        self.prefix = prefix
        self.save_path = Path(save_path) if save_path else None
        self.plotted_examples = 0
        self.draw = can_draw()

    def update(self, module, batch, prediction, target, mask) -> None:
        if self.plotted_examples >= self.num_samples_to_plot or not self.draw:
            return
        n = min(prediction.shape[0], self.num_samples_to_plot - self.plotted_examples)
        grid_shape = module.dataset_info.statics.grid_shape
        pred = _to_grid(to_host(prediction.array[:n] * mask[:n]), grid_shape)
        targ = _to_grid(to_host(target.array[:n]), grid_shape)
        std = module.dataset_info.stats.to_array("std", prediction.feature_names)
        mean = module.dataset_info.stats.to_array("mean", prediction.feature_names)
        pred = pred * std + mean
        targ = targ * std + mean

        feature_names = (
            prediction.feature_names[: self.num_features_to_plot]
            if self.num_features_to_plot
            else prediction.feature_names
        )
        for pred_slice, targ_slice in zip(pred, targ):
            self.plotted_examples += 1
            flat = targ_slice.reshape(-1, targ_slice.shape[-1])
            vranges = list(zip(flat.min(axis=0), flat.max(axis=0)))
            self.plot_map(module, pred_slice, targ_slice, feature_names, vranges)

    @abstractmethod
    def plot_map(self, module, prediction, target, feature_names, vranges): ...

    def on_step_end(self, module, label: str = "") -> None:
        pass

    def _emit(self, module, fig, fig_name: str, step: int):
        for lg in getattr(module, "_plot_loggers", []):
            lg.log_figure(fig_name, fig, step)
        if self.save_path is not None:
            dest = self.save_path / f"{fig_name}_{step}.png"
            dest.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(dest)
            return dest
        return None


class PredictionTimestepPlot(MapPlot):
    """Pred/target maps per timestep + per-variable GIF."""

    def plot_map(self, module, prediction, target, feature_names, vranges):
        plt = pyplot()
        info = module.dataset_info
        interior = np.asarray(info.statics.interior_mask)[..., 0]
        paths = defaultdict(list)
        for t_i in range(prediction.shape[0]):
            for var_i, name in enumerate(feature_names):
                fig = plot_prediction(
                    prediction[t_i, :, :, var_i],
                    target[t_i, :, :, var_i],
                    interior,
                    info.domain_info,
                    title=f"{name} ({info.units.get(name, '?')}), t={t_i + 1}",
                    vrange=vranges[var_i],
                )
                dest = self._emit(
                    module,
                    fig,
                    f"timestep_evol_per_param/{name}_example_{self.plotted_examples}",
                    t_i + 1,
                )
                if dest is not None:
                    paths[name].append(dest)
                plt.close(fig)
        for name, ps in paths.items():
            if len(ps) > 1:
                make_gif(ps, ps[0].parent / f"{name}_{self.plotted_examples}.gif")


class PredictionEpochPlot(MapPlot):
    """Pred/target maps at the final timestep, indexed by epoch."""

    def plot_map(self, module, prediction, target, feature_names, vranges):
        plt = pyplot()
        info = module.dataset_info
        interior = np.asarray(info.statics.interior_mask)[..., 0]
        t_i = prediction.shape[0] - 1
        epoch = getattr(module, "current_epoch", 0)
        for var_i, name in enumerate(feature_names):
            fig = plot_prediction(
                prediction[t_i, :, :, var_i],
                target[t_i, :, :, var_i],
                interior,
                info.domain_info,
                title=f"{name}, epoch {epoch}, t={t_i + 1}",
                vrange=vranges[var_i],
            )
            self._emit(
                module,
                fig,
                f"epoch_evol_per_param/{name}_example_{self.plotted_examples}",
                epoch,
            )
            plt.close(fig)


class StateErrorPlot(Plotter):
    """Per-variable error vs leadtime score card + JSON scores dump.
    Each batch's (B, T, F) errors stay on the device until the epoch
    ends; the JSON file is written with or without matplotlib."""

    def __init__(self, metrics: Dict[str, object], prefix: str = "Test",
                 save_path: Optional[Path] = None):
        self.metrics = metrics
        self.prefix = prefix
        self.save_path = Path(save_path) if save_path else None
        self.losses: Dict[str, list] = {m: [] for m in metrics}
        self.shortnames: list = []
        self.units: list = []
        self.initialized = False

    def update(self, module, batch, prediction, target, mask) -> None:
        for name, metric in self.metrics.items():
            self.losses[name].append(metric(prediction, target, mask).detach())
        if not self.initialized:
            self.shortnames = list(prediction.feature_names)
            self.units = [
                module.dataset_info.units.get(n, "?")
                for n in prediction.feature_names
            ]
            self.initialized = True

    def on_step_end(self, module, label: str = "") -> None:
        if not self.initialized:
            return
        draw = can_draw()
        for name in self.metrics:
            rows = to_host(torch.cat(self.losses[name], dim=0))
            loss = rows.mean(axis=0)  # (T, F)
            loss_dict = {
                self.shortnames[k]: [float(loss[t, k]) for t in range(loss.shape[0])]
                for k in range(loss.shape[1])
            }
            fig_name = f"score_cards/{self.prefix}_{name}"
            fig = None
            if draw:
                fig = plot_error_map(
                    loss, self.shortnames, self.units,
                    step_duration=module.dataset_info.pred_step,
                )
                for lg in getattr(module, "_plot_loggers", []):
                    lg.log_figure(fig_name, fig, getattr(module, "current_epoch", 0))
            if self.save_path is not None:
                if fig is not None:
                    dest = self.save_path / f"{fig_name}.png"
                    dest.parent.mkdir(parents=True, exist_ok=True)
                    fig.savefig(dest)
                self.save_path.mkdir(parents=True, exist_ok=True)
                with open(self.save_path / f"{label}_{name}_scores.json", "w") as f:
                    json.dump(loss_dict, f)
            if fig is not None:
                pyplot().close(fig)
            self.losses[name].clear()


class SpatialErrorPlot(Plotter):
    """Accumulated spatial error map over the epoch; the (B, T, *spatial)
    maps stay on the device until the epoch ends (nothing is kept
    without matplotlib, which alone uses them)."""

    def __init__(self, prefix: str = "Test", save_path: Optional[Path] = None):
        self.prefix = prefix
        self.save_path = Path(save_path) if save_path else None
        self.spatial_loss_maps: list = []
        self.draw = can_draw()

    def update(self, module, batch, prediction, target, mask) -> None:
        if not self.draw:
            return
        loss = module.loss(prediction, target, mask, reduce_spatial_dim=False).detach()
        if loss.ndim == 3:  # GRAPH: (B, T, ngrid)
            gs = module.dataset_info.statics.grid_shape
            loss = loss.reshape(loss.shape[0], loss.shape[1], gs[0], gs[1])
        self.spatial_loss_maps.append(loss)

    def on_step_end(self, module, label: str = "") -> None:
        if not self.spatial_loss_maps:
            return
        plt = pyplot()
        mean_loss = to_host(torch.cat(self.spatial_loss_maps, dim=0)).mean(axis=0)
        info = module.dataset_info
        interior = np.asarray(info.statics.interior_mask)[..., 0]
        for t_i, loss_map in enumerate(mean_loss):
            fig = plot_spatial_error(
                loss_map, interior, info.domain_info,
                title=f"{self.prefix} loss, t={t_i + 1}",
            )
            for lg in getattr(module, "_plot_loggers", []):
                lg.log_figure(f"spatial_error_{label}/{self.prefix}_loss", fig, t_i)
            if self.save_path is not None:
                dest = self.save_path / f"spatial_error_{label}" / f"t{t_i + 1}.png"
                dest.parent.mkdir(parents=True, exist_ok=True)
                fig.savefig(dest)
            plt.close(fig)
        self.spatial_loss_maps.clear()


# ----------------------------------------------------- sample-level plotting
def plot_sample_step(sample, item, step: int, save_path: Optional[Path] = None):
    """Plot every feature of one timestep of a sample's Item."""
    plt = pyplot()
    ntensor = item.inputs if step <= 0 else item.outputs
    if step <= 0:
        index = step + sample.settings.num_input_steps - 1
    else:
        index = step - 1

    feats = list(ntensor.feature_names)
    ncols = max(1, len(feats))
    fig, axs = plt.subplots(1, ncols, figsize=(5 * ncols, 4), squeeze=False)
    for j, fname in enumerate(feats):
        arr = np.asarray(ntensor[fname])[index, :, :, 0][::-1]
        vmin = vmax = None
        if sample.stats is not None and fname in sample.stats:
            vmin = sample.stats[fname].get("min")
            vmax = sample.stats[fname].get("max")
        img = axs[0, j].imshow(
            arr, vmin=vmin, vmax=vmax, extent=sample.grid.grid_limits
        )
        axs[0, j].set_title(fname)
        fig.colorbar(img, ax=axs[0, j], fraction=0.04, pad=0.04)
    plt.suptitle(
        f"Run: {sample.timestamps.datetime} - "
        f"Valid: {sample.timestamps.validity_times[step]}"
    )
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path)
        plt.close(fig)
    return fig


def sample_gif(sample, save_path: Path):
    """Animated GIF over all steps of a sample."""
    plt = pyplot()
    item = sample.load(no_standardize=True)
    n_in = sample.settings.num_input_steps
    n_pred = sample.settings.num_pred_steps
    frames = []
    for step in range(-n_in + 1, n_pred + 1):
        fig = plot_sample_step(sample, item, step)
        fig.canvas.draw()
        frame = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(frame)
        plt.close(fig)
    save_frames_as_gif(frames, save_path, duration_ms=250)


def save_frames_as_gif(frames: List[np.ndarray], save_path: Path, duration_ms=250):
    """Write RGB frames as an animated GIF using matplotlib only."""
    plt = pyplot()
    from matplotlib import animation

    fig = plt.figure(
        figsize=(frames[0].shape[1] / 100, frames[0].shape[0] / 100), dpi=100
    )
    ax = fig.add_axes([0, 0, 1, 1])
    ax.axis("off")
    im = ax.imshow(frames[0])

    def update(i):
        im.set_data(frames[i])
        return (im,)

    anim = animation.FuncAnimation(
        fig, update, frames=len(frames), interval=duration_ms, blit=True
    )
    anim.save(str(save_path), writer=animation.PillowWriter(fps=1000 / duration_ms))
    plt.close(fig)
