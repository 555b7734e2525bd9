"""Auto-regressive module and trainer.

``AutoRegressiveModule`` owns the model, the rollout configuration, the
loss and the static device buffers (grid statics, border and interior
masks, stats vectors), and runs one batch at a time: ``train_step``,
``eval_step``, ``predict_step``. ``Trainer`` drives it over datasets:
``fit`` (train, validate, ``last``/``best`` checkpoints, early stopping,
resume), ``test`` (per-timestep scores) and ``predict``. Validation and
test feed the observers: the plotters and score cards of ``plots.py``
and the PSD-K, PSD-Var and ACC metrics of ``metrics.py``, whose state
stays on the device until the epoch ends.

Under a ``torch.distributed`` process group (``parallel.mesh``) every
rank runs the same loop on its slice of each global batch: one gradient
all-reduce an optimizer step, eval rows and predictions gathered to
every rank, writes on rank 0. Under a spatial axis (``mesh.spatial`` >
1: every grid model and the lattice-path graph models) each rank also
holds one lat band of the grid (``parallel.spatial``): its statics,
masks and batch rows; the bands join inside the model, their loss
shares are summed, and predictions and eval arrays are gathered back to
the whole grid before anything on the host sees them.

Parameters travel as a plain ``{name: tensor}`` dict, applied with
``torch.func.functional_call`` — the counterpart of the JAX package's
``model.apply(params, x)``: ``init_params`` draws one from a
``torch.Generator`` and ``convert.params_from_jax`` builds one from the
JAX package's variables. Training wraps it in a ``TrainState``: the
parameters as leaf tensors, AdamW and its warmup-cosine schedule
stepped as optax steps them, and the gradient-accumulation count.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from py4cast_tpu_torch.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    CheckpointManager,
    check_format_version,
    load_manifest,
    state_file,
)
from py4cast_tpu_torch.datasets.base import DatasetInfo, ItemBatch
from py4cast_tpu_torch.export import export_forward
from py4cast_tpu_torch.losses import CombinedLoss, ScaledLoss
from py4cast_tpu_torch.metrics import MetricACC, MetricPSDK, MetricPSDVar
from py4cast_tpu_torch.models import (
    ModelType,
    build_model_from_settings,
    get_model_kls_and_settings,
)
from py4cast_tpu_torch.named_tensor import NamedArray
from py4cast_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    all_gather_rows,
    all_reduce_grads,
    barrier,
    broadcast_object,
    is_main_process,
    make_mesh,
    to_host,
)
from py4cast_tpu_torch.parallel.spatial import band_all_reduce, gather_lat, on_band
from py4cast_tpu_torch.plots import (
    NO_FIGURES,
    PredictionEpochPlot,
    PredictionTimestepPlot,
    SpatialErrorPlot,
    StateErrorPlot,
    can_draw,
    pyplot,
)
from py4cast_tpu_torch.rollout import (
    DROPOUT_STREAM,
    RolloutConfig,
    common_features_index,
    fold_seed,
    rollout,
)
from py4cast_tpu_torch.utils import compute_dtype, exact_fp32, resolve_device

Params = Dict[str, torch.Tensor]

#: flax's lecun_normal draws from a normal truncated at ±2 std, with the
#: std divided by this factor so the variance stays 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978

#: optax.adamw's defaults, which the JAX package trains with: weight decay
#: 1e-4 on every parameter (LayerNorm and biases included), eps 1e-8.
#: torch.optim.AdamW's own default decay is 1e-2.
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8


@dataclass
class TrainingSettings:
    """The `model:` config section (same keys as the JAX package)."""

    model_name: str = "HalfUNet"
    settings_init_args: Optional[dict] = None
    losses: List[dict] = field(
        default_factory=lambda: [
            {"class": "WeightedLoss", "weight": 1.0, "params": {"loss": "MSELoss"}}
        ]
    )
    training_strategy: str = "diff_ar"
    num_inter_steps: int = 1
    num_input_steps: int = 2
    num_pred_steps_train: int = 1
    num_pred_steps_val_test: int = 1
    mask_ratio: float = 0.0
    mask_on_nan: bool = False
    learning_rate: float = 1e-3
    min_learning_rate: float = 3e-7
    num_warmup_steps: int = 1000
    betas: Tuple[float, float] = (0.9, 0.95)
    precision: str = "32"
    accumulate_grad_batches: int = 1
    num_samples_to_plot: int = 1
    io_conf: Optional[str] = None
    seed: int = 42
    use_checkpointing: bool = False

    def __post_init__(self):
        # YAML 1.1 parses bare scientific notation ("1e-3") as a string
        for name in ("learning_rate", "min_learning_rate", "mask_ratio"):
            setattr(self, name, float(getattr(self, name)))
        for name in ("num_inter_steps", "num_input_steps", "num_warmup_steps",
                     "accumulate_grad_batches"):
            setattr(self, name, int(getattr(self, name)))
        self.betas = tuple(float(b) for b in self.betas)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw initial weights in place with the JAX package's initializers
    (Flax's defaults): Dense, Conv and ConvTranspose kernels lecun-normal
    (truncated, fan_in = in_features, or in_channels / groups · kh · kw
    for a conv, in_channels · kh · kw for a transposed one), biases zero,
    LayerNorm and GroupNorm scale one and bias zero, then a module's own
    leaves through its ``draw_params(generator)`` (HalfUNet's
    ``pos_embed``; EPA's ``temperature``, ``proj_k``, ``proj_v``). Draws
    on the generator's device, then copies."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                # weight (out, in), (out, in / groups, kh, kw), or (in, out,
                # kh, kw) for a transposed conv
                shape = mod.weight.shape
                fan_in = (shape[0] * math.prod(shape[2:]) if isinstance(mod, nn.ConvTranspose2d)
                          else math.prod(shape[1:]))
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
                w = torch.empty(mod.weight.shape, device=generator.device)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in model.modules():
            if hasattr(mod, "draw_params"):
                mod.draw_params(generator)


def _dropout_active(model_settings) -> bool:
    """Whether any dropout field the settings class declares in
    ``DROPOUT_FIELDS`` is nonzero. A nonzero field with "drop" in its name
    that the class does not declare raises, so that a model's dropout
    cannot silently stay off in training."""
    declared = tuple(getattr(type(model_settings), "DROPOUT_FIELDS", ()))
    if dataclasses.is_dataclass(model_settings):
        undeclared = [
            f.name for f in dataclasses.fields(model_settings)
            if "drop" in f.name and f.name not in declared
            and float(getattr(model_settings, f.name) or 0.0) > 0.0
        ]
        if undeclared:
            raise ValueError(
                f"{type(model_settings).__name__} has nonzero "
                f"dropout-like fields {undeclared} not listed in its "
                "DROPOUT_FIELDS — declare them so train-time rollouts "
                "thread an rng (otherwise the rate would be a silent "
                "no-op)."
            )
    return any(float(getattr(model_settings, f) or 0.0) > 0.0 for f in declared)


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int,
                           end: float):
    """The learning rate at optimizer step n: a linear warmup from 0 to
    ``peak`` over ``warmup_steps``, then a cosine decay to ``end`` at
    ``decay_steps`` (warmup included) — ``optax.warmup_cosine_decay_
    schedule(0, peak, warmup_steps, decay_steps, end)`` in plain Python."""
    alpha = 0.0 if peak == 0.0 else end / peak
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak * step / warmup_steps
        count = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


class TrainState:
    """What training carries from step to step.

    ``params``: leaf tensors that require grad; ``optimizer``: AdamW over
    them; ``scheduler``: a LambdaLR stepped once per optimizer step, so
    optimizer step n runs at ``schedule(n)`` as optax's count-before-
    update does; ``step``: optimizer steps taken; ``micro_step``:
    micro-batches since the last optimizer step, whose summed gradients
    wait in each parameter's ``.grad`` (the accumulation buffer).
    """

    def __init__(self, params: Params, optimizer, scheduler, accumulate: int = 1):
        self.params = params
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.accumulate = max(1, int(accumulate))
        self.step = 0
        self.micro_step = 0

    @property
    def lr(self) -> float:
        """The learning rate of the next optimizer step."""
        return float(self.optimizer.param_groups[0]["lr"])

    def state_dict(self) -> dict:
        return {
            "params": {k: v.detach().cpu() for k, v in self.params.items()},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "micro_step": self.micro_step,
            "grad_accum": {k: v.grad.detach().cpu() for k, v in self.params.items()
                           if v.grad is not None},
        }

    def load_state_dict(self, payload: dict) -> None:
        saved = payload["params"]
        if set(saved) != set(self.params):
            missing = sorted(set(self.params) - set(saved))
            unknown = sorted(set(saved) - set(self.params))
            raise ValueError(f"checkpoint params do not match: missing {missing[:5]}, "
                             f"unknown {unknown[:5]}")
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(saved[k])
                g = payload["grad_accum"].get(k)
                v.grad = None if g is None else g.to(v.device, v.dtype)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])
        self.micro_step = int(payload["micro_step"])


def _params_of(state: Union[TrainState, Params]) -> Params:
    return state.params if isinstance(state, TrainState) else state


def _zero_fill_grads(params: Params) -> None:
    """A zero gradient for every parameter the loss did not reach, so
    that AdamW still decays it (as optax.adamw does) and every rank lays
    out the same all-reduce buffer."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _global_rows(t: torch.Tensor, batch: ItemBatch, mesh: Mesh) -> np.ndarray:
    """A batch's per-sample rows on the host: gathered over the data
    ranks in global order, cut to the global batch's real samples (a
    padded tail's repeats never count)."""
    rows = to_host(t, mesh.data_group)
    return rows[: batch.num_valid or len(rows)]


class AutoRegressiveModule:
    """Owns the model, the loss, the rollout configuration and the static
    device buffers for one run. ``device`` defaults to the card; with no
    CUDA device the constructor raises unless ``device="cpu"`` is asked
    for. The steps (``loss_and_grads``, ``train_step``, ``eval_step``,
    ``predict_step``) run inside ``utils.exact_reductions``, forward and
    backward: fp32 runs are true fp32 (no TF32), bf16 products sum in fp32.

    ``settings.precision`` picks the JAX package's policy
    (``compute_dtype``): under "bf16" ("bf16-mixed", "16-mixed") each
    model call casts the fp32 master params and its input to bf16 and
    returns fp32 (``_model_apply``), inputs and forcing travel as bf16
    and targets as fp32 (``batch_arg_dtypes``), and the AR carry, the
    losses, the optimizer and the predictions stay fp32.

    ``mesh`` (default: ``make_mesh()`` over the current process group,
    one rank without one) places this process on the data axis: each
    train step all-reduces its gradients over the ranks.
    ``lat_multiple`` pads the lat dim up to a multiple of it with
    all-border rows (``Statics.pad_lat``), the layout a lat-sharded mesh
    needs: padded rows are excluded from the loss, border-forced in
    rollouts and cut off every prediction and eval array, while
    ``dataset_info``, manifests and everything the host sees keep the
    original grid.

    Under ``mesh.spatial`` S > 1 (the models with ``spatial_shardable``:
    every model of the zoo but the graph models' gather-table path, which
    raises at build as in the JAX package) the padded lat splits into S
    bands and this rank keeps its band (``mesh.band``) of the statics, the
    masks and every batch array; the graph is built on the whole padded
    grid and cut after. Each band must hold a multiple of the rows the
    model's pools, strides and windows and the loss's subsamples need
    (``ModelBase.spatial_lat_multiple`` and the losses'
    ``spatial_lat_multiple``, m their lcm): ``lat_multiple`` defaults to
    S·m under a spatial axis (1 without one), and one that leaves a band
    short of a multiple of m raises."""

    def __init__(self, settings: TrainingSettings, dataset_info: DatasetInfo,
                 device="cuda", mesh: Optional[Mesh] = None,
                 lat_multiple: Optional[int] = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.settings = settings
        self.dataset_info = dataset_info
        self.compute_dtype = compute_dtype(settings.precision)

        statics = dataset_info.statics
        ds = settings.training_strategy == "downscaling_only"
        self.num_grid_static_features = statics.grid_statics.dim_size("features")
        self.num_input_features = (
            settings.num_input_steps * dataset_info.weather_dim * int(not ds)
            + self.num_grid_static_features
            + dataset_info.forcing_dim
            + int(settings.mask_on_nan)
        )
        self.num_output_features = dataset_info.weather_dim

        kls, model_settings = get_model_kls_and_settings(
            settings.model_name, settings.settings_init_args
        )
        self.model_settings = model_settings
        self._dropout_active = _dropout_active(model_settings)
        self.is_graph = kls.model_type == ModelType.GRAPH
        if self.is_graph and settings.mask_ratio > 0:
            raise ValueError(
                f"mask_ratio={settings.mask_ratio} is unsupported for "
                f"GRAPH models ({settings.model_name}): block masking "
                "operates on the (lat, lon) grid layout. Set mask_ratio: 0."
            )

        sp = self.mesh.spatial
        self.loss = CombinedLoss(settings.losses)
        need = math.lcm(kls.spatial_lat_multiple(model_settings),
                        self.loss.spatial_lat_multiple())
        if sp > 1 and not kls.spatial_shardable:
            raise ValueError(f"spatial={sp}: {settings.model_name} does not declare "
                             f"spatial_shardable (its forward is not written for a lat "
                             f"band); use spatial=1")
        multiple = lat_multiple or (sp * need if sp > 1 else 1)
        self._lat_pad = (-statics.grid_shape[0]) % multiple if multiple > 1 else 0
        self._orig_grid_shape = tuple(statics.grid_shape)
        if self._lat_pad:
            statics = statics.pad_lat(self._lat_pad)
            print(f"Padding lat {self._orig_grid_shape[0]} -> {statics.grid_shape[0]} "
                  f"(all-border rows) to a multiple of {multiple}")

        grid_shape = statics.grid_shape
        input_shape = (grid_shape[0] * grid_shape[1],) if self.is_graph else tuple(grid_shape)
        if grid_shape[0] % sp:
            raise ValueError(f"(padded) lat {grid_shape[0]} does not split into {sp} spatial "
                             f"bands; pass a lat_multiple that {sp} divides")
        band_rows = grid_shape[0] // sp
        if sp > 1 and band_rows % need:
            raise ValueError(
                f"{settings.model_name} and its losses pool, stride, window or subsample a "
                f"lat band of {band_rows} rows "
                f"on its own, which needs a multiple of {need} rows: pass "
                f"lat_multiple={sp * need}")
        extra = {}
        if self.is_graph:
            extra["graph"] = kls.build_graph(model_settings, statics.meshgrid)
            if sp > 1:
                extra["band"] = (self.mesh.spatial_index, sp)
        self.model = build_model_from_settings(
            settings.model_name,
            self.num_input_features,
            self.num_output_features,
            model_settings,
            input_shape,
            **extra,
        ).to(self.device).eval()
        statics = statics.band(self.mesh.spatial_index, sp)

        host_statics = dataset_info.statics
        if self.is_graph:
            statics = statics.flatten_spatial()
            host_statics = host_statics.flatten_spatial()
        out_names = tuple(dataset_info.output_feature_names)
        forcing_names = tuple(dataset_info.forcing_feature_names)
        self.output_feature_names = out_names
        self.forcing_feature_names = forcing_names
        # the host-facing mask (score cards, plotters) keeps the original
        # grid; the loss inside a step reads the padded one: the same
        # interior count, as pad rows are all border
        self.interior_mask_np = np.asarray(host_statics.interior_mask, np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._buffers = {
            "grid_statics": dev(statics.grid_statics.array),
            "border_mask": dev(statics.border_mask),
            "interior_mask": dev(statics.interior_mask),
            "step_diff_mean": dev(dataset_info.diff_stats.to_array("mean", out_names)),
            "step_diff_std": dev(dataset_info.diff_stats.to_array("std", out_names)),
            "stats_mean": dev(dataset_info.stats.to_array("mean", out_names)),
            "stats_std": dev(dataset_info.stats.to_array("std", out_names)),
        }
        self.rollout_cfg = RolloutConfig(
            strategy=settings.training_strategy,
            num_inter_steps=settings.num_inter_steps,
            num_input_steps=settings.num_input_steps,
            mask_on_nan=settings.mask_on_nan,
            mask_ratio=settings.mask_ratio,
            data_ranks=(self.mesh.data_index, self.mesh.data),
            common_features_idx=common_features_index(
                out_names, forcing_names,
                strict=settings.training_strategy == "downscaling_only",
            ),
        )
        self.loss.prepare(self.interior_mask_np, dataset_info, out_names)

    # ------------------------------------------------------------------ setup
    def init_params(self, generator: torch.Generator) -> Params:
        """Draw initial weights into the model from ``generator`` and
        return them as the parameter state, with a pretrained encoder
        loaded where the model has one (``load_pretrained``: CustomUNet's
        and DeepLab's ``encoder_weights``)."""
        init_weights(self.model, generator)
        params = {k: v.detach() for k, v in self.model.named_parameters()}
        if hasattr(self.model, "load_pretrained"):
            params = self.model.load_pretrained(params)
        return params

    def _place(self, state: Params) -> Params:
        """The parameter state on this module's device, after checking
        that it names exactly the model's parameters."""
        expected = {k for k, _ in self.model.named_parameters()}
        if set(state) != expected:
            missing, unknown = sorted(expected - set(state)), sorted(set(state) - expected)
            raise ValueError(
                f"parameter state does not match {self.settings.model_name}: "
                f"missing {missing[:5]}, unknown {unknown[:5]}"
            )
        return {k: v.to(device=self.device, dtype=torch.float32) for k, v in state.items()}

    def make_optimizer(self, params: Params, num_training_steps: int):
        """(AdamW, LambdaLR) over ``params`` with the JAX package's
        warmup-cosine-min-lr schedule.

        ``num_training_steps`` counts MICRO-batches; the schedule runs in
        OPTIMIZER steps (one per ``accumulate_grad_batches`` micro-
        batches), as optax.MultiSteps ticks it."""
        s = self.settings
        k = max(1, s.accumulate_grad_batches)
        num_opt_steps = -(-num_training_steps // k)  # ceil division
        schedule = warmup_cosine_schedule(
            s.learning_rate, s.num_warmup_steps,
            max(num_opt_steps, s.num_warmup_steps + 1), s.min_learning_rate,
        )
        optimizer = torch.optim.AdamW(
            list(params.values()), lr=s.learning_rate, betas=s.betas, eps=ADAMW_EPS,
            weight_decay=ADAMW_WEIGHT_DECAY,
        )
        peak = s.learning_rate
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda n: schedule(n) / peak if peak else 0.0
        )
        return optimizer, scheduler

    def init_state(self, generator: torch.Generator, num_training_steps: int,
                   params: Optional[Params] = None) -> TrainState:
        """A fresh TrainState: ``params`` (drawn from ``generator`` when
        not given) as leaf tensors on the device, AdamW and its schedule."""
        if params is None:
            params = self.init_params(generator)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self._place(params).items()}
        optimizer, scheduler = self.make_optimizer(leaves, num_training_steps)
        return TrainState(leaves, optimizer, scheduler, self.settings.accumulate_grad_batches)

    def num_params(self, state) -> int:
        return sum(int(p.numel()) for p in _params_of(state).values())

    def summarize(self, state) -> str:
        """Per-submodule parameter table, printed at fit start."""
        groups: Dict[str, int] = {}
        for name, p in _params_of(state).items():
            top = name.split(".")[0]
            groups[top] = groups.get(top, 0) + int(p.numel())
        width = max((len(k) for k in groups), default=10) + 2
        lines = [f"{'module':<{width}}params"]
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1]):
            lines.append(f"{k:<{width}}{v:,}")
        lines.append(f"{'TOTAL':<{width}}{self.num_params(state):,}")
        return "\n".join(lines)

    def load_raw_params(self, state: TrainState, params_path) -> TrainState:
        """Copy the parameters of a port checkpoint into ``state``,
        leaving its optimizer alone."""
        payload = torch.load(state_file(params_path), map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(payload["params"][k])
        return state

    # ----------------------------------------------------------------- pieces
    def _named(self, arr) -> NamedArray:
        spatial = ("ngrid",) if self.is_graph else ("lat", "lon")
        return NamedArray(
            arr, ("batch", "timestep") + spatial + ("features",), self.output_feature_names
        )

    def batch_arg_dtypes(self) -> Tuple[torch.dtype, torch.dtype, torch.dtype]:
        """The dtypes of a batch's (inputs, forcing, outputs) on the
        device, as the JAX package's: the model's food (inputs, forcing)
        in the compute dtype, the targets in fp32 (the loss sums in
        fp32). ``downscaling_only`` keeps its forcing, and so its inputs,
        fp32: the forcing carries the coarse state the predictions add
        to."""
        food = (self.compute_dtype if self.settings.training_strategy != "downscaling_only"
                else torch.float32)
        return food, food, torch.float32

    def _pad_lat_np(self, a) -> np.ndarray:
        """Zero-pad the lat axis (2) of a host (B, T, lat, lon, F) batch
        array up to the padded grid (the pad rows are all border), and
        keep this rank's lat band of it."""
        if self._lat_pad:
            widths = [(0, 0)] * np.ndim(a)
            widths[2] = (0, self._lat_pad)
            a = np.pad(np.asarray(a, np.float32), widths)
        band = self.mesh.band
        return a if band is None else band.cut(a, 2)

    def _unpad(self, t: torch.Tensor) -> torch.Tensor:
        """The whole grid of a band's (B, T, lat, lon, F) prediction
        (``gather_lat`` over the spatial ranks), with the padded lat rows
        cut off; on a GRAPH model's (B, T, ngrid, F), whose ngrid is
        lat-major, the first lat·lon nodes are the real ones."""
        t = gather_lat(t, 2, self.mesh.band)
        if not self._lat_pad:
            return t
        lat, lon = self._orig_grid_shape
        return t[:, :, : lat * lon] if self.is_graph else t[:, :, :lat]

    def _to_device(self, a, dtype=torch.float32) -> torch.Tensor:
        """A (B, T, lat, lon, F) batch array on the device, in ``dtype``;
        (B, T, ngrid, F) for GRAPH models. bf16 is rounded on the host,
        so that half the bytes cross to the card."""
        t = torch.as_tensor(np.asarray(a, np.float32)).to(dtype).to(self.device)
        if self.is_graph:
            t = t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1])
        return t

    def _batch_arrays(self, batch: ItemBatch, with_outputs: bool = False):
        """(inputs, forcing, outputs) of a batch on the device; (B, T,
        ngrid, F) for GRAPH models, (B, T, lat, lon, F) otherwise;
        outputs is None unless asked for; in ``batch_arg_dtypes``; the
        lat axis padded as the module pads it."""
        def dev(a, dtype):
            return self._to_device(self._pad_lat_np(a), dtype)

        in_dtype, forcing_dtype, out_dtype = self.batch_arg_dtypes()
        forcing = dev(batch.forcing.array, forcing_dtype)
        if batch.inputs is not None:
            inputs = dev(batch.inputs.array, in_dtype)
        else:
            # downscaling-only datasets may have no prognostic inputs:
            # the window is a zero placeholder with output feature width
            inputs = torch.zeros(
                (forcing.shape[0], self.settings.num_input_steps)
                + tuple(forcing.shape[2:-1]) + (self.num_output_features,),
                device=self.device, dtype=in_dtype,
            )
        outputs = dev(batch.outputs.array, out_dtype) if with_outputs else None
        return inputs, forcing, outputs

    def _model_apply(self, params: Params):
        """``apply(x, seed=None)``: the model at ``params``; with a seed,
        its dropout draws from a fresh generator seeded with it, made
        inside ``apply`` so that a recomputed forward draws the same
        masks. Under bf16 the params and x are cast to bf16 inside
        ``apply`` (differentiable casts: the fp32 masters get the
        gradients rounded where ``jax.grad`` rounds them, and a
        recomputed forward casts again instead of keeping the copies)
        and the output comes back as fp32."""
        device, dtype = self.device, self.compute_dtype

        def apply(x, seed=None):
            p = params
            if dtype != torch.float32:
                x = x.to(dtype)
                p = {k: v.to(dtype) for k, v in params.items()}
            kwargs = {}
            if seed is not None:
                kwargs["generator"] = torch.Generator(device=device).manual_seed(seed)
            return functional_call(self.model, p, (x,), kwargs).to(torch.float32)

        ms = self.model_settings
        if (self.settings.use_checkpointing or getattr(ms, "use_checkpointing", False)
                or getattr(ms, "use_checkpoint", False)):
            # recompute the forward in the backward instead of keeping
            # its activations (the JAX package's jax.checkpoint; the
            # graph models' use_checkpointing, SwinUNetR's use_checkpoint)
            from torch.utils.checkpoint import checkpoint

            return lambda x, seed=None: checkpoint(apply, x, seed, use_reentrant=False)
        return apply

    def _dropout_seed(self, state: Union[TrainState, Params]) -> Optional[int]:
        """The seed of a train step's dropout, None when no dropout rate
        is active: the run's seed folded with the dropout stream's offset
        and the micro-batch's index (``TrainState``'s optimizer and micro
        steps, 0 for bare params), so every train step draws new masks and
        a resumed run draws the ones an unbroken run would have. With
        several data ranks the data index is folded in too, so that they
        draw different masks for their different rows (topologies then
        agree in distribution, not in value), while the spatial ranks of
        one sample draw alike."""
        if not self._dropout_active:
            return None
        index = (state.step * state.accumulate + state.micro_step
                 if isinstance(state, TrainState) else 0)
        seed = fold_seed(self.settings.seed, DROPOUT_STREAM, index)
        return fold_seed(seed, self.mesh.data_index) if self.mesh.data > 1 else seed

    def _rollout(self, params: Params, inputs, forcing, outputs, num_pred_steps: int,
                 generator=None, dropout_seed: Optional[int] = None):
        buf = self._buffers
        return rollout(
            self._model_apply(params), inputs, forcing, outputs,
            buf["grid_statics"], buf["border_mask"],
            buf["step_diff_mean"], buf["step_diff_std"],
            self.rollout_cfg, num_pred_steps, generator, dropout_seed,
        )

    def _mask_and_target(self, outputs):
        """NaN mask + zero-filled target."""
        if self.settings.mask_on_nan:
            mask = (~torch.isnan(outputs)).to(torch.float32)
            return mask, torch.nan_to_num(outputs, nan=0.0)
        return torch.ones_like(outputs), outputs

    def _batch_loss(self, params: Params, inputs, forcing, outputs, num_pred_steps: int,
                    generator=None, dropout_seed: Optional[int] = None):
        """(mean loss, (preds, per-step loss)). The rollout back-propagates
        through every AR step, as the JAX package's does. On a lat band
        (call inside ``on_band``) the preds are the band's and the losses
        its shares of the global ones."""
        preds = self._rollout(params, inputs, forcing, outputs, num_pred_steps, generator,
                              dropout_seed)
        mask, target = self._mask_and_target(outputs)
        per_step = self.loss(self._named(preds), self._named(target), mask,
                             interior_mask=self._buffers["interior_mask"])
        return per_step.mean(), (preds, per_step)

    def check_feature_contract(self, batch: ItemBatch):
        """The batch's feature names must match what the module was built for."""
        batch_out = tuple(batch.outputs.feature_names) if batch.outputs else ()
        if batch_out and batch_out != self.output_feature_names:
            raise ValueError(
                f"Feature-name contract mismatch: model was trained on "
                f"{self.output_feature_names}, batch provides {batch_out}"
            )

    # ------------------------------------------------------------------ steps
    @exact_fp32
    def loss_and_grads(self, state: Union[TrainState, Params], batch: ItemBatch,
                       generator: Optional[torch.Generator] = None):
        """(loss, {name: grad}) of one batch's training loss at the
        state's parameters, leaving the state untouched; dropout, if a
        rate is active, draws the masks ``train_step`` would at this
        state. On a lat band: this band's share of each, unreduced."""
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self._place(_params_of(state)).items()}
        inputs, forcing, outputs = self._batch_arrays(batch, with_outputs=True)
        with on_band(self.mesh.band):
            loss, _ = self._batch_loss(leaves, inputs, forcing, outputs, batch.num_pred_steps,
                                       generator, self._dropout_seed(state))
            # a parameter the loss does not reach (HiLAMParallel's last
            # layers above level 0) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    @exact_fp32
    def train_step(self, state: TrainState, batch: ItemBatch,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward, backward and (every ``accumulate_grad_batches``
        micro-batches) one AdamW step on the mean of the accumulated
        gradients. Updates ``state`` in place; returns the batch loss.
        The only step with dropout (``_dropout_seed``); eval, test and
        predict are deterministic.

        Under a process group the step's gradients are all-reduced once,
        after the backward (``parallel.mesh.all_reduce_grads``: summed over
        the spatial ranks, averaged over the data ranks), so that every
        rank steps on the global mean; the returned loss is the global
        batch's: the sum of the bands' shares, averaged over the data
        ranks."""
        inputs, forcing, outputs = self._batch_arrays(batch, with_outputs=True)
        band = self.mesh.band
        with on_band(band):
            loss, _ = self._batch_loss(state.params, inputs, forcing, outputs,
                                       batch.num_pred_steps, generator,
                                       self._dropout_seed(state))
            loss.backward()  # sums into each parameter's .grad
        state.micro_step += 1
        if state.micro_step == state.accumulate:
            _zero_fill_grads(state.params)
            if self.mesh.distributed:
                all_reduce_grads(state.params, self.mesh.world_size, state.accumulate,
                                 self.mesh.spatial)
            elif state.accumulate > 1:
                for p in state.params.values():
                    p.grad.div_(state.accumulate)
            state.optimizer.step()
            state.scheduler.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.micro_step = 0
            state.step += 1
        loss = band_all_reduce(loss.detach(), band)
        if self.mesh.distributed:
            loss = all_gather_rows(loss.reshape(1), self.mesh.data_group).mean()
        return loss

    @exact_fp32
    def eval_step(self, state: Union[TrainState, Params], batch: ItemBatch,
                  generator: Optional[torch.Generator] = None):
        """(normalized preds, per-sample per-step loss (B, T)) without
        gradients; on a lat band the band's preds and the whole grid's
        losses."""
        params = self._place(_params_of(state))
        inputs, forcing, outputs = self._batch_arrays(batch, with_outputs=True)
        band = self.mesh.band
        with torch.no_grad(), on_band(band):
            _, (preds, per_step) = self._batch_loss(params, inputs, forcing, outputs,
                                                    batch.num_pred_steps, generator)
        return preds, band_all_reduce(per_step, band)

    @exact_fp32
    def predict_step(self, state: Union[TrainState, Params], batch: ItemBatch,
                     generator: Optional[torch.Generator] = None) -> NamedArray:
        """De-normalized predictions (B, T, *spatial, F) for one batch on
        the original grid, as a NamedArray over a tensor on the module's
        device."""
        self.check_feature_contract(batch)
        params = self._place(_params_of(state))
        inputs, forcing, _ = self._batch_arrays(batch)
        buf = self._buffers
        with torch.inference_mode(), on_band(self.mesh.band):
            preds = self._rollout(params, inputs, forcing, None, batch.num_pred_steps,
                                  generator)
            preds = preds * buf["stats_std"] + buf["stats_mean"]
        return self._named(self._unpad(preds))

    # ----------------------------------------------------------- aux wiring
    def named_eval_arrays(self, preds: torch.Tensor, batch: ItemBatch):
        """(pred, target, mask) for the plotters and metrics: NamedArrays
        over tensors on the device and the float mask, on the original
        grid, the batch's real rows only (a padded tail's repeated rows
        never reach an observer). Under a process group this is a
        collective: every rank gets the global batch's rows, in global
        order, on the whole grid. Alone, only the real rows' targets are
        copied."""
        preds = self._unpad(preds)
        if self.mesh.distributed:
            preds = all_gather_rows(preds, self.mesh.data_group)
            outputs = all_gather_rows(self._to_device(batch.outputs.array),
                                      self.mesh.data_group)
            nv = batch.num_valid or preds.shape[0]
        else:
            nv = batch.valid_count
            outputs = self._to_device(batch.outputs.array[:nv])
        mask, target = self._mask_and_target(outputs[:nv])
        return self._named(preds[:nv]), self._named(target), mask

    def make_scaled_loss(self, kind: str) -> ScaledLoss:
        """A prepared ScaledLoss for the score cards: "rmse" or "mae"."""
        loss = ScaledLoss("MSELoss" if kind == "rmse" else "L1Loss")
        loss.prepare(self.interior_mask_np, self.dataset_info, self.output_feature_names)
        return loss

    def make_metrics(self, save_path, num_pred_steps: int) -> dict:
        """The PSD/ACC metric set updated during validation/test, on this
        module's device."""
        grid_shape = self.dataset_info.statics.grid_shape
        # the PSD metrics score the last prediction step
        last_step = max(0, num_pred_steps - 1)
        return {
            "psd_k": MetricPSDK(save_path, self.output_feature_names, grid_shape,
                                pred_step=last_step, device=self.device),
            "psd_var": MetricPSDVar(self.output_feature_names, grid_shape,
                                    pred_step=last_step, device=self.device),
            "acc": MetricACC(self.dataset_info, num_pred_steps, device=self.device),
        }

    # --------------------------------------------------------------- manifest
    def manifest(self) -> dict:
        """Self-describing artifact metadata, with the JAX package's keys."""
        spatial = ("ngrid",) if self.is_graph else ("lat", "lon")
        info = self.dataset_info
        return {
            "framework": "py4cast_tpu_torch",
            "checkpoint_format": CHECKPOINT_FORMAT_VERSION,
            "model_name": self.settings.model_name,
            "model_settings": self.model_settings,
            "training_settings": dataclasses.asdict(self.settings),
            "dataset": info.name,
            "input_feature_names": list(self.output_feature_names),
            "output_feature_names": list(self.output_feature_names),
            "forcing_feature_names": list(self.forcing_feature_names),
            "output_dim_names": ["batch", "timestep", *spatial, "features"],
            "output_dtype": "float32",
            "stats": {n: info.stats[n] for n in self.output_feature_names},
            "diff_stats": {n: info.diff_stats[n] for n in self.output_feature_names
                           if n in info.diff_stats},
            "grid_shape": list(info.statics.grid_shape),
            "units": info.units_by_feature,
        }


def check_manifest_contract(manifest: dict, dataset_info: DatasetInfo):
    """Validate a dataset against a trained artifact's stored contract:
    feature names, grid shape and normalization stats must all match."""
    check_format_version(manifest)
    problems = []
    out_names = list(dataset_info.output_feature_names)
    if out_names != list(manifest["output_feature_names"]):
        problems.append(
            f"output features differ: trained on "
            f"{manifest['output_feature_names']}, dataset provides {out_names}"
        )
    forcing = list(dataset_info.forcing_feature_names)
    if forcing != list(manifest.get("forcing_feature_names", forcing)):
        problems.append(
            f"forcing features differ: trained on "
            f"{manifest['forcing_feature_names']}, dataset provides {forcing}"
        )
    grid = list(dataset_info.statics.grid_shape)
    if grid != list(manifest.get("grid_shape", grid)):
        problems.append(
            f"grid shape differs: trained on {manifest['grid_shape']}, "
            f"dataset provides {grid}"
        )
    drifted = []
    for name, stored in manifest.get("stats", {}).items():
        if name not in out_names:
            continue
        current = dataset_info.stats[name]
        for key in ("mean", "std"):
            if key in stored and not np.isclose(
                float(stored[key]), float(current[key]), rtol=1e-5, atol=1e-8
            ):
                drifted.append(
                    f"{name}.{key}: ckpt {float(stored[key]):.6g} vs "
                    f"dataset {float(current[key]):.6g}"
                )
    if drifted:
        problems.append("normalization stats drifted: " + "; ".join(drifted))
    if problems:
        raise ValueError(
            "Checkpoint/dataset contract mismatch — the restored model "
            "was trained under a different data contract:\n- "
            + "\n- ".join(problems)
        )


@dataclass
class TrainerConfig:
    """The `trainer:` config section (the JAX package's keys), plus the
    device the port runs on. ``mesh_data_parallel`` × ``mesh_spatial``
    is the world size of the current process group (1 without one);
    ``mesh_data_parallel`` -1 takes the ranks ``mesh_spatial`` leaves.
    The CLI builds the module's mesh from them; ``Trainer`` itself
    follows the mesh of the module it is handed."""

    max_epochs: int = 1
    batch_size: int = 1
    num_workers: int = 2
    prefetch_factor: int = 2
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    check_val_every_n_epoch: int = 1
    logging_enabled: bool = True
    plot_period: int = 1
    num_samples_to_plot: int = 1
    #: the mesh layout (parallel.mesh.MeshConfig): ranks on the data axis
    #: and on the spatial one
    mesh_data_parallel: int = -1
    mesh_spatial: int = 1
    early_stopping_patience: int = 50
    save_path: str = "runs/default"
    log_every_n_steps: int = 10
    #: None | "simple" | "jax": "jax" (the shared configs' spelling)
    #: traces the whole fit into <save_path>/profile with torch.profiler
    profiler: Optional[str] = None
    fast_dev_run: bool = False
    seed: int = 42
    device: str = "cuda"

    def __post_init__(self):
        try:
            self.mesh_config()
        except ValueError as e:
            raise ValueError(f"trainer.mesh_data_parallel={self.mesh_data_parallel}, "
                             f"trainer.mesh_spatial={self.mesh_spatial}: {e}") from None

    def mesh_config(self) -> MeshConfig:
        """The mesh layout, checked against the current process group."""
        config = MeshConfig(int(self.mesh_data_parallel), int(self.mesh_spatial))
        make_mesh(config)
        return config


class Trainer:
    """Host-side loop over datasets: fit / test / predict.

    Under a process group every rank runs the loop; rank 0 alone writes
    (the save directory, checkpoints, the loggers, figures, scores and
    the model signature) and every rank waits after each checkpoint
    write, so that a resume on any rank reads a whole file."""

    def __init__(self, config: TrainerConfig, loggers=None):
        self.config = config
        self.device = resolve_device(config.device)
        self.save_path = Path(config.save_path)
        self.is_main = is_main_process()
        self.loggers = (loggers if loggers is not None else []) if self.is_main else []
        self._said_no_figures = False

    def _check_module(self, module: AutoRegressiveModule):
        if module.device != self.device:
            raise ValueError(
                f"the module lives on {module.device}, the trainer runs on {self.device}"
            )

    @staticmethod
    def _loader(module: AutoRegressiveModule, ds, **kwargs):
        """``ds``'s loader on ``module``'s mesh: each data index loads its
        slice of every global batch, the spatial ranks of one data index
        the same samples."""
        return ds.loader(process_index=module.mesh.data_index,
                         process_count=module.mesh.data, **kwargs)

    def _log(self, tag: str, value: float, step: int):
        for lg in self.loggers:
            lg.log_scalar(tag, value, step)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _say_if_no_figures(self):
        """Print once a trainer's life that figures are not drawn, when
        matplotlib is missing."""
        if self.is_main and not self._said_no_figures and not can_draw():
            print(NO_FIGURES)
            self._said_no_figures = True

    @staticmethod
    def _observe(module, batch, preds, plotters, metrics, metric_states):
        """Feed one eval batch's real rows to the plotters and metrics
        (gathered over the ranks: every rank calls this, rank 0 alone has
        plotters and metrics)."""
        pred_na, target_na, mask = module.named_eval_arrays(preds, batch)
        for p in plotters:
            p.update(module, batch, pred_na, target_na, mask)
        for k, m in metrics.items():
            metric_states[k] = m.update(metric_states[k], pred_na.array, target_na.array, mask)

    def _computed(self, metrics, metric_states, prefix: str, step: int) -> dict:
        """The metrics' scalars ({name: float}); their figures go to the
        loggers at ``step`` and are closed."""
        scalars = {}
        for k, m in metrics.items():
            for name, val in m.compute(metric_states[k], prefix).items():
                if isinstance(val, float):
                    scalars[name] = val
                else:
                    for lg in self.loggers:
                        lg.log_figure(name, val, step)
                    pyplot().close(val)
        return scalars

    def eval_rows(self, module: AutoRegressiveModule, state, loader,
                  limit: Optional[int] = None, generator=None, observe=None) -> np.ndarray:
        """(N, T) per-step losses of every real sample in the first
        ``limit`` batches of ``loader`` (all without one), gathered over
        the ranks in global order; ``observe(batch, preds)`` sees each
        batch on every rank."""
        rows = []
        for i, batch in enumerate(loader):
            if limit and i >= limit:
                break
            preds, per_step = module.eval_step(state, batch, generator)
            rows.append(_global_rows(per_step, batch, module.mesh))
            if observe is not None:
                observe(batch, preds)
        return np.concatenate(rows, axis=0) if rows else np.zeros((0, 0), np.float32)

    def _eval_observers(self, module, prefix: str, test: bool = False):
        """(plotters, metrics, metric states) of a validation or test
        pass: rank 0's; empty on the other ranks."""
        if not self.is_main:
            return [], {}, {}
        cfg = self.config
        if test:
            plotters = [
                StateErrorPlot({"mae": module.make_scaled_loss("mae"),
                                "rmse": module.make_scaled_loss("rmse")},
                               prefix=prefix, save_path=self.save_path),
                SpatialErrorPlot(prefix=prefix, save_path=self.save_path),
                PredictionTimestepPlot(num_samples_to_plot=cfg.num_samples_to_plot,
                                       prefix=prefix, save_path=self.save_path),
            ]
        else:
            plotters = [
                StateErrorPlot({"mae": module.make_scaled_loss("mae")},
                               prefix=prefix, save_path=self.save_path),
                PredictionTimestepPlot(num_samples_to_plot=cfg.num_samples_to_plot,
                                       num_features_to_plot=4, prefix=prefix,
                                       save_path=self.save_path),
                PredictionEpochPlot(num_samples_to_plot=cfg.num_samples_to_plot,
                                    num_features_to_plot=4, prefix=prefix,
                                    save_path=self.save_path),
            ]
        metrics = module.make_metrics(self.save_path, module.settings.num_pred_steps_val_test)
        return plotters, metrics, {k: m.init_state() for k, m in metrics.items()}

    def fit(self, module: AutoRegressiveModule, train_ds, val_ds,
            ckpt_path: Optional[str] = None, params: Optional[Params] = None) -> TrainState:
        """Train for ``max_epochs``; validate every
        ``check_val_every_n_epoch`` over every real validation sample;
        save ``last`` and ``best``; stop early after
        ``early_stopping_patience`` epochs without a better val loss.
        ``ckpt_path`` resumes (parameters, AdamW, schedule, step count);
        ``params`` starts from given weights instead of drawn ones."""
        self._check_module(module)
        cfg = self.config
        if self.is_main:
            self.save_path.mkdir(parents=True, exist_ok=True)
        generator = self._generator(module.settings.seed)

        train_loader = self._loader(
            module, train_ds,
            batch_size=cfg.batch_size, num_workers=cfg.num_workers, shuffle=True,
            prefetch=cfg.prefetch_factor, seed=cfg.seed,
        )
        # score EVERY val sample: pad the tail batch and mask the padded
        # rows (val_mean_loss drives checkpoint selection and early stop)
        val_loader = self._loader(
            module, val_ds,
            batch_size=cfg.batch_size, num_workers=cfg.num_workers,
            drop_last=False, pad_last=True,
        )
        steps_per_epoch = len(train_loader)
        if cfg.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        num_training_steps = max(1, steps_per_epoch * max_epochs)

        state = module.init_state(generator, num_training_steps, params)
        ckpt = CheckpointManager(self.save_path / "checkpoints", module.manifest(),
                                 write=self.is_main)
        if ckpt_path:
            # param-semantics gate before the restore
            try:
                old_manifest = load_manifest(Path(ckpt_path))
            except FileNotFoundError:
                old_manifest = None
            if old_manifest is not None:
                check_format_version(old_manifest)
            state = ckpt.restore(ckpt_path, state)
            if self.is_main:
                print(f"Resumed from checkpoint {ckpt_path} at optimizer step {state.step}")

        if self.is_main:
            print(
                f"Model: {module.settings.model_name} | params: "
                f"{module.num_params(state) / 1e6:.2f}M | strategy: "
                f"{module.settings.training_strategy} | device: {self.device} | "
                f"ranks: {module.mesh.world_size}"
            )
            print(module.summarize(state))
            self._dump_run_info(module)

        profiler = self._start_profiler() if cfg.profiler == "jax" and self.is_main else None

        global_step = 0
        epochs_no_improve = 0
        for epoch in range(max_epochs):
            # ------------------------------ train
            t0 = time.perf_counter()
            losses = []
            for i, batch in enumerate(train_loader):
                if cfg.limit_train_batches and i >= cfg.limit_train_batches:
                    break
                if cfg.fast_dev_run and i >= 1:
                    break
                losses.append(module.train_step(state, batch, generator))
                global_step += 1
                if global_step % cfg.log_every_n_steps == 0:
                    self._log("train/loss", float(losses[-1]), global_step)
                    self._log("lr-AdamW", state.lr, global_step)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            dt_train = time.perf_counter() - t0
            sps = len(losses) * cfg.batch_size / max(dt_train, 1e-9)  # global batch
            self._log("mean_loss_epoch/train", train_loss, global_step)
            self._log("train/samples_per_sec", sps, global_step)

            # ------------------------------ validate
            val_loss = float("nan")
            if (epoch + 1) % cfg.check_val_every_n_epoch == 0 or cfg.fast_dev_run:
                module._plot_loggers = self.loggers
                module.current_epoch = epoch
                do_plots = (cfg.logging_enabled and not cfg.fast_dev_run
                            and epoch % cfg.plot_period == 0)
                plotters, metrics, metric_states = [], {}, {}
                observe = None
                if do_plots:
                    self._say_if_no_figures()
                    plotters, metrics, metric_states = self._eval_observers(module, "Validation")

                    def observe(batch, preds):
                        self._observe(module, batch, preds, plotters, metrics, metric_states)
                # every real val sample, the same rows on every rank
                vrows = self.eval_rows(module, state, val_loader,
                                       1 if cfg.fast_dev_run else cfg.limit_val_batches,
                                       generator, observe)
                val_loss = float(vrows.mean()) if len(vrows) else float("nan")
                self._log("val_mean_loss", val_loss, global_step)
                self._log("mean_loss_epoch/validation", val_loss, global_step)
                if do_plots and len(vrows):
                    for p in plotters:
                        p.on_step_end(module, label="Valid")
                    for name, val in self._computed(metrics, metric_states, "val",
                                                    global_step).items():
                        self._log(name, val, global_step)

            if self.is_main:
                print(
                    f"epoch {epoch + 1}/{max_epochs} "
                    f"train_loss={train_loss:.5f} val_loss={val_loss:.5f} "
                    f"({sps:.2f} samples/s)"
                )

            # ------------------------------ checkpoint + early stop
            # (the same val_loss on every rank: the same decisions)
            if not cfg.fast_dev_run:
                if module.mesh.distributed and state.micro_step:
                    # each rank holds its own partial sums: keep their mean,
                    # whose sum over the ranks is the same, so that rank 0's
                    # file resumes every rank
                    _zero_fill_grads(state.params)
                    all_reduce_grads(state.params, module.mesh.world_size)
                ckpt.save_last(state)
                improved = None if np.isnan(val_loss) else ckpt.maybe_save_best(state, val_loss)
                barrier()
                if improved is not None:
                    epochs_no_improve = 0 if improved else epochs_no_improve + 1
                    if epochs_no_improve >= cfg.early_stopping_patience:
                        if self.is_main:
                            print(f"Early stopping at epoch {epoch + 1}")
                        break
        if profiler is not None:
            profiler.stop()
            print(f"Profiler trace written to {self.save_path / 'profile'}")
        if not cfg.fast_dev_run and self.is_main:
            self._log_model(module, state)
        return state

    def _start_profiler(self) -> torch.profiler.profile:
        """A started ``torch.profiler`` trace of the fit (CPU activity,
        and the card's when the trainer runs on one), which writes a
        TensorBoard trace into <save_path>/profile when stopped: the
        counterpart of the JAX package's ``jax.profiler.start_trace``."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(self.save_path / "profile")))
        profiler.start()
        return profiler

    def _log_model(self, module: AutoRegressiveModule, state: TrainState):
        """Write the trained model's input/output signature to
        <save_path>/model/signature.json and, for a grid model, its
        forward as a ``torch.export`` program to model/forward.pt2
        (``export.export_forward``; best-effort, as the JAX package's
        StableHLO export: a failure is printed), and hand the directory
        to any logger with ``log_artifacts`` (MLflow)."""
        out_dir = self.save_path / "model"
        out_dir.mkdir(parents=True, exist_ok=True)
        steps = module.settings.num_pred_steps_val_test
        h, w = module.dataset_info.statics.grid_shape
        spatial = [h * w] if module.is_graph else [h, w]
        dims = ["batch", "timestep", *(["ngrid"] if module.is_graph else ["lat", "lon"]),
                "features"]
        signature = {
            "inputs": {
                "prev_states": {
                    "shape": [1, module.settings.num_input_steps, *spatial,
                              module.num_output_features],
                    "dtype": "float32", "dims": dims,
                    "feature_names": list(module.output_feature_names),
                },
                "forcing": {
                    "shape": [1, steps, *spatial, module.dataset_info.forcing_dim],
                    "dtype": "float32", "dims": dims,
                    "feature_names": list(module.forcing_feature_names),
                },
            },
            "outputs": {
                "prediction": {
                    "shape": [1, steps, *spatial, module.num_output_features],
                    "dtype": "float32", "dims": dims,
                    "feature_names": list(module.output_feature_names),
                    "denormalized": True,
                }
            },
            "model_name": module.settings.model_name,
            "num_params": module.num_params(state),
        }
        with open(out_dir / "signature.json", "w") as f:
            json.dump(signature, f, indent=1)
        if not module.is_graph:
            try:
                export_forward(module.model, module._place(state.params),
                               module.model.input_shape, out_dir / "forward.pt2")
            except Exception as e:  # noqa: BLE001 — export is best-effort
                print(f"torch.export export skipped: {e}")
        for lg in self.loggers:
            if hasattr(lg, "log_artifacts"):
                lg.log_artifacts(out_dir)

    def _dump_run_info(self, module: AutoRegressiveModule):
        """Write the run's summary (and the git commit when the code
        sits in a git checkout) to <save_path>/run_info.json."""
        import subprocess

        info = {"save_path": str(self.save_path), "model_name": module.settings.model_name,
                "device": str(self.device)}
        root = Path(__file__).resolve().parent.parent
        try:
            out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                 timeout=5, cwd=root)
            if out.returncode == 0:
                info["git_commit"] = out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
        with open(self.save_path / "run_info.json", "w") as f:
            json.dump(info, f, indent=1)

    def test(self, module: AutoRegressiveModule, test_ds, state) -> dict:
        """Scoring loop: the loss of every real sample at each timestep
        and their mean; with ``logging_enabled``, mae/rmse score cards
        (JSON files and, with matplotlib, figures), the spatial-error and
        prediction maps, and the PSD-Var and ACC scores. The scores are
        written to <save_path>/test_scores.json. Under a process group
        every rank scores the gathered rows and returns rank 0's scores."""
        self._check_module(module)
        cfg = self.config
        generator = self._generator(0)
        module._plot_loggers = self.loggers
        module.current_epoch = 0
        loader = self._loader(
            module, test_ds,
            batch_size=cfg.batch_size, num_workers=cfg.num_workers,
            drop_last=False, pad_last=True,
        )
        plotters, metrics, metric_states = [], {}, {}
        observe = None
        if cfg.logging_enabled:
            self._say_if_no_figures()
            plotters, metrics, metric_states = self._eval_observers(module, "Test", test=True)

            def observe(batch, preds):
                self._observe(module, batch, preds, plotters, metrics, metric_states)
        rows = self.eval_rows(module, state, loader, cfg.limit_val_batches, generator, observe)
        if not len(rows):
            return {}
        # sample-weighted mean: every real sample counts once
        mean_per_step = rows.mean(axis=0)
        scores = {f"timestep_losses/test_step_{s}": float(v) for s, v in enumerate(mean_per_step)}
        scores["test_mean_loss"] = float(np.mean(mean_per_step))
        if cfg.logging_enabled:
            for p in plotters:
                p.on_step_end(module, label="Test")
            scores.update(self._computed(metrics, metric_states, "test", 0))
        scores = broadcast_object(scores)
        if self.is_main:
            self.save_path.mkdir(parents=True, exist_ok=True)
            with open(self.save_path / "test_scores.json", "w") as f:
                json.dump(scores, f, indent=1)
        for k, v in scores.items():
            self._log(k, v, 0)
        return scores

    def predict(self, module: AutoRegressiveModule, infer_ds, state) -> List[NamedArray]:
        """De-normalized predictions for every sample of ``infer_ds``, one
        host (numpy) NamedArray per batch, gathered over the ranks (every
        rank gets every row); the padded tail rows of the last batch are
        sliced off. ``state``: a TrainState or a parameter dict."""
        self._check_module(module)
        cfg = self.config
        generator = self._generator(cfg.seed)
        loader = self._loader(
            module, infer_ds,
            batch_size=cfg.batch_size, num_workers=cfg.num_workers,
            drop_last=False, pad_last=True,
        )
        preds = []
        for batch in loader:
            p = module.predict_step(state, batch, generator)
            preds.append(NamedArray(_global_rows(p.array, batch, module.mesh), p.names,
                                    p.feature_names))
        return preds
