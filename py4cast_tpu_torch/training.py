"""Auto-regressive module and trainer.

``AutoRegressiveModule`` owns the model, the rollout configuration, the
loss and the static device buffers (grid statics, border and interior
masks, stats vectors), and runs one batch at a time: ``train_step``,
``eval_step``, ``predict_step``. ``Trainer`` drives it over datasets:
``fit`` (train, validate, ``last``/``best`` checkpoints, early stopping,
resume), ``test`` (per-timestep scores) and ``predict``.

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
from py4cast_tpu_torch.losses import CombinedLoss
from py4cast_tpu_torch.models import (
    ModelType,
    build_model_from_settings,
    get_model_kls_and_settings,
)
from py4cast_tpu_torch.named_tensor import NamedArray
from py4cast_tpu_torch.rollout import RolloutConfig, common_features_index, rollout
from py4cast_tpu_torch.utils import resolve_device, str_to_dtype

Params = Dict[str, torch.Tensor]

#: flax's lecun_normal draws from a normal truncated at ±2 std, with the
#: std divided by this factor so the variance stays 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978

#: optax.adamw's defaults, which the JAX package trains with: weight decay
#: 1e-4 on every parameter (LayerNorm and biases included), eps 1e-8.
#: torch.optim.AdamW's own default decay is 1e-2.
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8

#: where the plotters and the PSD/ACC metrics stand
_NOT_COMPUTED = (
    "plots and PSD/ACC metrics: not computed (not yet ported to "
    "py4cast_tpu_torch, ROADMAP.md queue 1 item 9)"
)


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
    """Draw initial weights in place with the JAX package's initializers:
    Dense kernels lecun-normal (truncated), biases zero, LayerNorm scale
    one and bias zero. Draws on the generator's device, then copies."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD_CORRECTION
                w = torch.empty(mod.weight.shape, device=generator.device)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


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


class AutoRegressiveModule:
    """Owns the model, the loss, the rollout configuration and the static
    device buffers for one run. ``device`` defaults to the card; with no
    CUDA device the constructor raises unless ``device="cpu"`` is asked
    for."""

    def __init__(self, settings: TrainingSettings, dataset_info: DatasetInfo,
                 device="cuda"):
        self.device = resolve_device(device)
        self.settings = settings
        self.dataset_info = dataset_info
        if str_to_dtype.get(settings.precision) != torch.float32:
            raise NotImplementedError(
                f"precision {settings.precision!r}: py4cast_tpu_torch runs fp32 "
                "only so far (bf16 is queued in ROADMAP.md)"
            )

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
        self.is_graph = kls.model_type == ModelType.GRAPH
        if self.is_graph and settings.mask_ratio > 0:
            raise ValueError(
                f"mask_ratio={settings.mask_ratio} is unsupported for "
                f"GRAPH models ({settings.model_name}): block masking "
                "operates on the (lat, lon) grid layout. Set mask_ratio: 0."
            )

        grid_shape = statics.grid_shape
        input_shape = (grid_shape[0] * grid_shape[1],) if self.is_graph else tuple(grid_shape)
        extra = {}
        if self.is_graph:
            extra["graph"] = kls.build_graph(model_settings, statics.meshgrid)
        self.model = build_model_from_settings(
            settings.model_name,
            self.num_input_features,
            self.num_output_features,
            model_settings,
            input_shape,
            **extra,
        ).to(self.device).eval()

        if self.is_graph:
            statics = statics.flatten_spatial()
        out_names = tuple(dataset_info.output_feature_names)
        forcing_names = tuple(dataset_info.forcing_feature_names)
        self.output_feature_names = out_names
        self.forcing_feature_names = forcing_names
        self.interior_mask_np = np.asarray(statics.interior_mask, np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._buffers = {
            "grid_statics": dev(statics.grid_statics.array),
            "border_mask": dev(statics.border_mask),
            "interior_mask": dev(self.interior_mask_np),
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
            common_features_idx=common_features_index(
                out_names, forcing_names,
                strict=settings.training_strategy == "downscaling_only",
            ),
        )
        self.loss = CombinedLoss(settings.losses)
        self.loss.prepare(self.interior_mask_np, dataset_info, out_names)

    # ------------------------------------------------------------------ setup
    def init_params(self, generator: torch.Generator) -> Params:
        """Draw initial weights into the model from ``generator`` and
        return them as the parameter state."""
        init_weights(self.model, generator)
        return {k: v.detach() for k, v in self.model.named_parameters()}

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

    def _batch_arrays(self, batch: ItemBatch, with_outputs: bool = False):
        """(inputs, forcing, outputs) of a batch on the device; (B, T,
        ngrid, F) for GRAPH models, (B, T, lat, lon, F) otherwise;
        outputs is None unless asked for."""

        def dev(a):
            t = torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            if self.is_graph:
                t = t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1])
            return t

        forcing = dev(batch.forcing.array)
        if batch.inputs is not None:
            inputs = dev(batch.inputs.array)
        else:
            # downscaling-only datasets may have no prognostic inputs:
            # the window is a zero placeholder with output feature width
            inputs = torch.zeros(
                (forcing.shape[0], self.settings.num_input_steps)
                + tuple(forcing.shape[2:-1]) + (self.num_output_features,),
                device=self.device,
            )
        outputs = dev(batch.outputs.array) if with_outputs else None
        return inputs, forcing, outputs

    def _model_apply(self, params: Params):
        def apply(x):
            return functional_call(self.model, params, (x,))

        if self.settings.use_checkpointing or getattr(self.model_settings, "use_checkpointing",
                                                      False):
            # recompute the forward in the backward instead of keeping
            # its activations (the JAX package's jax.checkpoint)
            from torch.utils.checkpoint import checkpoint

            return lambda x: checkpoint(apply, x, use_reentrant=False)
        return apply

    def _rollout(self, params: Params, inputs, forcing, outputs, num_pred_steps: int,
                 generator=None):
        buf = self._buffers
        return rollout(
            self._model_apply(params), inputs, forcing, outputs,
            buf["grid_statics"], buf["border_mask"],
            buf["step_diff_mean"], buf["step_diff_std"],
            self.rollout_cfg, num_pred_steps, generator,
        )

    def _mask_and_target(self, outputs):
        """NaN mask + zero-filled target."""
        if self.settings.mask_on_nan:
            mask = (~torch.isnan(outputs)).to(torch.float32)
            return mask, torch.nan_to_num(outputs, nan=0.0)
        return torch.ones_like(outputs), outputs

    def _batch_loss(self, params: Params, inputs, forcing, outputs, num_pred_steps: int,
                    generator=None):
        """(mean loss, (preds, per-step loss)). The rollout back-propagates
        through every AR step, as the JAX package's does."""
        preds = self._rollout(params, inputs, forcing, outputs, num_pred_steps, generator)
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
    def loss_and_grads(self, state: Union[TrainState, Params], batch: ItemBatch,
                       generator: Optional[torch.Generator] = None):
        """(loss, {name: grad}) of one batch's training loss at the
        state's parameters, leaving the state untouched."""
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self._place(_params_of(state)).items()}
        inputs, forcing, outputs = self._batch_arrays(batch, with_outputs=True)
        loss, _ = self._batch_loss(leaves, inputs, forcing, outputs, batch.num_pred_steps,
                                   generator)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(self, state: TrainState, batch: ItemBatch,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward, backward and (every ``accumulate_grad_batches``
        micro-batches) one AdamW step on the mean of the accumulated
        gradients. Updates ``state`` in place; returns the batch loss."""
        inputs, forcing, outputs = self._batch_arrays(batch, with_outputs=True)
        loss, _ = self._batch_loss(state.params, inputs, forcing, outputs,
                                   batch.num_pred_steps, generator)
        loss.backward()  # sums into each parameter's .grad
        state.micro_step += 1
        if state.micro_step == state.accumulate:
            if state.accumulate > 1:
                for p in state.params.values():
                    if p.grad is not None:
                        p.grad.div_(state.accumulate)
            state.optimizer.step()
            state.scheduler.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.micro_step = 0
            state.step += 1
        return loss.detach()

    def eval_step(self, state: Union[TrainState, Params], batch: ItemBatch,
                  generator: Optional[torch.Generator] = None):
        """(normalized preds, per-sample per-step loss (B, T)) without
        gradients."""
        params = self._place(_params_of(state))
        inputs, forcing, outputs = self._batch_arrays(batch, with_outputs=True)
        with torch.no_grad():
            _, (preds, per_step) = self._batch_loss(params, inputs, forcing, outputs,
                                                    batch.num_pred_steps, generator)
        return preds, per_step

    def predict_step(self, state: Union[TrainState, Params], batch: ItemBatch,
                     generator: Optional[torch.Generator] = None) -> NamedArray:
        """De-normalized predictions (B, T, *spatial, F) for one batch,
        as a NamedArray over a tensor on the module's device."""
        self.check_feature_contract(batch)
        params = self._place(_params_of(state))
        inputs, forcing, _ = self._batch_arrays(batch)
        buf = self._buffers
        with torch.inference_mode():
            preds = self._rollout(params, inputs, forcing, None, batch.num_pred_steps,
                                  generator)
            preds = preds * buf["stats_std"] + buf["stats_mean"]
        return self._named(preds)

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
    device the port runs on."""

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
    #: device mesh layout of the JAX package; one card has none
    mesh_data_parallel: int = -1
    mesh_spatial: int = 1
    early_stopping_patience: int = 50
    save_path: str = "runs/default"
    log_every_n_steps: int = 10
    profiler: Optional[str] = None  # None | "simple"
    fast_dev_run: bool = False
    seed: int = 42
    device: str = "cuda"

    def __post_init__(self):
        one_card = {"mesh_data_parallel": -1, "mesh_spatial": 1}
        for key, default in one_card.items():
            if getattr(self, key) != default:
                raise ValueError(
                    f"trainer.{key}={getattr(self, key)}: py4cast_tpu_torch runs on "
                    "one card; data-parallel and spatial meshes are not ported yet "
                    "(ROADMAP.md, queue 1 item 12)"
                )
        if self.profiler == "jax":
            raise ValueError(
                "trainer.profiler='jax' traces with jax.profiler, which the port "
                "does not use (ROADMAP.md, queue 1 item 12); use torch.profiler "
                "around the Trainer instead"
            )


class Trainer:
    """Host-side loop over datasets: fit / test / predict."""

    def __init__(self, config: TrainerConfig, loggers=None):
        self.config = config
        self.device = resolve_device(config.device)
        self.save_path = Path(config.save_path)
        self.loggers = loggers if loggers is not None else []

    def _check_module(self, module: AutoRegressiveModule):
        if module.device != self.device:
            raise ValueError(
                f"the module lives on {module.device}, the trainer runs on {self.device}"
            )

    def _log(self, tag: str, value: float, step: int):
        for lg in self.loggers:
            lg.log_scalar(tag, value, step)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

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
        self.save_path.mkdir(parents=True, exist_ok=True)
        generator = self._generator(module.settings.seed)

        train_loader = train_ds.loader(
            batch_size=cfg.batch_size, num_workers=cfg.num_workers, shuffle=True,
            prefetch=cfg.prefetch_factor, seed=cfg.seed,
        )
        # score EVERY val sample: pad the tail batch and mask the padded
        # rows (val_mean_loss drives checkpoint selection and early stop)
        val_loader = val_ds.loader(
            batch_size=cfg.batch_size, num_workers=cfg.num_workers,
            drop_last=False, pad_last=True,
        )
        steps_per_epoch = len(train_loader)
        if cfg.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        num_training_steps = max(1, steps_per_epoch * max_epochs)

        state = module.init_state(generator, num_training_steps, params)
        ckpt = CheckpointManager(self.save_path / "checkpoints", module.manifest())
        if ckpt_path:
            # param-semantics gate before the restore
            try:
                old_manifest = load_manifest(Path(ckpt_path))
            except FileNotFoundError:
                old_manifest = None
            if old_manifest is not None:
                check_format_version(old_manifest)
            state = ckpt.restore(ckpt_path, state)
            print(f"Resumed from checkpoint {ckpt_path} at optimizer step {state.step}")

        print(
            f"Model: {module.settings.model_name} | params: "
            f"{module.num_params(state) / 1e6:.2f}M | strategy: "
            f"{module.settings.training_strategy} | device: {self.device}"
        )
        print(module.summarize(state))
        self._dump_run_info(module)

        global_step = 0
        epochs_no_improve = 0
        said_not_computed = False
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
            sps = len(losses) * cfg.batch_size / max(dt_train, 1e-9)
            self._log("mean_loss_epoch/train", train_loss, global_step)
            self._log("train/samples_per_sec", sps, global_step)

            # ------------------------------ validate
            val_loss = float("nan")
            if (epoch + 1) % cfg.check_val_every_n_epoch == 0 or cfg.fast_dev_run:
                do_plots = (cfg.logging_enabled and not cfg.fast_dev_run
                            and epoch % cfg.plot_period == 0)
                if do_plots and not said_not_computed:
                    print(_NOT_COMPUTED)
                    said_not_computed = True
                vrows = []  # per-SAMPLE (valid_count, T) loss rows
                for i, batch in enumerate(val_loader):
                    if cfg.limit_val_batches and i >= cfg.limit_val_batches:
                        break
                    if cfg.fast_dev_run and i >= 1:
                        break
                    _, per_step = module.eval_step(state, batch, generator)
                    vrows.append(per_step[: batch.valid_count].cpu().numpy())
                val_loss = float(np.concatenate(vrows, axis=0).mean()) if vrows else float("nan")
                self._log("val_mean_loss", val_loss, global_step)
                self._log("mean_loss_epoch/validation", val_loss, global_step)

            print(
                f"epoch {epoch + 1}/{max_epochs} "
                f"train_loss={train_loss:.5f} val_loss={val_loss:.5f} "
                f"({sps:.2f} samples/s)"
            )

            # ------------------------------ checkpoint + early stop
            if not cfg.fast_dev_run:
                ckpt.save_last(state)
                if not np.isnan(val_loss):
                    if ckpt.maybe_save_best(state, val_loss):
                        epochs_no_improve = 0
                    else:
                        epochs_no_improve += 1
                    if epochs_no_improve >= cfg.early_stopping_patience:
                        print(f"Early stopping at epoch {epoch + 1}")
                        break
        if not cfg.fast_dev_run:
            self._log_model(module, state)
        return state

    def _log_model(self, module: AutoRegressiveModule, state: TrainState):
        """Write the trained model's input/output signature to
        <save_path>/model/signature.json and hand the directory to any
        logger with ``log_artifacts`` (MLflow)."""
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
        """Scoring loop: the loss of every real sample at each timestep,
        their mean, written to <save_path>/test_scores.json."""
        self._check_module(module)
        cfg = self.config
        generator = self._generator(0)
        loader = test_ds.loader(
            batch_size=cfg.batch_size, num_workers=cfg.num_workers,
            drop_last=False, pad_last=True,
        )
        if cfg.logging_enabled:
            print(_NOT_COMPUTED)
        rows = []  # (valid_count, T) per batch
        for i, batch in enumerate(loader):
            if cfg.limit_val_batches and i >= cfg.limit_val_batches:
                break
            _, per_step = module.eval_step(state, batch, generator)
            rows.append(per_step[: batch.valid_count].cpu().numpy())
        if not rows:
            return {}
        # sample-weighted mean: every real sample counts once
        mean_per_step = np.concatenate(rows, axis=0).mean(axis=0)
        scores = {f"timestep_losses/test_step_{s}": float(v) for s, v in enumerate(mean_per_step)}
        scores["test_mean_loss"] = float(np.mean(mean_per_step))
        self.save_path.mkdir(parents=True, exist_ok=True)
        with open(self.save_path / "test_scores.json", "w") as f:
            json.dump(scores, f, indent=1)
        for k, v in scores.items():
            self._log(k, v, 0)
        return scores

    def predict(self, module: AutoRegressiveModule, infer_ds, state) -> List[NamedArray]:
        """De-normalized predictions for every sample of ``infer_ds``, one
        host (numpy) NamedArray per batch; the padded tail rows of the
        last batch are sliced off. ``state``: a TrainState or a
        parameter dict."""
        self._check_module(module)
        cfg = self.config
        generator = self._generator(cfg.seed)
        loader = infer_ds.loader(
            batch_size=cfg.batch_size, num_workers=cfg.num_workers,
            drop_last=False, pad_last=True,
        )
        preds = []
        for batch in loader:
            p = module.predict_step(state, batch, generator)
            arr = p.array.cpu().numpy()
            preds.append(NamedArray(arr[: batch.valid_count], p.names, p.feature_names))
        return preds
