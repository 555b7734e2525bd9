"""Auto-regressive module and trainer: the inference part.

``AutoRegressiveModule`` owns the model, the rollout configuration and
the static device buffers (grid statics, border mask, stats vectors);
``Trainer.predict`` drives it over a dataset. Parameters travel as a
plain ``{name: tensor}`` dict (the ``state``), applied with
``torch.func.functional_call`` — the counterpart of the JAX package's
``model.apply(params, x)``: ``init_params`` draws one from a
``torch.Generator`` and ``convert.params_from_jax`` builds one from the
JAX package's variables.

Training (``fit``/``test``, losses, optimizer, checkpoints) is not
ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from py4cast_tpu_torch.datasets.base import DatasetInfo, ItemBatch
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


class AutoRegressiveModule:
    """Owns the model, the rollout configuration and the static device
    buffers for one run. ``device`` defaults to the card; with no CUDA
    device the constructor raises unless ``device="cpu"`` is asked for."""

    def __init__(self, settings: TrainingSettings, dataset_info: DatasetInfo,
                 device="cuda"):
        self.device = resolve_device(device)
        self.settings = settings
        self.dataset_info = dataset_info
        if str_to_dtype.get(settings.precision) != torch.float32:
            raise NotImplementedError(
                f"precision {settings.precision!r}: py4cast_tpu_torch runs fp32 "
                "only so far (bf16 comes with the training slice, ROADMAP.md)"
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

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._buffers = {
            "grid_statics": dev(statics.grid_statics.array),
            "border_mask": dev(statics.border_mask),
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

    # ----------------------------------------------------------------- pieces
    def _named(self, arr) -> NamedArray:
        spatial = ("ngrid",) if self.is_graph else ("lat", "lon")
        return NamedArray(
            arr, ("batch", "timestep") + spatial + ("features",), self.output_feature_names
        )

    def _batch_arrays(self, batch: ItemBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inputs, forcing) of a batch on the device; (B, T, ngrid, F)
        for GRAPH models, (B, T, lat, lon, F) otherwise."""

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
        return inputs, forcing

    def check_feature_contract(self, batch: ItemBatch):
        """The batch's feature names must match what the module was built for."""
        batch_out = tuple(batch.outputs.feature_names) if batch.outputs else ()
        if batch_out and batch_out != self.output_feature_names:
            raise ValueError(
                f"Feature-name contract mismatch: model was trained on "
                f"{self.output_feature_names}, batch provides {batch_out}"
            )

    # ------------------------------------------------------------------ steps
    def predict_step(self, state: Params, batch: ItemBatch,
                     generator: Optional[torch.Generator] = None) -> NamedArray:
        """De-normalized predictions (B, T, *spatial, F) for one batch,
        as a NamedArray over a tensor on the module's device."""
        self.check_feature_contract(batch)
        params = self._place(state)
        inputs, forcing = self._batch_arrays(batch)
        buf = self._buffers

        def model_apply(x):
            return functional_call(self.model, params, (x,))

        with torch.inference_mode():
            preds = rollout(
                model_apply, inputs, forcing, None,
                buf["grid_statics"], buf["border_mask"],
                buf["step_diff_mean"], buf["step_diff_std"],
                self.rollout_cfg, batch.num_pred_steps, generator,
            )
            preds = preds * buf["stats_std"] + buf["stats_mean"]
        return self._named(preds)


@dataclass
class TrainerConfig:
    """The `trainer:` config keys that inference reads, plus the device
    the port runs on; the training keys come with the training slice."""

    batch_size: int = 1
    num_workers: int = 2
    seed: int = 42
    device: str = "cuda"


class Trainer:
    """Host-side loop over a dataset. This slice has ``predict`` only."""

    def __init__(self, config: TrainerConfig):
        self.config = config
        self.device = resolve_device(config.device)

    def predict(self, module: AutoRegressiveModule, infer_ds, state: Params) -> List[NamedArray]:
        """De-normalized predictions for every sample of ``infer_ds``, one
        host (numpy) NamedArray per batch; the padded tail rows of the
        last batch are sliced off."""
        if module.device != self.device:
            raise ValueError(
                f"the module lives on {module.device}, the trainer runs on {self.device}"
            )
        cfg = self.config
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
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
