"""Auto-regressive rollout engine.

A Python loop over prediction steps (the JAX package's ``lax.scan``),
with the intermediary steps (``num_inter_steps``) unrolled inside each
step. The carry is the sliding window of previous states.

Strategies:
- ``scaled_ar``:   border forcing ON, next = prev + y*diff_std + diff_mean
- ``diff_ar``:     no border forcing, next = prev + y, num_inter_steps == 1
- ``downscaling_only``: prev states unused; next = coarse_forcing + y
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from py4cast_tpu_torch.parallel.spatial import current_band

TRAINING_STRATEGIES = ("scaled_ar", "diff_ar", "downscaling_only")
#: the dropout seeds' own offset, so they stay apart from any other
#: stream folded from the same keys (the JAX package's fold_in(step_rng,
#: 1009 + k) beside mask_ratio's fold_in(step_rng, k))
DROPOUT_STREAM = 1009


def fold_seed(*keys: int) -> int:
    """A 63-bit seed that depends on every one of ``keys`` (non-negative
    ints), through numpy's SeedSequence hash: the port's counterpart of
    ``jax.random.fold_in``. Pure host arithmetic, no RNG state read."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


@dataclass(frozen=True)
class RolloutConfig:
    """Static rollout configuration."""

    strategy: str = "diff_ar"
    num_inter_steps: int = 1
    num_input_steps: int = 2
    mask_on_nan: bool = False
    mask_ratio: float = 0.0
    # (this process's data index, the data ranks): the block masks are
    # drawn for the global batch and each data rank keeps its rows
    data_ranks: Tuple[int, int] = (0, 1)
    # indices of forcing features matching each output feature, used by
    # downscaling_only to rebuild the state from the predicted residual
    common_features_idx: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.strategy not in TRAINING_STRATEGIES:
            raise ValueError(
                f"Unknown strategy {self.strategy!r}; one of {TRAINING_STRATEGIES}"
            )
        if self.strategy == "diff_ar" and self.num_inter_steps != 1:
            raise ValueError("Diff AR strategy requires exactly 1 intermediary step.")

    @property
    def force_border(self) -> bool:
        return self.strategy == "scaled_ar"

    @property
    def scale_y(self) -> bool:
        return self.strategy == "scaled_ar"

    @property
    def downscaling(self) -> bool:
        return self.strategy == "downscaling_only"


def common_features_index(
    output_feature_names: Sequence[str],
    forcing_feature_names: Sequence[str],
    strict: bool = False,
) -> Tuple[int, ...]:
    """Forcing index for each output feature, matched on the name suffix
    (level + level_type). With ``strict`` (set when the strategy consumes
    the index, i.e. downscaling_only), an output feature matching zero or
    several forcings raises."""
    idx = []
    for out_name in output_feature_names:
        matches = [
            i
            for i, f_name in enumerate(forcing_feature_names)
            if out_name.split("_")[1:] == f_name.split("_")[1:]
        ]
        if strict and len(matches) != 1:
            raise ValueError(
                f"downscaling_only needs exactly ONE forcing feature whose "
                f"level/level_type suffix matches output feature "
                f"{out_name!r}; found {len(matches)}: "
                f"{[forcing_feature_names[i] for i in matches]}"
            )
        idx.extend(matches)
    return tuple(idx)


def mask_blocks(x: torch.Tensor, generator: torch.Generator, mask_ratio: float,
                data_ranks: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Masked-autoencoder-style random block masking: zeroes
    ``mask_ratio`` of the (B, H, W, F) image in square-ish blocks, one
    uniform draw per block from ``generator`` (drawn on its device).

    The draw is always the whole global batch's on the whole grid, so
    that every layout draws one process's masks from one generator: with
    ``data_ranks`` (index d, count D) the batch is D·B rows of which this
    process keeps rows d·B..(d + 1)·B, and on a lat band
    (``parallel.spatial.current_band``) the grid has S·H rows, of which
    the band keeps its own; the blocks' height comes from the whole lat."""
    b, h, w, _ = x.shape
    band = current_band()
    if band is not None:
        h *= band.count
    index, count = data_ranks
    bh = max(1, h // max(1, int(h**0.5)))
    bw = max(1, w // max(1, int(w**0.5)))
    gh, gw = -(-h // bh), -(-w // bw)
    draw = torch.rand((b * count, gh, gw, 1), generator=generator, device=generator.device)
    keep = (draw[index * b:(index + 1) * b] >= mask_ratio).to(x.device)
    keep = keep.repeat_interleave(bh, dim=1).repeat_interleave(bw, dim=2)[:, :h, :w, :]
    if band is not None:
        keep = band.cut(keep, 1)
    return x * keep


def _nan_union_mask(arrays) -> torch.Tensor:
    """(B, *spatial, 1) True where every feature of every array is finite."""
    m = None
    for a in arrays:
        bad = torch.isnan(a).any(dim=-1, keepdim=True)
        m = bad if m is None else (m | bad)
    return ~m


def build_x(
    prev_states: torch.Tensor,
    statics_forcing_t: torch.Tensor,
    cfg: RolloutConfig,
) -> torch.Tensor:
    """Assemble the model input for one step.

    prev_states: (B, n_in, *spatial, F); statics_forcing_t:
    (B, *spatial, S + Ff) — the grid statics concatenated AHEAD of the
    step's forcing slice. Returns (B, *spatial, F_in) in the order
    [prev states, statics, forcing, (valid mask)].
    """
    inputs = [prev_states[:, i] for i in range(prev_states.shape[1])]

    extra = []
    if cfg.mask_on_nan:
        valid = _nan_union_mask(inputs + [statics_forcing_t])
        inputs = [torch.nan_to_num(i, nan=0.0) for i in inputs]
        statics_forcing_t = torch.nan_to_num(statics_forcing_t, nan=0.0)
        extra.append(valid.to(prev_states.dtype))

    parts = ([] if cfg.downscaling else inputs) + [statics_forcing_t] + extra
    return torch.cat(parts, dim=-1)


def rollout(
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    inputs: torch.Tensor,
    forcing: torch.Tensor,
    outputs: Optional[torch.Tensor],
    statics: torch.Tensor,
    border_mask: torch.Tensor,
    step_diff_mean: torch.Tensor,
    step_diff_std: torch.Tensor,
    cfg: RolloutConfig,
    num_pred_steps: int,
    generator: Optional[torch.Generator] = None,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Run the full AR rollout; returns predictions (B, T, *spatial, F).

    Args:
      model_apply: x (B, *spatial, F_in) → y (B, *spatial, F). For GRAPH
        models spatial is (ngrid,), else (lat, lon).
      inputs: (B, n_in, *spatial, F) initial window.
      forcing: (B, T, *spatial, Ff).
      outputs: (B, T, *spatial, F) ground truth, or None (inference:
        no border forcing).
      statics: (*spatial, S) grid static features.
      border_mask: (*spatial, 1); interior = 1 - border.
      step_diff_mean/std: (F,) diff stats (scaled_ar only).
      num_pred_steps: number of AR steps (== forcing.shape[1]).
      generator: draws the block masks when ``cfg.mask_ratio`` > 0.
      dropout_seed: when given (train rollouts of a model with an active
        dropout rate), model_apply takes a second argument, the seed of a
        fresh generator for each (AR step t, inter-step k):
        ``fold_seed(dropout_seed, t, DROPOUT_STREAM + k)``.
    """
    inference = outputs is None
    force_border = cfg.force_border and not inference
    interior_mask = 1.0 - border_mask
    if cfg.mask_ratio != 0.0 and generator is None:
        raise ValueError("mask_ratio > 0 needs a torch.Generator for the block masks")

    # the AR state accumulates in fp32
    carry_dtype = torch.promote_types(inputs.dtype, torch.float32)
    prev_states = inputs.to(carry_dtype)

    # statics ride inside the forcing tensor: one concat before the loop
    n_statics = statics.shape[-1]
    statics_bt = statics[None, None].expand(forcing.shape[:2] + statics.shape).to(forcing.dtype)
    forcing = torch.cat([statics_bt, forcing], dim=-1)

    preds = []
    for t in range(num_pred_steps):
        forcing_t = forcing[:, t]
        border_state = None
        if force_border:
            border_state = outputs[:, t]
            if cfg.mask_on_nan:
                border_state = torch.nan_to_num(border_state, nan=0.0)

        new_state = None
        for k in range(cfg.num_inter_steps):
            x = build_x(prev_states, forcing_t, cfg)
            if cfg.mask_ratio != 0.0:
                x = mask_blocks(x, generator, cfg.mask_ratio, cfg.data_ranks)
            if dropout_seed is not None:
                y = model_apply(x, fold_seed(dropout_seed, t, DROPOUT_STREAM + k))
            else:
                y = model_apply(x)

            last_prev = prev_states[:, -1]
            if cfg.mask_on_nan:
                last_prev = torch.nan_to_num(last_prev, nan=0.0)

            if cfg.scale_y:
                predicted = last_prev + y * step_diff_std + step_diff_mean
            elif cfg.downscaling:
                # +n_statics: forcing_t carries [statics, forcing]
                coarse = forcing_t[..., [n_statics + i for i in cfg.common_features_idx]]
                if cfg.mask_on_nan:
                    coarse = torch.nan_to_num(coarse, nan=0.0)
                predicted = coarse + y
            else:
                predicted = last_prev + y

            predicted = predicted.to(prev_states.dtype)
            if force_border:
                new_state = border_mask * border_state + interior_mask * predicted
            else:
                new_state = predicted

            prev_states = torch.cat([prev_states[:, 1:], new_state[:, None]], dim=1)
        preds.append(new_state)
    return torch.stack(preds, dim=1)  # (B, T, *spatial, F)
