"""Loss functions over NamedArray predictions.

The JAX package's losses in PyTorch: per-feature weight vectors are
computed once at ``prepare()`` time from ``DatasetInfo``, the interior
mask rides along as a tensor, and the mask-union correction of the
denominator matches the JAX package (and the reference) so RMSE
parity holds.

Losses return per-(batch, timestep) values; ``CombinedLoss`` sums its
members with config weights.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _huber(a, b):
    d = (a - b).abs()
    return torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)


#: elementwise losses by their torch-style config names
ELEMENTWISE: dict = {
    "MSELoss": lambda a, b: (a - b) ** 2,
    "L1Loss": lambda a, b: (a - b).abs(),
    "HuberLoss": _huber,
    "SmoothL1Loss": _huber,
}


def _spatial_axes(ndim: int) -> Tuple[int, ...]:
    """Spatial axes of a (B, T, *spatial, F) array."""
    return tuple(range(2, ndim - 1))


class Py4CastLoss:
    """Base: resolves the elementwise loss by name."""

    #: shape of __call__'s return — "bt" for (B, T), "btf" for (B, T, F).
    #: CombinedLoss can only sum members with the SAME output shape.
    output_shape: str = "bt"

    def __init__(self, loss: str = "MSELoss", reduction: str = "none", **_):
        if loss not in ELEMENTWISE:
            raise NameError(f"Loss: {loss} is not defined; known: {list(ELEMENTWISE)}")
        self.loss_name = loss
        self.elementwise: Callable = ELEMENTWISE[loss]
        self.interior_mask: Optional[torch.Tensor] = None
        self.num_interior: float = 0.0
        self.weights: Optional[torch.Tensor] = None

    def prepare(self, interior_mask, dataset_info, feature_names: Sequence[str]):
        raise NotImplementedError

    def __call__(self, prediction, target, mask) -> torch.Tensor:
        raise NotImplementedError

    def _union_denominator(self, mask: torch.Tensor) -> torch.Tensor:
        """num_interior corrected by the spatial points that are invalid
        for every batch row, timestep and feature."""
        union = (mask != 0).any(dim=0).any(dim=0).any(dim=-1)  # (*spatial,)
        return self.num_interior - (~union).sum()

    def _on(self, like: torch.Tensor):
        """The prepared tensors on ``like``'s device (moved once)."""
        if self.weights.device != like.device:
            self.weights = self.weights.to(like.device)
            self.interior_mask = self.interior_mask.to(like.device)


class WeightedLoss(Py4CastLoss):
    """Per-feature weighted loss, interior-masked spatial mean → (B, T).

    weight[f] = state_weight[f] / diff_std[f]^p, p = 2 for MSE else 1.
    """

    def prepare(self, interior_mask, dataset_info, feature_names: Sequence[str]):
        p = 2.0 if self.loss_name == "MSELoss" else 1.0
        w = np.asarray(
            [dataset_info.state_weights[n] / (dataset_info.diff_stats[n]["std"] ** p)
             for n in feature_names],
            np.float32,
        )
        self.weights = torch.from_numpy(w)
        self.interior_mask = torch.from_numpy(
            np.asarray(interior_mask, np.float32)
        ).squeeze(-1)  # (*spatial,)
        self.num_interior = float(np.sum(np.asarray(interior_mask)))

    def __call__(self, prediction, target, mask, reduce_spatial_dim: bool = True,
                 interior_mask=None):
        pred, tgt = prediction.array, target.array
        self._on(pred)
        elem = self.elementwise(pred * mask, tgt * mask)
        weighted = (elem * self.weights).sum(dim=-1)  # (B, T, *spatial)
        if not reduce_spatial_dim:
            return weighted
        denom = self._union_denominator(mask)
        sp = tuple(range(2, weighted.ndim))
        # interior_mask (*spatial, 1) passed by the module (its device
        # buffer); the prepared copy serves other callers
        im = interior_mask.squeeze(-1) if interior_mask is not None else self.interior_mask
        return (weighted * im).sum(dim=sp) / denom


class ScaledLoss(Py4CastLoss):
    """Per-feature std-rescaled loss → (B, T, F); sqrt for MSE (→RMSE)."""

    output_shape = "btf"

    def prepare(self, interior_mask, dataset_info, feature_names: Sequence[str]):
        w = np.asarray([dataset_info.stats[n]["std"] for n in feature_names], np.float32)
        self.weights = torch.from_numpy(w)
        self.interior_mask = torch.from_numpy(np.asarray(interior_mask, np.float32))
        self.num_interior = float(np.sum(np.asarray(interior_mask)))

    def __call__(self, prediction, target, mask, interior_mask=None):
        pred, tgt = prediction.array, target.array
        self._on(pred)
        elem = self.elementwise(pred * mask, tgt * mask)  # (B, T, *sp, F)
        denom = self._union_denominator(mask)
        sp = _spatial_axes(elem.ndim)
        im = interior_mask if interior_mask is not None else self.interior_mask
        mean_loss = (elem * im).sum(dim=sp) / denom  # (B, T, F)
        if self.loss_name == "MSELoss":
            mean_loss = torch.sqrt(mean_loss)
        return mean_loss * self.weights


class PerceptualLossPy4Cast(Py4CastLoss):
    """The JAX package's feature-space perceptual loss. Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PerceptualLossPy4Cast is not yet ported to py4cast_tpu_torch "
            "(ROADMAP.md, queue 1 item 6); use WeightedLoss or ScaledLoss"
        )


LOSS_CLASSES = {
    "WeightedLoss": WeightedLoss,
    "ScaledLoss": ScaledLoss,
    "PerceptualLossPy4Cast": PerceptualLossPy4Cast,
}


class CombinedLoss(Py4CastLoss):
    """Weighted sum of losses from a config list of
    {class, weight, params} dicts."""

    def __init__(self, losses_config: List[dict]):
        self.losses = []
        for conf in losses_config:
            kls = LOSS_CLASSES[conf["class"]]
            weight = conf.get("weight", 1.0)
            kwargs = conf.get("params", {})
            self.losses.append((kls(**kwargs), weight))
        # members must agree on output shape — (B,T) + (B,T,F) would fail
        # to broadcast at train time; reject at config time instead
        shapes = {type(l).__name__: l.output_shape for l, _ in self.losses}
        if len(set(shapes.values())) > 1:
            raise ValueError(
                f"CombinedLoss members return incompatible shapes and "
                f"cannot be summed: {shapes} — combine only losses with "
                f"matching output shape ('bt': WeightedLoss/Perceptual, "
                f"'btf': ScaledLoss)"
            )

    def prepare(self, interior_mask, dataset_info, feature_names: Sequence[str]):
        for loss, _ in self.losses:
            loss.prepare(interior_mask, dataset_info, feature_names)

    def __call__(self, prediction, target, mask, **kwargs):
        total = None
        for loss, weight in self.losses:
            val = weight * loss(prediction, target, mask, **kwargs)
            total = val if total is None else total + val
        return total
