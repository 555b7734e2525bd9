"""Loss functions over NamedArray predictions.

The JAX package's losses in PyTorch: per-feature weight vectors are
computed once at ``prepare()`` time from ``DatasetInfo``, the interior
mask rides along as a tensor, and the mask-union correction of the
denominator matches the JAX package (and the reference) so RMSE
parity holds.

Losses return per-(batch, timestep) values; ``CombinedLoss`` sums its
members with config weights.

On a lat band of a spatial mesh (called inside ``parallel.spatial.on_band``,
as model code is) a loss returns the band's share of the global loss, so that the bands' values
sum to it: ``WeightedLoss`` divides the band's sums by the global
denominators; ``ScaledLoss`` all-reduces its band sums before the square
root and returns a 1/S share of the result; ``PerceptualLossPy4Cast``
convolves each band on halo rows and divides its band's sums by the
whole grid's counts. ``spatial_lat_multiple`` is the rows a band must be
a multiple of for the loss (1 but for the perceptual loss's subsamples).
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from py4cast_tpu_torch.parallel.spatial import band_all_reduce, current_band, halo_rows


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
    #: whether ``__call__`` takes ``reduce_spatial_dim=False`` and returns
    #: a map over the grid points (the spatial error plot's)
    pointwise: bool = False

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

    def spatial_lat_multiple(self) -> int:
        """The rows a lat band must be a multiple of for this loss."""
        return 1

    def _union_denominator(self, mask: torch.Tensor) -> torch.Tensor:
        """num_interior corrected by the spatial points that are invalid
        for every batch row, timestep and feature (counted over every
        band of a lat-sharded grid)."""
        union = (mask != 0).any(dim=0).any(dim=0).any(dim=-1)  # (*spatial,)
        return self.num_interior - band_all_reduce((~union).sum())

    def _on(self, like: torch.Tensor):
        """The prepared tensors on ``like``'s device (moved once)."""
        if self.weights.device != like.device:
            self.weights = self.weights.to(like.device)
            self.interior_mask = self.interior_mask.to(like.device)


class WeightedLoss(Py4CastLoss):
    """Per-feature weighted loss, interior-masked spatial mean → (B, T).

    weight[f] = state_weight[f] / diff_std[f]^p, p = 2 for MSE else 1.
    """

    pointwise = True

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
        mean_loss = band_all_reduce((elem * im).sum(dim=sp)) / denom  # (B, T, F)
        if self.loss_name == "MSELoss":
            mean_loss = torch.sqrt(mean_loss)
        band = current_band()
        if band is not None:
            mean_loss = mean_loss / band.count  # this band's share
        return mean_loss * self.weights


#: the perceptual loss's trained features, a copy of the JAX package's file
PERCEPTUAL_FEATS = Path(__file__).parent / "data" / "perceptual_feats.npz"


class PerceptualLossPy4Cast(Py4CastLoss):
    """Feature-space perceptual loss on min-max-normalized fields → (B, T).

    Each field, de-normalized, min-max scaled to [0, 1] and masked, goes
    alone through a small single-channel conv encoder (the features folded
    into the batch: channel-iterative, mfai's multi-channel strategy):
    per scale a 3x3 SAME conv, bias and ReLU, then a [::2, ::2] subsample
    before the next. The loss sums over scales the mean squared feature
    difference of each image, averaged over the fields. The encoder's
    trained weights are ``PERCEPTUAL_FEATS`` (HWIO, layers k0, k1, ...);
    without the file, or with ``trained=False``, a fixed random pyramid
    drawn from ``np.random.default_rng(0)`` in the JAX package's order
    (32 channels a scale, std 1/sqrt(9 c), zero biases) stands in, with
    a warning when the file was asked for. The convolutions run inside
    the steps' ``utils.exact_reductions``: TF32 off.

    Each scale's mean covers every row the loss is given, a padded lat's
    border rows included, as in the JAX package. On a lat band each 3x3
    conv takes one halo row a side (zeros at the global edges), the
    subsample keeps the global even rows (bands of a multiple of
    2^(layers − 1) rows start on one at every scale), and each scale's
    mean is the band's sum over the whole grid's count: the loss is the
    band's share of the global one."""

    def __init__(self, in_channels: int = 1, num_scales: int = 3,
                 trained: bool = True, **_):
        self.in_channels = in_channels  # accepted for config parity
        self.num_scales = num_scales
        self.trained = trained
        self.kernels: List[torch.Tensor] = []  # OIHW
        self.biases: List[torch.Tensor] = []

    def _pyramid(self):
        """(kernels, biases), HWIO numpy: the trained features, or the
        fallback draws."""
        if self.trained and PERCEPTUAL_FEATS.exists():
            with np.load(PERCEPTUAL_FEATS) as z:
                layers = sorted(int(k[1:]) for k in z.files if k.startswith("k"))
                return [z[f"k{i}"] for i in layers], [z[f"b{i}"] for i in layers]
        if self.trained:
            warnings.warn(
                "perceptual_feats.npz not found — falling back to the "
                "fixed random feature pyramid")
        rng = np.random.default_rng(0)
        kernels = [
            (rng.standard_normal((3, 3, 1 if s == 0 else 32, 32)).astype(np.float32)
             / np.sqrt(9.0 * (1 if s == 0 else 32))).astype(np.float32)
            for s in range(self.num_scales)
        ]
        return kernels, [np.zeros(k.shape[-1], np.float32) for k in kernels]

    def _num_layers(self) -> int:
        """The scales ``_pyramid`` gives: the trained file's layers, or
        ``num_scales`` drawn."""
        if self.trained and PERCEPTUAL_FEATS.exists():
            with np.load(PERCEPTUAL_FEATS) as z:
                return sum(k.startswith("k") for k in z.files)
        return self.num_scales

    def spatial_lat_multiple(self) -> int:
        """Each scale but the last subsamples every other row: a band
        holds a multiple of 2^(layers − 1) rows."""
        return 2 ** (self._num_layers() - 1)

    def prepare(self, interior_mask, dataset_info, feature_names: Sequence[str]):
        kernels, biases = self._pyramid()
        self.kernels = [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
                        for k in kernels]
        self.biases = [torch.from_numpy(b) for b in biases]
        self.stats = {key: torch.tensor([dataset_info.stats[n][key] for n in feature_names],
                                        dtype=torch.float32)
                      for key in ("min", "max", "mean", "std")}

    def _on(self, like: torch.Tensor):
        if self.kernels[0].device != like.device:
            self.kernels = [w.to(like.device) for w in self.kernels]
            self.biases = [b.to(like.device) for b in self.biases]
            self.stats = {k: v.to(like.device) for k, v in self.stats.items()}

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        st = self.stats
        raw = x * st["std"] + st["mean"]
        return ((raw - st["min"]) / (st["max"] - st["min"] + 1e-8)).clamp(0.0, 1.0)

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (N, 1, H, W) → the feature map of each scale, NCHW; on a lat
        band each conv reads one halo row a side."""
        feats = []
        h = x
        band = current_band()
        for w, b in zip(self.kernels, self.biases):
            if band is None:
                h = F.conv2d(h, w, b, padding=1)
            else:
                rows = halo_rows(h.permute(0, 2, 3, 1), 1, 1, band).permute(0, 3, 1, 2)
                h = F.conv2d(rows, w, b, padding=(0, 1))
            h = F.relu(h)
            feats.append(h)
            h = h[:, :, ::2, ::2]  # stride-2 subsample between scales
        return feats

    def __call__(self, prediction, target, mask, interior_mask=None):
        # the features see the whole field; interior_mask is accepted for
        # CombinedLoss's sake
        self._on(prediction.array)
        pred = self._normalize(prediction.array) * mask
        tgt = self._normalize(target.array) * mask
        if pred.ndim != 5:
            raise ValueError(
                f"PerceptualLossPy4Cast needs (batch, timestep, lat, lon, features) "
                f"fields, got shape {tuple(pred.shape)}")
        b, t, hh, ww, f = pred.shape
        band = current_band()
        need = 2 ** (len(self.kernels) - 1)
        if band is not None and hh % need:
            raise ValueError(
                f"PerceptualLossPy4Cast subsamples a lat band of {hh} rows "
                f"{len(self.kernels) - 1} times, which needs a multiple of {need} rows")

        def fold(a):  # (B, T, H, W, F) -> (B·T·F, 1, H, W)
            return a.permute(0, 1, 4, 2, 3).reshape(b * t * f, 1, hh, ww)

        loss = 0.0
        for fp, ft in zip(self._features(fold(pred)), self._features(fold(tgt))):
            per_img = ((fp - ft) ** 2).mean(dim=(1, 2, 3))
            if band is not None:  # the band's sum over the whole grid's count
                per_img = per_img / band.count
            loss = loss + per_img.reshape(b, t, f).mean(dim=-1)
        return loss


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

    def spatial_lat_multiple(self) -> int:
        return math.lcm(1, *(loss.spatial_lat_multiple() for loss, _ in self.losses))

    def __call__(self, prediction, target, mask, **kwargs):
        """The weighted sum of the members. With ``reduce_spatial_dim``
        False (the spatial error plot's map) only the ``pointwise``
        members are summed: a perceptual loss has no value a grid point
        (the JAX package raises a TypeError there)."""
        members = self.losses
        if kwargs.get("reduce_spatial_dim", True) is False:
            members = [(loss, w) for loss, w in self.losses if loss.pointwise]
            if not members:
                raise ValueError("no member of this CombinedLoss maps its loss over the grid")
        total = None
        for loss, weight in members:
            val = weight * loss(prediction, target, mask, **kwargs)
            total = val if total is None else total + val
        return total
