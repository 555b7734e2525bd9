"""Model-layer contract: model types, settings machinery, base module.

Models are ``torch.nn.Module``s built from the four logical arguments
``(num_input_features, num_output_features, input_shape, settings)``.
Everything is features-last, as in the JAX package, so both packages
exchange tensors without transposes.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ModelType(Enum):
    CONVOLUTIONAL = "convolutional"
    VISION_TRANSFORMER = "vision_transformer"
    GRAPH = "graph"


def settings_from_dict(settings_kls, d: Optional[dict]):
    """Instantiate a settings dataclass from a dict, rejecting unknown keys."""
    d = d or {}
    known = {f.name for f in dataclasses.fields(settings_kls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"Unknown settings for {settings_kls.__name__}: {sorted(unknown)}; "
            f"accepted: {sorted(known)}"
        )
    coerced = {}
    for f in dataclasses.fields(settings_kls):
        if f.name in d:
            v = d[f.name]
            if isinstance(v, list):
                v = tuple(v)
            coerced[f.name] = v
    return settings_kls(**coerced)


class ModelBase(nn.Module):
    """Base class for the port's models.

    Subclasses set the class attributes below and implement ``forward``
    on a features-last tensor:
    - CONVOLUTIONAL / VISION_TRANSFORMER: (B, lat, lon, num_input_features)
    - GRAPH: (B, ngrid, num_input_features)
    and return the same layout with ``num_output_features`` channels.
    """

    settings_kls = None
    model_type: ModelType = ModelType.CONVOLUTIONAL
    supported_num_spatial_dims: Tuple[int, ...] = (2,)

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings):
        super().__init__()
        self.num_input_features = num_input_features
        self.num_output_features = num_output_features
        self.input_shape = tuple(input_shape)
        self.settings = settings


def pad_to_multiple(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad the two spatial dims of NHWC ``x`` at their ends up to a
    multiple. Returns the padded tensor and the original (H, W) for
    ``crop_to``."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x, (h, w)


def crop_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    return x[:, : hw[0], : hw[1], :]


def flax_same_pad(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis of length ``n`` under
    Flax's ``padding="SAME"``: the output has ceil(n / stride) positions,
    and the total pad goes half to the start (rounded down), the rest to
    the end. With stride > 1 that is asymmetric, unlike torch's
    ``padding=k // 2`` (k5/s4 on 64 pads (0, 1))."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class FlaxConv2d(nn.Conv2d):
    """A Flax ``nn.Conv`` (``padding="SAME"``, the Flax default) on an NHWC
    tensor: the input is padded as Flax pads it (``flax_same_pad``), then
    convolved in NCHW and returned NHWC. The weight is torch's OIHW;
    ``convert.params_from_jax`` maps Flax's HWIO kernel onto it."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = flax_same_pad(x.shape[1], kh, sh)
        left, right = flax_same_pad(x.shape[2], kw, sw)
        y = x.permute(0, 3, 1, 2)
        if top or bottom or left or right:
            y = F.pad(y, (left, right, top, bottom))
        return super().forward(y).permute(0, 2, 3, 1)
