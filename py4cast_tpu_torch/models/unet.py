"""The UNet family of the JAX package's ``models/unet.py``, NHWC: UNet
and HalfUNet with their ConvBlock and GhostBlock, the nearest
upsampling, and the bilinear resize that Segformer's and UNetRPP's
decoders share. CustomUNet is not ported yet (ROADMAP.md, queue 1 item
10).

Submodules carry Flax's auto names (``ConvBlock_0/Conv_1``,
``GhostBlock_2/GroupNorm_3``, ``ConvTranspose_0``, ``Conv_0``, the
top-level ``pos_embed``), so ``convert.params_from_jax`` maps the JAX
variables one to one. No hand kernel runs here: cuDNN runs the
convolutions (TF32 off inside every step, ``utils.exact_fp32``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.models.base import (
    FlaxConv2d,
    FlaxConvTranspose2d,
    ModelBase,
    ModelType,
    _gn,
    crop_to,
    flax_trunc_normal_,
    get_activation,
    pad_to_multiple,
)
from py4cast_tpu_torch.ops.pool import max_pool_2x2


class ConvBlock(nn.Module):
    """(conv3x3 → GroupNorm → ReLU) × 2."""

    def __init__(self, in_channels: int, features: int, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        for i in range(2):
            self.add_module(f"Conv_{i}", FlaxConv2d(
                in_channels if i == 0 else features, features, 3, bias=use_bias,
                dilation=dilation))
            self.add_module(f"GroupNorm_{i}", _gn(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return x


class GhostBlock(nn.Module):
    """Ghost module, twice: a primary conv makes half the channels, a
    cheap depthwise-grouped 3x3 conv (undilated, ``groups=half``) derives
    the other half from them (GhostNet, Han et al. 2020)."""

    def __init__(self, in_channels: int, features: int, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        half = features // 2
        for i in range(2):
            self.add_module(f"Conv_{2 * i}", FlaxConv2d(
                in_channels if i == 0 else features, half, 3, bias=use_bias,
                dilation=dilation))
            self.add_module(f"GroupNorm_{2 * i}", _gn(half))
            self.add_module(f"Conv_{2 * i + 1}", FlaxConv2d(
                half, features - half, 3, groups=half, bias=use_bias))
            self.add_module(f"GroupNorm_{2 * i + 1}", _gn(features - half))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            primary = F.relu(getattr(self, f"GroupNorm_{2 * i}")(
                getattr(self, f"Conv_{2 * i}")(x)))
            cheap = F.relu(getattr(self, f"GroupNorm_{2 * i + 1}")(
                getattr(self, f"Conv_{2 * i + 1}")(primary)))
            x = torch.cat([primary, cheap], dim=-1)
        return x


def _upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour spatial upsampling of NHWC ``x``."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def _bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to (h, w), as
    ``jax.image.resize(method="bilinear")`` upsamples (half-pixel
    centres, edges clamped). Shrinking raises: jax antialiases when it
    downsizes and ``F.interpolate`` does not, and no ported model
    shrinks."""
    if h < x.shape[1] or w < x.shape[2]:
        raise ValueError(
            f"_bilinear_resize only upsamples: {tuple(x.shape[1:3])} -> {(h, w)} would "
            "need jax's antialiased downsizing, which is not ported"
        )
    if (h, w) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


@dataclass(frozen=True)
class UNetSettings:
    init_features: int = 64
    depth: int = 4
    autopad_enabled: bool = True


class UNet(ModelBase):
    """The classic UNet (reference settings: config/CLI/model/unet.yaml):
    ``depth`` levels of ConvBlock and 2x2 max pool with the width doubled
    each level, a ConvBlock at the bottom, then per level a 2x2 stride-2
    transposed convolution, the skip concatenated after it, and a
    ConvBlock; a 1x1 convolution to the outputs."""

    settings_kls = UNetSettings
    model_type = ModelType.CONVOLUTIONAL

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: UNetSettings = UNetSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        f, depth = settings.init_features, settings.depth
        # ConvBlock_0..depth-1 down, ConvBlock_depth at the bottom, then
        # ConvBlock_depth+1.. up, as Flax numbers them in call order
        in_ch = num_input_features
        for level in range(depth + 1):
            self.add_module(f"ConvBlock_{level}", ConvBlock(in_ch, f * 2 ** level))
            in_ch = f * 2 ** level
        for j, level in enumerate(reversed(range(depth))):
            self.add_module(f"ConvTranspose_{j}",
                            FlaxConvTranspose2d(f * 2 ** (level + 1), f * 2 ** level, 2, 2))
            self.add_module(f"ConvBlock_{depth + 1 + j}",
                            ConvBlock(2 * f * 2 ** level, f * 2 ** level))
        self.Conv_0 = FlaxConv2d(f, num_output_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.settings
        if s.autopad_enabled:
            x, hw = pad_to_multiple(x, 2 ** s.depth)
        skips = []
        for level in range(s.depth):
            x = getattr(self, f"ConvBlock_{level}")(x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = getattr(self, f"ConvBlock_{s.depth}")(x)
        for j, level in enumerate(reversed(range(s.depth))):
            x = getattr(self, f"ConvTranspose_{j}")(x)
            x = torch.cat([x, skips[level]], dim=-1)
            x = getattr(self, f"ConvBlock_{s.depth + 1 + j}")(x)
        x = self.Conv_0(x)
        if s.autopad_enabled:
            x = crop_to(x, hw)
        return x


@dataclass(frozen=True)
class HalfUNetSettings:
    num_filters: int = 64
    dilation: int = 1
    bias: bool = False
    use_ghost: bool = False
    last_activation: str = "Identity"
    absolute_pos_embed: bool = False
    autopad_enabled: bool = True
    depth: int = 4


class HalfUNet(ModelBase):
    """Half-UNet: a shared-width encoder whose per-scale features are
    upsampled to full resolution and summed, with no decoder convs (Lu et
    al. 2022; reference settings: config/CLI/model/halfunet.yaml). The
    JAX package's default model."""

    settings_kls = HalfUNetSettings
    model_type = ModelType.CONVOLUTIONAL

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: HalfUNetSettings = HalfUNetSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        s = settings
        block = GhostBlock if s.use_ghost else ConvBlock
        name = block.__name__
        for level in range(s.depth + 1):  # one a scale, then the one on the sum
            self.add_module(f"{name}_{level}", block(
                num_input_features if level == 0 else s.num_filters, s.num_filters,
                dilation=s.dilation, use_bias=s.bias))
        self.Conv_0 = FlaxConv2d(s.num_filters, num_output_features, 1, bias=s.bias)
        self.activation = get_activation(s.last_activation)
        self.block_name = name
        if s.absolute_pos_embed:
            self.pos_embed = nn.Parameter(torch.zeros(1, *self.input_shape, 1))

    def draw_params(self, generator: torch.Generator) -> None:
        """Flax's initializer for ``pos_embed``: truncated_normal(0.02)."""
        if self.settings.absolute_pos_embed:
            flax_trunc_normal_(self.pos_embed, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.settings
        if s.absolute_pos_embed:
            x = x + self.pos_embed
        if s.autopad_enabled:
            x, hw = pad_to_multiple(x, 2 ** (s.depth - 1))
        summed = None
        for level in range(s.depth):
            if level > 0:
                x = max_pool_2x2(x)
            x = getattr(self, f"{self.block_name}_{level}")(x)
            up = _upsample(x, 2 ** level) if level > 0 else x
            summed = up if summed is None else summed + up
        y = getattr(self, f"{self.block_name}_{s.depth}")(summed)
        y = self.activation(self.Conv_0(y))
        if s.autopad_enabled:
            y = crop_to(y, hw)
        return y
