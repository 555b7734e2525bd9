"""The UNet family of the JAX package's ``models/unet.py``, NHWC: UNet
and HalfUNet with their ConvBlock and GhostBlock, the nearest
upsampling, and the bilinear resize that Segformer's and UNetRPP's
decoders share; CustomUNet with its ResNet encoder, which DeepLabV3 and
DeepLabV3Plus share.

Submodules carry Flax's auto names (``ConvBlock_0/Conv_1``,
``GhostBlock_2/GroupNorm_3``, ``ConvTranspose_0``, ``Conv_0``, the
top-level ``pos_embed``) and the encoder its stable names
(``encoder.stem_conv``, ``encoder.stage1_block0.proj_norm``), so
``convert.params_from_jax`` maps the JAX variables one to one and
``models/pretrained.py`` the pretrained npz. No hand kernel runs here: cuDNN runs the
convolutions (TF32 off inside every step, ``utils.exact_fp32``)."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
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
from py4cast_tpu_torch.parallel.spatial import current_band, halo_rows


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


@functools.lru_cache(maxsize=64)
def _linear_weights(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) weights of ``F.interpolate``'s linear mode along one
    axis that grows (half-pixel centres, edges clamped), built in
    float64."""
    src = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), lo), 1.0 - frac)
    np.add.at(m, (np.arange(n_out), np.minimum(lo + 1, n_in - 1)), frac)
    return torch.as_tensor(m, dtype=torch.float32, device=device)


class _GrowBilinear(torch.autograd.Function):
    """Bilinear growth of NCHW ``x`` to (h, w): ``F.interpolate``'s
    forward, and a backward of two products with each axis's weights
    (``_linear_weights``), which sum in a fixed order on every device.
    CUDA's own backward adds each input's gradient up with atomics, in
    no fixed order, so that two backward passes differ in the last
    bits."""

    @staticmethod
    def forward(ctx, x, h: int, w: int):
        ctx.in_hw = tuple(x.shape[2:])
        return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (hi, wi), (n, c, ho, wo) = ctx.in_hw, g.shape
        wh = _linear_weights(ho, hi, g.device)
        ww = _linear_weights(wo, wi, g.device)
        # in NHWC order, which the models' gradients come in: no copy
        rows = torch.matmul(ww.t(), g.permute(0, 2, 3, 1).reshape(n * ho, wo, c))
        dx = torch.matmul(wh.t(), rows.reshape(n, ho, wi * c))
        return dx.reshape(n, hi, wi, c).permute(0, 3, 1, 2), None, None


def _bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to (h, w), as
    ``jax.image.resize(method="bilinear")`` resizes: half-pixel centres,
    edges clamped, and on an axis that shrinks the triangle filter
    widened by the factor (jax antialiases when it downsizes). That is
    ``F.interpolate``'s ``antialias=True``, which leaves an axis that
    grows plain bilinear; it is taken only when an axis shrinks. A bf16
    ``x`` is resized in fp32 and rounded once, forward and backward, as
    XLA sums the resize's weights: the card's bilinear backward adds a
    bf16 input's gradient up in bf16, which at DeepLab's x32 resize
    loses it. A growth runs through ``_GrowBilinear``, so that its
    backward repeats bit for bit.

    On a lat band (``h`` the band's rows of the grown lat) the lat grows
    by a whole factor f: the band's rows and one row of each neighbour
    band (the edge row itself at the global top and bottom, which is the
    clamp) grow to f·(rows + 2), and the band keeps its own f·rows of
    them, which read no row beyond those. A resize in lon alone is each
    band's own. A lat shrink or a fractional lat growth raises there; no
    model reaches one on a band, whose rows are a whole multiple of what
    the model pools."""
    if (h, w) == tuple(x.shape[1:3]):
        return x
    shrinks = h < x.shape[1] or w < x.shape[2]
    band = current_band()
    if band is not None and h != x.shape[1]:
        if h < x.shape[1] or h % x.shape[1]:
            raise ValueError(
                f"a resize of a lat band from {x.shape[1]} to {h} rows is no whole-factor "
                f"growth: its filter does not split into lat bands")
        f = h // x.shape[1]
        grown = _resize(halo_rows(x, 1, 1, band, clamp=True), h + 2 * f, w, shrinks)
        return grown[:, f:f + h]
    return _resize(x, h, w, shrinks)


def _resize(x: torch.Tensor, h: int, w: int, shrinks: bool) -> torch.Tensor:
    """``_bilinear_resize`` of the whole of ``x``."""
    xc = x.permute(0, 3, 1, 2).float()
    if shrinks:
        y = F.interpolate(xc, size=(h, w), mode="bilinear", align_corners=False,
                          antialias=True)
    else:
        y = _GrowBilinear.apply(xc, h, w)
    return y.to(x.dtype).permute(0, 2, 3, 1)


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
    ConvBlock; a 1x1 convolution to the outputs. On a lat band the
    ConvBlocks take halo rows and band statistics, and the pools, the
    k = stride transposed convolutions and the skips are the band's own
    (``depth`` pools: bands of a multiple of 2^depth rows)."""

    settings_kls = UNetSettings
    model_type = ModelType.CONVOLUTIONAL
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        return 2 ** settings.depth

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
    JAX package's default model. On a lat band the blocks take halo rows
    and band statistics, the pools and the nearest upsamples are the
    band's own (``depth`` − 1 pools: bands of a multiple of 2^(depth − 1)
    rows), and ``pos_embed`` is cut to the band's rows."""

    settings_kls = HalfUNetSettings
    model_type = ModelType.CONVOLUTIONAL
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        return 2 ** (settings.depth - 1)

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
            band = current_band()
            x = x + (self.pos_embed if band is None else band.cut(self.pos_embed, 1))
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


@dataclass(frozen=True)
class CustomUNetSettings:
    encoder_name: str = "resnet18"
    encoder_depth: int = 5
    # False: drawn weights; True: the default pretrained npz
    # (models/pretrained.default_weights_path); a string: an npz path
    encoder_weights: object = False
    # "group" (GroupNorm) or "affine" (frozen BN: per-channel scale and bias)
    encoder_norm: str = "group"
    autopad_enabled: bool = True
    decoder_channels: Tuple[int, ...] = (256, 128, 64, 32, 16)


class AffineNorm(nn.Module):
    """Per-channel scale and bias, a BatchNorm with its running statistics
    folded in ("frozen BN"): eval-exact for converted torchvision
    encoders and batch-independent. Flax's ``scale`` is ``weight`` here,
    so ``convert.params_from_jax`` maps it; 1 and 0 at init
    (``draw_params``, which ``training.init_weights`` calls)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def draw_params(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight + self.bias


def _enc_norm(kind: str, features: int) -> nn.Module:
    return AffineNorm(features) if kind == "affine" else _gn(features)


class ResNetBlock(nn.Module):
    """A ResNet basic block: conv1 (3x3, ``stride``, padded 1 on every
    side as torch pads, not SAME), norm, ReLU, conv2 (3x3 SAME), norm,
    plus the input, through a 1x1 ``proj`` and its norm where the shape
    changes; ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        self.conv1 = FlaxConv2d(in_channels, features, 3, stride=stride, padding=1)
        self.norm1 = _enc_norm(norm, features)
        self.conv2 = FlaxConv2d(features, features, 3)
        self.norm2 = _enc_norm(norm, features)
        if stride != 1 or in_channels != features:
            self.proj = FlaxConv2d(in_channels, features, 1, stride=stride)
            self.proj_norm = _enc_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = self.proj_norm(self.proj(x)) if hasattr(self, "proj") else x
        return F.relu(y + residual)


#: name: (blocks per stage, base width)
_RESNET_STAGES = {
    "resnet18": ((2, 2, 2, 2), 64),
    "resnet34": ((3, 4, 6, 3), 64),
}


def max_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 stride-2 max pool of NHWC ``x``, padded 1 on every
    side with -inf (Flax's ``nn.max_pool`` with ``padding=((1, 1), (1,
    1))``); its backward routes a window's cotangent to its first
    maximum, as XLA's select-and-scatter does. On a lat band of even rows
    a window reads one row of the band above (-inf above the global top),
    in global order, so that a tie (zeros after a ReLU are common) goes
    to the row one process would pick, and only its columns pad."""
    if current_band() is not None:
        if x.shape[1] % 2:
            raise ValueError(f"a lat band of {x.shape[1]} rows does not split into the "
                             f"stride 2 of the 3x3 max pool")
        y = halo_rows(x, 1, 0, fill=float("-inf")).permute(0, 3, 1, 2)
        return F.max_pool2d(y, 3, stride=2, padding=(0, 1)).permute(0, 2, 3, 1)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


class ResNetEncoder(nn.Module):
    """ResNet-18/34 encoder returning one feature map per depth level: the
    stem (7x7 stride 2, padded 3 on every side, norm, ReLU) at /2, then,
    after a 3x3 stride-2 max pool padded 1 with -inf, one map per stage.
    ``channels`` lists the maps' widths. On a lat band its convs and the
    pool take halo rows, its GroupNorms band statistics (``AffineNorm``
    is each band's own), and its 1x1 stride-2 ``proj`` reads no halo:
    bands of a multiple of 2^depth rows."""

    def __init__(self, in_channels: int, encoder_name: str = "resnet18", depth: int = 5,
                 norm: str = "group"):
        super().__init__()
        if encoder_name not in _RESNET_STAGES:
            raise ValueError(
                f"Unknown encoder {encoder_name}; available: {list(_RESNET_STAGES)}")
        blocks, width = _RESNET_STAGES[encoder_name]
        self.stem_conv = FlaxConv2d(in_channels, width, 7, stride=2, padding=3)
        self.stem_norm = _enc_norm(norm, width)
        self.channels: List[int] = [width]
        self.stages: List[int] = list(blocks[: depth - 1])
        in_ch = width
        for stage, n_blocks in enumerate(self.stages):
            f = width * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"stage{stage}_block{b}",
                                ResNetBlock(in_ch, f, stride=stride, norm=norm))
                in_ch = f
            self.channels.append(f)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        feats = [x]
        x = max_pool_3x3(x)
        for stage, n_blocks in enumerate(self.stages):
            for b in range(n_blocks):
                x = getattr(self, f"stage{stage}_block{b}")(x)
            feats.append(x)
        return feats


class CustomUNet(ModelBase):
    """A UNet on a ResNet encoder, segmentation-models style (reference
    settings: config/CLI/model/customunet.yaml): from the deepest map up,
    a nearest x2 upsampling (resized bilinearly to the skip when autopad
    is off and the sides differ), the skip concatenated and a ConvBlock
    per decoder width; a last x2 upsampling, ConvBlock and 1x1 conv.
    ``load_pretrained`` loads the encoder per ``encoder_weights``. On a
    lat band the encoder and the ConvBlocks take halo rows and band
    statistics, the nearest upsamples are each band's own, and a resize
    to a skip (autopad off) differs in lon only: bands of a multiple of
    2^encoder_depth rows."""

    settings_kls = CustomUNetSettings
    model_type = ModelType.CONVOLUTIONAL
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        return 2 ** settings.encoder_depth

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...],
                 settings: CustomUNetSettings = CustomUNetSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        s = settings
        self.encoder = ResNetEncoder(num_input_features, s.encoder_name, s.encoder_depth,
                                     norm=s.encoder_norm)
        channels = self.encoder.channels
        dec = tuple(s.decoder_channels[: len(channels)])
        skips = channels[:-1][::-1]  # deepest first
        self.num_up = len(dec[: len(skips)])
        y_ch = channels[-1]
        for i, ch in enumerate(dec[: len(skips)]):
            self.add_module(f"ConvBlock_{i}", ConvBlock(y_ch + skips[i], ch))
            y_ch = ch
        self.add_module(f"ConvBlock_{self.num_up}", ConvBlock(y_ch, dec[-1]))
        self.Conv_0 = FlaxConv2d(dec[-1], num_output_features, 1)

    def load_pretrained(self, params):
        """``params`` with the pretrained encoder loaded per
        ``settings.encoder_weights`` (the trainer calls it after init)."""
        from py4cast_tpu_torch.models.pretrained import maybe_load_encoder

        return maybe_load_encoder(params, self.settings, self.num_input_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.settings
        if s.autopad_enabled:
            x, hw = pad_to_multiple(x, 2 ** s.encoder_depth)
        feats = self.encoder(x)
        y = feats[-1]
        skips = feats[:-1][::-1]
        for i in range(self.num_up):
            y = _upsample(y, 2)
            skip = skips[i]
            if skip.shape[1:3] != y.shape[1:3]:
                y = _bilinear_resize(y, skip.shape[1], skip.shape[2])
            y = getattr(self, f"ConvBlock_{i}")(torch.cat([y, skip], dim=-1))
        # back to the input's resolution (the stem halved it)
        y = getattr(self, f"ConvBlock_{self.num_up}")(_upsample(y, 2))
        y = self.Conv_0(y)
        if s.autopad_enabled:
            y = crop_to(y, hw)
        return y
