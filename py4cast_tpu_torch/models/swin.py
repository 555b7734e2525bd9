"""SwinUNetR, NHWC: the JAX package's ``models/swin.py`` in PyTorch
(reference settings: config/CLI/model/swinunetr.yaml).

A Swin-transformer encoder (windowed attention with a relative-position
bias, shifted windows on odd blocks, patch merging between stages) and
a UNETR-style convolutional decoder. The input is padded to a multiple
of 2^(stages+1) and the output cropped back; each stage pads its tokens
to a multiple of the window *before* its blocks, so the padded tokens
take part in attention as in the JAX package, and crops after.

Windowed attention is a plain product, softmax, product (no TPU kernel
sits on it): the logits, bias, mask and softmax in fp32, the weights
back in the activation dtype for the value product. The bias is
gathered by a product with a fixed 0/1 matrix, so its gradient is a
product too, summed in a fixed order on the card (indexing's backward
adds with atomics).

Submodules carry Flax's names (``SwinStage_0/SwinBlock_1/
WindowAttention_0/rel_pos_bias``, ``ConvBlockRes_2``, ``UpBlock_0/
ConvTranspose_0``, ``v2_block0``), so ``convert.params_from_jax`` maps
the JAX variables one to one. Dropout (``drop_rate``,
``attn_drop_rate``) and stochastic depth (``dropout_path_rate``) draw
from the ``generator`` the trainer passes in train steps only.

On a lat band (``parallel.spatial``) the windows stay inside the band:
its rows at every stage are a multiple of the window (a band of a
multiple of ws·2^stages rows, ``spatial_lat_multiple``). The shifted
blocks roll the lat dim across the bands (``roll_rows``) and the lon dim
locally, and take the band's windows of the whole grid's shift mask;
the convs take halo rows, the instance norms band statistics, and the
patch embedding, the merges and the transposed convs are each band's
own. Dropout draws the whole grid's masks and cuts the band's
(``base.dropout``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.models.base import (
    FlaxConv2d,
    FlaxConvTranspose2d,
    LayerNorm,
    ModelBase,
    ModelType,
    crop_to,
    drop_path,
    dropout,
    flax_trunc_normal_,
    norm_layer,
    pad_to_multiple,
)
from py4cast_tpu_torch.parallel.spatial import current_band, roll_rows


@dataclass(frozen=True)
class SwinUNetRSettings:
    #: fields that turn on train-time dropout when nonzero (the trainer's
    #: ``_dropout_active``); a nonzero ``drop`` field not listed raises
    DROPOUT_FIELDS = ("drop_rate", "attn_drop_rate", "dropout_path_rate")

    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    feature_size: int = 24
    norm_name: str = "instance"
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    dropout_path_rate: float = 0.0
    normalize: bool = True
    #: the trainer recomputes the forward in the backward
    use_checkpoint: bool = False
    downsample: str = "merging"
    use_v2: bool = False
    window_size: int = 7

    def __post_init__(self):
        norm_layer(self.norm_name, 8)  # config-time validation
        for f in ("drop_rate", "attn_drop_rate", "dropout_path_rate"):
            v = getattr(self, f)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{f} must be in [0, 1); got {v}")
        if self.downsample != "merging":
            raise ValueError(
                f"downsample {self.downsample!r} unsupported; only 'merging' "
                "(patch merging — the reference default) is implemented"
            )


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nH·nW, ws·ws, C)"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


@lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The static attention mask of shifted windows on an (h, w) stage
    padded to the window: (nW, ws·ws, ws·ws), 0 where two tokens share a
    region, −1e9 otherwise (the JAX package's bits)."""
    img = np.zeros((1, h, w, 1), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    wins = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    wins = wins.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff == 0, 0.0, -1e9).astype(np.float32)


def _rel_idx(ws: int) -> np.ndarray:
    """(ws·ws, ws·ws) index of each token pair's relative offset into
    ``rel_pos_bias``'s (2·ws − 1)² columns."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + ws - 1
    return (rel[0] * (2 * ws - 1) + rel[1]).astype(np.int32)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window: ``Dense_0`` gives q, k, v
    (split in thirds), the logits get the relative-position bias of
    their offset and, on a shifted block, the region mask, and
    ``Dense_1`` projects the heads back."""

    def __init__(self, dim: int, heads: int, ws: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros(heads, (2 * ws - 1) ** 2))
        self.Dense_1 = nn.Linear(dim, dim)
        idx = _rel_idx(ws).ravel()
        select = np.zeros(((2 * ws - 1) ** 2, idx.size), np.float32)
        select[idx, np.arange(idx.size)] = 1.0
        #: bias = rel_pos_bias @ select: the gather by ``_rel_idx`` as a
        #: product, whose backward is a product too
        self.register_buffer("bias_select", torch.from_numpy(select), persistent=False)

    @torch.no_grad()
    def draw_params(self, generator: torch.Generator) -> None:
        """Flax's truncated_normal(0.02) for ``rel_pos_bias``."""
        flax_trunc_normal_(self.rel_pos_bias, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                windows: Optional[int] = None) -> torch.Tensor:
        """``x`` (B·nW, ws·ws, dim), the nW = ``windows`` windows of each
        sample in row-major order (on a lat band, the band's: its dropout
        masks are cut from the whole grid's windows)."""
        nb, t, _ = x.shape
        heads, hd = self.heads, self.dim // self.heads
        per_sample = windows or nb

        def drop(a, rate):
            return dropout(a.reshape(nb // per_sample, per_sample, *a.shape[1:]), rate,
                           generator).reshape(a.shape)

        def heads_first(a):
            return a.reshape(nb, t, heads, hd).transpose(1, 2)

        q, k, v = map(heads_first, self.Dense_0(x).chunk(3, dim=-1))
        rpb = self.rel_pos_bias
        bias = (rpb @ self.bias_select.to(rpb.dtype)).reshape(heads, t, t)
        # the logits in fp32 (exact products of bf16 values, as the JAX
        # package's preferred_element_type), divided by sqrt(hd) rounded
        # to the activation dtype; bias, mask and softmax in fp32
        root = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / root + bias
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(nb // nw, nw, heads, t, t) + mask[None, :, None]).reshape(
                nb, heads, t, t)
        attn = drop(attn.softmax(dim=-1).to(v.dtype), self.attn_drop)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nb, t, self.dim)
        return drop(self.Dense_1(out), self.proj_drop)


class SwinBlock(nn.Module):
    """Pre-norm window attention (cyclically shifted by ``shift`` when
    nonzero) and a tanh-GELU MLP of 4·dim, each a residual behind
    stochastic depth."""

    def __init__(self, dim: int, heads: int, ws: int, shift: int, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.drop, self.drop_path_rate = drop, drop_path_rate
        self.LayerNorm_0 = LayerNorm(dim)
        self.WindowAttention_0 = WindowAttention(dim, heads, ws, attn_drop, drop)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        s, ws = self.shift, self.ws
        y = self.LayerNorm_0(x)
        if s > 0:  # the lat roll crosses the bands (torch.roll off a band)
            y = roll_rows(torch.roll(y, -s, dims=2), -s)
        windows = (h // ws) * (w // ws)
        y = _window_reverse(self.WindowAttention_0(_window_partition(y, ws), mask, generator,
                                                   windows), ws, h, w)
        if s > 0:
            y = roll_rows(torch.roll(y, s, dims=2), s)
        x = x + drop_path(y, self.drop_path_rate, generator)
        z = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")  # flax nn.gelu
        z = dropout(self.Dense_1(dropout(z, self.drop, generator)), self.drop, generator)
        return x + drop_path(z, self.drop_path_rate, generator)


class SwinStage(nn.Module):
    """``depth`` SwinBlocks, shifted by ws // 2 on odd blocks, on the
    tokens zero-padded to a multiple of the window. ``hw`` is the
    stage's input size for the model's grid: its shift mask is built
    once, as a buffer; another size builds its own."""

    def __init__(self, dim: int, depth: int, heads: int, ws: int, drop: float,
                 attn_drop: float, drop_path_rates: Tuple[float, ...], hw: Tuple[int, int]):
        super().__init__()
        self.ws, self.depth = ws, depth
        for i in range(depth):
            shift = 0 if i % 2 == 0 else ws // 2
            self.add_module(f"SwinBlock_{i}", SwinBlock(dim, heads, ws, shift, drop, attn_drop,
                                                        drop_path_rates[i]))
        self.padded = tuple(-(-n // ws) * ws for n in hw)
        mask = _shift_mask(*self.padded, ws, ws // 2) if depth > 1 else np.zeros(0, np.float32)
        self.register_buffer("shift_mask", torch.from_numpy(mask), persistent=False)

    def _mask(self, h: int, w: int) -> torch.Tensor:
        """The shift mask of an (h, w) input (a band's: the band's windows
        of the whole grid's mask, which depends on global position)."""
        band = current_band()
        whole = h * (band.count if band is not None else 1)
        if (whole, w) == self.padded:
            mask = self.shift_mask
        else:
            mask = torch.from_numpy(_shift_mask(whole, w, self.ws, self.ws // 2)).to(
                self.shift_mask.device)
        return mask if band is None else band.cut(mask, 0)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if current_band() is not None and x.shape[1] % self.ws:
            raise ValueError(f"a lat band of {x.shape[1]} rows does not hold whole windows "
                             f"of {self.ws} rows")
        x, hw = pad_to_multiple(x, self.ws)
        mask = self._mask(x.shape[1], x.shape[2]) if self.depth > 1 else None
        for i in range(self.depth):
            x = getattr(self, f"SwinBlock_{i}")(x, mask if i % 2 else None, generator)
        return crop_to(x, hw)


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated in the JAX package's (dh, dw, c) order
    (its reshape and transpose, not torch Swin's x0‖x1‖x2‖x3), then
    LayerNorm and a bias-free Dense to ``out_dim``."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * dim)
        self.Dense_0 = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = pad_to_multiple(x, 2)
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.Dense_0(self.LayerNorm_0(x.reshape(b, h // 2, w // 2, 4 * c)))


class ConvBlockRes(nn.Module):
    """Two bias-free 3×3 convs, each normed (``norm_name``), ReLU between,
    and a residual through a bias-free 1×1 conv where the width changes."""

    def __init__(self, in_channels: int, features: int, norm_name: str = "instance"):
        super().__init__()
        self.Conv_0 = FlaxConv2d(in_channels, features, 3, bias=False)
        self.GroupNorm_0 = norm_layer(norm_name, features)
        self.Conv_1 = FlaxConv2d(features, features, 3, bias=False)
        self.GroupNorm_1 = norm_layer(norm_name, features)
        self.Conv_2 = (FlaxConv2d(in_channels, features, 1, bias=False)
                       if in_channels != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(x + y)


class UpBlock(nn.Module):
    """A 2×2 stride-2 transposed conv, cropped to the skip, concatenated
    with it and refined by a ConvBlockRes."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 norm_name: str = "instance"):
        super().__init__()
        self.ConvTranspose_0 = FlaxConvTranspose2d(in_channels, features, 2, 2)
        self.ConvBlockRes_0 = ConvBlockRes(features + skip_channels, features, norm_name)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(x)[:, : skip.shape[1], : skip.shape[2]]
        return self.ConvBlockRes_0(torch.cat([x, skip], dim=-1))


class SwinUNetR(ModelBase):
    """SwinUNetR: a full-resolution ConvBlockRes kept as the outermost
    skip; a 2×2 stride-2 patch embed; Swin stages at widths
    feature_size·2^i joined by patch merging (with ``use_v2``, a
    ConvBlockRes before each stage), each stage's tokens (LayerNormed
    with ``normalize``) refined into a skip; a decoder of UpBlocks back
    to full resolution and a 1×1 head.

    ``forward(x, generator=None)``: with a generator, dropout and
    stochastic depth are on."""

    settings_kls = SwinUNetRSettings
    model_type = ModelType.VISION_TRANSFORMER
    register = True
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        """Stage i holds a band's rows / 2^(i+1), whole windows each."""
        return settings.window_size * 2 ** len(settings.depths)

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: SwinUNetRSettings = SwinUNetRSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        s = settings
        n = len(s.depths)
        f, norm = s.feature_size, s.norm_name
        self.total = 2 ** (n + 1)
        hp, wp = (-(-d // self.total) * self.total for d in self.input_shape)
        # stochastic-depth rates rise linearly over all blocks (swin/timm)
        total_blocks = max(1, sum(s.depths))
        dpr = [s.dropout_path_rate * i / max(1, total_blocks - 1) for i in range(total_blocks)]
        offsets = np.cumsum((0,) + tuple(s.depths))

        self.ConvBlockRes_0 = ConvBlockRes(num_input_features, f, norm)
        self.Conv_0 = FlaxConv2d(num_input_features, f, 2, stride=2)
        for i in range(n):
            dim = f * 2 ** i
            if s.use_v2:
                self.add_module(f"v2_block{i}", ConvBlockRes(dim, dim, norm))
            self.add_module(f"SwinStage_{i}", SwinStage(
                dim, s.depths[i], s.num_heads[i], s.window_size, s.drop_rate, s.attn_drop_rate,
                tuple(dpr[offsets[i]:offsets[i + 1]]), (hp // 2 ** (i + 1), wp // 2 ** (i + 1))))
            if s.normalize:
                self.add_module(f"LayerNorm_{i}", LayerNorm(dim))
            self.add_module(f"ConvBlockRes_{i + 1}", ConvBlockRes(dim, dim, norm))
            if i < n - 1:
                self.add_module(f"PatchMerging_{i}", PatchMerging(dim, 2 * dim))
        width = f * 2 ** (n - 1)
        self.add_module(f"ConvBlockRes_{n + 1}", ConvBlockRes(width, width, norm))
        for j, i in enumerate(reversed(range(n - 1))):
            self.add_module(f"UpBlock_{j}", UpBlock(width, f * 2 ** i, f * 2 ** i, norm))
            width = f * 2 ** i
        self.add_module(f"UpBlock_{n - 1}", UpBlock(width, f, f, norm))
        self.Conv_1 = FlaxConv2d(f, num_output_features, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        s = self.settings
        n = len(s.depths)
        mod = self.get_submodule
        x_pad, hw = pad_to_multiple(x, self.total)

        skips = [self.ConvBlockRes_0(x_pad)]
        h = dropout(self.Conv_0(x_pad), s.drop_rate, generator)
        for i in range(n):
            if s.use_v2:
                h = mod(f"v2_block{i}")(h)
            h = mod(f"SwinStage_{i}")(h, generator)
            # the skip reads the stage's tokens LayerNormed; the chain
            # goes on unnormalized
            skips.append(mod(f"ConvBlockRes_{i + 1}")(
                mod(f"LayerNorm_{i}")(h) if s.normalize else h))
            if i < n - 1:
                h = mod(f"PatchMerging_{i}")(h)

        y = mod(f"ConvBlockRes_{n + 1}")(skips[-1])
        for j, i in enumerate(reversed(range(n - 1))):
            y = mod(f"UpBlock_{j}")(y, skips[i + 1])
        y = mod(f"UpBlock_{n - 1}")(y, skips[0])
        return crop_to(self.Conv_1(y), hw)
