"""Segformer: hierarchical MiT encoder + all-MLP decoder, features-last.

The JAX package's ``models/segformer.py`` in PyTorch, with submodule
names that reproduce its Flax parameter tree (``Conv_0``,
``MiTStage_0``, ``EfficientSelfAttention_1``, ``LayerNorm_4``, ...), so
``convert.params_from_jax`` maps it one to one. Every Flax convolution
pads as Flax does (``FlaxConv2d``), LayerNorms use Flax's eps 1e-6 and
GELU is the tanh form (``flax.linen.gelu``'s default). The efficient
self-attention runs on kernels c-fwd and c-bwd
(``ops/attention.py``).

On a lat band (``parallel.spatial``) the convs take halo rows (the
strided patch embeddings their SAME pad's rows), the reduced K/V of
each attention is gathered from every band (``gather_rows``) while the
queries stay the band's own tokens, and the decoder's bilinear growths
take one clamped halo row a side. A band's rows must be a multiple of
every stride a stage takes (``spatial_lat_multiple``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from py4cast_tpu_torch.models.base import (
    FlaxConv2d,
    LayerNorm,
    ModelBase,
    ModelType,
    crop_to,
    pad_to_multiple,
)
from py4cast_tpu_torch.models.unet import _bilinear_resize
from py4cast_tpu_torch.ops.attention import dot_product_attention_short_kv
from py4cast_tpu_torch.parallel.spatial import gather_rows


@dataclass(frozen=True)
class SegformerSettings:
    dims: Tuple[int, ...] = (32, 64, 160, 256)
    heads: Tuple[int, ...] = (1, 2, 5, 8)
    ff_expansion: Tuple[int, ...] = (8, 8, 4, 4)
    reduction_ratio: Tuple[int, ...] = (8, 4, 2, 1)
    num_layers: int = 2
    decoder_dim: int = 256
    num_downsampling_chans: int = 32


class EfficientSelfAttention(nn.Module):
    """Attention with spatially reduced K/V (the SegFormer trick): K and V
    come from the input after a stride-``reduction`` conv. On a lat band
    the queries are the band's tokens and K/V every band's, gathered
    after the conv and the projections; the gather's backward sums each
    band's dK/dV share."""

    def __init__(self, dim: int, heads: int, reduction: int):
        super().__init__()
        self.heads = heads
        self.Dense_0 = nn.Linear(dim, dim, bias=False)  # q
        if reduction > 1:
            self.Conv_0 = FlaxConv2d(dim, dim, reduction, stride=reduction)
        self.Dense_1 = nn.Linear(dim, dim, bias=False)  # k
        self.Dense_2 = nn.Linear(dim, dim, bias=False)  # v
        self.Dense_3 = nn.Linear(dim, dim)               # out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        q = self.Dense_0(x).reshape(b, h * w, self.heads, -1)
        kv_in = self.Conv_0(x) if hasattr(self, "Conv_0") else x
        kv = gather_rows(torch.cat([self.Dense_1(kv_in), self.Dense_2(kv_in)], dim=-1), 1)
        n_kv = kv.shape[1] * kv.shape[2]
        k, v = (t.reshape(b, n_kv, self.heads, -1) for t in kv.chunk(2, dim=-1))
        out = dot_product_attention_short_kv(q, k, v).reshape(b, h, w, c)
        return self.Dense_3(out)


class MixFFN(nn.Module):
    """FFN with a 3×3 depthwise conv in the middle (positional mixing)."""

    def __init__(self, dim: int, expansion: int):
        super().__init__()
        hidden = dim * expansion
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Conv_0 = FlaxConv2d(hidden, hidden, 3, groups=hidden)
        self.act = nn.GELU(approximate="tanh")
        self.Dense_1 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.act(self.Conv_0(self.Dense_0(x))))


class MiTStage(nn.Module):
    """Overlapping patch merging (a (s+1)×(s+1) conv of stride s), then
    ``num_layers`` pre-norm attention + Mix-FFN blocks and a LayerNorm."""

    def __init__(self, in_dim: int, dim: int, heads: int, expansion: int, reduction: int,
                 num_layers: int, patch_stride: int):
        super().__init__()
        self.num_layers = num_layers
        self.Conv_0 = FlaxConv2d(in_dim, dim, patch_stride + 1, stride=patch_stride)
        for i in range(num_layers):
            setattr(self, f"EfficientSelfAttention_{i}",
                    EfficientSelfAttention(dim, heads, reduction))
            setattr(self, f"MixFFN_{i}", MixFFN(dim, expansion))
        for i in range(2 * num_layers + 1):
            setattr(self, f"LayerNorm_{i}", LayerNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        for i in range(self.num_layers):
            attn = getattr(self, f"EfficientSelfAttention_{i}")
            ffn = getattr(self, f"MixFFN_{i}")
            x = x + attn(getattr(self, f"LayerNorm_{2 * i}")(x))
            x = x + ffn(getattr(self, f"LayerNorm_{2 * i + 1}")(x))
        return getattr(self, f"LayerNorm_{2 * self.num_layers}")(x)


class Segformer(ModelBase):
    settings_kls = SegformerSettings
    model_type = ModelType.VISION_TRANSFORMER
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        """The total stride, and each stage's patch stride times its K/V
        reduction: stage i reduces a band's rows by 4·2^i·r_i."""
        n = len(settings.dims)
        return math.lcm(4 * 2 ** (n - 1),
                        *(4 * 2 ** i * r for i, r in enumerate(settings.reduction_ratio[:n])))

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: SegformerSettings = SegformerSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        s = settings
        self.n_stages = len(s.dims)
        self.total_stride = 4 * 2 ** (self.n_stages - 1)
        self.Conv_0 = FlaxConv2d(num_input_features, s.num_downsampling_chans, 3)
        in_dim = s.num_downsampling_chans
        for i in range(self.n_stages):
            setattr(self, f"MiTStage_{i}", MiTStage(
                in_dim, s.dims[i], s.heads[i], s.ff_expansion[i], s.reduction_ratio[i],
                s.num_layers, patch_stride=4 if i == 0 else 2,
            ))
            in_dim = s.dims[i]
        for i in range(self.n_stages):
            setattr(self, f"Dense_{i}", nn.Linear(s.dims[i], s.decoder_dim))
        self.Conv_1 = FlaxConv2d(self.n_stages * s.decoder_dim, s.decoder_dim, 1)
        self.act = nn.GELU(approximate="tanh")
        self.Conv_2 = FlaxConv2d(s.decoder_dim, num_output_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.Conv_0(x)
        x0, hw = pad_to_multiple(x0, self.total_stride)
        feats = []
        h = x0
        for i in range(self.n_stages):
            h = getattr(self, f"MiTStage_{i}")(h)
            feats.append(h)

        # all-MLP decoder: every stage projected to decoder_dim at 1/4 res
        th, tw = feats[0].shape[1], feats[0].shape[2]
        fused = [_bilinear_resize(getattr(self, f"Dense_{i}")(f), th, tw)
                 for i, f in enumerate(feats)]
        y = self.Conv_2(self.act(self.Conv_1(torch.cat(fused, dim=-1))))
        y = crop_to(_bilinear_resize(y, x0.shape[1], x0.shape[2]), hw)
        return y[:, : x.shape[1], : x.shape[2], :]
