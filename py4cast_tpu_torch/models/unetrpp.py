"""UNETR++ with Efficient Paired Attention (EPA), NHWC: the JAX package's
``models/unetrpp.py`` in PyTorch (reference settings:
config/CLI/model/unetrpp.yaml).

EPA (Shaker et al. 2023) pairs a spatial-attention branch, whose K/V are
projected onto a fixed ``proj_size`` tokens, with a channel-attention
branch over head dim × head dim, sharing the query and key weights. With
``attention_code`` ``flash_attn`` or ``pallas`` the spatial branch runs
on kernels c-fwd and c-bwd (``ops/attention.py::short_kv_attention``: a
long query against a short projected K/V, the same function Segformer
runs); with ``torch`` or ``xla`` it is the plain einsum, softmax,
einsum. The port has no TPU gate: on the card the kernels take every
head dim up to 128 and every K/V length.

Submodules carry Flax's names (``Conv_3``, ``ConvTranspose_0``,
``EPABlock_1/EPA_0/Dense_2``, ``enc_stage0``), so
``convert.params_from_jax`` maps the JAX variables one to one. A stage
of depth > 1, which the JAX package runs as ``nn.scan`` over stacked
params, is a ModuleList of EPABlocks here; its ``nn.remat`` is a TPU
compile and memory device and changes no number (the trainer's
``use_checkpointing`` recomputes the forward, as for every model).

Dropout (``dropout_rate``) follows Flax's ``nn.Dropout`` and draws from
the ``generator`` the trainer passes in train steps only
(``base.dropout``).

On a lat band (``parallel.spatial``) a band's tokens are one run of the
row-major N: EPA's token norms, its channel logits and its projected
K/V are sums over every band (``band_all_reduce``, in fp32, rounded
once where one process's product rounds), ``proj_k`` and ``proj_v`` are cut to
the band's token rows, and the spatial branch attends the band's
queries to the whole projected K/V (kernels c-fwd and c-bwd under
``flash_attn`` and ``pallas``). The convs take halo rows, the instance
norms band statistics, the linear upsamplings a clamped halo row a
side; the patch embedding, the 2x2 down convs and the transposed convs
are each band's own. A band's rows must be a multiple of dr·2^(n−1)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

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
    dropout,
    flax_trunc_normal_,
    norm_layer,
    pad_to_multiple,
)
from py4cast_tpu_torch.models.unet import _bilinear_resize
from py4cast_tpu_torch.ops.attention import short_kv_attention
from py4cast_tpu_torch.parallel.spatial import band_all_reduce, current_band

#: the channel branch's norm guard (``unetrpp.py`` adds it to the norm)
NORM_EPS = 1e-6
ATTENTION_CODES = ("torch", "xla", "flash_attn", "pallas")
KERNEL_CODES = ("flash_attn", "pallas")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


@dataclass(frozen=True)
class UNetRPPSettings:
    #: fields that turn on train-time dropout when nonzero (the trainer's
    #: ``_dropout_active``); a nonzero ``drop`` field not listed raises
    DROPOUT_FIELDS = ("dropout_rate",)

    hidden_size: int = 256
    num_heads_encoder: int = 16
    num_heads_decoder: int = 4
    pos_embed: str = "perceptron"
    norm_name: str = "instance"
    dropout_rate: float = 0.0
    depths: Tuple[int, ...] = (3, 3, 3, 3)
    conv_op: str = "Conv2d"
    linear_upsampling: bool = False
    downsampling_rate: int = 4
    decoder_proj_size: int = 64
    encoder_proj_sizes: Tuple[int, ...] = (64, 64, 64, 32)
    add_skip_connections: bool = True
    #: "torch"/"xla": the plain einsum attention; "flash_attn"/"pallas":
    #: kernels c-fwd and c-bwd
    attention_code: str = "xla"

    def __post_init__(self):
        norm_layer(self.norm_name, 8)  # config-time validation
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1); got {self.dropout_rate}")
        if self.conv_op != "Conv2d":
            raise ValueError(
                f"conv_op {self.conv_op!r} unsupported: this build is 2-D "
                "NHWC (Conv2d) only, matching the framework's grid layout"
            )
        if self.attention_code not in ATTENTION_CODES:
            raise ValueError(
                f"attention_code {self.attention_code!r} unknown; accepted: "
                "torch | xla (plain attention), flash_attn | pallas "
                "(the short-KV attention kernels)"
            )
        if self.pos_embed not in ("perceptron", "none"):
            raise ValueError(
                f"pos_embed {self.pos_embed!r} unknown; accepted: "
                "perceptron | none"
            )


class EPA(nn.Module):
    """Efficient Paired Attention over (B, N, C) tokens: one bias-free
    Dense(4·dim) gives q, k (shared by both branches), v_sp and v_ch; the
    spatial branch attends the N queries to k and v_sp projected onto
    p = min(proj_size, N) tokens by ``proj_k`` and ``proj_v`` (N, p),
    the channel branch softmaxes the (hd × hd) products of q and k
    normalised over the tokens, scaled by ``temperature``; ``Dense_1``
    and ``Dense_2`` project the two and their sum is the output."""

    def __init__(self, dim: int, heads: int, proj_size: int, tokens: int,
                 drop: float = 0.0, kernel: bool = False):
        super().__init__()
        self.dim, self.heads, self.tokens = dim, heads, tokens
        self.drop, self.kernel = drop, kernel
        p = min(proj_size, tokens)
        self.Dense_0 = nn.Linear(dim, 4 * dim, bias=False)
        self.Dense_1 = nn.Linear(dim, dim)  # spatial branch
        self.Dense_2 = nn.Linear(dim, dim)  # channel branch
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.proj_k = nn.Parameter(torch.zeros(tokens, p))
        self.proj_v = nn.Parameter(torch.zeros(tokens, p))

    @torch.no_grad()
    def draw_params(self, generator: torch.Generator) -> None:
        """Flax's initializers for EPA's own leaves: ``temperature`` ones,
        ``proj_k`` and ``proj_v`` truncated_normal(0.02), cut at ±2 std."""
        self.temperature.fill_(1.0)
        for proj in (self.proj_k, self.proj_v):
            flax_trunc_normal_(proj, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        band = current_band()
        count = 1 if band is None else band.count
        if n * count != self.tokens:
            raise ValueError(f"EPA was built for {self.tokens} tokens (its proj_k, proj_v), "
                             f"got {n}{f' on each of {count} bands' if count > 1 else ''}: "
                             f"build the model for this grid")
        heads, hd = self.heads, self.dim // self.heads

        def split_heads(a):  # (B, heads, N, hd)
            return a.reshape(b, n, heads, hd).transpose(1, 2)

        q, k, v_sp, v_ch = map(split_heads, self.Dense_0(x).chunk(4, dim=-1))

        # channel branch: (hd x hd) a head, q and k normalised over the
        # tokens (on a band, fp32 sums of squares over every band's)
        if band is None:
            norms = [torch.linalg.vector_norm(a, dim=-2, keepdim=True) for a in (q, k)]
        else:
            norms = band_all_reduce(torch.stack(
                [a.float().square().sum(dim=-2, keepdim=True) for a in (q, k)]), band).sqrt()
        qn = q / (norms[0].to(q.dtype) + NORM_EPS)
        kn = k / (norms[1].to(k.dtype) + NORM_EPS)
        # the logits and their softmax in fp32 (exact products of bf16
        # values, as the JAX package's preferred_element_type), the
        # weights back in the activation dtype for the value product
        attn_ch = band_all_reduce(torch.einsum("bhnd,bhne->bhde", qn.float(), kn.float()), band)
        attn_ch = attn_ch * self.temperature
        out_ch = torch.einsum("bhde,bhne->bhnd", attn_ch.softmax(dim=-1).to(v_ch.dtype), v_ch)

        # spatial branch: K/V projected onto p tokens by proj_k and proj_v;
        # on a band, the band's token rows of them, the partial products
        # summed over the bands in fp32 and rounded once, as one process's
        # product rounds its fp32 sum once
        if band is None:
            k_p = torch.einsum("bhnd,np->bhpd", k, self.proj_k)
            v_p = torch.einsum("bhnd,np->bhpd", v_sp, self.proj_v)
        else:
            rows = band.rows(self.tokens)
            k_p, v_p = band_all_reduce(torch.stack(
                [torch.einsum("bhnd,np->bhpd", a.float(), proj[rows].float())
                 for a, proj in ((k, self.proj_k), (v_sp, self.proj_v))]), band).to(q.dtype)
        if self.kernel:
            p = k_p.shape[2]
            out_sp = short_kv_attention(
                q.reshape(b * heads, n, hd).contiguous(),
                k_p.reshape(b * heads, p, hd).contiguous(),
                v_p.reshape(b * heads, p, hd).contiguous(),
                1.0 / math.sqrt(hd),
            ).reshape(b, heads, n, hd)
        else:  # the JAX package's plain path divides by sqrt(hd) in q's dtype
            root = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
            attn_sp = torch.einsum("bhnd,bhpd->bhnp", q.float(), k_p.float()) / root
            out_sp = torch.einsum("bhnp,bhpd->bhnd", attn_sp.softmax(dim=-1).to(v_p.dtype), v_p)

        def merge(a):
            return a.transpose(1, 2).reshape(b, n, self.dim)

        fused = self.Dense_1(merge(out_sp)) + self.Dense_2(merge(out_ch))
        return dropout(fused, self.drop, generator)


class EPABlock(nn.Module):
    """Pre-norm EPA over the spatial tokens with a residual, then a conv
    FFN (3x3 dim → 2·dim, GELU, dropout, 3x3 back to dim) with a
    residual, on (B, H, W, C)."""

    def __init__(self, dim: int, heads: int, proj_size: int, tokens: int,
                 drop: float = 0.0, kernel: bool = False):
        super().__init__()
        self.drop = drop
        self.LayerNorm_0 = LayerNorm(dim)
        self.EPA_0 = EPA(dim, heads, proj_size, tokens, drop, kernel)
        self.Conv_0 = FlaxConv2d(dim, 2 * dim, 3)
        self.Conv_1 = FlaxConv2d(2 * dim, dim, 3)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        t = t + self.EPA_0(self.LayerNorm_0(t), generator)
        y = t.reshape(b, h, w, c)
        z = dropout(_gelu(self.Conv_0(y)), self.drop, generator)
        return y + self.Conv_1(z)


def _epa_stage(depth: int, dim: int, heads: int, proj_size: int, tokens: int,
               drop: float = 0.0, kernel: bool = False) -> nn.Module:
    """An encoder stage: one EPABlock at depth 1 (or 0, as the JAX
    package builds it), else a ModuleList of ``depth`` blocks, the JAX
    package's ``nn.scan`` over stacked params."""
    if depth <= 1:
        return EPABlock(dim, heads, proj_size, tokens, drop, kernel)
    return nn.ModuleList(EPABlock(dim, heads, proj_size, tokens, drop, kernel)
                         for _ in range(depth))


class UNetRPP(ModelBase):
    """UNETR++: a full-resolution conv stem kept as the outermost skip; a
    dr×dr patch embed (and a ``perceptron`` Dense); encoder stages of EPA
    blocks at widths hidden_size / 2^(n−1−i), joined by 2x2 stride-2
    convs; a decoder that upsamples (bilinear resize and a 1x1 conv with
    ``linear_upsampling``, else a stride-2 transposed conv), adds the
    skip and runs one EPA block a stage; then back to full resolution,
    concatenated with the stem, a 3x3 conv, norm, GELU and a 1x1 conv to
    the outputs. The input is padded to a multiple of dr·2^(n−1) and the
    output cropped back.

    ``forward(x, generator=None)``: with a generator, dropout is on."""

    settings_kls = UNetRPPSettings
    model_type = ModelType.VISION_TRANSFORMER
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        return settings.downsampling_rate * 2 ** (len(settings.depths) - 1)

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: UNetRPPSettings = UNetRPPSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        s = settings
        n_stages = len(s.depths)
        dr = s.downsampling_rate
        self.total = dr * 2 ** (n_stages - 1)
        hp, wp = (-(-n // self.total) * self.total for n in self.input_shape)
        dims = [s.hidden_size // 2 ** i for i in reversed(range(n_stages))]
        kernel = s.attention_code in KERNEL_CODES
        drop = s.dropout_rate
        counts = {}

        def add(kind: str, module: nn.Module) -> str:
            """Register ``module`` under Flax's next auto name for ``kind``."""
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, module)
            return name

        def tokens(i: int) -> int:
            return (hp // (dr * 2 ** i)) * (wp // (dr * 2 ** i))

        half = dims[0] // 2
        self.stem_conv = add("Conv", FlaxConv2d(num_input_features, half, 3))
        self.stem_norm = add("GroupNorm", norm_layer(s.norm_name, half))
        self.patch_embed = add("Conv", FlaxConv2d(num_input_features, dims[0], dr, stride=dr))
        self.perceptron = (add("Dense", nn.Linear(dims[0], dims[0]))
                           if s.pos_embed == "perceptron" else None)
        self.down = []
        for i in range(n_stages):
            self.add_module(f"enc_stage{i}", _epa_stage(
                s.depths[i], dims[i], s.num_heads_encoder, s.encoder_proj_sizes[i], tokens(i),
                drop, kernel))
            if i < n_stages - 1:
                self.down.append(add("Conv", FlaxConv2d(dims[i], dims[i + 1], 2, stride=2)))
        self.up, self.dec_blocks = [], []
        for i in reversed(range(n_stages - 1)):
            self.up.append(add("Conv", FlaxConv2d(dims[i + 1], dims[i], 1))
                           if s.linear_upsampling else
                           add("ConvTranspose", FlaxConvTranspose2d(dims[i + 1], dims[i], 2, 2)))
            self.dec_blocks.append(add("EPABlock", EPABlock(
                dims[i], s.num_heads_decoder, s.decoder_proj_size, tokens(i), drop, kernel)))
        self.final_up = (add("Conv", FlaxConv2d(dims[0], half, 1)) if s.linear_upsampling
                         else add("ConvTranspose", FlaxConvTranspose2d(dims[0], half, dr, dr)))
        self.head_conv = add("Conv", FlaxConv2d(2 * half, half, 3))
        self.head_norm = add("GroupNorm", norm_layer(s.norm_name, half))
        self.out_conv = add("Conv", FlaxConv2d(half, num_output_features, 1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        s = self.settings
        n_stages = len(s.depths)
        mod = self.get_submodule
        x_pad, hw = pad_to_multiple(x, self.total)

        stem = _gelu(mod(self.stem_norm)(mod(self.stem_conv)(x_pad)))
        h = mod(self.patch_embed)(x_pad)
        if self.perceptron is not None:
            h = mod(self.perceptron)(h)
        h = dropout(h, s.dropout_rate, generator)
        skips = []
        for i in range(n_stages):
            stage = mod(f"enc_stage{i}")
            for block in (stage if isinstance(stage, nn.ModuleList) else (stage,)):
                h = block(h, generator)
            skips.append(h)
            if i < n_stages - 1:
                h = mod(self.down[i])(h)

        y = skips[-1]
        for j, i in enumerate(reversed(range(n_stages - 1))):
            if s.linear_upsampling:
                y = _bilinear_resize(y, skips[i].shape[1], skips[i].shape[2])
            y = mod(self.up[j])(y)
            if s.add_skip_connections:
                y = y + skips[i]
            y = mod(self.dec_blocks[j])(y, generator)

        if s.linear_upsampling:
            y = _bilinear_resize(y, x_pad.shape[1], x_pad.shape[2])
        y = torch.cat([mod(self.final_up)(y), stem], dim=-1)
        y = _gelu(mod(self.head_norm)(mod(self.head_conv)(y)))
        return crop_to(mod(self.out_conv)(y), hw)
