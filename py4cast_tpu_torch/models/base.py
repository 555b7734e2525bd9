"""Model-layer contract: model types, settings machinery, base module.

Models are ``torch.nn.Module``s built from the four logical arguments
``(num_input_features, num_output_features, input_shape, settings)``.
Everything is features-last, as in the JAX package, so both packages
exchange tensors without transposes.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.parallel.spatial import band_all_reduce, current_band, halo_rows


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


@torch.no_grad()
def flax_trunc_normal_(param: torch.Tensor, generator: torch.Generator,
                       std: float = 0.02) -> None:
    """Flax's ``truncated_normal(std)`` in place: a normal of ``std`` cut
    at ±2 std, drawn on the generator's device, then copied."""
    w = torch.empty(param.shape, device=generator.device)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    param.copy_(w)


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
    #: a plugin module's subclass with ``register = True`` joins the
    #: registry (``models._discover_plugins``)
    register: bool = False
    #: the model runs on a lat band of a spatial mesh (``parallel.spatial``)
    spatial_shardable: bool = False

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        """The rows a lat band of a model built from ``settings`` must be
        a multiple of to run alone (its pools, strides and windows): 1
        unless the model pools."""
        return 1

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
    ``crop_to``. On a lat band only the columns pad: the whole lat (the
    band's rows times the bands) must be a multiple already, so that one
    process would pad no rows either."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % multiple, (-w) % multiple
    band = current_band()
    if band is not None:
        if (h * band.count) % multiple:
            raise ValueError(
                f"a lat of {h * band.count} rows on {band.count} bands is not a multiple of "
                f"{multiple}, which the model pads its lat to: pass a lat_multiple that is")
        ph = 0
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
    """A Flax ``nn.Conv`` (``padding="SAME"``, the Flax default, with
    ``kernel_dilation``) on an NHWC tensor: the input is padded as Flax
    pads it (``flax_same_pad`` of the dilated kernel's extent), then
    convolved in NCHW and returned NHWC. An int ``padding`` is Flax's
    explicit ``padding=((p, p), (p, p))`` instead: p on every side, the
    ResNet encoder's torch-style stem and strided convs, where SAME would
    pad (2, 3) or (0, 1) at stride 2 on an even side. The weight is
    torch's OIHW; ``convert.params_from_jax`` maps Flax's HWIO kernel
    onto it.

    On a lat band (``parallel.spatial.current_band``) whose rows are a
    multiple of the stride, a conv takes the rows its padding of the
    whole lat would read (``band_halo``) from its neighbour bands, zeros
    only at the global top and bottom, and pads its columns as it does
    off a band: for SAME, what Flax's SAME pad of the whole lat adds
    ((k − 1)·d / 2 a side at stride 1, (0, 1) at k 5 / stride 4 and k 3 /
    stride 2, none where the kernel equals the stride); for an explicit
    ``padding`` p, p rows above and k − s − p below ((3, 2) for the 7x7
    stride-2 stem, (1, 0) for the 3x3 stride-2 ``conv1``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, dilation: int = 1,
                 padding: Optional[int] = None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding or 0, dilation=dilation, groups=groups, bias=bias)
        self.same = padding is None

    def _rows_and_cols(self, h: int, w: int):
        """The pads (top, bottom), (left, right) for an h x w input:
        Flax's SAME for the dilated extent (k - 1) * d + 1, or the
        explicit padding on every side."""
        if not self.same:
            (ph, pw) = self.padding
            return (ph, ph), (pw, pw)
        (kh, kw), (sh, sw), (dh, dw) = self.kernel_size, self.stride, self.dilation
        return (flax_same_pad(h, (kh - 1) * dh + 1, sh),
                flax_same_pad(w, (kw - 1) * dw + 1, sw))

    def band_halo(self) -> Tuple[int, int]:
        """The halo rows (top, bottom) this conv reads on a lat band whose
        rows are a multiple of the stride: Flax's SAME pad of any such
        lat, (k_dilated − stride) rows split as ``flax_same_pad`` splits
        them; with an explicit padding p, p above and the k_dilated −
        stride − p rows below that the band's last window reads."""
        if self.same:
            return self._rows_and_cols(self.stride[0], 1)[0]
        extent = (self.kernel_size[0] - 1) * self.dilation[0] + 1
        p = self.padding[0]
        return p, max(extent - self.stride[0] - p, 0)

    def forward_halo(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of a band grown by its halo rows (``band_halo``,
        NHWC): no row padding, the columns padded as off a band."""
        top, bottom = self.band_halo()
        _, (left, right) = self._rows_and_cols(x.shape[1] - top - bottom, x.shape[2])
        y = F.pad(x.permute(0, 3, 1, 2), (left, right))
        return F.conv2d(y, self.weight, self.bias, self.stride, 0, self.dilation,
                        self.groups).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if current_band() is not None:
            if x.shape[1] % self.stride[0]:
                raise ValueError(
                    f"a lat band of {x.shape[1]} rows does not split into the stride "
                    f"{self.stride[0]} of a {self.kernel_size} conv")
            return self.forward_halo(halo_rows(x, *self.band_halo()))
        y = x.permute(0, 3, 1, 2)
        if self.same:
            (top, bottom), (left, right) = self._rows_and_cols(x.shape[1], x.shape[2])
            if top or bottom or left or right:
                y = F.pad(y, (left, right, top, bottom))
        return super().forward(y).permute(0, 2, 3, 1)


class FlaxConvTranspose2d(nn.ConvTranspose2d):
    """A Flax ``nn.ConvTranspose`` (``padding="SAME"``,
    ``transpose_kernel=False``) on an NHWC tensor, for the one kind the
    zoo uses: kernel equal to stride, where the output is the input's
    size times the stride and y[s·i + r] = x[i] · w_flax[k − 1 − r] on
    each axis. The weight is torch's (in, out, kh, kw), which makes
    y[s·i + r] = x[i] · w[r]; ``convert.params_from_jax`` flips Flax's
    HWIO kernel in both spatial axes onto it. Another (kernel, stride)
    pair raises: its SAME padding is not worked out here."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int):
        if kernel != stride:
            raise ValueError(
                f"FlaxConvTranspose2d supports kernel == stride only (the zoo's "
                f"upsampling), got kernel {kernel}, stride {stride}")
        super().__init__(in_channels, out_channels, kernel, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout``: inverted dropout, each element kept with
    probability 1 − ``rate`` and scaled by 1 / (1 − rate). Active only
    when a generator is given (JAX's ``deterministic=False`` with a
    ``dropout`` rng), which must live on ``x``'s device; the keep mask is
    drawn from it, never from the global RNG. ``F.dropout`` takes no
    generator. On a lat band the mask is the whole grid's, cut to the
    band's run of axis 1 (NHWC rows, row-major tokens or windows)."""
    if generator is None or rate == 0.0:
        return x
    band = current_band()
    shape = list(x.shape)
    if band is not None:  # the whole grid's draw keeps every band's generator in step
        shape[1] *= band.count
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if band is not None:
        keep = band.cut(keep, 1)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth, the JAX package's ``DropPath``: ``dropout`` with
    one keep draw a sample, broadcast over every other axis (Flax's
    ``broadcast_dims``), survivors scaled by 1 / (1 − rate). Active only
    with a generator, drawn from it alone: the same draw on every band."""
    if generator is None or rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


GN_EPS = 1e-6  # flax nn.GroupNorm default; torch's is 1e-5
LN_EPS = 1e-6  # flax nn.LayerNorm default; torch's is 1e-5


class LayerNorm(nn.LayerNorm):
    """A Flax ``nn.LayerNorm`` over the last axis: eps 1e-6 (torch's is
    1e-5). On bf16, torch's layer_norm takes its statistics, scale and
    bias in fp32 and rounds the result once, as Flax's
    ``force_float32_reductions`` does. Its CPU backward, though, sums
    the scale and bias gradients over the rows in bf16 (12 % off at
    3,840 rows, where CUDA's sums in fp32): on a CPU tensor of another
    dtype than fp32 the norm runs in fp32, forward and backward, and
    rounds its output and the gradients once."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or x.device.type != "cpu":
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """A Flax ``nn.GroupNorm`` on an NHWC tensor: statistics over (H, W)
    and the channels of each group, eps 1e-6, scale and bias per channel
    (``weight``/``bias``; none when ``affine`` is off). Flax computes the
    variance as E[x²] − E[x]² and torch in two passes; both agree within
    the port's 1e-4 bar, so torch's ``group_norm`` runs as it is. On bf16
    it takes fp32 statistics and rounds once, as ``LayerNorm``.

    On a lat band the statistics span every band: fp32 sums of x and x²
    a (batch, group) over the band (``band_sums``), all-reduced over the
    band group, then Flax's E[x²] − E[x]² (``normalize``)."""

    def __init__(self, num_groups: int, num_channels: int, affine: bool = True):
        super().__init__(num_groups, num_channels, eps=GN_EPS, affine=affine)

    def band_sums(self, x: torch.Tensor) -> torch.Tensor:
        """(B, G, 2), in fp32 or wider: the sums of x and of x² over a
        band's rows, columns and each group's channels."""
        b, h, w, c = x.shape
        xg = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
            b, h * w, self.num_groups, c // self.num_groups)
        return torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], dim=-1)

    def normalize(self, x: torch.Tensor, sums: torch.Tensor, count: int) -> torch.Tensor:
        """x normalized with the statistics of ``sums`` (``band_sums``
        over every band) of ``count`` elements a (batch, group), in
        ``sums``' dtype, rounded once to x's."""
        b, h, w, c = x.shape
        mean = sums[..., 0] / count
        var = torch.clamp(sums[..., 1] / count - mean * mean, min=0.0)
        xg = x.to(sums.dtype).reshape(b, h * w, self.num_groups, c // self.num_groups)
        y = ((xg - mean[:, None, :, None]) * torch.rsqrt(var + self.eps)[:, None, :, None])
        y = y.reshape(b, h, w, c)
        if self.affine:
            y = y * self.weight.to(sums.dtype) + self.bias.to(sums.dtype)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        band = current_band()
        if band is not None:
            b, h, w, c = x.shape
            count = h * band.count * w * (c // self.num_groups)
            return self.normalize(x, band_all_reduce(self.band_sums(x), band), count)
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _gn(num_channels: int) -> GroupNorm:
    """GroupNorm with up to 8 groups, halved until they divide the
    channels (the zoo's default norm)."""
    groups = 8
    while groups > 1 and num_channels % groups != 0:
        groups //= 2
    return GroupNorm(groups, num_channels)


def norm_layer(name: str, features: int) -> GroupNorm:
    """The reference's ``norm_name`` setting as a stateless norm:
    'instance' is GroupNorm with a group a channel and no scale or bias
    (torch ``InstanceNorm2d``'s ``affine=False``), 'layer' one group,
    'group' ``_gn``. 'batch' raises, as in the JAX package: BatchNorm
    carries running statistics the zoo does not keep."""
    if name in ("instance", "INSTANCE"):
        return GroupNorm(features, features, affine=False)
    if name in ("layer", "LAYER"):
        return GroupNorm(1, features)
    if name in ("group", "GROUP"):
        return _gn(features)
    if name in ("batch", "BATCH"):
        raise ValueError(
            "norm_name 'batch' is unsupported: BatchNorm carries running "
            "statistics the zoo does not keep. Use 'instance', 'group' or "
            "'layer' (the reference's own default here is 'instance')."
        )
    raise ValueError(f"Unknown norm_name {name!r}; accepted: instance | group | layer")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


#: the zoo's activations by name; "GELU" is Flax's default tanh form
ACTIVATIONS: dict = {
    "Identity": _identity,
    "ReLU": F.relu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "SiLU": F.silu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    None: _identity,
    "null": _identity,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get_activation(name) -> Callable:
    if callable(name):
        return name
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {name!r}; known: {list(ACTIVATIONS)}")
    return ACTIVATIONS[name]
