"""DeepLabV3 and DeepLabV3Plus on the ResNet encoder of ``models/unet.py``
(reference settings: config/CLI/model/deeplabv3.yaml, deeplabv3plus.yaml).

Submodules carry Flax's auto names: ``ASPP_0`` with its 1x1 branch
``Conv_0``, dilated branches ``Conv_1..``, pooled branch and projection
after them, and ``GroupNorm_0``; DeepLabV3's head ``Conv_0``;
DeepLabV3Plus's low-level ``Conv_0``/``GroupNorm_0``, fused
``Conv_1``/``GroupNorm_1`` and head ``Conv_2``. No hand kernel runs here:
cuDNN runs the convolutions, the atrous ones through ``FlaxConv2d``'s
SAME padding of the dilated extent, which at rates 12/24/36 is larger
than the deepest map (16x20 at 512x640). On a lat band those branches
take halos deeper than a band from every band they span
(``parallel.spatial.halo_rows``), the image-level mean is the bands'
summed sums, and the bilinear growths are whole-factor growths on a
clamped halo row a side."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.models.base import (
    FlaxConv2d,
    ModelBase,
    ModelType,
    _gn,
    crop_to,
    get_activation,
    pad_to_multiple,
)
from py4cast_tpu_torch.models.unet import ResNetEncoder, _bilinear_resize
from py4cast_tpu_torch.parallel.spatial import band_all_reduce, current_band


@dataclass(frozen=True)
class DeepLabSettings:
    encoder_name: str = "resnet18"
    encoder_depth: int = 5
    # False | True | npz path — see models/pretrained.py
    encoder_weights: object = False
    encoder_norm: str = "group"
    decoder_channels: int = 256
    activation: Optional[str] = None
    upsampling: int = 8
    aux_params: Optional[dict] = None
    atrous_rates: Tuple[int, ...] = (12, 24, 36)

    def __post_init__(self):
        if self.aux_params is not None:
            # smp's auxiliary classification head has no meaning for
            # field regression: refuse it rather than ignore it
            raise ValueError(
                "aux_params (an auxiliary classification head) is not "
                "supported: this framework predicts weather fields, not "
                "classes. Remove aux_params from the model settings.")


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, a dilated 3x3 branch
    a rate, and an image-level branch (the mean over the map, a 1x1 conv,
    broadcast back), concatenated, projected 1x1, GroupNorm, ReLU. No
    conv has a bias. On a lat band the image-level mean is every band's
    fp32 sum, all-reduced, over the whole map's count (``_map_mean``)."""

    def __init__(self, in_channels: int, features: int, rates: Tuple[int, ...]):
        super().__init__()
        self.num_rates = len(rates)
        self.Conv_0 = FlaxConv2d(in_channels, features, 1, bias=False)
        for i, r in enumerate(rates):
            self.add_module(f"Conv_{i + 1}",
                            FlaxConv2d(in_channels, features, 3, bias=False, dilation=r))
        n = len(rates) + 1
        self.add_module(f"Conv_{n}", FlaxConv2d(in_channels, features, 1, bias=False))
        self.add_module(f"Conv_{n + 1}",
                        FlaxConv2d(features * (n + 1), features, 1, bias=False))
        self.GroupNorm_0 = _gn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_rates + 1
        branches = [getattr(self, f"Conv_{i}")(x) for i in range(n)]
        pooled = getattr(self, f"Conv_{n}")(_map_mean(x))
        branches.append(pooled.expand(-1, x.shape[1], x.shape[2], -1))
        y = getattr(self, f"Conv_{n + 1}")(torch.cat(branches, dim=-1))
        return F.relu(self.GroupNorm_0(y))


def _map_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of NHWC ``x`` over (lat, lon), keeping both dims. On a lat
    band: the band's sum in fp32 or wider (as one process sums a bf16 map),
    all-reduced over the bands, over the whole map's count, rounded once
    to ``x``'s dtype."""
    band = current_band()
    if band is None:
        return x.mean(dim=(1, 2), keepdim=True)
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    total = band_all_reduce(wide.sum(dim=(1, 2), keepdim=True), band)
    return (total / (x.shape[1] * band.count * x.shape[2])).to(x.dtype)


class _DeepLabBase(ModelBase):
    settings_kls = DeepLabSettings
    model_type = ModelType.CONVOLUTIONAL
    spatial_shardable = True

    @classmethod
    def spatial_lat_multiple(cls, settings) -> int:
        return 2 ** settings.encoder_depth

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: DeepLabSettings = DeepLabSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        s = settings
        self.encoder = ResNetEncoder(num_input_features, s.encoder_name, s.encoder_depth,
                                     norm=s.encoder_norm)
        self.ASPP_0 = ASPP(self.encoder.channels[-1], s.decoder_channels, s.atrous_rates)
        self.activation = get_activation(s.activation)

    def load_pretrained(self, params):
        """``params`` with the pretrained encoder loaded per
        ``settings.encoder_weights`` (the trainer calls it after init)."""
        from py4cast_tpu_torch.models.pretrained import maybe_load_encoder

        return maybe_load_encoder(params, self.settings, self.num_input_features)


class DeepLabV3(_DeepLabBase):
    """The encoder (always padded to a multiple of 2^depth), ASPP on its
    deepest map, a 1x1 head, a bilinear resize to the padded input, crop,
    activation."""

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: DeepLabSettings = DeepLabSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        self.Conv_0 = FlaxConv2d(settings.decoder_channels, num_output_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, hw = pad_to_multiple(x, 2 ** self.settings.encoder_depth)
        y = self.Conv_0(self.ASPP_0(self.encoder(x)[-1]))
        y = _bilinear_resize(y, x.shape[1], x.shape[2])
        return self.activation(crop_to(y, hw))


class DeepLabV3Plus(_DeepLabBase):
    """DeepLabV3 with a low-level skip: the stride-4 map through a 1x1
    conv to 48 channels, GroupNorm and ReLU, concatenated with the ASPP
    output resized to it, then a 3x3 conv, GroupNorm, ReLU and the 1x1
    head before the resize to the input."""

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: DeepLabSettings = DeepLabSettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        d = settings.decoder_channels
        self.Conv_0 = FlaxConv2d(self.encoder.channels[1], 48, 1, bias=False)
        self.GroupNorm_0 = _gn(48)
        self.Conv_1 = FlaxConv2d(d + 48, d, 3, bias=False)
        self.GroupNorm_1 = _gn(d)
        self.Conv_2 = FlaxConv2d(d, num_output_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, hw = pad_to_multiple(x, 2 ** self.settings.encoder_depth)
        feats = self.encoder(x)
        y = self.ASPP_0(feats[-1])
        low = F.relu(self.GroupNorm_0(self.Conv_0(feats[1])))  # the stride-4 map
        y = _bilinear_resize(y, low.shape[1], low.shape[2])
        y = F.relu(self.GroupNorm_1(self.Conv_1(torch.cat([y, low], dim=-1))))
        y = _bilinear_resize(self.Conv_2(y), x.shape[1], x.shape[2])
        return self.activation(crop_to(y, hw))
