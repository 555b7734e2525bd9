"""Model registry.

GraphLAM, HiLAM, HiLAMParallel, HalfUNet, UNet, CustomUNet, DeepLabV3,
DeepLabV3Plus, Segformer and UNetRPP are ported so far. The other names of the JAX package's zoo are known
here, so that asking for one says it is not ported yet instead of that
it does not exist.
"""

from __future__ import annotations

from typing import Optional, Tuple

from py4cast_tpu_torch.models.base import ModelBase, ModelType, settings_from_dict
from py4cast_tpu_torch.models.deeplab import DeepLabV3, DeepLabV3Plus
from py4cast_tpu_torch.models.graph import GraphLAM, HiLAM, HiLAMParallel
from py4cast_tpu_torch.models.segformer import Segformer
from py4cast_tpu_torch.models.unet import CustomUNet, HalfUNet, UNet
from py4cast_tpu_torch.models.unetrpp import UNetRPP

registry: dict = {"GraphLAM": GraphLAM, "HiLAM": HiLAM, "HiLAMParallel": HiLAMParallel,
                  "HalfUNet": HalfUNet, "UNet": UNet, "CustomUNet": CustomUNet,
                  "DeepLabV3": DeepLabV3, "DeepLabV3Plus": DeepLabV3Plus,
                  "Segformer": Segformer, "UNetRPP": UNetRPP}

#: models of the JAX package the port does not have yet (ROADMAP.md, queue 1)
NOT_YET_PORTED = ("SwinUNetR",)

all_nn_architectures = tuple(registry)


def get_model_kls_and_settings(model_name: str, settings_init_args: Optional[dict] = None):
    lookup = {k.lower(): v for k, v in registry.items()}
    kls = lookup.get(model_name.lower())
    if kls is None:
        if model_name.lower() in {n.lower() for n in NOT_YET_PORTED}:
            raise ValueError(
                f"Model {model_name} is not yet ported to py4cast_tpu_torch "
                f"(ROADMAP.md, queue 1); ported: {sorted(registry)}"
            )
        raise ValueError(
            f"Model {model_name} not found in registry; available: {sorted(registry)}"
        )
    return kls, settings_from_dict(kls.settings_kls, settings_init_args)


def build_model_from_settings(
    model_name: str,
    num_input_features: int,
    num_output_features: int,
    settings,
    input_shape: Tuple[int, ...],
    **extra,
) -> ModelBase:
    kls, _ = get_model_kls_and_settings(model_name)
    if len(input_shape) not in kls.supported_num_spatial_dims:
        raise ValueError(
            f"{model_name} supports spatial ranks {kls.supported_num_spatial_dims}, "
            f"got input_shape={input_shape}"
        )
    return kls(
        num_input_features=num_input_features,
        num_output_features=num_output_features,
        input_shape=tuple(input_shape),
        settings=settings,
        **extra,
    )


__all__ = [
    "ModelBase",
    "ModelType",
    "registry",
    "all_nn_architectures",
    "get_model_kls_and_settings",
    "build_model_from_settings",
    "settings_from_dict",
]
