"""Model registry and plugin discovery.

A name → class dict over the port's model zoo (every model of the JAX
package's: GraphLAM, HiLAM, HiLAMParallel, HalfUNet, UNet, CustomUNet,
DeepLabV3, DeepLabV3Plus, Segformer, SwinUNetR, UNetRPP), extended by
plugin discovery: any importable top-level module named
``py4cast_tpu_torch_plugin_*`` contributes its ``ModelBase`` subclasses
with ``register = True`` (``py4cast_tpu_torch_plugin_example.py``'s
``Identity``). The JAX package's plugins (``py4cast_tpu_plugin_*``) are
Flax modules and are not scanned here.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import traceback
import warnings
from typing import Optional, Tuple

from py4cast_tpu_torch.models.base import ModelBase, ModelType, settings_from_dict
from py4cast_tpu_torch.models.deeplab import DeepLabV3, DeepLabV3Plus
from py4cast_tpu_torch.models.graph import GraphLAM, HiLAM, HiLAMParallel
from py4cast_tpu_torch.models.segformer import Segformer
from py4cast_tpu_torch.models.swin import SwinUNetR
from py4cast_tpu_torch.models.unet import CustomUNet, HalfUNet, UNet
from py4cast_tpu_torch.models.unetrpp import UNetRPP

PLUGIN_PREFIX = "py4cast_tpu_torch_plugin_"

registry: dict = {"GraphLAM": GraphLAM, "HiLAM": HiLAM, "HiLAMParallel": HiLAMParallel,
                  "HalfUNet": HalfUNet, "UNet": UNet, "CustomUNet": CustomUNet,
                  "DeepLabV3": DeepLabV3, "DeepLabV3Plus": DeepLabV3Plus,
                  "Segformer": Segformer, "SwinUNetR": SwinUNetR, "UNetRPP": UNetRPP}


def _discover_plugins() -> None:
    """Register the ``ModelBase`` subclasses with ``register = True`` of
    every top-level ``py4cast_tpu_torch_plugin_*`` module. A module that
    fails to import warns; a name already registered by another class
    raises ValueError."""
    for _, name, _ in pkgutil.iter_modules():
        if not name.startswith(PLUGIN_PREFIX):
            continue
        try:
            mod = importlib.import_module(name)
        except ImportError:
            warnings.warn(f"Could not import plugin {name}:\n{traceback.format_exc(limit=2)}")
            continue
        for _, kls in inspect.getmembers(mod, inspect.isclass):
            if issubclass(kls, ModelBase) and kls is not ModelBase and kls.register:
                if registry.get(kls.__name__, kls) is not kls:
                    raise ValueError(f"Plugin model name collision: {kls.__name__} from {name} "
                                     "already registered")
                registry[kls.__name__] = kls


_discover_plugins()

all_nn_architectures = tuple(registry)


def get_model_kls_and_settings(model_name: str, settings_init_args: Optional[dict] = None):
    lookup = {k.lower(): v for k, v in registry.items()}
    kls = lookup.get(model_name.lower())
    if kls is None:
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
