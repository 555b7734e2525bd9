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
