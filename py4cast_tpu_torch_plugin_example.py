"""Example model plugin of the PyTorch port: proves the plugin discovery
path.

Any importable top-level module named ``py4cast_tpu_torch_plugin_*`` is
scanned for ``ModelBase`` subclasses with ``register = True``
(``py4cast_tpu_torch.models._discover_plugins``), so

    python -m py4cast_tpu_torch fit ... --model.model_name Identity

trains this model. The JAX package's own example,
``py4cast_tpu_plugin_example.py``, is a Flax module its registry finds.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from py4cast_tpu_torch.models.base import ModelBase, ModelType


@dataclass(frozen=True)
class IdentitySettings:
    scale: float = 1.0


class Identity(ModelBase):
    """Projects input features to output features with a single linear
    layer (Flax's ``Dense_0``) times ``scale``: the smallest model that
    satisfies the contract."""

    settings_kls = IdentitySettings
    model_type = ModelType.CONVOLUTIONAL
    register = True
    #: a Dense a grid point: each lat band's own
    spatial_shardable = True

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape, settings: IdentitySettings = IdentitySettings()):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        self.Dense_0 = nn.Linear(num_input_features, num_output_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x) * self.settings.scale
