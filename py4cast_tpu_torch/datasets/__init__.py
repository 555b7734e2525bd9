"""Dataset registry and entry point.

Only the Dummy dataset is ported so far; the other accessors of the
JAX package are named here so that asking for one says where it stands.
"""

from pathlib import Path
from typing import Dict, Optional, Tuple

from py4cast_tpu_torch.datasets.base import WeatherDataset
from py4cast_tpu_torch.datasets.dummy import DummyAccessor
from py4cast_tpu_torch.utils import merge_dicts

registry: Dict[str, type] = {"dummy": DummyAccessor}

#: accessors of the JAX package the port does not have yet
NOT_YET_PORTED = ("titan", "poesy", "rainfall")


def get_accessor(name: str) -> type:
    """Look up an accessor class whose registered key is a substring of name."""
    for key, kls in registry.items():
        if key in name.lower():
            return kls
    for key in NOT_YET_PORTED:
        if key in name.lower():
            raise NotImplementedError(
                f"The {key} accessor is not ported to py4cast_tpu_torch yet "
                "(ROADMAP.md, queue 1: the remaining datasets); only "
                f"{list(registry)} is available"
            )
    raise ValueError(f"Dataset {name} not found in registry, available: {list(registry)}")


def get_datasets(
    name: str,
    num_input_steps: int,
    num_pred_steps_train: int,
    num_pred_steps_val_test: int,
    dataset_conf: Optional[dict] = None,
    config_override: Optional[dict] = None,
) -> Tuple[WeatherDataset, WeatherDataset, WeatherDataset]:
    """Build the (train, valid, test) datasets for the named dataset."""
    accessor_kls = get_accessor(name)
    if dataset_conf is None:
        dataset_conf = accessor_kls.default_config()
    elif isinstance(dataset_conf, (str, Path)):
        return WeatherDataset.from_json(
            accessor_kls,
            Path(dataset_conf),
            num_input_steps,
            num_pred_steps_train,
            num_pred_steps_val_test,
            config_override,
        )
    if config_override is not None:
        dataset_conf = merge_dicts(dataset_conf, config_override)
    return WeatherDataset.from_dict(
        accessor_kls,
        name,
        dataset_conf,
        num_input_steps,
        num_pred_steps_train,
        num_pred_steps_val_test,
    )
