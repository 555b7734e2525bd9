"""Dataset registry and entry point: Dummy, Titan, Poesy and Rainfall,
looked up by a registered key that is a substring of the dataset's name
(``titan_aro_arp`` finds Titan)."""

from pathlib import Path
from typing import Dict, Optional, Tuple

from py4cast_tpu_torch.datasets.base import WeatherDataset
from py4cast_tpu_torch.datasets.dummy import DummyAccessor
from py4cast_tpu_torch.datasets.poesy import PoesyAccessor
from py4cast_tpu_torch.datasets.rainfall import RainfallAccessor
from py4cast_tpu_torch.datasets.titan import TitanAccessor
from py4cast_tpu_torch.utils import merge_dicts

registry: Dict[str, type] = {
    "dummy": DummyAccessor,
    "titan": TitanAccessor,
    "poesy": PoesyAccessor,
    "rainfall": RainfallAccessor,
}


def get_accessor(name: str) -> type:
    """Look up an accessor class whose registered key is a substring of name."""
    for key, kls in registry.items():
        if key in name.lower():
            return kls
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
