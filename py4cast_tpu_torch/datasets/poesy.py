"""Poesy dataset accessor: PEARO ensemble reforecast (16 members,
leadtimes +1..+45h) stored as memory-mapped npy arrays indexed
(lat, lon, leadtime, member).

A copy of the JAX package's ``py4cast_tpu/datasets/poesy.py`` on the
same tree. Members are sample entries; a sample reads its slices of the
memory map, never a whole file.
"""

from __future__ import annotations

import datetime as dt
from pathlib import Path
from typing import List, Union

import numpy as np

from py4cast_tpu_torch.datasets.access import (
    DataAccessor,
    Grid,
    GridConfig,
    ParamConfig,
    Timestamps,
    WeatherParam,
)
from py4cast_tpu_torch.settings import CACHE_DIR, POESY_PATH

OROGRAPHY_FNAME = "PEARO_EURW1S40_Orography_crop.npy"
LATLON_FNAME = "latlon_crop.npy"
#: (lon, lat, leadtimes, members)
DATA_SHAPE = (600, 600, 45, 16)
TERMS = {"start": 1, "end": 45, "timestep": 1}
MEMBERS = list(range(16))

WEATHER_PARAMS = {
    "t2m": {
        "grid": "EURW1S40", "levels": [2], "level_type": "heightAboveGround",
        "unit": "K", "long_name": "PEARO 2-meters temperature", "file_name": "t2m",
    },
    "u10": {
        "grid": "EURW1S40", "levels": [10], "level_type": "heightAboveGround",
        "unit": "m * s**-1", "long_name": "PEARO 10-meters U component of wind",
        "file_name": "u",
    },
    "v10": {
        "grid": "EURW1S40", "levels": [10], "level_type": "heightAboveGround",
        "unit": "m * s**-1", "long_name": "PEARO 10-meters V component of wind",
        "file_name": "v",
    },
    "tirf": {
        "grid": "EURW1S40", "levels": [0], "level_type": "surface",
        "unit": "kg m**-2", "long_name": "PEARO rainfall", "file_name": "tirf",
    },
}


class PoesyAccessor(DataAccessor):
    def cache_dir(self, name: str, grid: Grid) -> Path:
        path = CACHE_DIR / f"{name}_{grid.name}"
        path.mkdir(parents=True, exist_ok=True)
        return path

    @staticmethod
    def get_dataset_path(name: str, grid: Grid) -> Path:
        return POESY_PATH

    @staticmethod
    def get_weight_per_level(level: int, level_type: str) -> float:
        if level_type == "isobaricInHpa":
            return 1.0 + level / 90.0
        if level_type == "heightAboveGround":
            return 2.0
        if level_type == "surface":
            return 1.0
        raise Exception(f"unknown level_type:{level_type}")

    @staticmethod
    def load_grid_info(name: str) -> GridConfig:
        """Orography + latlon from companion npy files; land-sea mask
        derived from orography."""
        geopotential = np.load(POESY_PATH / OROGRAPHY_FNAME)
        latlon = np.load(POESY_PATH / LATLON_FNAME)
        return GridConfig(
            full_size=geopotential.shape,
            latitude=latlon[1, :, 0],
            longitude=latlon[0, 0],
            geopotential=geopotential,
            landsea_mask=np.where(geopotential > 0, 1.0, 0.0).astype(np.float32),
        )

    @staticmethod
    def load_param_info(name: str) -> ParamConfig:
        info = WEATHER_PARAMS[name]
        return ParamConfig(
            unit=info["unit"],
            level_type=info["level_type"],
            long_name=info["long_name"],
            grid=info["grid"],
            grib_name=None,
            grib_param=None,
        )

    @staticmethod
    def get_grid_coords(param: WeatherParam) -> List[float]:
        raise NotImplementedError("Poesy does not require get_grid_coords")

    @classmethod
    def get_filepath(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> Path:
        date = (
            timestamps.datetime
            if isinstance(timestamps, Timestamps)
            else timestamps
        )
        var_file = WEATHER_PARAMS[param.name]["file_name"]
        return (
            POESY_PATH
            / f"{date.strftime('%Y-%m-%dT%H:%M:%SZ')}_{var_file}_lt1-45_crop.npy"
        )

    @classmethod
    def load_data_from_disk(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npy",
    ) -> np.ndarray:
        """Memory-mapped indexing (lat, lon, leadtime, member) → (T, lat,
        lon, 1): only the requested slices are read."""
        data = np.load(cls.get_filepath(dataset_name, param, timestamps),
                       mmap_mode="r")
        sub = param.grid.subdomain
        lt_idx = (
            np.array(timestamps.timedeltas) / dt.timedelta(hours=1)
        ).astype(int) - 1
        arr = data[sub[0] : sub[1], sub[2] : sub[3], lt_idx, member].transpose(
            [2, 0, 1]
        )
        return np.expand_dims(arr, -1)

    def exists(
        self,
        ds_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> bool:
        return self.get_filepath(ds_name, param, timestamps).exists()

    @staticmethod
    def optional_check_before_exists(
        t0: dt.datetime,
        num_input_steps: int,
        num_pred_steps: int,
        pred_step: dt.timedelta,
        leadtime: Union[dt.timedelta, None],
    ) -> bool:
        """Prune samples whose window exceeds the +1..+45h leadtime range."""
        validtime = t0 + leadtime
        min_validtime = validtime - (num_input_steps - 1) * pred_step
        max_validtime = validtime + num_pred_steps * pred_step
        if min_validtime - t0 < dt.timedelta(hours=TERMS["start"]):
            return False
        if max_validtime - t0 > dt.timedelta(hours=TERMS["end"]):
            return False
        return True

    @staticmethod
    def parameter_namer(param: WeatherParam) -> str:
        return f"{param.name}_{param.level}_{param.level_type}"

    @classmethod
    def default_config(cls) -> dict:
        return {
            "periods": {
                "train": {
                    "start": 20210101, "end": 20210531,
                    "refcst_daily_runs": [0, 43200],
                    "refcst_leadtime_start_in_sec": 3600,
                    "refcst_leadtime_end_in_sec": 162000,
                    "refcst_leadtime_step_in_sec": 3600,
                },
                "valid": {
                    "start": 20210601, "end": 20210615,
                    "refcst_daily_runs": [0, 43200],
                    "refcst_leadtime_start_in_sec": 3600,
                    "refcst_leadtime_end_in_sec": 162000,
                    "refcst_leadtime_step_in_sec": 3600,
                },
                "test": {
                    "start": 20210616, "end": 20210630,
                    "refcst_daily_runs": [0, 43200],
                    "refcst_leadtime_start_in_sec": 3600,
                    "refcst_leadtime_end_in_sec": 162000,
                    "refcst_leadtime_step_in_sec": 3600,
                },
            },
            "grid": {"name": "EURW1S40", "border_size": 10},
            "settings": {"standardize": True, "file_format": "npy"},
            "members": MEMBERS,
            "params": {
                "t2m": {"levels": [2], "kind": "input_output"},
                "u10": {"levels": [10], "kind": "input_output"},
                "v10": {"levels": [10], "kind": "input_output"},
            },
        }
