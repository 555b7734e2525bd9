"""Rainfall dataset accessor: radar "lame d'eau" water depth, 1536×1536
Stereographic grid, 5-minute step, stored as per-timestamp npz files.

A copy of the JAX package's ``py4cast_tpu/datasets/rainfall.py`` on the
same tree. Values are converted from mm/100 per 5 min to mm/h and the
latitude flipped on load, so the files are not read raw:
``file_paths_for`` stays None and the fused batch read never takes them.
"""

from __future__ import annotations

import datetime as dt
from pathlib import Path
from typing import List

import numpy as np

from py4cast_tpu_torch.datasets.access import (
    DataAccessor,
    Grid,
    GridConfig,
    ParamConfig,
    Timestamps,
    WeatherParam,
)
from py4cast_tpu_torch.settings import RAINFALL_PATH

FORMATSTR = "%Y%m%d%H%M"
#: Stereographic(central_latitude=45) corner points of the radar mosaic
DOMAIN = {
    "upper_left": (-9.965, 53.670),
    "lower_right": (10.259217, 39.46785),
    "upper_right": (14.564706, 53.071644),
    "lower_left": (-6.977881, 39.852361),
}


def domain_to_extent(domain: dict):
    """Project the corner points to the Stereographic plane; the raw
    lon/lat extent without cartopy."""
    try:
        from cartopy.crs import PlateCarree, Stereographic

        crs = Stereographic(central_latitude=45)
        lower_right = crs.transform_point(*domain["lower_right"], PlateCarree())
        upper_right = crs.transform_point(*domain["upper_right"], PlateCarree())
        lower_left = crs.transform_point(*domain["lower_left"], PlateCarree())
        return (lower_left[0], lower_right[0], lower_left[1], upper_right[1])
    except ImportError:
        return (
            domain["lower_left"][0],
            domain["lower_right"][0],
            domain["lower_right"][1],
            domain["upper_left"][1],
        )


class RainfallAccessor(DataAccessor):
    @staticmethod
    def get_weight_per_level(level: int, level_type: str) -> float:
        return 1.0

    @staticmethod
    def load_grid_info(name: str) -> GridConfig:
        shape = (1536, 1536)
        startlon, endlon, endlat, startlat = domain_to_extent(DOMAIN)
        return GridConfig(
            full_size=shape,
            latitude=np.linspace(startlat, endlat, shape[0]),
            longitude=np.linspace(startlon, endlon, shape[1]),
            geopotential=np.ones(shape),
            landsea_mask=None,
        )

    @staticmethod
    def get_grid_coords(param: WeatherParam) -> List[float]:
        return [51.5, 41.0, -6.0, 10.5]

    @staticmethod
    def load_param_info(name: str = "precip") -> ParamConfig:
        if name != "precip":
            raise NotImplementedError("Param must be in ['precip'].")
        return ParamConfig(
            unit="mm/h",
            level_type="surface",
            long_name="lame d'eau Serval",
            grid=name,
            grib_name=None,
            grib_param="prec",
        )

    def cache_dir(self, name: str, grid: Grid) -> Path:
        path = self.get_dataset_path(name, grid)
        path.mkdir(parents=True, exist_ok=True)
        return path

    @staticmethod
    def get_dataset_path(name: str, grid: Grid) -> Path:
        return RAINFALL_PATH / "cache"

    @classmethod
    def _date_filepath(cls, date: dt.datetime, file_format: str = "npz") -> Path:
        return (
            RAINFALL_PATH
            / "Hexagone"
            / f"{date.year}"
            / f"{date.strftime(FORMATSTR)}.{file_format}"
        )

    @classmethod
    def get_filepath(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npz",
    ) -> Path:
        return cls._date_filepath(timestamps.validity_times[0], file_format)

    @classmethod
    def load_data_from_disk(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npz",
    ) -> np.ndarray:
        arr_list = []
        for date in timestamps.validity_times:
            path = cls._date_filepath(date, file_format)
            arr = np.load(path)["arr_0"]
            arr = np.where(arr < 0, 0, arr)  # 0 outside the radar field
            arr = arr / 100.0 * 12.0  # mm/100 per 5 min → mm/h
            arr_list.append(arr[::-1][..., None])
        full = np.stack(arr_list)
        sub = param.grid.subdomain
        return full[:, sub[0] : sub[1], sub[2] : sub[3]]

    def exists(
        self,
        ds_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npz",
    ) -> bool:
        return all(
            self._date_filepath(date, file_format).exists()
            for date in timestamps.validity_times
        )

    @staticmethod
    def parameter_namer(param: WeatherParam) -> str:
        return param.name

    @classmethod
    def default_config(cls) -> dict:
        return {
            "periods": {
                "train": {"start": 20230101, "end": 20230531, "obs_step": 300},
                "valid": {"start": 20230601, "end": 20230615, "obs_step": 300},
                "test": {"start": 20230616, "end": 20230630, "obs_step": 300},
            },
            "grid": {"name": "rainfall_1536", "border_size": 10},
            "settings": {"standardize": True, "file_format": "npz"},
            "params": {"precip": {"levels": [0], "kind": "input_output"}},
        }
