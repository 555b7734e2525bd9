"""Dummy dataset: random 64x64 data, auto-created stats.

The fake backend that drives the port end to end. Its data file is
bit-identical to the JAX package's (same generator, seed, shape and
cache path), so both packages read the same samples.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import List

import numpy as np

from py4cast_tpu_torch.datasets.access import (
    DataAccessor,
    Grid,
    GridConfig,
    ParamConfig,
    Stats,
    Timestamps,
    WeatherParam,
)
from py4cast_tpu_torch.settings import CACHE_DIR

PARAM_NAME = "dummy_parameter_500_isobaricInhPa"

#: serializes first-touch data creation across the threaded loader's
#: workers (np.save is not atomic)
_CREATE_LOCK = threading.Lock()


def _random_fields(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.standard_normal((n, 64, 64, 1)).clip(-3, 3).astype(np.float32)


class DummyAccessor(DataAccessor):
    def cache_dir(self, name: str, grid: Grid) -> Path:
        path = CACHE_DIR / f"{name}_{grid.name}"
        os.makedirs(path, exist_ok=True)
        # stats for every level a config may request
        levels = (500, 700, 850, 1000)
        names = [f"dummy_parameter_{lv}_isobaricInhPa" for lv in levels]
        with _CREATE_LOCK:
            if not (path / "parameters_stats.json").exists():
                Stats(
                    stats={
                        n: {"mean": 0.0, "std": 1.0, "max": 3.0, "min": -3.0}
                        for n in names
                    }
                ).save(path / "parameters_stats.json")
            if not (path / "diff_stats.json").exists():
                Stats(stats={n: {"mean": 0.0, "std": 1.42} for n in names}).save(
                    path / "diff_stats.json"
                )
        return path

    @classmethod
    def default_config(cls) -> dict:
        return {
            "grid": {"name": "dummygrid", "border_size": 10},
            "params": {"dummy_parameter": {"levels": [500], "kind": "input_output"}},
            "settings": {"standardize": True, "file_format": "npy"},
            "periods": {
                "train": {"start": 20230101, "end": 20230103, "obs_step": 3600},
                "valid": {"start": 20230104, "end": 20230104, "obs_step": 3600},
                "test": {"start": 20230105, "end": 20230105, "obs_step": 3600},
            },
        }

    @staticmethod
    def get_dataset_path(name: str, grid: Grid) -> Path:
        path = CACHE_DIR / f"{name}_{grid.name}"
        os.makedirs(path, exist_ok=True)
        return path

    @staticmethod
    def get_weight_per_level(level: int, level_type: str) -> float:
        return 1.0

    @staticmethod
    def load_grid_info(name: str) -> GridConfig:
        lat = (np.arange(64) - 16) * 0.5
        lon = (np.arange(64) + 30) * 0.5
        return GridConfig(
            full_size=(64, 64),
            latitude=lat,
            longitude=lon,
            geopotential=np.ones((64, 64)),
            landsea_mask=None,
        )

    @staticmethod
    def get_grid_coords(param: WeatherParam) -> List[float]:
        return [-8.0, 24.0, 15.0, 47.0]

    @staticmethod
    def load_param_info(name: str) -> ParamConfig:
        return ParamConfig(
            unit="adimensional",
            level_type="isobaricInhPa",
            long_name="dummy_parameter",
            grid="dummygrid",
            grib_name=None,
            grib_param=None,
        )

    @classmethod
    def get_filepath(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> Path:
        fpath = cls.get_dataset_path(dataset_name, param.grid) / "dummy_data.npy"
        if not fpath.exists():
            with _CREATE_LOCK:
                if not fpath.exists():
                    arr = _random_fields(len(timestamps.timedeltas))
                    # write-then-rename: concurrent processes must never
                    # observe a half-written file
                    tmp = fpath.with_suffix(f".tmp{os.getpid()}.npy")
                    np.save(tmp, arr)
                    os.replace(tmp, fpath)
        return fpath

    @classmethod
    def load_data_from_disk(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npy",
    ) -> np.ndarray:
        arr = np.load(cls.get_filepath(dataset_name, param, timestamps))
        n = len(timestamps.timedeltas)
        if arr.shape[0] < n:  # regenerate if a larger window is requested
            arr = _random_fields(n)
        return arr[:n]

    def exists(
        self,
        ds_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> bool:
        return True
