"""Titan dataset accessor: AROME/ARPEGE reanalysis over France, 1h step.

A copy of the JAX package's ``py4cast_tpu/datasets/titan/__init__.py``
on the same tree: per-(date, param) npy files under
``<TITAN_PATH>/subdatasets/<name>_<grid>_<subdomain>/data/<date>/<param>.npy``,
read through the parallel batch reader (``native.py``), with a
grib → npy ``prepare`` path that needs xarray and cfgrib. Regridding
ARPEGE → AROME resizes on the host with ``torch.nn.functional.interpolate``
(bilinear, half-pixel centres), as ``jax.image.resize(..., "linear")``
does.
"""

from __future__ import annotations

import datetime as dt
import warnings
from functools import lru_cache
from pathlib import Path
from typing import Callable, List, Literal

import numpy as np

from py4cast_tpu_torch.datasets.access import (
    DataAccessor,
    Grid,
    GridConfig,
    ParamConfig,
    Timestamps,
    WeatherParam,
)
from py4cast_tpu_torch.datasets.titan.metadata import GRIDS, WEATHER_PARAMS
from py4cast_tpu_torch.settings import TITAN_PATH

FORMATSTR = "%Y-%m-%d_%Hh%M"


def _grid_latlon(name: str):
    """lat/lon 1-D axes derived from the grid's extent and size (the
    accessor reads the conf grib instead when it is there)."""
    g = GRIDS[name]
    lat_max, lat_min, lon_min, lon_max = g["extent"]
    nlat, nlon = g["size"]
    lats = np.linspace(lat_max, lat_min, nlat)
    lons = np.linspace(lon_min, lon_max, nlon)
    return lats, lons


class TitanAccessor(DataAccessor):
    @staticmethod
    def get_weight_per_level(level: int, level_type: str) -> float:
        if level_type == "isobaricInhPa":
            return 1.0 + level / 1000.0
        return 2.0

    # ------------------------------------------------------------------ grid
    @staticmethod
    def load_grid_info(name: str) -> GridConfig:
        if name not in ["PAAROME_1S100", "PAAROME_1S40"]:
            raise NotImplementedError(
                "Grid must be in ['PAAROME_1S100', 'PAAROME_1S40']"
            )
        conf_grib = TITAN_PATH / f"conf_{name}.grib"
        if conf_grib.exists():
            try:
                import xarray as xr

                ds = xr.open_dataset(conf_grib)
                return GridConfig(
                    tuple(GRIDS[name]["size"]),
                    ds.latitude.values,
                    ds.longitude.values,
                    ds.h.values,
                    None,
                )
            except (ImportError, ValueError, OSError) as e:
                warnings.warn(f"Could not read {conf_grib}: {e}; deriving grid")
        lats, lons = _grid_latlon(name)
        return GridConfig(
            tuple(GRIDS[name]["size"]),
            lats,
            lons,
            np.zeros(GRIDS[name]["size"], np.float32),  # geopotential fallback
            None,
        )

    @staticmethod
    def get_grid_coords(param: WeatherParam) -> List[float]:
        return list(GRIDS[param.grid.name]["extent"])

    # ---------------------------------------------------------------- params
    @staticmethod
    def load_param_info(name: str) -> ParamConfig:
        info = WEATHER_PARAMS[name]
        return ParamConfig(
            unit=info["unit"],
            level_type=info["type_level"],
            long_name=info["long_name"],
            grid=info["grid"],
            grib_name=info["grib"],
            grib_param=info["param"],
        )

    # --------------------------------------------------------------- loading
    def cache_dir(self, name: str, grid: Grid) -> Path:
        return self.get_dataset_path(name, grid)

    @staticmethod
    def get_dataset_path(name: str, grid: Grid) -> Path:
        subdomain = "-".join(str(i) for i in grid.subdomain)
        return TITAN_PATH / "subdatasets" / f"{name}_{grid.name}_{subdomain}"

    @classmethod
    def _date_filepath(
        cls, ds_name: str, param: WeatherParam, date: dt.datetime, file_format: str
    ) -> Path:
        if file_format == "grib":
            return TITAN_PATH / "grib" / date.strftime(FORMATSTR) / param.grib_name
        return (
            cls.get_dataset_path(ds_name, param.grid)
            / "data"
            / date.strftime(FORMATSTR)
            / f"{cls.parameter_namer(param)}.npy"
        )

    @classmethod
    def get_filepath(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> Path:
        return cls._date_filepath(
            dataset_name, param, timestamps.validity_times[0], file_format
        )

    @classmethod
    def load_data_for_date(
        cls,
        ds_name: str,
        param: WeatherParam,
        date: dt.datetime,
        file_format: Literal["npy", "grib"] = "npy",
    ) -> np.ndarray:
        path = cls._date_filepath(ds_name, param, date, file_format)
        if file_format == "grib":
            arr, lons, lats = load_data_grib(param, path)
            arr = fit_to_grid(param, arr, lons, lats, cls.get_grid_coords)
            return arr[::-1]  # invert latitude
        return np.load(path)

    @classmethod
    def file_paths_for(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npy",
    ):
        if file_format != "npy":
            return None
        return [
            cls._date_filepath(dataset_name, param, date, "npy")
            for date in timestamps.validity_times
        ]

    @classmethod
    def load_data_from_disk(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npy",
    ) -> np.ndarray:
        if file_format == "npy":
            # every validity time in one call of the parallel batch reader
            from py4cast_tpu_torch.native import read_npy_float32_batch

            paths = cls.file_paths_for(
                dataset_name, param, timestamps, member, "npy"
            )
            probe = np.load(paths[0], mmap_mode="r")
            batch = read_npy_float32_batch(paths, probe.shape)
            return batch[..., None]
        arrs = [
            cls.load_data_for_date(dataset_name, param, date, file_format)[..., None]
            for date in timestamps.validity_times
        ]
        full = np.stack(arrs)
        if file_format == "grib":
            # npy files are saved cropped by `prepare`; the grib path
            # crops here so both formats yield subdomain-sized arrays
            sub = param.grid.subdomain
            full = full[:, sub[0] : sub[1], sub[2] : sub[3]]
        return full

    def exists(
        self,
        ds_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> bool:
        return all(
            self._date_filepath(ds_name, param, date, file_format).exists()
            for date in timestamps.validity_times
        )

    @staticmethod
    def parameter_namer(param: WeatherParam) -> str:
        suffix = (
            "m" if param.level_type in ["surface", "heightAboveGround"] else "hpa"
        )
        return f"{param.name}_{param.level}{suffix}"

    @classmethod
    def default_config(cls) -> dict:
        """The default Titan training config: 21 AROME input_output
        fields and 16 ARPEGE inputs on PAAROME_1S40's 512 x 640
        subdomain [100, 612, 240, 880]."""
        iso4 = [250, 500, 700, 850]
        return {
            "periods": {
                "train": {"start": 20200101, "end": 20221231, "obs_step": 3600},
                "valid": {
                    "start": 20230101,
                    "end": 20231231,
                    "obs_step": 3600,
                    "obs_step_btw_t0": 10800,
                },
                "test": {
                    "start": 20240101,
                    "end": 20240831,
                    "obs_step": 3600,
                    "obs_step_btw_t0": 10800,
                },
            },
            "grid": {
                "name": "PAAROME_1S40",
                "border_size": 0,
                "subdomain": [100, 612, 240, 880],
                "proj_name": "PlateCarree",
                "projection_kwargs": {},
            },
            "settings": {"standardize": True, "file_format": "npy"},
            "params": {
                "aro_t2m": {"levels": [2], "kind": "input_output"},
                "aro_r2": {"levels": [2], "kind": "input_output"},
                "aro_tp": {"levels": [0], "kind": "input_output"},
                "aro_u10": {"levels": [10], "kind": "input_output"},
                "aro_v10": {"levels": [10], "kind": "input_output"},
                "aro_t": {"levels": iso4, "kind": "input_output"},
                "aro_u": {"levels": iso4, "kind": "input_output"},
                "aro_v": {"levels": iso4, "kind": "input_output"},
                "aro_z": {"levels": iso4, "kind": "input_output"},
                "arp_t": {"levels": iso4, "kind": "input"},
                "arp_u": {"levels": iso4, "kind": "input"},
                "arp_v": {"levels": iso4, "kind": "input"},
                "arp_z": {"levels": iso4, "kind": "input"},
            },
        }


# ------------------------------------------------------------ grib helpers
def fit_to_grid(
    param: WeatherParam,
    arr: np.ndarray,
    lons: np.ndarray,
    lats: np.ndarray,
    get_grid_coords: Callable[[WeatherParam], List[float]],
) -> np.ndarray:
    """Crop (ARPEGE → AROME bbox) then resample to the target grid size,
    on the host: ``F.interpolate(mode="bilinear", align_corners=False)``
    on a CPU tensor, the half-pixel linear resize of
    ``jax.image.resize(..., "linear")``, antialiased toward PAAROME_1S40
    as the JAX package sets it (a shrink from PAAROME_1S100; growing
    from PA_01D, the antialias changes nothing)."""
    if param.grid.name == param.native_grid:
        return arr

    if param.native_grid == "PA_01D" and param.grid.name in (
        "PAAROME_1S100",
        "PAAROME_1S40",
    ):
        coords = get_grid_coords(param)
        mask_lon = (lons >= coords[2]) & (lons <= coords[3])
        mask_lat = (lats >= coords[1]) & (lats <= coords[0])
        arr = arr[mask_lat, :][:, mask_lon]

    import torch
    import torch.nn.functional as F

    antialias = param.grid.name == "PAAROME_1S40"
    x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))[None, None]
    out = F.interpolate(x, size=tuple(param.grid.full_size), mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out[0, 0].numpy()


@lru_cache(maxsize=50)
def read_grib(path_grib: Path):
    """The grib file as an xarray Dataset (needs xarray and cfgrib)."""
    try:
        import cfgrib  # noqa: F401  (xarray's "cfgrib" engine)
        import xarray as xr
    except ImportError as e:
        raise ImportError(
            f"reading {path_grib} needs xarray and cfgrib, which are not "
            f"installed ({e})"
        ) from e

    return xr.load_dataset(
        path_grib, engine="cfgrib", backend_kwargs={"indexpath": ""}
    )


def load_data_grib(param: WeatherParam, path: Path):
    """The field of ``param`` in the grib file ``path`` with its lon/lat
    axes (needs xarray and cfgrib)."""
    ds = read_grib(path)
    assert param.grib_param is not None
    level_type = ds[param.grib_param].attrs["GRIB_typeOfLevel"]
    lats = ds.latitude.values
    lons = ds.longitude.values
    if level_type != "isobaricInhPa":
        arr = ds[param.grib_param].values
    else:
        arr = ds[param.grib_param].sel(isobaricInhPa=param.level).values
    return arr, lons, lats
