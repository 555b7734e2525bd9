"""Data-access layer: grid geometry, time enumeration, parameter descriptors,
normalization statistics, and the storage-backend contract.

Host-side numpy only — nothing in this module touches a device. A copy
of the JAX package's access layer (``py4cast_tpu/datasets/access.py``)
so the port never imports that package.
"""

from __future__ import annotations

import datetime as dt
import json
import os
from abc import ABC, abstractmethod
from collections import namedtuple
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from typing import Any, Callable, Iterable, List, Literal, Optional, Tuple, Union

import numpy as np

from py4cast_tpu_torch.named_tensor import NamedArray
from py4cast_tpu_torch.settings import CACHE_DIR

GridConfig = namedtuple(
    "GridConfig", "full_size latitude longitude geopotential landsea_mask"
)

ParamConfig = namedtuple(
    "ParamConfig", "unit level_type long_name grid grib_name grib_param"
)


@dataclass
class Period:
    """Enumeration of sample reference times for one split.

    Two modes:
    - continuous/observation: ``obs_step`` between consecutive observations,
      optional ``obs_step_btw_t0`` between consecutive sample t0s;
    - reforecast: daily runs at ``refcst_daily_runs`` offsets with leadtimes
      in [start, end) stepped by ``refcst_leadtime_step_in_sec``.
    """

    name: str
    start: dt.datetime
    end: dt.datetime
    obs_step: Optional[dt.timedelta] = None
    obs_step_btw_t0: Optional[dt.timedelta] = None
    refcst_daily_runs: Optional[List[dt.timedelta]] = None
    refcst_leadtime_start_in_sec: Optional[int] = None
    refcst_leadtime_end_in_sec: Optional[int] = None
    refcst_leadtime_step_in_sec: Optional[int] = None

    def __post_init__(self):
        self.start = dt.datetime.strptime(str(self.start), "%Y%m%d")
        self.end = dt.datetime.strptime(str(self.end), "%Y%m%d")

        obs_mode = self.obs_step is not None
        refcst_mode = self.refcst_leadtime_start_in_sec is not None
        if not obs_mode and not refcst_mode:
            raise ValueError(
                "Period requires either obs_step (continuous dataset) or the "
                "refcst_* leadtime settings (reforecast dataset)."
            )
        if obs_mode:
            self.obs_step = dt.timedelta(seconds=int(_seconds(self.obs_step)))
            if self.obs_step_btw_t0 is not None:
                self.obs_step_btw_t0 = dt.timedelta(
                    seconds=int(_seconds(self.obs_step_btw_t0))
                )
            else:
                self.obs_step_btw_t0 = self.obs_step
        if refcst_mode:
            self.refcst_daily_runs = [
                dt.timedelta(seconds=int(_seconds(sec)))
                for sec in self.refcst_daily_runs
            ]

    @property
    def available_t0_and_leadtimes(self) -> List[Tuple[dt.datetime, dt.timedelta]]:
        """All (t0, leadtime) couples in the period (cartesian product)."""
        if self.obs_step is not None:
            t0s = []
            t = self.start
            while t <= self.end + dt.timedelta(days=1) - dt.timedelta(seconds=1):
                t0s.append(t)
                t = t + self.obs_step_btw_t0
            leadtimes = [dt.timedelta(seconds=0)]
        else:
            days = []
            d = self.start
            while d <= self.end:
                days.append(d)
                d = d + dt.timedelta(days=1)
            t0s = [day + run for day in days for run in self.refcst_daily_runs]
            leadtimes = [
                dt.timedelta(seconds=s)
                for s in range(
                    int(self.refcst_leadtime_start_in_sec),
                    int(self.refcst_leadtime_end_in_sec),
                    int(self.refcst_leadtime_step_in_sec),
                )
            ]
        return [(t0, lt) for t0 in t0s for lt in leadtimes]

    @property
    def forecast_step(self) -> dt.timedelta:
        if self.obs_step is not None:
            return self.obs_step
        return dt.timedelta(seconds=self.refcst_leadtime_step_in_sec)


def _seconds(v) -> float:
    return v.total_seconds() if isinstance(v, dt.timedelta) else float(v)


@dataclass
class Timestamps:
    """All timestamps in one sample: reference datetime + per-step timedeltas.

    validity_times[i] = datetime + timedeltas[i]
    """

    datetime: dt.datetime
    timedeltas: Iterable[dt.timedelta]

    def __post_init__(self):
        self.timedeltas = list(self.timedeltas)
        self.validity_times = [self.datetime + d for d in self.timedeltas]


@dataclass
class Grid:
    """Grid geometry with subdomain cropping and border mask.

    ``subdomain`` is (lat_start, lat_end, lon_start, lon_end); (0,0,0,0)
    keeps the full grid.
    """

    name: str
    load_grid_info_func: Callable[[Any], GridConfig]
    border_size: int = 10
    subdomain: Tuple[int, int, int, int] = (0, 0, 0, 0)
    proj_name: str = "PlateCarree"
    projection_kwargs: dict = field(default_factory=dict)

    def __post_init__(self):
        self.grid_config = self.load_grid_info_func(self.name)
        if sum(self.subdomain) == 0:
            self.subdomain = (
                0,
                self.grid_config.full_size[0],
                0,
                self.grid_config.full_size[1],
            )
        self.subdomain = tuple(self.subdomain)
        self.x = self.subdomain[1] - self.subdomain[0]
        self.y = self.subdomain[3] - self.subdomain[2]
        self.full_size = self.grid_config.full_size

    @cached_property
    def lat(self) -> np.ndarray:
        lats = self.grid_config.latitude[self.subdomain[0] : self.subdomain[1]]
        return np.transpose(np.tile(lats, (self.y, 1)))

    @cached_property
    def lon(self) -> np.ndarray:
        lons = self.grid_config.longitude[self.subdomain[2] : self.subdomain[3]]
        return np.tile(lons, (self.x, 1))

    @property
    def geopotential(self) -> np.ndarray:
        return self.grid_config.geopotential[
            self.subdomain[0] : self.subdomain[1],
            self.subdomain[2] : self.subdomain[3],
        ]

    @property
    def landsea_mask(self) -> np.ndarray:
        if self.grid_config.landsea_mask is not None:
            return self.grid_config.landsea_mask[
                self.subdomain[0] : self.subdomain[1],
                self.subdomain[2] : self.subdomain[3],
            ]
        return np.zeros((self.x, self.y))

    @property
    def border_mask(self) -> np.ndarray:
        if self.border_size > 0:
            mask = np.ones((self.x, self.y), dtype=bool)
            s = self.border_size
            mask[s:-s, s:-s] = False
            return mask
        if self.border_size == 0:
            return np.zeros((self.x, self.y), dtype=bool)
        raise ValueError(f"border_size must be >= 0, got {self.border_size}")

    @property
    def N_grid(self) -> int:
        return self.x * self.y

    @cached_property
    def grid_limits(self) -> List[float]:
        return [
            float(self.grid_config.longitude[self.subdomain[2]]),
            float(self.grid_config.longitude[self.subdomain[3] - 1]),
            float(self.grid_config.latitude[self.subdomain[1] - 1]),
            float(self.grid_config.latitude[self.subdomain[0]]),
        ]

    @cached_property
    def meshgrid(self) -> np.ndarray:
        lats = self.grid_config.latitude[self.subdomain[0] : self.subdomain[1]]
        lons = self.grid_config.longitude[self.subdomain[2] : self.subdomain[3]]
        return np.array(np.meshgrid(lons, lats))  # (2, x, y)

    @cached_property
    def projection(self):
        """The cartopy projection ``proj_name(**projection_kwargs)`` for
        map plots, or None when cartopy is not installed."""
        try:
            import cartopy.crs as ccrs
        except ImportError:
            return None
        return getattr(ccrs, self.proj_name)(**self.projection_kwargs)


def grid_static_features(grid: Grid, extra_statics: List[NamedArray]) -> NamedArray:
    """Static per-node features: normalized x/y coords, normalized
    geopotential, border mask, plus dataset extras."""
    xy = grid.meshgrid.astype(np.float32)  # (2, x, y)
    pos_max = xy.reshape(2, -1).max(axis=1)
    pos_min = xy.reshape(2, -1).min(axis=1)
    denom = np.where(pos_max > pos_min, pos_max - pos_min, 1.0)
    grid_xy = (np.moveaxis(xy, 0, -1) - pos_min) / denom  # (x, y, 2)

    gp = np.asarray(grid.geopotential, dtype=np.float32)[..., None]
    gp_min, gp_max = gp.min(), gp.max()
    if gp_max != gp_min:
        gp = (gp - gp_min) / (gp_max - gp_min)
    elif gp_max != 0:
        gp = gp / gp_max

    border = grid.border_mask.astype(np.float32)[..., None]

    extra_names: List[str] = []
    for x in extra_statics:
        extra_names += list(x.feature_names)
    tensor = np.concatenate(
        [grid_xy, gp, border] + [np.asarray(x.array, np.float32) for x in extra_statics],
        axis=-1,
    ).astype(np.float32)
    return NamedArray(
        tensor,
        names=("lat", "lon", "features"),
        feature_names=tuple(["x", "y", "geopotential", "border_mask"] + extra_names),
    )


@dataclass
class WeatherParam:
    """One 2-D field descriptor: name + vertical level + role.

    kind: "input" (forcing), "output" (diagnostic), "input_output"
    (prognostic).
    """

    name: str
    level: int
    grid: Grid
    load_param_info: Callable[[str], ParamConfig]
    kind: Literal["input", "output", "input_output"]
    get_weight_per_level: Callable[[int, str], float]

    def __post_init__(self):
        info = self.load_param_info(self.name)
        self.unit = info.unit
        if info.level_type in ["heightAboveGround", "meanSea", "surface"]:
            self.level_type = info.level_type
        else:
            self.level_type = "isobaricInhPa"
        self.long_name = info.long_name
        self.native_grid = info.grid
        self.grib_name = info.grib_name
        self.grib_param = info.grib_param

    @property
    def state_weight(self) -> float:
        return self.get_weight_per_level(self.level, self.level_type)

    @property
    def parameter_name(self) -> str:
        return f"{self.long_name}_{self.level}_{self.level_type}"


class Stats:
    """Per-feature normalization statistics {name: {mean, std, min, max}}.

    Persisted as JSON (``save``); also reads torch ``.pt`` files.
    ``to_array`` stacks the requested stat over an ordered feature list.
    """

    def __init__(self, fname: Union[Path, None] = None, stats: Optional[dict] = None):
        if stats is not None:
            self.stats = {k: {s: float(v) for s, v in d.items()} for k, d in stats.items()}
        elif fname is not None:
            self.stats = self._load(Path(fname))
        else:
            raise ValueError("Stats needs either fname or stats dict")

    @staticmethod
    def _load(fname: Path) -> dict:
        if fname.suffix == ".json":
            with open(fname) as f:
                raw = json.load(f)
            return {k: {s: float(v) for s, v in d.items()} for k, d in raw.items()}
        import torch

        raw = torch.load(fname, map_location="cpu", weights_only=True)
        return {k: {s: float(v) for s, v in d.items()} for k, d in raw.items()}

    def save(self, fname: Path):
        # write-to-tmp-then-rename: a concurrent process must never read a
        # truncated stats file
        fname = Path(fname)
        fname.parent.mkdir(parents=True, exist_ok=True)
        tmp = fname.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(self.stats, f, indent=1)
        os.replace(tmp, fname)

    def items(self):
        return self.stats.items()

    def __getitem__(self, shortname: str) -> dict:
        return self.stats[shortname]

    def __contains__(self, shortname: str) -> bool:
        return shortname in self.stats

    def to_array(
        self,
        stat_name: Literal["mean", "std", "min", "max"],
        shortnames: Iterable[str],
        dtype=np.float32,
    ) -> np.ndarray:
        names = list(shortnames)
        if not names:
            return np.zeros((0,), dtype=dtype)
        return np.asarray([self.stats[n][stat_name] for n in names], dtype=dtype)


@dataclass
class SamplePreprocSettings:
    dataset_name: str
    num_input_steps: int
    num_pred_steps: int
    standardize: bool = True
    file_format: Literal["npy", "grib", "npz"] = "npy"
    members: Optional[Tuple[int, ...]] = None
    add_landsea_mask: bool = False


class DataAccessor(ABC):
    """Storage-backend contract: concrete accessors implement file layout,
    grid metadata and raw array reads; the dataset layer adds sample
    enumeration, normalization, forcing generation and batching."""

    @staticmethod
    def optional_check_before_exists(
        t0: dt.datetime,
        num_input_steps: int,
        num_pred_steps: int,
        pred_step: dt.timedelta,
        leadtime: Union[dt.timedelta, None],
    ) -> bool:
        """Cheap pre-filter before per-file existence checks."""
        return True

    def cache_dir(self, name: str, grid: Grid) -> Path:
        path = CACHE_DIR / f"{name}_{grid.name}"
        os.makedirs(path, exist_ok=True)
        return path

    @classmethod
    def default_config(cls) -> dict:
        """Default dataset configuration dict (grid/params/periods/settings)."""
        raise NotImplementedError(
            f"{cls.__name__} provides no default config; pass dataset_conf"
        )

    @staticmethod
    @abstractmethod
    def get_dataset_path(name: str, grid: Grid) -> Path: ...

    @staticmethod
    @abstractmethod
    def get_weight_per_level(level: int, level_type: str) -> float: ...

    @staticmethod
    @abstractmethod
    def load_grid_info(name: str) -> GridConfig: ...

    @staticmethod
    @abstractmethod
    def get_grid_coords(param: WeatherParam) -> List[float]: ...

    @abstractmethod
    def load_param_info(self, name: str) -> ParamConfig: ...

    @classmethod
    @abstractmethod
    def get_filepath(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str,
    ) -> Path: ...

    @classmethod
    @abstractmethod
    def load_data_from_disk(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npy",
    ) -> np.ndarray: ...

    @classmethod
    def file_paths_for(
        cls,
        dataset_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        member: int = 0,
        file_format: str = "npy",
    ) -> Optional[List[Path]]:
        """Optional hook: the one-file-per-validity-time paths behind
        ``load_data_from_disk``, or None when the accessor's storage is
        not file-per-timestep. When every param of a sample provides
        paths, Sample.load fuses ALL of them into ONE parallel batch read
        (``native.read_npy_float32_batch`` on ``csrc/p4t_io.cpp``)
        instead of one small call per param: the reader's thread pool
        only saturates with a whole sample's worth of files.

        CONTRACT: the returned files must be consumable RAW: the fused
        path copies float32 payloads straight into the batch buffer, so
        any postprocessing ``load_data_from_disk`` applies (unit
        conversion, latitude flips, regridding, ...) must either be baked
        into the files or the accessor must return None here. An
        accessor implementing this hook should ship an equivalence test
        against its per-param path (see
        tests/test_torch_datasets.py::test_fused_read_equals_per_param_read)."""
        return None

    @abstractmethod
    def exists(
        self,
        ds_name: str,
        param: WeatherParam,
        timestamps: Timestamps,
        file_format: str = "npy",
    ) -> bool: ...

    @staticmethod
    def parameter_namer(param: WeatherParam) -> str:
        return f"{param.name}_{param.level}_{param.level_type}"
