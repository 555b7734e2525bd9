"""Dataset layer: samples, items, batches, statics and dataset metadata.

Everything here is host-side numpy; the module moves batches to its
device (``training.AutoRegressiveModule``). A copy of the JAX package's
``py4cast_tpu/datasets/base.py``: a sample whose accessor names its
files (``DataAccessor.file_paths_for``) is read in one call of the
parallel npy batch reader (``native.py``).
"""

from __future__ import annotations

import datetime as dt
import json
from dataclasses import dataclass, field, fields
from functools import cached_property
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Type, Union

import numpy as np

from py4cast_tpu_torch.datasets.access import (
    DataAccessor,
    Grid,
    Period,
    SamplePreprocSettings,
    Stats,
    Timestamps,
    WeatherParam,
    grid_static_features,
)
from py4cast_tpu_torch.datasets.forcing import generate_forcings
from py4cast_tpu_torch.named_tensor import NamedArray
from py4cast_tpu_torch.parallel.spatial import Band
from py4cast_tpu_torch.utils import merge_dicts


@dataclass
class Item:
    """One sample: inputs/outputs/forcing NamedArrays + validity times.

    Shapes: (timestep, lat, lon, features). Invariant: inputs and outputs
    share dim names and feature names.
    """

    inputs: Optional[NamedArray]
    forcing: Optional[NamedArray]
    outputs: NamedArray
    validity_times: List[dt.datetime]

    def __post_init__(self):
        if self.inputs is not None:
            if self.inputs.names != self.outputs.names:
                raise ValueError(
                    f"Inputs and outputs must have the same dim names, got "
                    f"{self.inputs.names} and {self.outputs.names}"
                )
            if self.inputs.feature_names != self.outputs.feature_names:
                raise ValueError(
                    f"Inputs and outputs must have the same feature names, got "
                    f"{self.inputs.feature_names} and {self.outputs.feature_names}"
                )

    def unsqueeze(self, dim_name: str, dim_index: int) -> "Item":
        """A size-1 dim named ``dim_name`` inserted at ``dim_index`` in
        every array."""
        return Item(
            inputs=self.inputs.unsqueeze(dim_name, dim_index) if self.inputs else None,
            forcing=self.forcing.unsqueeze(dim_name, dim_index) if self.forcing else None,
            outputs=self.outputs.unsqueeze(dim_name, dim_index),
            validity_times=self.validity_times,
        )

    def squeeze(self, dim_name: Union[str, List[str]]) -> "Item":
        """The size-1 dim(s) named ``dim_name`` dropped from every array."""
        return Item(
            inputs=self.inputs.squeeze(dim_name) if self.inputs else None,
            forcing=self.forcing.squeeze(dim_name) if self.forcing else None,
            outputs=self.outputs.squeeze(dim_name),
            validity_times=self.validity_times,
        )

    def __str__(self) -> str:
        lines = []
        for f in fields(self):
            if f.name == "validity_times":
                continue
            nt = getattr(self, f.name)
            if nt is not None:
                lines.append(f"{f.name}: {nt}")
        return "\n".join(lines)


@dataclass
class ItemBatch(Item):
    """A batch of items with a leading `batch` dim on each NamedArray.

    ``num_valid`` < batch_size marks a PADDED final batch (the last sample
    repeated); consumers keep only the first ``valid_count`` rows.
    """

    num_valid: Optional[int] = None

    @cached_property
    def batch_size(self) -> int:
        return self.outputs.dim_size("batch")

    @property
    def valid_count(self) -> int:
        return self.batch_size if self.num_valid is None else self.num_valid

    @cached_property
    def num_input_steps(self) -> int:
        if self.inputs is None:
            return self.outputs.dim_size("timestep")
        return self.inputs.dim_size("timestep")

    @cached_property
    def num_pred_steps(self) -> int:
        return self.outputs.dim_size("timestep")


def collate_fn(items: List[Item], num_valid: Optional[int] = None) -> ItemBatch:
    """Stack a list of Items into an ItemBatch with a leading batch dim."""
    first = items[0]

    def _stack(attr: str) -> Optional[NamedArray]:
        nt0 = getattr(first, attr)
        if nt0 is None:
            return None
        stacked = np.stack(
            [np.asarray(getattr(it, attr).array) for it in items]
        ).astype(np.float32)
        return NamedArray.expand_to_batch_like(stacked, nt0)

    return ItemBatch(
        inputs=_stack("inputs"),
        forcing=_stack("forcing"),
        outputs=_stack("outputs"),
        validity_times=[it.validity_times for it in items],
        num_valid=num_valid,
    )


@dataclass
class Statics:
    """Static fields of the dataset."""

    grid_statics: NamedArray
    grid_shape: Tuple[int, int]

    def __post_init__(self):
        self.border_mask = np.asarray(self.grid_statics["border_mask"], dtype=np.float32)
        self.interior_mask = 1.0 - self.border_mask

    @cached_property
    def meshgrid(self) -> np.ndarray:
        """(2, x, y) normalized coordinates, for GNN graph building."""
        xy = np.concatenate([self.grid_statics["x"], self.grid_statics["y"]], axis=-1)
        return np.moveaxis(xy, -1, 0)

    def flatten_spatial(self) -> "Statics":
        """Return a copy with (lat, lon) flattened to ngrid (GRAPH models)."""
        flat = Statics.__new__(Statics)
        flat.grid_statics = self.grid_statics.flatten("ngrid", 0, 1)
        flat.grid_shape = self.grid_shape
        flat.border_mask = self.border_mask.reshape(-1, 1)
        flat.interior_mask = self.interior_mask.reshape(-1, 1)
        return flat

    def pad_lat(self, pad: int) -> "Statics":
        """A copy with ``pad`` lat rows appended, all border (border_mask
        1, interior 0): they never enter a loss or metric denominator and
        are border-forced in rollouts. The coordinate channels carry on
        the last row spacing, so graph builders see monotone node
        positions. ``pad_lat(0)`` returns ``self``."""
        if pad <= 0:
            return self
        arr = np.asarray(self.grid_statics.array, np.float32)
        names = list(self.grid_statics.feature_names)
        tail = np.zeros((pad,) + arr.shape[1:], arr.dtype)
        if arr.shape[0] >= 2:
            step = arr[-1] - arr[-2]
            for k in range(pad):
                tail[k] = arr[-1] + (k + 1) * step
        tail[..., names.index("border_mask")] = 1.0
        return Statics(
            grid_statics=NamedArray(np.concatenate([arr, tail], axis=0),
                                    self.grid_statics.names, self.grid_statics.feature_names),
            grid_shape=(self.grid_shape[0] + pad, self.grid_shape[1]),
        )

    def band(self, index: int, count: int) -> "Statics":
        """Lat band ``index`` of ``count`` (rows ``[index·H/count,
        (index+1)·H/count)``): its grid statics, border and interior
        masks, and meshgrid. ``band(0, 1)`` returns ``self``. A graph is
        built on the whole grid and cut after, never on a band."""
        if count == 1:
            return self
        g = self.grid_statics
        rows = Band(index, count).cut(np.asarray(g.array), 0)
        return Statics(grid_statics=NamedArray(rows, g.names, g.feature_names),
                       grid_shape=(rows.shape[0], self.grid_shape[1]))


@dataclass
class DatasetInfo:
    """Everything other components need to know about a dataset."""

    name: str
    units: Dict[str, str]
    weather_dim: int
    forcing_dim: int
    pred_step: dt.timedelta
    statics: Statics
    stats: Stats
    diff_stats: Stats
    state_weights: Dict[str, float]
    shortnames: Optional[Dict[str, List[str]]] = None
    domain_info: Optional[object] = None
    # feature-name orderings as produced by Sample.load
    output_feature_names: Tuple[str, ...] = ()
    forcing_feature_names: Tuple[str, ...] = ()
    units_by_feature: Optional[Dict[str, str]] = None

    def summary(self):
        """Print the dataset's step, statics, and each feature's unit,
        statistics and state weight."""
        print(f"\n Summarizing {self.name}\n")
        print(f"Step duration: {self.pred_step}")
        print(f"Static features: {self.statics.grid_statics.feature_names}")
        print(f"Shortnames: {self.shortnames}")
        for kind in ["input", "input_output", "output"]:
            names = self.shortnames.get(kind, []) if self.shortnames else []
            if not names:
                continue
            print(kind.upper())
            for n in names:
                s = self.stats[n]
                row = (
                    f"  {n} [{self.units.get(n, '?')}] mean={s['mean']:.4g} "
                    f"std={s['std']:.4g} min={s['min']:.4g} max={s['max']:.4g}"
                )
                if kind != "input" and n in self.diff_stats:
                    d = self.diff_stats[n]
                    row += (
                        f" diff_mean={d['mean']:.4g} diff_std={d['std']:.4g} "
                        f"weight={self.state_weights.get(n, 1.0)}"
                    )
                print(row)


def get_param_list(
    conf: dict, grid: Grid, accessor: Type[DataAccessor]
) -> List[WeatherParam]:
    params = []
    for name, values in conf["params"].items():
        for lvl in values["levels"]:
            params.append(
                WeatherParam(
                    name=name,
                    level=lvl,
                    grid=grid,
                    load_param_info=accessor.load_param_info,
                    kind=values["kind"],
                    get_weight_per_level=accessor.get_weight_per_level,
                )
            )
    return params


@dataclass
class Sample:
    """A lazily-loaded sample.

    ``load()`` reads per-param arrays from the accessor, standardizes them,
    splits input/output steps by param kind, appends generated forcings and
    concatenates into an Item.
    """

    timestamps: Timestamps
    settings: SamplePreprocSettings
    params: List[WeatherParam]
    stats: Optional[Stats]
    grid: Grid
    accessor: DataAccessor
    member: int = 0
    output_timestamps: Timestamps = field(default=None)

    def __post_init__(self):
        n = self.settings.num_input_steps + self.settings.num_pred_steps
        if n != len(self.timestamps.validity_times):
            raise ValueError("Length of validity times does not match inputs+outputs")
        self.output_timestamps = Timestamps(
            datetime=self.timestamps.datetime,
            timedeltas=self.timestamps.timedeltas[self.settings.num_input_steps :],
        )

    def __repr__(self):
        return f"Sample({self.timestamps.datetime}, member={self.member})"

    def is_valid(self) -> bool:
        return all(
            self.accessor.exists(
                ds_name=self.settings.dataset_name,
                param=p,
                timestamps=self.timestamps,
                file_format=self.settings.file_format,
            )
            for p in self.params
        )

    def get_param_array(
        self, param: WeatherParam, timestamps: Timestamps, standardize: bool
    ) -> np.ndarray:
        arr = self.accessor.load_data_from_disk(
            self.settings.dataset_name,
            param,
            timestamps,
            self.member,
            self.settings.file_format,
        )
        if standardize:
            name = self.accessor.parameter_namer(param)
            arr = (arr - self.stats[name]["mean"]) / self.stats[name]["std"]
        return np.asarray(arr, dtype=np.float32)

    def _param_stamps(self, param: WeatherParam) -> Timestamps:
        return self.timestamps if param.kind == "input_output" else self.output_timestamps

    def _batched_param_arrays(self, standardize: bool) -> Optional[dict]:
        """Whole-sample fused read: ONE parallel batch over every (param ×
        validity time) file, since a sample's worth of files is what it
        takes to saturate the reader's thread pool (a per-param call
        covers only num_steps files). Returns {param_name: (T,H,W,1)}, or
        None when the accessor's storage is not file-per-timestep npy or
        its files differ in shape."""
        if self.settings.file_format != "npy":
            return None
        per_param = []
        for p in self.params:
            paths = self.accessor.file_paths_for(
                self.settings.dataset_name, p, self._param_stamps(p), self.member, "npy",
            )
            if paths is None:
                return None
            per_param.append(paths)
        from py4cast_tpu_torch.native import read_npy_float32_batch

        # one batch buffer needs one shape: read the headers alone (mmap)
        shapes = {np.load(paths[0], mmap_mode="r").shape for paths in per_param}
        if len(shapes) != 1:
            return None
        flat = [q for paths in per_param for q in paths]
        block = read_npy_float32_batch(flat, shapes.pop())
        out, i = {}, 0
        for p, paths in zip(self.params, per_param):
            arr = block[i : i + len(paths)][..., None]
            i += len(paths)
            if standardize:
                name = self.accessor.parameter_namer(p)
                arr = (arr - self.stats[name]["mean"]) / self.stats[name]["std"]
            out[self.accessor.parameter_namer(p)] = np.asarray(arr, dtype=np.float32)
        return out

    def load(self, no_standardize: bool = False) -> Item:
        linputs, loutputs, lforcings = [], [], []
        names4 = ("timestep", "lat", "lon", "features")
        standardize = self.settings.standardize and not no_standardize
        batched = self._batched_param_arrays(standardize)

        for param in self.params:
            fname = self.accessor.parameter_namer(param)
            arr = (
                batched[fname]
                if batched is not None
                else self.get_param_array(param, self._param_stamps(param), standardize)
            )
            nt = NamedArray(arr, names4, (fname,))
            if param.kind == "input":
                lforcings.append(nt)
            elif param.kind == "output":
                loutputs.append(nt)
            else:
                loutputs.append(
                    NamedArray(arr[-self.settings.num_pred_steps :], names4, (fname,))
                )
                linputs.append(
                    NamedArray(arr[: self.settings.num_input_steps], names4, (fname,))
                )

        if not loutputs:
            raise ValueError(
                "Can't train anything without target data: outputs list is empty."
            )

        external = generate_forcings(
            date=self.timestamps.datetime,
            timedeltas=self.output_timestamps.timedeltas,
            grid=self.grid,
        )
        lforcings += [f.broadcast_like(loutputs[0]) for f in external]

        return Item(
            inputs=NamedArray.concat(linputs) if linputs else None,
            outputs=NamedArray.concat(loutputs),
            forcing=NamedArray.concat(lforcings) if lforcings else None,
            validity_times=self.output_timestamps.validity_times,
        )

    # ------------------------------------------------------------- plotting
    def plot(self, item: Item, step: int, save_path: Optional[Path] = None):
        """Every feature of one timestep of ``item`` (needs matplotlib)."""
        from py4cast_tpu_torch.plots import plot_sample_step

        plot_sample_step(self, item, step, save_path)

    def plot_gif(self, save_path: Path):
        """An animated GIF over the sample's steps (needs matplotlib)."""
        from py4cast_tpu_torch.plots import sample_gif

        sample_gif(self, save_path)


class WeatherDataset:
    """Map-style dataset of Samples."""

    def __init__(
        self,
        name: str,
        grid: Grid,
        period: Period,
        params: List[WeatherParam],
        settings: SamplePreprocSettings,
        accessor: DataAccessor,
    ):
        self.name = name
        self.grid = grid
        self.period = period
        self.params = params
        self.settings = settings
        self.accessor = accessor
        self.shuffle = period.name == "train"
        self.cache_dir = accessor.cache_dir(name, grid)

    def __str__(self):
        return f"{self.name}_{self.grid.name}"

    def __getitem__(self, index: int) -> Item:
        return self.sample_list[index].load()

    def __len__(self):
        return len(self.sample_list)

    @cached_property
    def sample_list(self) -> List[Sample]:
        stats = self.stats if self.settings.standardize else None
        timestamps = []
        for t0, leadtime in self.period.available_t0_and_leadtimes:
            if self.accessor.optional_check_before_exists(
                t0,
                self.settings.num_input_steps,
                self.settings.num_pred_steps,
                self.period.forecast_step,
                leadtime,
            ):
                steps = [
                    delta * self.period.forecast_step + leadtime
                    for delta in range(
                        -self.settings.num_input_steps + 1,
                        self.settings.num_pred_steps + 1,
                    )
                ]
                timestamps.append(Timestamps(datetime=t0, timedeltas=steps))

        samples = []
        members = self.settings.members or [0]
        for ts in timestamps:
            for member in members:
                s = Sample(
                    ts, self.settings, self.params, stats, self.grid, self.accessor,
                    member,
                )
                if s.is_valid():
                    samples.append(s)
        return samples

    def filter_samples(self, predicate) -> "WeatherDataset":
        """A shallow copy of this dataset whose ``sample_list`` keeps the
        samples for which ``predicate(sample)`` is true (e.g. a run
        hour); the original's list is not touched. Raises ``ValueError``
        if no sample survives."""
        import copy

        filtered = [s for s in self.sample_list if predicate(s)]
        if not filtered:
            raise ValueError(
                f"filter_samples left no samples in {self} "
                f"(started from {len(self.sample_list)})"
            )
        ds = copy.copy(self)
        ds.__dict__["sample_list"] = filtered  # the copy's cached_property slot
        return ds

    def loader(
        self,
        batch_size: int = 1,
        num_workers: int = 2,
        shuffle: bool = False,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        from py4cast_tpu_torch.datasets.loader import DataLoader

        return DataLoader(
            self,
            batch_size=batch_size,
            num_workers=num_workers,
            shuffle=shuffle,
            prefetch=prefetch,
            seed=seed,
            drop_last=drop_last,
            pad_last=pad_last,
            process_index=process_index,
            process_count=process_count,
        )

    # -------------------------------------------------------------- derived
    @cached_property
    def input_dim(self) -> int:
        """Number of forcing features (4 calendar + 1 solar + `input` params)."""
        return 5 + sum(1 for p in self.params if p.kind == "input")

    @cached_property
    def input_output_dim(self) -> int:
        return sum(1 for p in self.params if p.kind == "input_output")

    @cached_property
    def output_dim(self) -> int:
        return sum(1 for p in self.params if p.kind == "output")

    @property
    def dataset_extra_statics(self) -> List[NamedArray]:
        if self.settings.add_landsea_mask:
            return [
                NamedArray(
                    self.grid.landsea_mask.astype(np.float32)[..., None],
                    ("lat", "lon", "features"),
                    ("LandSeaMask",),
                )
            ]
        return []

    @cached_property
    def grid_shape(self) -> Tuple[int, int]:
        x, _ = self.grid.meshgrid
        return x.shape

    @cached_property
    def statics(self) -> Statics:
        return Statics(
            grid_statics=grid_static_features(self.grid, self.dataset_extra_statics),
            grid_shape=self.grid_shape,
        )

    def _load_stats(self, basename: str) -> Stats:
        for ext in (".json", ".pt"):
            f = self.cache_dir / f"{basename}{ext}"
            if f.exists():
                return Stats(fname=f)
        raise FileNotFoundError(
            f"No {basename}.json/.pt in {self.cache_dir}; compute the "
            "dataset's statistics first."
        )

    @cached_property
    def stats(self) -> Stats:
        return self._load_stats("parameters_stats")

    @cached_property
    def diff_stats(self) -> Stats:
        return self._load_stats("diff_stats")

    def shortnames(self, kind: str) -> List[str]:
        return [self.accessor.parameter_namer(p) for p in self.params if p.kind == kind]

    @cached_property
    def units(self) -> Dict[str, str]:
        return {self.accessor.parameter_namer(p): p.unit for p in self.params}

    @cached_property
    def state_weights(self) -> Dict[str, float]:
        return {
            self.accessor.parameter_namer(p): p.state_weight
            for p in self.params
            if p.kind in ("output", "input_output")
        }

    @cached_property
    def output_feature_names(self) -> Tuple[str, ...]:
        """Feature order of Item.outputs: params of kind output/input_output
        in declaration order (Sample.load's concat order)."""
        return tuple(
            self.accessor.parameter_namer(p)
            for p in self.params
            if p.kind in ("output", "input_output")
        )

    @cached_property
    def forcing_feature_names(self) -> Tuple[str, ...]:
        """Feature order of Item.forcing: `input` params then the five
        generated forcings (calendar + solar)."""
        return tuple(
            [self.accessor.parameter_namer(p) for p in self.params if p.kind == "input"]
            + ["cos_hour", "sin_hour", "cos_doy", "sin_doy", "toa_radiation"]
        )

    @cached_property
    def domain_info(self):
        """The grid's limits and projection, for map plots."""
        from py4cast_tpu_torch.plots import DomainInfo

        return DomainInfo(grid_limits=self.grid.grid_limits, projection=self.grid.projection)

    @cached_property
    def dataset_info(self) -> DatasetInfo:
        return DatasetInfo(
            name=str(self),
            domain_info=self.domain_info,
            shortnames={
                "input": self.shortnames("input"),
                "input_output": self.shortnames("input_output"),
                "output": self.shortnames("output"),
            },
            units=self.units,
            weather_dim=self.input_output_dim + self.output_dim,
            forcing_dim=self.input_dim,
            pred_step=self.period.forecast_step,
            statics=self.statics,
            stats=self.stats,
            diff_stats=self.diff_stats,
            state_weights=self.state_weights,
            output_feature_names=self.output_feature_names,
            forcing_feature_names=self.forcing_feature_names,
            units_by_feature=self.units,
        )

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_dict(
        cls,
        accessor_kls: Type[DataAccessor],
        name: str,
        conf: dict,
        num_input_steps: int,
        num_pred_steps_train: int,
        num_pred_steps_val_test: int,
    ) -> Tuple["WeatherDataset", "WeatherDataset", "WeatherDataset"]:
        grid = Grid(load_grid_info_func=accessor_kls.load_grid_info, **conf["grid"])
        members = conf.get("members", [0])
        params = get_param_list(conf, grid, accessor_kls)

        def mk(period_key: str, num_pred: int, period_name: str) -> "WeatherDataset":
            settings = SamplePreprocSettings(
                dataset_name=name,
                num_input_steps=num_input_steps,
                num_pred_steps=num_pred,
                members=members,
                **conf["settings"],
            )
            period = Period(**conf["periods"][period_key], name=period_name)
            return cls(name, grid, period, params, settings, accessor_kls())

        return (
            mk("train", num_pred_steps_train, "train"),
            mk("valid", num_pred_steps_val_test, "valid"),
            mk("test", num_pred_steps_val_test, "test"),
        )

    @classmethod
    def from_json(
        cls,
        accessor_kls: Type[DataAccessor],
        fname: Path,
        num_input_steps: int,
        num_pred_steps_train: int,
        num_pred_steps_val_test: int,
        config_override: Optional[dict] = None,
    ) -> Tuple["WeatherDataset", "WeatherDataset", "WeatherDataset"]:
        with open(fname) as fp:
            conf = json.load(fp)
        if config_override is not None:
            conf = merge_dicts(conf, config_override)
        return cls.from_dict(
            accessor_kls,
            Path(fname).stem,
            conf,
            num_input_steps,
            num_pred_steps_train,
            num_pred_steps_val_test,
        )
