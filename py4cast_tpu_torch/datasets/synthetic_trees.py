"""Synthetic trees in the Titan, Poesy and Rainfall on-disk layouts,
drawn from a numpy seed, for tests and smoke runs where no real file is
at hand. Each writer takes the root the accessor reads (``TITAN_PATH``,
``POESY_PATH``, ``RAINFALL_PATH``) and returns the files it wrote."""

from __future__ import annotations

import datetime as dt
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from py4cast_tpu_torch.datasets.poesy import LATLON_FNAME, OROGRAPHY_FNAME, WEATHER_PARAMS
from py4cast_tpu_torch.datasets.rainfall import FORMATSTR as RAINFALL_FORMATSTR
from py4cast_tpu_torch.datasets.titan import FORMATSTR as TITAN_FORMATSTR


def write_titan_tree(root: Path, subdataset: str, fields: Dict[str, Tuple[float, float]],
                     dates: Iterable[dt.datetime], shape: Tuple[int, int],
                     seed: int = 0) -> List[Path]:
    """One npy file a (date, field) under
    ``root/subdatasets/<subdataset>/data/<date>/<field>.npy``: float32
    ``standard_normal(shape) * scale + offset`` for ``fields`` =
    {file stem (``TitanAccessor.parameter_namer``): (scale, offset)},
    drawn date by date, field by field, from one generator."""
    rng = np.random.default_rng(seed)
    base = Path(root) / "subdatasets" / subdataset / "data"
    written = []
    for date in dates:
        d = base / date.strftime(TITAN_FORMATSTR)
        d.mkdir(parents=True, exist_ok=True)
        for stem, (scale, offset) in fields.items():
            path = d / f"{stem}.npy"
            np.save(path, rng.standard_normal(shape).astype(np.float32) * scale + offset)
            written.append(path)
    return written


def titan_fields(conf: dict) -> Dict[str, Tuple[float, float]]:
    """The file stems of a Titan dataset conf's params, each with a scale
    and an offset: temperatures near 280 K, geopotentials near 5e4, the
    rest near 0."""
    from py4cast_tpu_torch.datasets.titan.metadata import WEATHER_PARAMS as TITAN_PARAMS

    out = {}
    for name, values in conf["params"].items():
        kind = TITAN_PARAMS[name]["type_level"]
        suffix = "m" if kind in ("surface", "heightAboveGround") else "hpa"
        var = name.split("_", 1)[1]
        scale, offset = {"t": (5.0, 280.0), "t2m": (5.0, 285.0), "z": (500.0, 5e4),
                         "r2": (10.0, 70.0)}.get(var, (3.0, 0.0))
        for level in values["levels"]:
            out[f"{name}_{level}{suffix}"] = (scale, offset)
    return out


def write_poesy_tree(root: Path, shape: Sequence[int], runs: Iterable[dt.datetime],
                     variables: Iterable[str] = ("t2m", "u10", "v10"), seed: int = 1,
                     slab_rows: int = 64) -> List[Path]:
    """Poesy's files: the orography (``uniform(-10, 500)``) and lat/lon
    of a ``shape[:2]`` grid, then one ``(lat, lon, leadtime, member) =
    shape`` float32 array a (run, variable), written through
    ``np.lib.format.open_memmap`` in slabs of ``slab_rows`` latitudes
    drawn from one generator (the same values as one draw of the whole
    array), so a 1.04 GB file never sits in memory."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    n_lat, n_lon = shape[:2]
    np.save(root / OROGRAPHY_FNAME, rng.uniform(-10, 500, (n_lat, n_lon)).astype(np.float32))
    lons, lats = np.meshgrid(np.linspace(-5, 5, n_lon), np.linspace(50, 40, n_lat))
    np.save(root / LATLON_FNAME, np.stack([lons, lats]).astype(np.float32))
    written = [root / OROGRAPHY_FNAME, root / LATLON_FNAME]
    for var in variables:
        file_name = WEATHER_PARAMS[var]["file_name"]
        for run in runs:
            path = root / f"{run.strftime('%Y-%m-%dT%H:%M:%SZ')}_{file_name}_lt1-45_crop.npy"
            out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                            shape=tuple(shape))
            for lo in range(0, n_lat, slab_rows):
                hi = min(n_lat, lo + slab_rows)
                out[lo:hi] = rng.standard_normal((hi - lo, *shape[1:])).astype(np.float32)
            out.flush()
            del out
            written.append(path)
    return written


def write_rainfall_tree(root: Path, t0: dt.datetime, n: int, shape: Tuple[int, int],
                        seed: int = 2, compressed: bool = True) -> List[Path]:
    """``n`` radar files 5 minutes apart from ``t0``: int32
    ``integers(-10, 500)`` (mm/100 a 5 minutes, negative outside the
    radar field) in npz (compressed unless told not to) under
    ``root/Hexagone/<year>/``."""
    rng = np.random.default_rng(seed)
    written = []
    for i in range(n):
        date = t0 + dt.timedelta(minutes=5 * i)
        d = Path(root) / "Hexagone" / f"{date.year}"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{date.strftime(RAINFALL_FORMATSTR)}.npz"
        save = np.savez_compressed if compressed else np.savez
        save(path, rng.integers(-10, 500, shape).astype(np.int32))
        written.append(path)
    return written
