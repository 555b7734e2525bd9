"""Inference product export: GIF animations and GRIB2 fields.

GRIB files are written through the in-repo codec (``io/grib2.py``)
against a template GRIB: each predicted feature and leadtime is
embedded into the template field with the same parameter id, masked
outside the model's subdomain. GIFs need matplotlib; asking for them
without it raises an ImportError that names it.

Predictions come as the port's NamedArrays (``Trainer.predict`` returns
them on the host); GRAPH models' (ngrid) layout is put back onto the
dataset's (lat, lon) grid before export.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import warnings
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from py4cast_tpu_torch.io.grib2 import LEVEL_TYPE_CODES, read_grib2, write_grib2
from py4cast_tpu_torch.named_tensor import NamedArray
from py4cast_tpu_torch.utils import to_host


@dataclass
class OutputSavingSettings:
    """Template/path settings for product export.

    The format strings are validated: each template must contain the
    declared number of ``{}`` placeholders.
    """

    template_grib: str = ""
    directory: str = "."
    output_kwargs: tuple = ()
    sample_identifiers: tuple = ("date", "leadtime")
    output_fmt: str = "grib"
    path_to_runtime: str = "{}/{}.grib"

    def __post_init__(self):
        n_placeholders = self.path_to_runtime.count("{}")
        n_ids = len(self.output_kwargs) + len(self.sample_identifiers)
        if n_placeholders != n_ids:
            raise ValueError(
                f"path_to_runtime has {n_placeholders} placeholders but "
                f"{n_ids} identifiers were declared "
                f"({self.output_kwargs} + {self.sample_identifiers})"
            )

    def get_path(self, *identifiers) -> str:
        return self.path_to_runtime.format(*self.output_kwargs, *identifiers)

    @classmethod
    def from_json(cls, fname) -> "OutputSavingSettings":
        with open(fname) as f:
            d = json.load(f)
        for k in ("output_kwargs", "sample_identifiers"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)


def match_latlon(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    template_lat: np.ndarray,
    template_lon: np.ndarray,
):
    """Locate the model grid inside a (larger) template grid.

    Returns (lat_slice, lon_slice) into the template, raising if the
    model grid is not embeddable.
    """
    lat0, lat1 = float(grid_lat.min()), float(grid_lat.max())
    lon0, lon1 = float(grid_lon.min()), float(grid_lon.max())
    tlat = np.asarray(template_lat)
    tlon = np.asarray(template_lon)
    lat_ok = (tlat >= lat0 - 1e-6) & (tlat <= lat1 + 1e-6)
    lon_ok = (tlon >= lon0 - 1e-6) & (tlon <= lon1 + 1e-6)
    if lat_ok.sum() != len(np.unique(np.asarray(grid_lat))) or lon_ok.sum() != len(
        np.unique(np.asarray(grid_lon))
    ):
        raise ValueError(
            "Model grid is not embeddable in the GRIB template grid: "
            f"model lat [{lat0}, {lat1}] lon [{lon0}, {lon1}] vs template "
            f"lat [{tlat.min()}, {tlat.max()}] lon [{tlon.min()}, {tlon.max()}]"
        )
    lat_idx = np.nonzero(lat_ok)[0]
    lon_idx = np.nonzero(lon_ok)[0]
    return (
        slice(int(lat_idx[0]), int(lat_idx[-1]) + 1),
        slice(int(lon_idx[0]), int(lon_idx[-1]) + 1),
    )


def fill_tensor_with(
    template_shape, values: np.ndarray, lat_slice: slice, lon_slice: slice,
    fill_value=np.nan,
):
    """Embed a subgrid field into a full-size masked array."""
    out = np.full(template_shape, fill_value, dtype=np.float32)
    out[lat_slice, lon_slice] = values
    return np.ma.masked_invalid(out)


#: GRIB shortname token → (discipline, parameterCategory, parameterNumber,
#: cumulative, eccodes-style alias): the surface, gust, precipitation
#: integral, radiation, isobaric upper-air and radar parameters of the
#: Titan dataset
FEATURE2GRIB = {
    # AROME / ARPEGE surface
    "t2m": (0, 0, 0, False, "2t"),
    "r2": (0, 1, 1, False, "2r"),
    "u10": (0, 2, 2, False, "10u"),
    "v10": (0, 2, 3, False, "10v"),
    "ugust": (0, 2, 23, False, "ugust"),
    "vgust": (0, 2, 24, False, "vgust"),
    "tp": (0, 1, 8, True, "tp"),
    "tirf": (0, 1, 65, True, "tirf"),
    "sprate": (0, 1, 66, True, "sprate"),
    "sd": (0, 1, 11, False, "sd"),
    "str": (0, 5, 5, True, "str"),
    "ssr": (0, 4, 9, True, "ssr"),
    "tciwv": (0, 1, 64, False, "tciwv"),
    "prmsl": (0, 3, 1, False, "prmsl"),
    # Antilope radar precipitation
    "prec": (0, 1, 8, True, "prec"),
    # isobaric upper-air
    "z": (0, 3, 4, False, "z"),
    "t": (0, 0, 0, False, "t"),
    "u": (0, 2, 2, False, "u"),
    "v": (0, 2, 3, False, "v"),
    "wz": (0, 2, 9, False, "wz"),
    "r": (0, 1, 1, False, "r"),
    "ciwc": (0, 1, 84, False, "ciwc"),
    "clwc": (0, 1, 83, False, "clwc"),
    "crwc": (0, 1, 85, False, "crwc"),
    "cswc": (0, 1, 86, False, "cswc"),
}


def feature2fid(feature_name: str, time_step_hours: int = 1) -> Optional[dict]:
    """Map a feature name (``{var}_{level}_{leveltype}``) to GRIB2
    identification keys.

    Unknown variables fall back to a deterministic local-table id
    (category 254) so synthetic datasets still round-trip through the
    template workflow.
    """
    parts = feature_name.split("_")
    if len(parts) < 3:
        return None
    level_type = parts[-1]
    if level_type not in LEVEL_TYPE_CODES:
        return None
    try:
        level = int(parts[-2])
    except ValueError:
        return None
    var = parts[-3]  # the grib shortname token, e.g. aro_t2m → t2m

    known = FEATURE2GRIB.get(var)
    if known is not None:
        discipline, category, number, cumulative, alias = known
    else:
        discipline, category = 0, 254  # local-use category
        number = zlib.crc32(var.encode()) % 255
        cumulative, alias = False, var
    fid = {
        "shortName": alias,
        "discipline": discipline,
        "parameterCategory": category,
        "parameterNumber": number,
        "typeOfLevel": level_type,
        "typeOfFirstFixedSurface": LEVEL_TYPE_CODES[level_type],
        "level": level,
        "productDefinitionTemplateNumber": 8 if cumulative else 0,
    }
    if cumulative:
        fid["typeOfStatisticalProcessing"] = 1  # accumulation
        fid["lengthOfTimeRange"] = time_step_hours
    return fid


def template_fids_for_features(
    feature_names, time_step_hours: int = 1
) -> List[dict]:
    """The parameter ids a template GRIB must contain to export the given
    features — feed to :func:`py4cast_tpu_torch.io.grib2.make_template`."""
    fids = []
    for name in feature_names:
        fid = feature2fid(name, time_step_hours)
        if fid is not None:
            fids.append(fid)
    return fids


def _embed_in_template(tf, data: np.ndarray, glat, glon):
    """Embed model-grid data into a template field's grid, aligning row /
    column orientation, masked outside the model subdomain."""
    lat_slice, lon_slice = match_latlon(glat, glon, tf.lat, tf.lon)
    if (glat[0] > glat[-1]) != (tf.lat[0] > tf.lat[-1]):
        data = data[::-1]
    if len(glon) > 1 and len(tf.lon) > 1 and (
        (glon[0] > glon[-1]) != (tf.lon[0] > tf.lon[-1])
    ):
        data = data[:, ::-1]
    return fill_tensor_with(tf.values.shape, data, lat_slice, lon_slice)


def save_named_tensors_to_grib(
    pred: NamedArray,
    grid,
    validity_times: List[dt.datetime],
    settings: OutputSavingSettings,
    sample_identifiers=(),
    base_datetime: Optional[dt.datetime] = None,
    time_step_hours: int = 1,
):
    """Template-based GRIB2 export: read the template, embed each
    predicted feature × leadtime (``pred`` is (timestep, lat, lon,
    features)) into the matching template field via ``match_latlon`` /
    ``fill_tensor_with``, and write one GRIB per leadtime.
    """
    if not settings.template_grib or not Path(settings.template_grib).exists():
        warnings.warn(
            f"template_grib {settings.template_grib!r} not found; "
            "skipping GRIB export"
        )
        return []

    template = read_grib2(settings.template_grib)
    by_key = {tf.param_key(): tf for tf in template}

    glat = np.asarray(grid.lat)[:, 0]
    glon = np.asarray(grid.lon)[0, :]
    if base_datetime is None:
        base_datetime = validity_times[0] - dt.timedelta(hours=time_step_hours)

    per_leadtime = "leadtime" in settings.sample_identifiers
    written = []
    skipped = set()
    fields_by_path: dict = {}
    for t, vt in enumerate(validity_times):
        leadtime = int(round((vt - base_datetime).total_seconds() / 3600))
        ids = tuple(sample_identifiers) + ((leadtime,) if per_leadtime else ())
        path = Path(settings.directory) / settings.get_path(*ids)
        for fname in pred.feature_names:
            fid = feature2fid(fname, time_step_hours)
            if fid is None:
                skipped.add(fname)
                continue
            key = (
                fid["discipline"], fid["parameterCategory"],
                fid["parameterNumber"], fid["typeOfFirstFixedSurface"],
                float(fid["level"]),
            )
            tf = by_key.get(key)
            if tf is None:
                skipped.add(fname)
                continue
            data = to_host(pred[fname])[t, :, :, 0]
            embedded = _embed_in_template(tf, data, glat, glon)
            fields_by_path.setdefault(path, []).append(
                dataclasses.replace(
                    tf,
                    values=embedded,
                    data_date=base_datetime.date(),
                    data_time=(base_datetime.hour, base_datetime.minute),
                    forecast_hours=leadtime,
                    pdt=fid["productDefinitionTemplateNumber"],
                    stat_processing=fid.get("typeOfStatisticalProcessing", 1),
                    length_of_time_range=fid.get(
                        "lengthOfTimeRange", time_step_hours
                    ),
                )
            )
    for path, fields in fields_by_path.items():
        write_grib2(path, fields)
        written.append(path)
    if skipped:
        warnings.warn(
            f"No GRIB id/template field for features: {sorted(skipped)}"
        )
    return written


def save_gifs(pred: NamedArray, out_dir: Path, prefix: str = "pred"):
    """One animated GIF per feature over the rollout; ``pred`` is
    (timestep, lat, lon, features)."""
    from py4cast_tpu_torch.plots import pyplot, save_frames_as_gif

    plt = pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for fname in pred.feature_names:
        arr = to_host(pred[fname])[:, :, :, 0]  # (T, lat, lon)
        vmin, vmax = np.nanmin(arr), np.nanmax(arr)
        frames = []
        for t in range(arr.shape[0]):
            fig, ax = plt.subplots(figsize=(4, 4))
            ax.imshow(arr[t][::-1], vmin=vmin, vmax=vmax)
            ax.set_title(f"{fname} +{t + 1}")
            ax.axis("off")
            fig.canvas.draw()
            frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
            plt.close(fig)
        path = out_dir / f"{prefix}_{fname}.gif"
        save_frames_as_gif(frames, path)
        paths.append(path)
    return paths


def save_predictions(
    preds: List[NamedArray],
    infer_ds,
    out_dir: Path,
    save_gifs_flag: bool = False,
    save_gribs: bool = False,
    io_conf: Optional[str] = None,
    **kwargs,
):
    """Export a list of prediction batches (one NamedArray per batch):
    GIFs under ``out_dir/gifs``, GRIB files where ``io_conf``'s
    settings put them. GIFs without matplotlib raise an ImportError
    before anything is written."""
    save_gifs_flag = save_gifs_flag or kwargs.pop("save_gifs", False)
    if save_gifs_flag:
        from py4cast_tpu_torch.plots import pyplot

        pyplot()  # an ImportError naming matplotlib, before any export
    settings = (
        OutputSavingSettings.from_json(io_conf) if (io_conf and save_gribs) else None
    )
    offset = 0  # running sample index — batches may have uneven sizes
    for b, batch_pred in enumerate(preds):
        if "ngrid" in batch_pred.names:  # GRAPH models: back onto the grid
            batch_pred = batch_pred.unflatten(
                "ngrid", (infer_ds.grid.x, infer_ds.grid.y), ("lat", "lon"))
        for i, sample_pred in enumerate(batch_pred.iter_dim("batch")):
            tag = f"b{b}_s{i}"
            if save_gifs_flag:
                save_gifs(sample_pred, Path(out_dir) / "gifs", prefix=tag)
            if save_gribs and settings is not None:
                sample = infer_ds.sample_list[offset + i]
                deltas = sample.timestamps.timedeltas
                step_h = (
                    int((deltas[1] - deltas[0]).total_seconds() // 3600)
                    if len(deltas) > 1
                    else 1
                )
                save_named_tensors_to_grib(
                    sample_pred,
                    infer_ds.grid,
                    sample.output_timestamps.validity_times,
                    settings,
                    sample_identifiers=_sample_identifiers(
                        settings, sample, tag
                    ),
                    base_datetime=sample.timestamps.datetime,
                    time_step_hours=max(1, step_h),
                )
        offset += batch_pred.dim_size("batch")


def _sample_identifiers(settings: OutputSavingSettings, sample, tag: str):
    """Resolve the settings' declared identifier names against a sample:
    ``date``/``runtime`` (the run's datetime), ``member``, anything else
    (``sample`` and custom names) the batch tag. ``leadtime`` is
    appended per output step by save_named_tensors_to_grib."""
    ids = []
    for name in settings.sample_identifiers:
        if name == "leadtime":
            continue
        if name in ("date", "runtime"):
            ids.append(sample.timestamps.datetime.strftime("%Y%m%d%H"))
        elif name == "member":
            ids.append(getattr(sample, "member", 0))
        else:  # "sample" and any custom identifier: the batch tag
            ids.append(tag)
    return tuple(ids)
