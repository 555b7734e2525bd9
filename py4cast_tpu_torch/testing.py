"""Synthetic in-memory fixtures for smoke runs and tests: a full
DatasetInfo (grid statics, stats, diff stats) and batches drawn from a
numpy seed, without touching disk."""

from __future__ import annotations

import datetime as dt
from typing import Tuple

import numpy as np

from py4cast_tpu_torch.datasets.access import Stats
from py4cast_tpu_torch.datasets.base import DatasetInfo, Item, ItemBatch, Statics, collate_fn
from py4cast_tpu_torch.named_tensor import NamedArray


def synthetic_statics(grid_shape: Tuple[int, int], border_size: int = 10) -> Statics:
    h, w = grid_shape
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    border = np.zeros((h, w), np.float32)
    if border_size > 0:
        border[:border_size] = border[-border_size:] = 1.0
        border[:, :border_size] = border[:, -border_size:] = 1.0
    gp = np.zeros((h, w), np.float32)
    statics = np.stack([xs, ys, gp, border], axis=-1).astype(np.float32)
    return Statics(
        grid_statics=NamedArray(
            statics, ("lat", "lon", "features"), ("x", "y", "geopotential", "border_mask")
        ),
        grid_shape=grid_shape,
    )


def synthetic_dataset_info(
    grid_shape: Tuple[int, int] = (64, 64),
    weather_features: int = 1,
    forcing_features: int = 5,
    border_size: int = 10,
    name: str = "synthetic",
) -> DatasetInfo:
    out_names = tuple(f"var{i}_500_isobaricInhPa" for i in range(weather_features))
    forcing_names = tuple(
        [f"forcing{i}" for i in range(forcing_features - 5)]
        + ["cos_hour", "sin_hour", "cos_doy", "sin_doy", "toa_radiation"]
    )
    stats = Stats(
        stats={
            n: {"mean": 0.0, "std": 1.0, "min": -3.0, "max": 3.0}
            for n in out_names + forcing_names
        }
    )
    diff_stats = Stats(stats={n: {"mean": 0.0, "std": 1.0} for n in out_names + forcing_names})
    return DatasetInfo(
        name=name,
        units={n: "-" for n in out_names},
        weather_dim=weather_features,
        forcing_dim=forcing_features,
        pred_step=dt.timedelta(hours=1),
        statics=synthetic_statics(grid_shape, border_size),
        stats=stats,
        diff_stats=diff_stats,
        state_weights={n: 1.0 for n in out_names},
        shortnames={"input": [], "input_output": list(out_names), "output": []},
        output_feature_names=out_names,
        forcing_feature_names=forcing_names,
        units_by_feature={n: "-" for n in out_names},
    )


def synthetic_batch(
    info: DatasetInfo,
    batch_size: int = 1,
    num_input_steps: int = 2,
    num_pred_steps: int = 1,
    seed: int = 0,
) -> ItemBatch:
    """A batch of standard-normal fields drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    h, w = info.statics.grid_shape
    names = ("timestep", "lat", "lon", "features")
    items = []
    for _ in range(batch_size):
        def field(steps, n_feat):
            return rng.standard_normal((steps, h, w, n_feat)).astype(np.float32)

        t0 = dt.datetime(2023, 1, 1)
        items.append(
            Item(
                inputs=NamedArray(field(num_input_steps, info.weather_dim), names,
                                  info.output_feature_names),
                outputs=NamedArray(field(num_pred_steps, info.weather_dim), names,
                                   info.output_feature_names),
                forcing=NamedArray(field(num_pred_steps, info.forcing_dim), names,
                                   info.forcing_feature_names),
                validity_times=[t0 + dt.timedelta(hours=i) for i in range(num_pred_steps)],
            )
        )
    return collate_fn(items)
