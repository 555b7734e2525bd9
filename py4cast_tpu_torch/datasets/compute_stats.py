"""Dataset statistics: streaming per-feature mean/std/min/max and
time-difference stats.

A copy of the JAX package's ``py4cast_tpu/datasets/compute_stats.py``:
nan-aware accumulation of per-sample spatial means of x and x², diff
stats computed on standardized data, forcing diff stats pinned to
(0, 1). Written by ``Stats.save`` in the JAX package's JSON, so either
package reads the other's ``parameters_stats.json`` and
``diff_stats.json``.
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np

from py4cast_tpu_torch.datasets.access import Stats


def _flat_bxf(arr: np.ndarray) -> np.ndarray:
    """(B, T, *spatial, F) → (B, X, F)"""
    return arr.reshape(arr.shape[0], -1, arr.shape[-1])


def compute_mean_std_min_max(
    dataset, type_tensor: Literal["inputs", "outputs", "forcing"], batch_size: int = 1
) -> dict:
    """Per-feature mean, std, min and max of ``type_tensor`` over the
    (unstandardized) dataset."""
    if dataset.settings.standardize:
        raise ValueError("Your dataset should not be standardized.")

    loader = dataset.loader(batch_size=batch_size, num_workers=2, shuffle=False)
    first = next(iter(loader))
    named = getattr(first, type_tensor)
    if named is None:
        return {}
    n_features = len(named.feature_names)
    sum_means = np.zeros(n_features)
    sum_squares = np.zeros(n_features)
    best_min = np.full(n_features, np.inf)
    best_max = np.full(n_features, -np.inf)
    counter = 0
    warned = False

    for batch in loader:
        arr = _flat_bxf(np.asarray(getattr(batch, type_tensor).array))
        if not warned and np.isnan(arr).any():
            warnings.warn(
                "Dataset contains NaN values; statistics ignore the NaNs."
            )
            warned = True
        counter += arr.shape[0]
        sum_means += np.nansum(np.nanmean(arr, axis=1), axis=0)
        sum_squares += np.nansum(np.nanmean(arr**2, axis=1), axis=0)
        best_min = np.minimum(
            best_min, np.nan_to_num(arr, nan=np.inf).min(axis=(0, 1))
        )
        best_max = np.maximum(
            best_max, np.nan_to_num(arr, nan=-np.inf).max(axis=(0, 1))
        )

    mean = sum_means / counter
    std = np.sqrt(np.maximum(sum_squares / counter - mean**2, 0.0))
    return {
        name: {
            "mean": float(mean[i]),
            "std": float(std[i]),
            "min": float(best_min[i]),
            "max": float(best_max[i]),
        }
        for i, name in enumerate(named.feature_names)
    }


def compute_parameters_stats(dataset, batch_size: int = 1) -> Stats:
    """First (unstandardized) pass over the dataset."""
    all_stats: dict = {}
    for type_tensor in ["inputs", "outputs", "forcing"]:
        for feature, st in compute_mean_std_min_max(
            dataset, type_tensor, batch_size
        ).items():
            all_stats.setdefault(feature, st)  # keep first occurrence
    stats = Stats(stats=all_stats)
    dest = dataset.cache_dir / "parameters_stats.json"
    stats.save(dest)
    print(f"Parameters statistics saved in {dest}")
    return stats


def compute_time_step_stats(dataset, batch_size: int = 1) -> Stats:
    """Second (standardized) pass: stats of x_{t+1} − x_t."""
    if not dataset.settings.standardize:
        raise ValueError("Your dataset should be standardized.")

    loader = dataset.loader(batch_size=batch_size, num_workers=2, shuffle=False)
    sum_means = sum_squares = None
    counter = 0
    feature_names = forcing_names = None

    for batch in loader:
        inputs = np.asarray(batch.inputs.array)
        outputs = np.asarray(batch.outputs.array)
        in_out = np.concatenate([inputs, outputs], axis=1)
        diff = _flat_bxf(in_out[:, 1:] - in_out[:, :-1])
        if sum_means is None:
            n = diff.shape[-1]
            sum_means, sum_squares = np.zeros(n), np.zeros(n)
            feature_names = batch.inputs.feature_names
            forcing_names = (
                batch.forcing.feature_names if batch.forcing is not None else ()
            )
        counter += in_out.shape[0]
        sum_means += np.nansum(np.nanmean(diff, axis=1), axis=0)
        sum_squares += np.nansum(np.nanmean(diff**2, axis=1), axis=0)

    diff_mean = sum_means / counter
    diff_std = np.sqrt(np.maximum(sum_squares / counter - diff_mean**2, 0.0))
    store = {
        name: {"mean": float(diff_mean[i]), "std": float(diff_std[i])}
        for i, name in enumerate(feature_names)
    }
    # forcing diffs are unused in training: pinned
    for name in forcing_names:
        store[name] = {"mean": 0.0, "std": 1.0}
    stats = Stats(stats=store)
    dest = dataset.cache_dir / "diff_stats.json"
    stats.save(dest)
    print(f"Time-difference statistics saved in {dest}")
    return stats
