"""Per-dataset command-line tools: prepare / describe / plot / speedtest.

One argparse app for every accessor, a copy of the JAX package's
``py4cast_tpu/datasets/dataset_cli.py``:

    python -m py4cast_tpu_torch.datasets.dataset_cli titan_aro_arp prepare \
        --dataset-conf titan_aro_arp.json
    python -m py4cast_tpu_torch.datasets.dataset_cli titan_aro_arp describe
    python -m py4cast_tpu_torch.datasets.dataset_cli titan_aro_arp speedtest --batch-size 2

``prepare`` computes the statistics of the train split (the default;
``--no-compute-stats`` skips them) and, with ``--convert-grib2npy``,
first writes Titan's npy tree from its grib files, which needs xarray
and cfgrib. A dataset conf's name is its file's stem, as in the JAX
package: it names the dataset's directories.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from py4cast_tpu_torch.datasets import get_accessor, get_datasets


def _build(name: str, args) -> tuple:
    dataset_conf = args.dataset_conf
    if dataset_conf is not None:
        with open(dataset_conf) as f:
            dataset_conf = json.load(f)
    return get_datasets(
        name,
        args.num_input_steps,
        args.num_pred_steps_train,
        args.num_pred_steps_val_test,
        dataset_conf=dataset_conf,
    )


def _require_grib_readers():
    """Raise an ImportError naming xarray and cfgrib when either is missing."""
    try:
        import cfgrib  # noqa: F401
        import xarray  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"--convert-grib2npy reads grib files with xarray and cfgrib, which are "
            f"not installed ({e})"
        ) from e


def convert_samples_grib2_numpy(dataset):
    """grib → per-(date, param) npy conversion, cropped to the subdomain.
    A file that fails to convert is skipped with a warning (sample-level
    fault tolerance); missing grib readers raise first."""
    _require_grib_readers()
    accessor = dataset.accessor
    dataset.settings.file_format = "grib"
    if "sample_list" in dataset.__dict__:
        del dataset.__dict__["sample_list"]
    domain = dataset.grid.subdomain
    n_files, n_skipped = 0, 0
    for sample in dataset.sample_list:
        for date in sample.timestamps.validity_times:
            for p in sample.params:
                dest = accessor._date_filepath(dataset.name, p, date, "npy")
                dest.parent.mkdir(parents=True, exist_ok=True)
                if dest.exists():
                    continue
                try:
                    arr = accessor.load_data_for_date(
                        dataset.name, p, date, file_format="grib"
                    )
                    arr = arr[domain[0] : domain[1], domain[2] : domain[3]]
                    np.save(dest, arr.astype(np.float32))
                    n_files += 1
                except Exception as e:  # noqa: BLE001 (skip and warn, a file)
                    print(
                        f"WARNING: could not convert "
                        f"{accessor.parameter_namer(p)} {date}: {e}. Skipping."
                    )
                    n_skipped += 1
                    break
    dataset.settings.file_format = "npy"
    print(f"Converted {n_files} files ({n_skipped} skipped).")


def cmd_prepare(name: str, args):
    """Convert the gribs (optional), then the train split's statistics."""
    from py4cast_tpu_torch.datasets.compute_stats import (
        compute_parameters_stats,
        compute_time_step_stats,
    )

    print(f"--> Preparing {name} dataset...")
    train_ds, valid_ds, test_ds = _build(name, args)
    train_ds.cache_dir.mkdir(parents=True, exist_ok=True)
    print(f"Dataset will be cached in {train_ds.cache_dir}")

    if args.convert_grib2npy:
        for ds in (train_ds, valid_ds, test_ds):
            ds.settings.standardize = False
        print("Converting gribs to npy...")
        for split, ds in (("train", train_ds), ("valid", valid_ds), ("test", test_ds)):
            print(split)
            convert_samples_grib2_numpy(ds)
        for ds in (train_ds, valid_ds, test_ds):
            ds.settings.standardize = True

    if args.compute_stats:
        train_ds.__dict__.pop("sample_list", None)
        train_ds.settings.standardize = False
        print("Computing stats on each parameter...")
        compute_parameters_stats(train_ds, batch_size=args.batch_size)
        train_ds.__dict__.pop("sample_list", None)
        train_ds.__dict__.pop("stats", None)
        train_ds.settings.standardize = True
        print("Computing time-step diff stats...")
        compute_time_step_stats(train_ds, batch_size=args.batch_size)


def cmd_describe(name: str, args):
    """Print the dataset's summary, its length and its first item."""
    train_ds, _, _ = _build(name, args)
    train_ds.dataset_info.summary()
    print(f"Length of train dataset: {len(train_ds)}")
    item = train_ds[0]
    print("Example item:")
    print(item)


def cmd_plot(name: str, args):
    """Plot the first train sample's first step, or all steps as a GIF."""
    train_ds, _, _ = _build(name, args)
    sample = train_ds.sample_list[0]
    out = Path(args.output or f"{name}_sample.png")
    if args.gif:
        out = out.with_suffix(".gif")
        sample.plot_gif(out)
    else:
        item = sample.load(no_standardize=True)
        sample.plot(item, 0, out)
    print(f"Saved plot to {out}")


def cmd_speedtest(name: str, args):
    """Input-pipeline throughput: the train loader's first ``--n-iter``
    batches (fewer when the split has fewer)."""
    train_ds, _, _ = _build(name, args)
    loader = train_ds.loader(batch_size=args.batch_size, num_workers=args.num_workers)
    n_batches = 0
    start = time.perf_counter()
    for _ in zip(range(args.n_iter), loader):
        n_batches += 1
    elapsed = time.perf_counter() - start
    if not n_batches:
        raise SystemExit(f"{name}: the train split has no batch of {args.batch_size}")
    print(f"Loading time of {n_batches} batches: {elapsed:.4f} s")
    print(f"ms a batch: {elapsed * 1e3 / n_batches:.3f}")
    print(f"Throughput: {n_batches * args.batch_size / elapsed:.2f} samples/s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset", help="dataset name (registry key or superset)")
    parser.add_argument(
        "command", choices=["prepare", "describe", "plot", "speedtest"]
    )
    parser.add_argument("--dataset-conf", default=None, help="JSON config path")
    parser.add_argument("--num-input-steps", type=int, default=1)
    parser.add_argument("--num-pred-steps-train", type=int, default=1)
    parser.add_argument("--num-pred-steps-val-test", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--n-iter", type=int, default=5)
    parser.add_argument("--convert-grib2npy", action="store_true")
    parser.add_argument("--no-compute-stats", dest="compute_stats",
                        action="store_false")
    parser.add_argument("--gif", action="store_true")
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)

    get_accessor(args.dataset)  # fail fast on unknown dataset
    {
        "prepare": cmd_prepare,
        "describe": cmd_describe,
        "plot": cmd_plot,
        "speedtest": cmd_speedtest,
    }[args.command](args.dataset, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
