"""Convert a prepared Titan npy tree into one chunked zarr array.

A copy of the JAX package's ``py4cast_tpu/datasets/titan/npy2zarr.py``.
A single zarr store turns thousands of small-file reads into a handful
of chunk reads. Needs zarr, imported only when converting.

Usage:
    python -m py4cast_tpu_torch.datasets.titan.npy2zarr \
        --data-dir <cache>/data --out <cache>/data.zarr
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def convert(data_dir: Path, out: Path, chunk_dates: int = 24) -> Path:
    try:
        import zarr
    except ImportError as e:
        raise ImportError(f"converting to zarr needs zarr, which is not installed ({e})") from e

    date_dirs = sorted(p for p in Path(data_dir).iterdir() if p.is_dir())
    if not date_dirs:
        raise SystemExit(f"No date directories under {data_dir}")
    params = sorted(p.stem for p in date_dirs[0].glob("*.npy"))
    probe = np.load(date_dirs[0] / f"{params[0]}.npy")

    store = zarr.open(
        str(out),
        mode="w",
        shape=(len(date_dirs), len(params)) + probe.shape,
        chunks=(chunk_dates, len(params)) + probe.shape,
        dtype=np.float32,
    )
    for i, d in enumerate(date_dirs):
        for j, name in enumerate(params):
            store[i, j] = np.load(d / f"{name}.npy")
    # sidecar metadata
    (Path(out) / ".dates").write_text("\n".join(p.name for p in date_dirs))
    (Path(out) / ".params").write_text("\n".join(params))
    print(f"Wrote {out}: {store.shape} ({len(date_dirs)} dates × {len(params)} params)")
    return Path(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--chunk-dates", type=int, default=24)
    a = ap.parse_args()
    convert(Path(a.data_dir), Path(a.out), a.chunk_dates)
