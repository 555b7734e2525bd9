"""Generate a template GRIB for a dataset's grid and output features.

The reference's GRIB export reads an operational Météo-France template
file (reference: io/outputs.py:135) that is not redistributable; this
utility builds an equivalent one from any registered dataset with the
port's codec (``io/grib2.py``) — one constant field per exportable
feature, on the model grid optionally padded by a margin (emulating the
larger operational domain the prediction is embedded into).

Usage:
    python -m py4cast_tpu_torch.tools.make_grib_template --dataset dummy \\
        --output template.grib --margin 8
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from py4cast_tpu_torch.datasets import get_datasets
from py4cast_tpu_torch.io.grib2 import make_template
from py4cast_tpu_torch.io.outputs import template_fids_for_features


def widen(axis: np.ndarray, margin: int) -> np.ndarray:
    """A regular coordinate axis extended by ``margin`` steps at each end."""
    if not margin:
        return axis
    step = axis[1] - axis[0] if len(axis) > 1 else 1.0
    return np.concatenate([axis[0] - step * np.arange(margin, 0, -1), axis,
                           axis[-1] + step * np.arange(1, margin + 1)])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", required=True, help="registered dataset name")
    parser.add_argument("--output", required=True, type=Path)
    parser.add_argument("--margin", type=int, default=0,
                        help="extra grid cells added on every side of the model grid")
    parser.add_argument("--num-input-steps", type=int, default=2)
    parser.add_argument("--num-pred-steps", type=int, default=1)
    args = parser.parse_args(argv)

    train_ds, _, _ = get_datasets(args.dataset, args.num_input_steps, args.num_pred_steps,
                                  args.num_pred_steps)
    grid = train_ds.grid
    lat = widen(np.asarray(grid.lat)[:, 0], args.margin)
    lon = widen(np.asarray(grid.lon)[0, :], args.margin)
    fids = template_fids_for_features(train_ds.dataset_info.output_feature_names)
    make_template(args.output, lat, lon, fids)
    print(f"Wrote template with {len(fids)} fields on a {len(lat)}x{len(lon)} grid to "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
