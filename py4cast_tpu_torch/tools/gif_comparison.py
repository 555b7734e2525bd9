"""Side-by-side animated comparison of several trained checkpoints on
one case study: a GIF a feature, the ground truth beside each model's
forecast.

Each run is rebuilt from its own manifest
(``CheckpointManager.read_manifest``: the model, its settings and the
rollout's) and its checkpoint restored with
``CheckpointManager.restore``, as the JAX package's
``bin/gif_comparison.py`` does with its orbax checkpoints.

Usage:
    python -m py4cast_tpu_torch.tools.gif_comparison \\
        --ckpts runA/checkpoints/best runB/checkpoints/best --dataset dummy \\
        --date 2023010500 --num-pred-steps 6 --output-dir gifs/
"""

from __future__ import annotations

import argparse
import datetime as dt
import sys
from pathlib import Path

import numpy as np
import torch

from py4cast_tpu_torch.checkpoint import CheckpointManager
from py4cast_tpu_torch.datasets import get_datasets
from py4cast_tpu_torch.datasets.base import collate_fn
from py4cast_tpu_torch.plots import pyplot, save_frames_as_gif
from py4cast_tpu_torch.training import AutoRegressiveModule, TrainingSettings
from py4cast_tpu_torch.utils import to_host


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpts", nargs="+", required=True,
                   help="checkpoint directories (<save_path>/checkpoints/{last,best})")
    p.add_argument("--labels", nargs="+", default=None)
    p.add_argument("--dataset", default="dummy")
    p.add_argument("--date", default=None, help="case-study run time YYYYMMDDHH")
    p.add_argument("--num-pred-steps", type=int, default=4)
    p.add_argument("--output-dir", default="gif_comparison")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    labels = args.labels or [Path(c).parent.parent.name for c in args.ckpts]
    managers = [CheckpointManager(Path(c).parent, write=False) for c in args.ckpts]
    manifests = [m.read_manifest() for m in managers]
    num_input_steps = manifests[0]["training_settings"]["num_input_steps"]

    _, _, test_ds = get_datasets(args.dataset, num_input_steps, args.num_pred_steps,
                                 args.num_pred_steps)
    samples = test_ds.sample_list
    if args.date:
        t0 = dt.datetime.strptime(args.date, "%Y%m%d%H")
        samples = [s for s in samples if s.timestamps.datetime == t0] or samples
    batch = collate_fn([samples[0].load()])

    # ground truth, de-normalized: (T, lat, lon, F)
    info = test_ds.dataset_info
    std = info.stats.to_array("std", info.output_feature_names)
    mean = info.stats.to_array("mean", info.output_feature_names)
    truth = np.asarray(batch.outputs.array)[0] * std + mean

    preds_per_model = []
    for ckpt, manager, manifest in zip(args.ckpts, managers, manifests):
        ts = manifest["training_settings"]
        settings = TrainingSettings(
            model_name=manifest["model_name"],
            settings_init_args=dict(manifest["model_settings"]),
            training_strategy=ts["training_strategy"],
            num_inter_steps=ts["num_inter_steps"],
            num_input_steps=ts["num_input_steps"],
            mask_on_nan=ts.get("mask_on_nan", False),
        )
        module = AutoRegressiveModule(settings, info, device=args.device)
        state = module.init_state(torch.Generator().manual_seed(0), 1)
        state = manager.restore(ckpt, state)
        preds = module.predict_step(state, batch)
        # a graph model's (T, ngrid, F) on the grid of the truth
        preds_per_model.append(to_host(preds.array)[0].reshape(truth.shape))

    plt = pyplot()
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ncols = 1 + len(preds_per_model)
    for f_i, fname in enumerate(info.output_feature_names):
        vmin = truth[..., f_i].min()
        vmax = truth[..., f_i].max()
        frames = []
        for t in range(truth.shape[0]):
            fig, axs = plt.subplots(1, ncols, figsize=(4 * ncols, 4))
            panels = [("AROME (truth)", truth[t, :, :, f_i])] + [
                (lbl, pr[t, :, :, f_i]) for lbl, pr in zip(labels, preds_per_model)
            ]
            for ax, (title, data) in zip(np.atleast_1d(axs), panels):
                ax.imshow(data[::-1], vmin=vmin, vmax=vmax)
                ax.set_title(f"{title} +{t + 1}")
                ax.axis("off")
            fig.suptitle(fname)
            fig.canvas.draw()
            frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
            plt.close(fig)
        dest = out_dir / f"comparison_{fname}.gif"
        save_frames_as_gif(frames, dest)
        print(f"Saved {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
