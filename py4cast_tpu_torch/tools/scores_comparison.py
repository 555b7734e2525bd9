"""Compare the test scores of several runs: one panel a variable, each
run's scores against lead time.

Reads the per-run ``Test_{metric}_scores.json`` that ``Trainer.test``
writes (``plots.StateErrorPlot``), as the JAX package's
``bin/scores_comparison.py`` does.

Usage:
    python -m py4cast_tpu_torch.tools.scores_comparison \\
        --runs runA/Test_rmse_scores.json runB/Test_rmse_scores.json \\
        --labels A B --output scores.png
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from py4cast_tpu_torch.plots import pyplot


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", nargs="+", required=True,
                   help="paths to Test_<metric>_scores.json files")
    p.add_argument("--labels", nargs="+", default=None)
    p.add_argument("--output", default="scores_comparison.png")
    p.add_argument("--step-duration-h", type=float, default=1.0)
    args = p.parse_args(argv)

    labels = args.labels or [Path(r).parent.name for r in args.runs]
    if len(labels) != len(args.runs):
        raise SystemExit("--labels must match --runs")

    scores = []
    for run in args.runs:
        with open(run) as f:
            scores.append(json.load(f))

    plt = pyplot()
    variables = sorted(set().union(*[set(s) for s in scores]))
    ncols = min(3, len(variables))
    nrows = -(-len(variables) // ncols)
    fig, axs = plt.subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows), squeeze=False)
    for i, var in enumerate(variables):
        ax = axs[i // ncols][i % ncols]
        for label, s in zip(labels, scores):
            if var not in s:
                continue
            vals = s[var]
            leadtimes = (np.arange(len(vals)) + 1) * args.step_duration_h
            ax.plot(leadtimes, vals, marker="o", label=label)
        ax.set_title(var)
        ax.set_xlabel("Lead time (h)")
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(args.output)
    plt.close(fig)
    print(f"Saved comparison figure to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
