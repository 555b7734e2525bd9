"""Host-memory leak canary for the data pipeline.

Iterates the Dummy dataset's loader (``datasets/loader.py``: sample load
+ standardization + collate, the code the reference's leak class lives
in, ``py4cast/ideas/minimal_leak.py``) for several epochs and reports
the process RSS trajectory, read from ``/proc/<pid>/status``. Bounded
RSS after the warm-up epoch = no leak; growth beyond ``--grow-mb`` exits
1. The pipeline standardizes in numpy (the reference's own conclusion:
"Using numpy seems to work fine") and holds batches in shared memory
without pickling, so the canary should stay flat. It touches no card.

Usage:
    python -m py4cast_tpu_torch.tools.host_memory_check [--epochs 6] [--batch-size 8]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path


def rss_mb() -> float:
    """This process's resident set, MB."""
    with open(f"/proc/{os.getpid()}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--grow-mb", type=float, default=64.0,
                    help="max tolerated RSS growth after the warm-up epoch")
    args = ap.parse_args(argv)

    # the Dummy files go to a scratch root unless the caller names one
    os.environ.setdefault("PY4CAST_TPU_ROOTDIR", str(Path(tempfile.gettempdir()) / "p4t_memcheck"))
    from py4cast_tpu_torch.datasets import get_datasets

    train_ds, _, _ = get_datasets("dummy", 2, 1, 1)
    per_epoch = []
    for epoch in range(args.epochs):
        n = 0
        for batch in train_ds.loader(batch_size=args.batch_size, num_workers=2, shuffle=True):
            # touch the standardized arrays so lazy work actually runs
            float(batch.inputs.array.mean())
            float(batch.outputs.array.mean())
            n += 1
        per_epoch.append(rss_mb())
        print(f"epoch {epoch}: {n} batches, RSS {per_epoch[-1]:.1f} MB", flush=True)

    growth = per_epoch[-1] - per_epoch[0]  # after the warm-up epoch
    print(f"RSS growth after warm-up: {growth:+.1f} MB (tolerance {args.grow_mb} MB)")
    ok = growth <= args.grow_mb
    print("MEMCHECK", "OK" if ok else "LEAK")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
