"""Checkpoints: the training state as one ``torch.save`` file, plus a
JSON manifest.

The port's own format. The JAX package writes orbax trees, which need
JAX to read; this package reads and writes

    <save_path>/checkpoints/manifest.json
    <save_path>/checkpoints/{last,best}/state.pt

where ``state.pt`` holds the parameters, the AdamW state, the
scheduler state, the optimizer-step count and the gradient-accumulation
buffer (``training.TrainState.state_dict``). The manifest carries the
JAX package's keys with ``"framework": "py4cast_tpu_torch"``, so an
artifact describes itself for the inference-time contract checks.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

#: Param-tree semantics version, stamped into every manifest; the same
#: numbering as the JAX package's. History:
#:   1 (implicit, manifests without the field): SwinUNetR ConvBlockRes /
#:     UNetRPP stem used 8-group GroupNorm.
#:   2: per-channel instance norm, affine-free: SwinUNetR/UNetRPP param
#:     trees changed; GroupNorm scale/bias leaves are gone.
CHECKPOINT_FORMAT_VERSION = 2

#: models whose param semantics changed at each version bump — only
#: their old checkpoints are actually incompatible
_FORMAT_AFFECTED_MODELS = {2: ("SwinUNetR", "UNetRPP")}

#: the file a checkpoint directory holds
STATE_FILE = "state.pt"


def check_format_version(manifest: dict) -> None:
    """Refuse a checkpoint whose param semantics predate the current
    format: a shape-compatible restore would silently compute different
    outputs."""
    stored = int(manifest.get("checkpoint_format", 1))
    if stored >= CHECKPOINT_FORMAT_VERSION:
        return
    model = manifest.get("model_name", "")
    affected = [
        v for v in range(stored + 1, CHECKPOINT_FORMAT_VERSION + 1)
        if model in _FORMAT_AFFECTED_MODELS.get(v, ())
    ]
    if affected:
        raise ValueError(
            f"Checkpoint format {stored} predates version(s) {affected} "
            f"which changed {model}'s normalization param semantics "
            "(8-group GroupNorm → affine-free per-channel instance norm). "
            "Restoring would silently compute different outputs. Re-train."
        )


def _jsonable(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _jsonable(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def state_file(path) -> Path:
    """The ``state.pt`` of a checkpoint directory. Raises when there is
    none: a directory the JAX package wrote holds an orbax tree, which
    needs JAX to read."""
    path = Path(path)
    target = path / STATE_FILE if path.is_dir() else path
    if target.is_file():
        return target
    if path.is_dir():
        raise ValueError(
            f"{path} holds no {STATE_FILE}: it is not a py4cast_tpu_torch "
            "checkpoint. An orbax checkpoint of the JAX package (py4cast_tpu) "
            "cannot be read without JAX; convert its params with "
            "py4cast_tpu_torch.convert.params_from_jax instead"
        )
    raise FileNotFoundError(f"No checkpoint at {path}")


class CheckpointManager:
    """Saves `last` and `best` (lowest val_mean_loss) checkpoints.

    Layout: <dir>/last/state.pt, <dir>/best/state.pt + <dir>/manifest.json

    ``write=False`` (every rank but 0 under a process group) writes
    nothing: ``maybe_save_best`` still tracks the best metric, so that
    every rank takes the same early-stopping decisions, and ``restore``
    reads what rank 0 wrote.
    """

    def __init__(self, directory: Path, manifest: Optional[dict] = None, write: bool = True):
        self.directory = Path(directory)
        self.write = write
        self.best_metric = float("inf")
        if write:
            self.directory.mkdir(parents=True, exist_ok=True)
            if manifest is not None:
                self.write_manifest(manifest)

    def write_manifest(self, manifest: dict):
        with open(self.directory / "manifest.json", "w") as f:
            json.dump(_jsonable(manifest), f, indent=1, default=str)

    def read_manifest(self) -> dict:
        with open(self.directory / "manifest.json") as f:
            return json.load(f)

    def _save(self, name: str, state):
        """Crash-safe replace: write to a temp sibling, then swap via
        renames — a valid copy of the previous checkpoint stays on disk
        until the new one is fully written."""
        if not self.write:
            return
        final = (self.directory / name).absolute()
        tmp = (self.directory / f".{name}.tmp").absolute()
        old = (self.directory / f".{name}.old").absolute()
        for stale in (tmp, old):
            if stale.exists():
                shutil.rmtree(stale)
        tmp.mkdir()
        torch.save(state.state_dict(), tmp / STATE_FILE)
        if final.exists():
            final.rename(old)
        tmp.rename(final)
        if old.exists():
            shutil.rmtree(old)

    def save_last(self, state):
        self._save("last", state)

    def maybe_save_best(self, state, metric: float) -> bool:
        if metric < self.best_metric:
            self.best_metric = metric
            self._save("best", state)
            return True
        return False

    def restore(self, name: str, state):
        """Load checkpoint ``name`` (``last``/``best`` under this
        directory, or a path) into ``state`` in place; returns it."""
        path = self.directory / name
        if not path.exists():
            path = Path(name)
        payload = torch.load(state_file(path), map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        return state


def load_manifest(ckpt_path: Path) -> dict:
    """Find manifest.json next to (or above) a checkpoint dir."""
    p = Path(ckpt_path)
    for cand in (p / "manifest.json", p.parent / "manifest.json"):
        if cand.exists():
            with open(cand) as f:
                return json.load(f)
    raise FileNotFoundError(f"No manifest.json next to {ckpt_path}")
