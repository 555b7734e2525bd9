"""Process groups and the data axis — the scale-out layer.

The JAX package lays its devices out as one ``jax.sharding.Mesh`` with
axes ``('data', 'spatial')`` and lets XLA insert the gradient
all-reduce. Here one process drives one device, ``torch.distributed``
joins the processes, and the collectives are explicit:

- parameters are replicated; every rank loads its slice of each global
  batch (``datasets.loader.DataLoader``);
- after the backward of an optimizer step, ``all_reduce_grads`` sums
  every gradient across ranks in one flat fp32 buffer and divides it by
  the world size, so each rank steps AdamW on the global mean;
- eval rows and predictions are gathered to every rank in rank order
  (``to_host``), which is global row order;
- writes (checkpoints, logs, figures, scores) happen on rank 0
  (``is_main_process``).

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
The spatial axis (lat sharding with halo exchanges) is not ported:
``spatial > 1`` raises (ROADMAP.md, queue 1 item 12b).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from py4cast_tpu_torch.utils import resolve_device

SPATIAL_NOT_PORTED = (
    "spatial={}: lat sharding with halo exchanges is not ported to "
    "py4cast_tpu_torch yet (ROADMAP.md, queue 1 item 12b); use spatial=1"
)


@dataclass(frozen=True)
class MeshConfig:
    """How to lay the ranks out. data_parallel × spatial must equal the
    world size; -1 on data_parallel means "all remaining ranks"."""

    data_parallel: int = -1
    spatial: int = 1


@dataclass(frozen=True)
class Mesh:
    """This process's place in the group: its rank, its local rank (the
    card it drives on its host), the world size, the extent of each
    axis, and whether a process group is up (``distributed``; without
    one, nothing runs a collective). The spatial axis is not ported:
    ``spatial`` > 1 raises (queue 1 item 12b)."""

    rank: int = 0
    local_rank: int = 0
    world_size: int = 1
    data: int = 1
    spatial: int = 1
    distributed: bool = False

    def __post_init__(self):
        if self.spatial > 1:
            raise ValueError(SPATIAL_NOT_PORTED.format(self.spatial))


def distributed() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def maybe_init_distributed(device="cuda", timeout: Optional[float] = None) -> bool:
    """Join the process group a launcher set up, and say whether there
    is one.

    - ``torchrun`` (or any launcher that sets ``RANK`` and
      ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), even at one
      process;
    - a SLURM step with ``SLURM_NTASKS`` > 1: ``RANK``, ``WORLD_SIZE`` and
      ``LOCAL_RANK`` come from ``SLURM_PROCID``, ``SLURM_NTASKS`` and
      ``SLURM_LOCALID``; ``MASTER_ADDR`` must be exported (``MASTER_PORT``
      defaults to 29500);
    - otherwise nothing happens.

    The backend follows ``device``: NCCL for a card (bound to
    ``cuda:LOCAL_RANK`` first), gloo for the CPU. ``timeout`` (seconds)
    bounds every collective."""
    if distributed():
        return True
    env = os.environ
    if not ("RANK" in env and "WORLD_SIZE" in env):
        ntasks = int(env.get("SLURM_NTASKS", "1") or 1)
        if ntasks <= 1:
            return False
        if not env.get("MASTER_ADDR"):
            raise RuntimeError(
                f"SLURM_NTASKS={ntasks} but MASTER_ADDR is unset: export the first "
                "node's address before srun, e.g. MASTER_ADDR=$(scontrol show hostnames "
                "$SLURM_JOB_NODELIST | head -n 1)"
            )
        env["RANK"] = env["SLURM_PROCID"]
        env["WORLD_SIZE"] = str(ntasks)
        env["LOCAL_RANK"] = env.get("SLURM_LOCALID", "0")
        env.setdefault("MASTER_PORT", "29500")
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)  # raises when torch finds no card
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """This process's ``Mesh`` over the current process group (one rank
    without one). Raises for any spatial axis (queue 1 item 12b), and
    when data × spatial is not the world size."""
    group = distributed()
    world = dist.get_world_size() if group else 1
    rank = dist.get_rank() if group else 0
    dp = config.data_parallel if config.data_parallel > 0 else world
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if group else 0
    mesh = Mesh(rank, local_rank, world, dp, config.spatial, group)
    if dp * config.spatial != world:
        raise ValueError(
            f"mesh {dp}x{config.spatial} does not match {world} processes; "
            f"set data_parallel/spatial to divide the world size"
        )
    return mesh


def shard_batch(mesh: Mesh, *arrays):
    """Check host batch arrays against the data axis: each rank passes
    its LOCAL rows, and the global batch must divide the data axis.
    Returns the arrays as they are: every rank feeds its own card. The
    port's own loop needs no such check a batch: ``DataLoader`` refuses
    a global batch the ranks do not divide when it is built."""
    for a in arrays:
        if a is None:
            continue
        global_rows = a.shape[0] * mesh.world_size
        if global_rows % mesh.data:
            raise ValueError(
                f"Global batch size {global_rows} ({a.shape[0]} local rows "
                f"x {mesh.world_size} processes) is not divisible by the data-parallel "
                f"mesh axis ({mesh.data} devices); adjust batch_size or the mesh "
                f"(MeshConfig.data_parallel)."
            )
    return arrays if len(arrays) > 1 else arrays[0]


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked on the row axis in rank order, on every
    rank (``t`` itself without a process group). Every rank passes the
    same shape — padded local rows, never a ragged tail — on the device
    the backend serves."""
    t = t.detach().contiguous()
    if not distributed():
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=0)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``all_gather_rows(t)`` as a numpy array on every rank: the global
    rows, since the loader slices each global batch by rank."""
    return all_gather_rows(t).cpu().numpy()


def is_main_process() -> bool:
    """Rank-0 gating for writes (checkpoints, logs, figures, scores)."""
    return not distributed() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if not distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable; ``obj`` itself without
    a process group)."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@contextlib.contextmanager
def main_process_first():
    """Run the body on rank 0 first, then on the other ranks: what rank
    0 creates on disk (a dataset's first-touch files) the others then
    read whole."""
    if not is_main_process():
        barrier()
    yield
    if is_main_process():
        barrier()


def all_reduce_grads(params: Dict[str, torch.Tensor], world_size: int,
                     accumulate: int = 1) -> int:
    """Replace every parameter's ``.grad`` by its sum over ranks divided
    by ``world_size * accumulate``: the global mean gradient of the
    step's micro-batches. The gradients are copied into one contiguous
    fp32 buffer in ``params``' order, reduced with one ``all_reduce``
    (none without a process group) and copied back. Every parameter must
    have a gradient, so that every rank lays out the same buffer.
    Returns the buffer's bytes."""
    grads = [p.grad for p in params.values()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    if distributed():
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(world_size * accumulate)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    return flat.numel() * flat.element_size()
