"""Process groups, the data axis and the spatial axis — the scale-out layer.

The JAX package lays its devices out as one ``jax.sharding.Mesh`` with
axes ``('data', 'spatial')`` and lets XLA insert the collectives. Here
one process drives one device, ``torch.distributed`` joins the
processes, and the collectives are explicit.

**The layout.** Ranks are laid out data-major: ``rank = d · S + s``, so
the S spatial ranks of one data group are neighbours (one host, one
NVLink domain). ``make_mesh`` builds one spatial group a data index and
one data group a spatial index (every rank creates every group, in the
same order).

**The data axis.** Parameters are replicated; every data group loads
its slice of each global batch (``Trainer`` hands ``DataLoader`` the
module mesh's ``data_index`` and ``data``); eval rows and predictions are gathered over
the data group in its order, which is global row order; writes happen
on rank 0 (``is_main_process``).

**The spatial axis** (``parallel.spatial``). The padded lat H is cut
into S bands of H / S rows; spatial rank s holds rows
``[s·H/S, (s+1)·H/S)`` of every grid tensor, of the statics and of the
grid-side lattice metadata. Convolutions take halo rows from their
neighbours, GroupNorm and the g2m hop all-reduce band sums, the graph
models' mesh levels run replicated on every band; Segformer gathers
its reduced K/V from every band, UNetRPP's EPA all-reduces its token
sums, SwinUNetR rolls its shifted windows across the bands.

**The gradient semantics.**
- Each rank's loss is its band's share of the global loss: the band's
  sums over the global denominators (``losses.py``). The sum over the
  spatial ranks is the global loss.
- Replicated computation (the graph models' mesh levels) gets only its
  band's share of the cotangent.
- Hence a parameter's gradient is the sum over the spatial ranks and
  the mean over the data ranks: ``all_reduce_grads`` sums every
  gradient over all ranks in one flat fp32 buffer and divides it by
  ``data · accumulate``.
- A collective that sums partial values in the forward pass
  (``band_all_reduce``) all-reduces its cotangent in the backward pass;
  a halo exchange sends each halo row's gradient back to its owner,
  which adds it to its edge row in a fixed order, so two backward
  passes repeat bit for bit.

The backend follows the device: NCCL for ``cuda`` (one card a rank:
spatial > 1 needs S cards a data group), gloo for ``cpu``; nothing falls
back from one to the other.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from dataclasses import field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from py4cast_tpu_torch.parallel.spatial import Band
from py4cast_tpu_torch.utils import resolve_device

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
    axis, whether a process group is up (``distributed``; without one,
    nothing runs a collective), and under spatial > 1 the process groups
    of its band (``spatial_group``) and of its data axis
    (``data_group``; None means the whole world)."""

    rank: int = 0
    local_rank: int = 0
    world_size: int = 1
    data: int = 1
    spatial: int = 1
    distributed: bool = False
    spatial_group: Optional[object] = field(default=None, compare=False, repr=False)
    data_group: Optional[object] = field(default=None, compare=False, repr=False)

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def band(self) -> Optional[Band]:
        """This rank's lat band, None when spatial is 1."""
        if self.spatial == 1:
            return None
        return Band(self.spatial_index, self.spatial, self.spatial_group)


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
        local, cards = int(env.get("LOCAL_RANK", "0")), torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(
                f"local rank {local} has no card of its own: this host has {cards} "
                f"card(s), and NCCL runs one card a rank, so data x spatial ranks need as "
                f"many cards (spatial > 1 needs spatial cards a data group); the port does "
                f"not fall back to gloo on cards")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


#: the process groups of each layout made in the current world:
#: (data, spatial) -> (world group, spatial groups, data groups)
_GROUPS: dict = {}


def _layout_groups(dp: int, sp: int) -> Tuple[list, list]:
    """(spatial groups by data index, data groups by spatial index) of
    the data-major layout ``rank = d · sp + s``, made once a world: every
    rank creates every group, in the same order."""
    world = dist.group.WORLD
    cached = _GROUPS.get((dp, sp))
    if cached is not None and cached[0] is world:
        return cached[1], cached[2]
    spatial = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(dp)]
    data = [dist.new_group([d * sp + s for d in range(dp)]) for s in range(sp)]
    _GROUPS[(dp, sp)] = (world, spatial, data)
    return spatial, data


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """This process's ``Mesh`` over the current process group (one rank
    without one), laid out data-major. Raises when data × spatial is not
    the world size. Under spatial > 1 it makes the layout's process
    groups (a collective: every rank calls it with the same config)."""
    group = distributed()
    world = dist.get_world_size() if group else 1
    rank = dist.get_rank() if group else 0
    sp = max(1, config.spatial)
    dp = config.data_parallel if config.data_parallel > 0 else max(1, world // sp)
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if group else 0
    if dp * sp != world:
        raise ValueError(
            f"mesh {dp}x{sp} does not match {world} processes; "
            f"set data_parallel/spatial to divide the world size"
        )
    spatial_group = data_group = None
    if group and sp > 1:
        spatial_groups, data_groups = _layout_groups(dp, sp)
        spatial_group, data_group = spatial_groups[rank // sp], data_groups[rank % sp]
    return Mesh(rank, local_rank, world, dp, sp, group, spatial_group, data_group)


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


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked on the row axis in rank order, on every
    rank of ``group`` (default the world; ``t`` itself without a process
    group). Every rank passes the same shape — padded local rows, never
    a ragged tail — on the device the backend serves. Under spatial > 1
    pass the mesh's ``data_group``: the spatial ranks of one data index
    hold the same rows."""
    t = t.detach().contiguous()
    if not distributed():
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def to_host(t: torch.Tensor, group=None) -> np.ndarray:
    """``all_gather_rows(t, group)`` as a numpy array on every rank: the
    global rows, since the loader slices each global batch by data
    index."""
    return all_gather_rows(t, group).cpu().numpy()


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
                     accumulate: int = 1, spatial: int = 1) -> int:
    """Replace every parameter's ``.grad`` by its sum over ranks divided
    by ``world_size / spatial * accumulate``: summed over the spatial
    ranks (each holds its band's share) and averaged over the data ranks
    and the step's micro-batches. The gradients are copied into one contiguous
    fp32 buffer in ``params``' order, reduced with one ``all_reduce``
    (none without a process group) and copied back. Every parameter must
    have a gradient, so that every rank lays out the same buffer.
    Returns the buffer's bytes."""
    grads = [p.grad for p in params.values()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    if distributed():
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(world_size // spatial * accumulate)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    return flat.numel() * flat.element_size()
