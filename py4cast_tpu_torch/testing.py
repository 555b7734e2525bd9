"""Synthetic in-memory fixtures for smoke runs and tests: a full
DatasetInfo (grid statics, stats, diff stats), batches and datasets
drawn from a numpy seed, without touching disk; ``run_ranks``, which
runs a function on several local ranks joined in a process group, with
two such functions (``train_report``, ``fit_test_report``);
``run_on_bands``, which runs every lat band of a grid in one process;
and a seeded torchvision ResNet checkpoint."""

from __future__ import annotations

import datetime as dt
import importlib
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed
from torch.optim.optimizer import register_optimizer_step_pre_hook

from py4cast_tpu_torch.datasets.access import Stats
from py4cast_tpu_torch.datasets.base import DatasetInfo, Item, ItemBatch, Statics, collate_fn
from py4cast_tpu_torch.datasets.loader import DataLoader
from py4cast_tpu_torch.named_tensor import NamedArray


def synthetic_statics(grid_shape: Tuple[int, int], border_size: int = 10) -> Statics:
    h, w = grid_shape
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    border = np.zeros((h, w), np.float32)
    if border_size > 0:
        border[:border_size] = border[-border_size:] = 1.0
        border[:, :border_size] = border[:, -border_size:] = 1.0
    gp = np.zeros((h, w), np.float32)
    statics = np.stack([xs, ys, gp, border], axis=-1).astype(np.float32)
    return Statics(
        grid_statics=NamedArray(
            statics, ("lat", "lon", "features"), ("x", "y", "geopotential", "border_mask")
        ),
        grid_shape=grid_shape,
    )


def synthetic_dataset_info(
    grid_shape: Tuple[int, int] = (64, 64),
    weather_features: int = 1,
    forcing_features: int = 5,
    border_size: int = 10,
    name: str = "synthetic",
) -> DatasetInfo:
    out_names = tuple(f"var{i}_500_isobaricInhPa" for i in range(weather_features))
    forcing_names = tuple(
        [f"forcing{i}" for i in range(forcing_features - 5)]
        + ["cos_hour", "sin_hour", "cos_doy", "sin_doy", "toa_radiation"]
    )
    stats = Stats(
        stats={
            n: {"mean": 0.0, "std": 1.0, "min": -3.0, "max": 3.0}
            for n in out_names + forcing_names
        }
    )
    diff_stats = Stats(stats={n: {"mean": 0.0, "std": 1.0} for n in out_names + forcing_names})
    return DatasetInfo(
        name=name,
        units={n: "-" for n in out_names},
        weather_dim=weather_features,
        forcing_dim=forcing_features,
        pred_step=dt.timedelta(hours=1),
        statics=synthetic_statics(grid_shape, border_size),
        stats=stats,
        diff_stats=diff_stats,
        state_weights={n: 1.0 for n in out_names},
        shortnames={"input": [], "input_output": list(out_names), "output": []},
        output_feature_names=out_names,
        forcing_feature_names=forcing_names,
        units_by_feature={n: "-" for n in out_names},
    )


def synthetic_items(
    info: DatasetInfo,
    n: int = 1,
    num_input_steps: int = 2,
    num_pred_steps: int = 1,
    seed: int = 0,
) -> List[Item]:
    """``n`` samples of standard-normal fields drawn from a numpy seed,
    in order."""
    rng = np.random.default_rng(seed)
    h, w = info.statics.grid_shape
    names = ("timestep", "lat", "lon", "features")
    items = []
    for _ in range(n):
        def field(steps, n_feat):
            return rng.standard_normal((steps, h, w, n_feat)).astype(np.float32)

        t0 = dt.datetime(2023, 1, 1)
        items.append(
            Item(
                inputs=NamedArray(field(num_input_steps, info.weather_dim), names,
                                  info.output_feature_names),
                outputs=NamedArray(field(num_pred_steps, info.weather_dim), names,
                                   info.output_feature_names),
                forcing=NamedArray(field(num_pred_steps, info.forcing_dim), names,
                                   info.forcing_feature_names),
                validity_times=[t0 + dt.timedelta(hours=i) for i in range(num_pred_steps)],
            )
        )
    return items


def synthetic_batch(
    info: DatasetInfo,
    batch_size: int = 1,
    num_input_steps: int = 2,
    num_pred_steps: int = 1,
    seed: int = 0,
) -> ItemBatch:
    """A batch of standard-normal fields drawn from a numpy seed."""
    return collate_fn(synthetic_items(info, batch_size, num_input_steps, num_pred_steps, seed))


class SyntheticDataset:
    """``synthetic_items`` as a dataset with the datasets' ``loader``:
    sample i is row i of ``synthetic_batch(info, n, ..., seed)``."""

    def __init__(self, info: DatasetInfo, n: int, num_input_steps: int = 2,
                 num_pred_steps: int = 1, seed: int = 0):
        self.dataset_info = info
        self.items = synthetic_items(info, n, num_input_steps, num_pred_steps, seed)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Item:
        return self.items[i]

    def loader(self, **kwargs) -> DataLoader:
        return DataLoader(self, **kwargs)


#: torchvision's ResNet layout: basic blocks a stage
TORCHVISION_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def torchvision_resnet_state_dict(encoder: str, seed: int = 0) -> dict:
    """A state dict in torchvision's ResNet layout (``conv1``, ``bn1``,
    ``layer{s}.{b}.conv/bn``, ``downsample``, ``fc``), running
    statistics included, drawn from a torch seed: the input of
    ``tools/convert_torchvision_encoder`` where no ImageNet checkpoint
    can be downloaded."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[f"{prefix}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{prefix}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{prefix}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(100)

    def conv(key, o, i, k):
        sd[key] = torch.randn(o, i, k, k, generator=g) / (i * k * k) ** 0.5

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, n in enumerate(TORCHVISION_BLOCKS[encoder]):
        c = 64 * 2 ** s
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            conv(f"{t}.conv1.weight", c, cin if b == 0 else c, 3)
            bn(f"{t}.bn1", c)
            conv(f"{t}.conv2.weight", c, c, 3)
            bn(f"{t}.bn2", c)
            if b == 0 and s > 0:
                conv(f"{t}.downsample.0.weight", c, cin, 1)
                bn(f"{t}.downsample.1", c)
        cin = c
    sd["fc.weight"] = torch.randn(1000, 512, generator=g) / 512 ** 0.5
    sd["fc.bias"] = torch.zeros(1000)
    return sd


# ----------------------------------------------------------- several ranks
#: what a rank process runs: join the group, call the target, save its
#: report, leave the group
_RANK_MAIN = ("import sys; from py4cast_tpu_torch.testing import _rank_main; "
              "_rank_main(sys.argv[1:])")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target(spec: str) -> Callable:
    """The function ``module:function`` or ``path/to/file.py:function``."""
    where, name = spec.rsplit(":", 1)
    if where.endswith(".py"):
        loaded = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(loaded)
        loaded.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv: List[str]) -> None:
    target, kwargs, out, device, timeout = argv
    torch.set_num_threads(1)
    from py4cast_tpu_torch.parallel.mesh import maybe_init_distributed

    if not maybe_init_distributed(device, timeout=float(timeout)):
        raise RuntimeError("no process group: RANK and WORLD_SIZE are unset")
    try:
        torch.save(_target(target)(**json.loads(kwargs)), out)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(target: str, world_size: int, kwargs: Optional[dict] = None,
              device: str = "cpu", timeout: float = 120.0) -> List[dict]:
    """Run ``target`` (``module:function`` or ``file.py:function``) on
    ``world_size`` local ranks, one process each, joined in a process
    group on a free localhost port (gloo for ``device="cpu"``, NCCL for
    ``"cuda"``, rank r on ``cuda:r``), and return each rank's report: the
    target's return value (what ``torch.load(weights_only=True)`` reads:
    tensors, numbers, strings, lists, dicts), in rank order. Each rank
    runs torch on one intra-op thread.

    ``timeout`` (seconds) bounds the whole run and every collective in
    it. A rank that fails, or a run past its time, kills every rank
    still running and raises with the failed rank's output: a dead rank
    never leaves the others waiting."""
    root = str(Path(__file__).resolve().parent.parent)
    port = _free_port()
    tmp = Path(tempfile.mkdtemp(prefix="p4t_ranks_"))
    procs, logs = [], []
    try:
        for rank in range(world_size):
            env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "RANK": str(rank), "WORLD_SIZE": str(world_size), "LOCAL_RANK": str(rank),
                   "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": os.pathsep.join(
                       p for p in (root, os.environ.get("PYTHONPATH")) if p)}
            logs.append(open(tmp / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN, target, json.dumps(kwargs or {}),
                 str(tmp / f"rank{rank}.pt"), device, str(timeout)],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env, cwd=root))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"rank {r} of {world_size} exited with {codes[r]}:\n"
                                   + (tmp / f"rank{r}.log").read_text()[-4000:])
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {target} still running after "
                                   f"{timeout} s (exit codes {codes})")
            time.sleep(0.05)
        return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world_size)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_on_bands(fn: Callable, count: int, before_last: Optional[Callable] = None) -> list:
    """``fn(band)`` on each of ``count`` lat bands in turn, in this
    process, under ``on_band(band)``, as if the bands ran together: each
    exchange of ``parallel.spatial`` (its ``_gather`` and
    ``_all_reduce``) is answered with what every band sent to that
    exchange, recorded as the bands run. A band's k-th send depends only
    on the answers to its exchanges before it, so the answers are all
    right from the (n + 1)-th pass on, n the exchanges a band makes
    (where a send is not known yet, the band's own stands in for it):
    ``fn`` runs n + 1 times a band, and its results of the last pass are
    returned in band order. ``fn`` runs everything that exchanges (the
    forward and its backward) and returns what it keeps.
    ``before_last()`` runs before the last pass (a reset of the kernel
    launch counts: the last pass's launches are one run's)."""
    from py4cast_tpu_torch.parallel import spatial

    sent: dict = {}
    made = [0] * count
    bands = [spatial.Band(s, count) for s in range(count)]

    def gather(t, band):
        key = made[band.index]
        made[band.index] += 1
        sent[band.index, key] = t.detach().clone()
        return [sent.get((b, key), sent[band.index, key]) for b in range(count)]

    def all_reduce(t, band):
        parts = gather(t, band)
        out = parts[0].clone()
        for part in parts[1:]:
            out += part
        return out

    saved = spatial._gather, spatial._all_reduce
    spatial._gather, spatial._all_reduce = gather, all_reduce
    try:
        passes, done, results = 1, 0, []
        while done < passes:
            if done == passes - 1 and before_last is not None:
                before_last()
            made = [0] * count
            results = []
            for band in bands:
                with spatial.on_band(band):
                    results.append(fn(band))
            if len(set(made)) != 1:
                raise RuntimeError(f"the bands made different numbers of exchanges: {made}")
            passes = made[0] + 1
            done += 1
        return results
    finally:
        spatial._gather, spatial._all_reduce = saved


def _small_module(model_name: str, settings_init_args: dict, grid, device: str,
                  lat_multiple: Optional[int] = None, mesh=None, losses=None, **settings):
    """A small ``scaled_ar`` module; ``mesh`` (data, spatial) lays out the
    process group (``MeshConfig``; default every rank on the data axis);
    ``losses`` replaces ``TrainingSettings``' default loss list."""
    from py4cast_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from py4cast_tpu_torch.training import AutoRegressiveModule, TrainingSettings

    info = synthetic_dataset_info(grid_shape=tuple(grid), weather_features=3,
                                  forcing_features=6, border_size=2)
    if losses is not None:
        settings["losses"] = [dict(conf) for conf in losses]
    settings = TrainingSettings(model_name=model_name, settings_init_args=dict(settings_init_args),
                                training_strategy="scaled_ar", num_input_steps=2,
                                num_warmup_steps=2, **settings)
    layout = make_mesh(MeshConfig(*mesh)) if mesh is not None else None
    return AutoRegressiveModule(settings, info, device=device, lat_multiple=lat_multiple,
                                mesh=layout), info


def kernel_wrappers() -> dict:
    """The six kernel wrappers by name, each counting its launches."""
    from py4cast_tpu_torch.ops import attention, hop_kernel, stencil_kernel

    return {"stencil_message": stencil_kernel.fused_stencil_message,
            "corner_hop": hop_kernel.fused_corner_hop,
            "stencil_message_bwd": stencil_kernel.fused_stencil_message_bwd,
            "corner_hop_bwd": hop_kernel.fused_corner_hop_bwd,
            "short_kv_attention": attention.fused_short_kv_attention,
            "short_kv_attention_bwd": attention.fused_short_kv_attention_bwd}


def held_params(grads: dict, params: dict, bar: float) -> dict:
    """``params`` flattened, without the elements whose gradient in
    ``grads`` (one process's first step) is within ``bar`` of the largest
    gradient of zero: there a gradient comparison held to ``bar`` cannot
    fix the sign, and AdamW, which moves an element by about the learning
    rate whatever its gradient's size, moves it apart by up to twice the
    rate a step (a conv's bias before an instance norm, the key third of
    a window attention's bias: zero in exact arithmetic)."""
    largest = max(float(g.abs().max()) for g in grads.values() if g.numel())
    return {k: p.reshape(-1)[grads[k].reshape(-1).abs() > bar * largest]
            for k, p in params.items()}


def train_report(model_name: str, settings_init_args: dict, grid=(32, 32), batch_size: int = 4,
                 steps: int = 3, seed: int = 0, params_path: Optional[str] = None,
                 device: str = "cpu", mesh=None, padded_grid=None,
                 lat_multiple: Optional[int] = None, precision: str = "32",
                 losses: Optional[list] = None, mask_ratio: float = 0.0) -> dict:
    """``steps`` AdamW steps of a small ``scaled_ar`` module, alone or on
    every rank of a group laid out as ``mesh`` (data, spatial): step k
    trains on the global batch ``synthetic_batch(info, batch_size,
    seed=seed + k)``, of which each data index loads its slice through
    ``DataLoader``. The parameters start from ``params_path`` (a
    ``torch.save``d dict) or from seed 0. Reports the rank, the world
    size, the losses, the final parameters, the kernel launches, halo
    bytes and host ms of each step, the first step's gradients as AdamW
    receives them (after ``all_reduce_grads``), the bytes the spatial
    exchanges received a step (``halo_rows``, ``gather_rows``,
    ``roll_rows``), the peak device memory (cuda), and ``predict_step``
    of the first batch at the final parameters on the whole grid,
    gathered over the data ranks; ``precision``, ``losses`` and
    ``mask_ratio`` are the module's (the block masks drawn from a
    generator seeded with ``seed``, the same on every rank, and the
    prediction's from one seeded with ``seed`` + 1). With
    ``padded_grid`` it
    also predicts that batch's counterpart on a ``padded_grid`` module
    padded to ``lat_multiple``, from seed-0 parameters."""
    from py4cast_tpu_torch.parallel.mesh import to_host
    from py4cast_tpu_torch.parallel.spatial import gather_rows, halo_rows, roll_rows

    module, info = _small_module(model_name, settings_init_args, grid, device,
                                 lat_multiple=lat_multiple if padded_grid is None else None,
                                 mesh=mesh, precision=precision, losses=losses,
                                 mask_ratio=mask_ratio)
    params = torch.load(params_path, weights_only=True) if params_path else None
    state = module.init_state(torch.Generator().manual_seed(0), steps, params)
    grads = {}

    def keep_first_grads(optimizer, args, kwargs):
        if not grads:
            grads.update({k: p.grad.detach().cpu().clone() for k, p in state.params.items()})

    state.optimizer.register_step_pre_hook(keep_first_grads)
    coords = {"process_index": module.mesh.data_index, "process_count": module.mesh.data}
    wrappers = kernel_wrappers()
    masks = torch.Generator(device=device).manual_seed(seed) if mask_ratio else None
    step_losses, launches, host_ms = [], [], []
    exchanges = {"halo_bytes": (halo_rows, []), "gather_bytes": (gather_rows, []),
                 "roll_bytes": (roll_rows, [])}
    batches = []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in range(steps):
        data = SyntheticDataset(info, batch_size, num_pred_steps=1, seed=seed + k)
        batches.append(next(iter(data.loader(batch_size=batch_size, num_workers=1,
                                             **coords))))
        for fn in wrappers.values():
            fn.launches = 0
        for counter, _ in exchanges.values():
            counter.bytes = 0
        t0 = time.perf_counter()
        step_losses.append(float(module.train_step(state, batches[-1], masks)))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({name: fn.launches for name, fn in wrappers.items()})
        for counter, per_step in exchanges.values():
            per_step.append(counter.bytes)
    predict_masks = torch.Generator(device=device).manual_seed(seed + 1) if mask_ratio else None
    report = {"rank": module.mesh.rank, "world_size": module.mesh.world_size,
              "losses": step_losses, "launches": launches, "host_ms": host_ms,
              **{key: per_step for key, (_, per_step) in exchanges.items()},
              "params": {k: v.detach().cpu() for k, v in state.params.items()},
              "grads": grads,
              "predictions": torch.from_numpy(to_host(
                  module.predict_step(state, batches[0], predict_masks).array,
                  module.mesh.data_group))}
    if device == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
    if padded_grid is not None:
        padded, pinfo = _small_module(model_name, settings_init_args, padded_grid, device,
                                      lat_multiple=lat_multiple, mesh=mesh, precision=precision)
        pdata = SyntheticDataset(pinfo, batch_size, num_pred_steps=1, seed=seed)
        pbatch = next(iter(pdata.loader(batch_size=batch_size, num_workers=1, **coords)))
        pparams = padded.init_params(torch.Generator().manual_seed(0))
        report["padded_predictions"] = torch.from_numpy(to_host(
            padded.predict_step(pparams, pbatch).array, padded.mesh.data_group))
    return report


def train_reports(cases: List[dict], **common) -> List[dict]:
    """``train_report`` of each case (its arguments over ``common``), in
    turn, in this process: several runs from one launch of the ranks."""
    return [train_report(**{**common, **case}) for case in cases]


def fit_test_report(save_path: str, n_test: int = 11, batch_size: int = 4, grid=(32, 32),
                    device: str = "cpu", mesh=None, model_name: str = "HalfUNet",
                    settings_init_args: Optional[dict] = None,
                    losses: Optional[list] = None) -> dict:
    """A small model's (HalfUNet's by default; ``losses`` its loss list)
    ``Trainer.fit`` (2 train batches, a padded
    validation tail), ``Trainer.test`` with logging (figures, scores,
    PSD-K, PSD-Var, ACC) over ``n_test`` samples, the per-sample test
    rows (``Trainer.eval_rows``), ``Trainer.predict``, the fitted
    parameters and the first step's gradients as AdamW receives them,
    alone or on every rank of a group whose module is laid
    out as ``mesh`` (data, spatial). The ``TrainerConfig`` keeps its
    default layout: the trainer follows the module's mesh. Rank r saves
    under ``<save_path>/rank{r}``, so that what each rank wrote can be
    told apart."""
    from py4cast_tpu_torch.parallel.mesh import is_main_process
    from py4cast_tpu_torch.training import Trainer, TrainerConfig

    args = {"num_filters": 8, "depth": 2} if settings_init_args is None else settings_init_args
    module, info = _small_module(model_name, args, grid, device, mesh=mesh, losses=losses,
                                 num_pred_steps_val_test=2)
    rank = module.mesh.rank
    trainer = Trainer(TrainerConfig(max_epochs=1, batch_size=batch_size, num_workers=1,
                                    limit_train_batches=2, save_path=f"{save_path}/rank{rank}",
                                    device=device))
    train = SyntheticDataset(info, 2 * batch_size, num_pred_steps=1, seed=0)
    val = SyntheticDataset(info, batch_size + 1, num_pred_steps=2, seed=1)
    test = SyntheticDataset(info, n_test, num_pred_steps=2, seed=2)
    first = {}

    def keep_first_grads(optimizer, args, kwargs):
        if not first:
            first.update({id(p): p.grad.detach().cpu().clone()
                          for group in optimizer.param_groups for p in group["params"]})

    hook = register_optimizer_step_pre_hook(keep_first_grads)
    try:
        state = trainer.fit(module, train, val)
    finally:
        hook.remove()
    scores = trainer.test(module, test, state)
    rows = trainer.eval_rows(module, state, test.loader(
        batch_size=batch_size, num_workers=1, drop_last=False, pad_last=True,
        process_index=module.mesh.data_index, process_count=module.mesh.data))
    preds = trainer.predict(module, test, state)
    return {"rank": rank, "is_main": is_main_process(), "scores": scores,
            "rows": torch.from_numpy(rows), "step": state.step,
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "grads": {k: first[id(v)] for k, v in state.params.items()},
            "predictions": torch.from_numpy(np.concatenate([p.array for p in preds]))}
