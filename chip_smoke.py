#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (py4cast_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases — each passes or raises, so any failure ends the run with a
non-zero exit code and no result line:

1. the card: its name and power limit (nvidia-smi), TF32 off;
2. build every CUDA kernel of the main path from ``py4cast_tpu_torch/csrc``
   with nvcc (one process per source, all at once);
3. each forward kernel against its plain PyTorch version at the main
   path's shapes (GraphLAM at 500x500: the level-0 125x125 lattice for
   the stencil message, the 500x500 grid for the corner hop), inputs
   from a numpy seed, then both timed with CUDA events;
3b. each backward kernel the same way, with random cotangents: input
   gradients against the plain backward, weight gradients (sums over
   every cell) against the plain backward in fp64, as is the plain
   backward in fp32;
4. ``Trainer.predict`` on the Dummy dataset with GraphLAM at the width of
   config/CLI/model/graphlam.yaml: launch counts of both forward
   kernels, finite outputs, agreement with the same module on the CPU;
5. the full-size GraphLAM rollout (500x500 grid, batch 1, 3 AR steps)
   through the same predict path: ms per step, peak memory, a profile of
   where the device time goes, and step 1 against the CPU;
6. ``Trainer.fit`` on Dummy, GraphLAM at the same width: launch counts of
   all four kernels, a finite and changing train loss, ``last`` and the
   manifest written, a resume that continues the optimizer-step count,
   ``Trainer.test``; one train step's gradients on the card against the
   CPU's; the CLI's fit, test and predict in-process;
7. one full-size train step (500x500, batch 1, 1 AR step): ms per step,
   peak memory, a profile of where the device time goes, finite loss
   and gradients;
8. one JSON line with every kernel's numbers, then the result line.

Exits non-zero without a result when torch sees no CUDA device or the
package is missing. Build outputs go to ``build/`` and long reports to
``chiprun_out/``, both inside the checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
BUILD = ROOT / "build"
TOL = 1e-4
#: gradients: the JAX kernel tests' bar (tests/test_stencil_kernel.py:86)
GRAD_TOL = 2e-4
#: one train step's gradients, card against CPU, over the whole model
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5

#: settings_init_args of config/CLI/model/graphlam.yaml
GRAPHLAM_ARGS = {
    "tmp_dir": "/tmp",
    "hidden_dims": 64,
    "hidden_layers": 1,
    "use_checkpointing": False,
    "offload_to_cpu": False,
    "mesh_aggr": "sum",
    "processor_layers": 4,
    "use_lattice": True,
}

#: H100 SXM data-sheet peaks (full 700 W power limit): HBM3 bytes/s and
#: fp32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

#: the TPU kernel each one replaces in the JAX package: its body
#: (file:line) and the function that reaches pl.pallas_call
REPLACES = {
    "stencil_message": ("py4cast_tpu/ops/stencil_kernel.py:52", "_fwd_kernel via _fwd_call:96"),
    "corner_hop": ("py4cast_tpu/ops/hop_kernel.py:120", "_fwd_kernel via _fwd_call:539"),
    "stencil_message_bwd": ("py4cast_tpu/ops/stencil_kernel.py:245",
                            "_bwd_kernel via _bwd_call:347"),
    "corner_hop_bwd": ("py4cast_tpu/ops/hop_kernel.py:267", "_bwd_kernel via _bwd_call:589"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between
    two CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float = TOL) -> float:
    """Max abs difference; raises when it exceeds ``tol`` relative to the
    reference's scale (or ``tol`` absolute below 1)."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not np.isfinite(err) or err > tol * scale:
        raise AssertionError(f"{name}: max abs diff {err:.3e} exceeds {tol:g} x {scale:.3g}")
    return err


def _rand(rng, *shape, scale=1.0, shift=0.0, device="cuda"):
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device)


# ------------------------------------------------------------------- phase 3
def stencil_inputs(rng, b=1, hr=125, w=125, h=64):
    return (
        _rand(rng, b, 8, hr, w, h), _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h),
        torch.from_numpy((rng.uniform(size=(8, hr, w, 1)) > 0.2).astype(np.float32)).cuda(),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )


def hop_inputs(rng, b=1, hr=500, w=500, h=64, ff=3):
    psg = [_rand(rng, b, hr, w, h) for _ in range(4)]
    rest = (
        _rand(rng, b, hr, w, h), _rand(rng, 4, hr, w, ff, scale=0.5),
        _rand(rng, ff, h, scale=ff ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, h, scale=h ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=(2 * h) ** -0.5), _rand(rng, h, h, scale=(2 * h) ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )
    return psg, rest


def check_stencil(rng, b=1, hr=125, w=125, h=64):
    from py4cast_tpu_torch.ops.stencil_kernel import fused_stencil_message, stencil_message_plain

    args = stencil_inputs(rng, b, hr, w, h)
    out, agg = fused_stencil_message(*args, residual=True)
    torch.cuda.synchronize()
    ref_out, ref_agg = stencil_message_plain(*args, residual=True)
    err = max(compare("stencil out", out, ref_out), compare("stencil agg", agg, ref_agg))
    ms = time_ms(lambda: fused_stencil_message(*args, residual=True))
    plain_ms = time_ms(lambda: stencil_message_plain(*args, residual=True))
    cells = b * hr * w
    n_bytes = 4 * (3 * 8 * cells * h + 2 * cells * h + 8 * hr * w + 2 * h * h + 4 * h)
    # per cell and direction: two h x h products, plus ~19 elementwise
    # operations a channel (bias/vs/pd adds, silu, LayerNorm, residual, agg)
    n_ops = 8 * cells * (4 * h * h + 19 * h)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "name": "stencil_message", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/stencil_message.cu",
        "replaces": REPLACES["stencil_message"][0],
        "replaces_function": REPLACES["stencil_message"][1],
        "shape": f"e,vs ({b},8,{hr},{w},{h}) residual=True",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def check_hop(rng, b=1, hr=500, w=500, h=64, ff=3):
    from py4cast_tpu_torch.ops.hop_kernel import corner_hop_plain, fused_corner_hop

    psg, rest = hop_inputs(rng, b, hr, w, h, ff)
    out = fused_corner_hop(psg, *rest, mean=False)
    torch.cuda.synchronize()
    err = compare("corner hop", out, corner_hop_plain(psg, *rest, mean=False))
    ms = time_ms(lambda: fused_corner_hop(psg, *rest, mean=False))
    plain_ms = time_ms(lambda: corner_hop_plain(psg, *rest, mean=False))
    cells = b * hr * w
    n_bytes = 4 * (6 * cells * h + 4 * hr * w * ff + 5 * h * h + ff * h + 8 * h)
    # per cell: eight h x h products (Wd, 4 x Wo, Nd0a, Nd0b, Nd1), the
    # 4 corner-feature products, ~84 elementwise operations a channel
    n_ops = cells * (16 * h * h + 8 * ff * h + 84 * h)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "name": "corner_hop", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/corner_hop.cu",
        "replaces": REPLACES["corner_hop"][0],
        "replaces_function": REPLACES["corner_hop"][1],
        "shape": f"psg,vd ({b},{hr},{w},{h}) feats (4,{hr},{w},{ff}) mean=False",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


# ------------------------------------------------------------------ phase 3b
def _check_bwd(name, got, plain32, plain64, n_inputs):
    """Input gradients against the plain backward (fp32); weight
    gradients, sums over every cell, against the plain backward in fp64,
    and the fp32 plain backward against it too, so that another
    summation order is not read as a fault. Returns the kernel's largest
    difference from its reference, and the largest such difference over
    the reference's scale (max(1, max|ref|)), the quantity the bar holds."""
    err = rel = 0.0
    for i, (g, p32, p64) in enumerate(zip(got, plain32, plain64)):
        ref = p32 if i < n_inputs else p64
        what = "input" if i < n_inputs else "weight"
        e = compare(f"{name} {what} grad {i}", g, ref, GRAD_TOL)
        err, rel = max(err, e), max(rel, e / max(1.0, float(ref.abs().max())))
        if i >= n_inputs:
            compare(f"{name} weight grad {i} (plain fp32)", p32, p64, GRAD_TOL)
    return err, rel


def check_stencil_bwd(rng, b=1, hr=125, w=125, h=64):
    from py4cast_tpu_torch.ops.stencil_kernel import (
        fused_stencil_message_bwd,
        stencil_message_bwd_plain,
    )

    args = stencil_inputs(rng, b, hr, w, h)
    g_out, g_agg = _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h)
    got = fused_stencil_message_bwd(*args, g_out, g_agg, residual=True)
    torch.cuda.synchronize()
    plain32 = stencil_message_bwd_plain(*args, g_out, g_agg, residual=True)
    plain64 = stencil_message_bwd_plain(*(a.double() for a in args), g_out.double(),
                                        g_agg.double(), residual=True)
    err, rel = _check_bwd("stencil_message_bwd", got, plain32, plain64, 3)
    ms = time_ms(lambda: fused_stencil_message_bwd(*args, g_out, g_agg, residual=True))
    plain_ms = time_ms(lambda: stencil_message_bwd_plain(*args, g_out, g_agg, residual=True))
    cells = b * hr * w
    # reads e, vs, g_out (8 rows a cell), pd, g_agg, mask, the weights;
    # writes de, dvs (8 rows), dpd and the weight gradients
    n_bytes = 4 * (5 * 8 * cells * h + 3 * cells * h + 8 * hr * w + 2 * (2 * h * h + 4 * h))
    # per cell and direction: six h x h products (e@We and z@Wo
    # recomputed, dt@Wo^T, dpre@We^T, z^T dt, e^T dpre), ~40 elementwise
    # operations a channel (silu and its derivative, LayerNorm forward
    # and backward, the masked cotangent, the residual, the sums)
    n_ops = 8 * cells * (12 * h * h + 40 * h)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "name": "stencil_message_bwd", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/stencil_message_bwd.cu",
        "replaces": REPLACES["stencil_message_bwd"][0],
        "replaces_function": REPLACES["stencil_message_bwd"][1],
        "shape": f"e,vs,g_out ({b},8,{hr},{w},{h}) residual=True",
        "max_abs_err": err, "max_err_over_scale": rel,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def check_hop_bwd(rng, b=1, hr=500, w=500, h=64, ff=3):
    from py4cast_tpu_torch.ops.hop_kernel import corner_hop_bwd_plain, fused_corner_hop_bwd

    psg, rest = hop_inputs(rng, b, hr, w, h, ff)
    g = _rand(rng, b, hr, w, h)
    got = fused_corner_hop_bwd(psg, *rest, g, mean=False)
    torch.cuda.synchronize()
    plain32 = corner_hop_bwd_plain(psg, *rest, g, mean=False)
    plain64 = corner_hop_bwd_plain([p.double() for p in psg], *(a.double() for a in rest),
                                   g.double(), mean=False)
    err, rel = _check_bwd("corner_hop_bwd", got, plain32, plain64, 5)
    del plain64
    ms = time_ms(lambda: fused_corner_hop_bwd(psg, *rest, g, mean=False))
    plain_ms = time_ms(lambda: corner_hop_bwd_plain(psg, *rest, g, mean=False))
    cells = b * hr * w
    # reads psg_k, vd, g, feats, the weights; writes dpsg_k, dvd and the
    # weight gradients
    n_bytes = 4 * (11 * cells * h + 4 * hr * w * ff + 2 * (5 * h * h + ff * h + 8 * h))
    # per cell: 24 h x h products (8 of the forward, their 8 transposes,
    # 8 weight-gradient updates), the corner-feature products and their
    # gradient (16 ff*h), ~200 elementwise operations a channel
    n_ops = cells * (48 * h * h + 16 * ff * h + 200 * h)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "name": "corner_hop_bwd", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/corner_hop_bwd.cu",
        "replaces": REPLACES["corner_hop_bwd"][0],
        "replaces_function": REPLACES["corner_hop_bwd"][1],
        "shape": f"psg,vd,g ({b},{hr},{w},{h}) feats (4,{hr},{w},{ff}) mean=False",
        "max_abs_err": err, "max_err_over_scale": rel,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


# ------------------------------------------------------------------- phase 4
def _wrappers() -> dict:
    from py4cast_tpu_torch.ops import hop_kernel, stencil_kernel

    return {"stencil_message": stencil_kernel.fused_stencil_message,
            "corner_hop": hop_kernel.fused_corner_hop,
            "stencil_message_bwd": stencil_kernel.fused_stencil_message_bwd,
            "corner_hop_bwd": hop_kernel.fused_corner_hop_bwd}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def graphlam_settings(**kw):
    from py4cast_tpu_torch.training import TrainingSettings

    return TrainingSettings(model_name="GraphLAM", settings_init_args=dict(GRAPHLAM_ARGS),
                            training_strategy="diff_ar", **kw)


def predict_dummy() -> dict:
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    _, _, test_ds = get_datasets("dummy", 2, 1, 3)
    settings = graphlam_settings()
    module = AutoRegressiveModule(settings, test_ds.dataset_info, device="cuda")
    state = module.init_params(torch.Generator().manual_seed(0))
    trainer = Trainer(TrainerConfig(batch_size=8, device="cuda"))

    reset_counts()
    t0 = time.perf_counter()
    preds = trainer.predict(module, test_ds, state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    steps = 3
    forwards = len(preds) * steps
    per_forward = module.model_settings.mesh_levels * module.model_settings.processor_layers
    want = {"stencil_message": per_forward * forwards, "corner_hop": forwards,
            "stencil_message_bwd": 0, "corner_hop_bwd": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    for p in preds:
        finite = bool(np.isfinite(p.array).all())
        if p.shape[1:] != (steps, 64 * 64, 1) or not finite:
            raise AssertionError(f"bad predictions: shape {p.shape}, finite={finite}")

    cpu_module = AutoRegressiveModule(settings, test_ds.dataset_info, device="cpu")
    cpu_preds = Trainer(TrainerConfig(batch_size=8, device="cpu")).predict(
        cpu_module, test_ds, {k: v.cpu() for k, v in state.items()}
    )
    err = max(
        compare("predict (cuda vs cpu)", torch.from_numpy(g.array), torch.from_numpy(c.array))
        for g, c in zip(preds, cpu_preds)
    )
    return {"launches": counts, "forwards": forwards, "batches": len(preds),
            "seconds": seconds, "max_abs_err_vs_cpu": err}


# ------------------------------------------------------------------- phase 5
def full_size_rollout(steps: int = 3, grid=(500, 500)) -> dict:
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    # bench.py's GNN cell: 500x500 grid, 21 weather and 21 forcing features
    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    settings = graphlam_settings()
    t0 = time.perf_counter()
    module = AutoRegressiveModule(settings, info, device="cuda")
    build_s = time.perf_counter() - t0
    state = module.init_params(torch.Generator().manual_seed(0))
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=steps, seed=0)

    module.predict_step(state, batch)  # warm-up: allocator, kernels' first launch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds = module.predict_step(state, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / steps)
    peak = torch.cuda.max_memory_allocated()
    arr = preds.array
    if arr.shape != (1, steps, grid[0] * grid[1], 21) or not bool(torch.isfinite(arr).all()):
        raise AssertionError(f"full-size predictions: shape {tuple(arr.shape)} or non-finite")

    profile = profile_step(lambda: module.predict_step(state, batch), "smoke_profile.txt")
    call_ms = float(np.median(runs)) * steps
    profile["device_idle_share"] = max(0.0, 1.0 - profile["device_busy_ms"] / call_ms)

    # step 1 against the CPU module with the same weights (plain path)
    one = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)
    gpu1 = module.predict_step(state, one).array.cpu()
    cpu_module = AutoRegressiveModule(settings, info, device="cpu")
    cpu1 = cpu_module.predict_step({k: v.cpu() for k, v in state.items()}, one).array
    err = compare("full-size step 1 (cuda vs cpu)", gpu1, cpu1)
    return {"grid": list(grid), "batch": 1, "steps": steps, "graph_build_s": build_s,
            "ms_per_step_runs": runs, "ms_per_step": float(np.median(runs)),
            "peak_mem_bytes": peak, "max_abs_err_step1_vs_cpu": err, "profile": profile}


#: how the profile's device activities are grouped in the report
GROUPS = (
    ("corner_hop kernel", "corner_hop_fwd"),
    ("stencil_message kernel", "stencil_message_fwd"),
    ("corner_hop_bwd kernel", "corner_hop_bwd"),
    ("stencil_message_bwd kernel", "stencil_message_bwd"),
    ("weight-gradient partial sums", "sum_partials"),
    ("AdamW (foreach)", "multi_tensor_apply"),
    ("host-to-device batch copy", "Memcpy HtoD"),
    ("layer_norm (torch)", "layer_norm"),
    ("matmuls (cuBLAS/CUTLASS)", "gemm"),
)


def profile_step(step, out_name: str) -> dict:
    """Device time over one call of ``step`` (torch.profiler), from the
    device activities only (kernels and copies), summed by group. The
    full table goes to chiprun_out/<out_name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # device activities only: not the profiler's buffer requests, and not
    # the GPU ranges of the optimizer's record_function annotations
    # (Optimizer.step#AdamW.step), which span kernels already counted
    rows = sorted(
        ((float(e.self_device_time_total), e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
         and not e.key.startswith("Optimizer.")),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for us, key, _ in rows:
        name = next((g for g, pat in GROUPS if pat in key), "other")
        groups[name] += us / 1e3
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(
        "\n".join(f"{us / 1e3:10.3f} ms  x{n:<5d} {key}" for us, key, n in rows if us > 0)
    )
    return {"device_busy_ms": busy_ms, "groups_ms": groups,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:8]]}


# ------------------------------------------------------------------- phase 6
class _ListLogger:
    """Keeps what the trainer logs."""

    def __init__(self):
        self.rows = []

    def log_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))


def train_dummy() -> dict:
    """Trainer.fit on Dummy (3 train batches, 1 val batch), counted;
    resume; Trainer.test; one step's gradients against the CPU."""
    import shutil

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    save = BUILD / "smoke_fit"
    shutil.rmtree(save, ignore_errors=True)
    # 1 AR step in training, 3 in validation and test, linked into the
    # settings as the CLI links them
    train_ds, val_ds, test_ds = get_datasets("dummy", 2, 1, 3)
    settings = graphlam_settings(num_warmup_steps=2, num_pred_steps_train=1,
                                 num_pred_steps_val_test=3)
    module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cuda")
    log = _ListLogger()
    cfg = TrainerConfig(max_epochs=1, batch_size=8, limit_train_batches=3, limit_val_batches=1,
                        save_path=str(save), log_every_n_steps=1, device="cuda")
    trainer = Trainer(cfg, loggers=[log])

    reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(module, train_ds, val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    per_forward = module.model_settings.mesh_levels * module.model_settings.processor_layers
    train_steps, val_forwards = 3, 1 * settings.num_pred_steps_val_test
    forwards = train_steps * settings.num_pred_steps_train + val_forwards
    backwards = train_steps * settings.num_pred_steps_train
    want = {"stencil_message": per_forward * forwards, "corner_hop": forwards,
            "stencil_message_bwd": per_forward * backwards, "corner_hop_bwd": backwards}
    if counts != want:
        raise AssertionError(f"fit kernel launches {counts}, expected {want}")
    losses = [v for tag, v, _ in log.rows if tag == "train/loss"]
    if len(losses) != train_steps or not np.isfinite(losses).all() or len(set(losses)) < 2:
        raise AssertionError(f"train losses {losses}: not {train_steps} finite, changing values")
    ckpt = save / "checkpoints"
    if not ((ckpt / "last" / "state.pt").is_file() and (ckpt / "manifest.json").is_file()):
        raise AssertionError(f"fit wrote no last checkpoint or manifest under {ckpt}")
    if state.step != train_steps:
        raise AssertionError(f"fit took {state.step} optimizer steps, expected {train_steps}")

    resumed = trainer.fit(module, train_ds, val_ds, ckpt_path=str(ckpt / "last"))
    if resumed.step != 2 * train_steps:
        raise AssertionError(f"resume ended at step {resumed.step}, expected {2 * train_steps}")
    scores = trainer.test(module, test_ds, resumed)
    if not scores or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"test scores {scores}")

    # one train step's gradients on the card and on the CPU, same params
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    batch = next(iter(train_ds.loader(batch_size=8, num_workers=1)))
    loss_gpu, grads_gpu = module.loss_and_grads(params, batch)
    cpu_module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cpu")
    loss_cpu, grads_cpu = cpu_module.loss_and_grads(params, batch)
    loss_rel = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train loss card {float(loss_gpu)} vs cpu {float(loss_cpu)}")
    grad_err = max(compare(f"grad {k} (cuda vs cpu)", grads_gpu[k].cpu(), grads_cpu[k],
                           TRAIN_GRAD_TOL) for k in grads_cpu)
    zero = [k for k, g in grads_gpu.items() if float(g.abs().max()) == 0.0]
    if zero:
        raise AssertionError(f"parameters with no gradient on the card: {zero[:5]}")
    return {"launches": counts, "train_steps": train_steps, "val_forwards": val_forwards,
            "seconds": seconds, "train_losses": losses, "resumed_step": resumed.step,
            "test_scores": scores, "loss_cuda": float(loss_gpu), "loss_cpu": float(loss_cpu),
            "loss_rel_diff": loss_rel, "max_abs_grad_err_vs_cpu": grad_err}


def cli_dummy() -> dict:
    """The port's CLI in-process: fit, then test and predict from its
    checkpoint, with config/CLI's trainer, dummy and graphlam files."""
    import shutil

    from py4cast_tpu_torch import cli

    save = BUILD / "smoke_cli"
    shutil.rmtree(save, ignore_errors=True)
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--config", str(ROOT / "config/CLI/model/graphlam.yaml"),
               "--trainer.save_path", str(save)]
    steps = {
        "fit": ["--trainer.max_epochs", "1", "--trainer.limit_train_batches", "2",
                "--trainer.limit_val_batches", "1"],
        "test": ["--trainer.ckpt_path", "last"],
        "predict": ["--trainer.ckpt_path", "last"],
    }
    for sub, extra in steps.items():
        if cli.main([sub, *configs, *extra]) != 0:
            raise AssertionError(f"cli {sub} failed")
    scores = json.loads((save / "test_scores.json").read_text())
    preds = sorted((save / "predictions").glob("batch_*.npy"))
    arrays = [np.load(p) for p in preds]
    if not preds or not all(np.isfinite(a).all() for a in arrays) or not np.isfinite(
            scores["test_mean_loss"]):
        raise AssertionError(f"cli outputs: {len(preds)} prediction files, scores {scores}")
    return {"test_mean_loss": scores["test_mean_loss"], "prediction_files": len(preds),
            "prediction_shape": list(arrays[0].shape)}


# ------------------------------------------------------------------- phase 7
def full_size_train_step(grid=(500, 500), reps: int = 5) -> dict:
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    module = AutoRegressiveModule(graphlam_settings(num_warmup_steps=2), info, device="cuda")
    state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=100)
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)

    for _ in range(2):  # warm-up: allocator, kernels' first launch, lr 0 step
        module.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, losses = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        loss = module.train_step(state, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"full-size train losses {losses}")
    loss, grads = module.loss_and_grads(state, batch)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not np.isfinite(float(loss)):
        raise AssertionError(f"full-size gradients not finite: {bad[:5]}, loss {float(loss)}")

    profile = profile_step(lambda: module.train_step(state, batch), "smoke_profile_train.txt")
    step_ms = float(np.median(runs))
    profile["device_idle_share"] = max(0.0, 1.0 - profile["device_busy_ms"] / step_ms)
    return {"grid": list(grid), "batch": 1, "pred_steps": 1, "ms_per_train_step_runs": runs,
            "ms_per_train_step": step_ms, "peak_mem_bytes": peak, "losses": losses,
            "profile": profile}


# ---------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    os.environ.setdefault("PY4CAST_TPU_ROOTDIR", str(ROOT / "build" / "smoke_data"))
    import py4cast_tpu_torch  # fails here when run outside the repo

    found = Path(py4cast_tpu_torch.__file__).resolve().parent.parent
    if found != ROOT:
        raise RuntimeError(f"py4cast_tpu_torch was imported from {found}, not from this checkout")
    from py4cast_tpu_torch.ops import _build

    # phase 1: the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    # phase 2: build every kernel of the path
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")

    # phase 3 and 3b: each kernel against its plain version at the main
    # path's shapes
    rng = np.random.default_rng(0)
    kernels = [check_stencil(rng), check_hop(rng), check_stencil_bwd(rng), check_hop_bwd(rng)]
    for k in kernels:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3e} ms {k['ms']:.4f} "
            f"plain_ms {k['plain_ms']:.4f} bound_ms {k['bound_ms']:.4f} ({k['bound_by']})")

    # phase 4: Trainer.predict on Dummy, counted
    dummy = predict_dummy()
    log(f"predict dummy: {json.dumps(dummy)}")

    # phase 5: the full-size rollout
    full = full_size_rollout()
    log(f"full size: {json.dumps(full)}")

    # phase 6: Trainer.fit on Dummy, counted; resume, test, gradients
    # against the CPU; the CLI
    fit = train_dummy()
    log(f"fit dummy: {json.dumps(fit)}")
    fit["cli"] = cli_dummy()
    log(f"cli dummy: {json.dumps(fit['cli'])}")
    for k in kernels:
        k["launches"] = fit["launches"][k["name"]]
        k["launches_predict"] = dummy["launches"][k["name"]]

    # phase 7: one full-size train step
    train_full = full_size_train_step()
    log(f"full-size train step: {json.dumps(train_full)}")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_report.json").write_text(json.dumps(
        {"card": card, "kind": kind, "kernels": kernels, "predict_dummy": dummy,
         "full_size": full, "fit_dummy": fit, "full_size_train": train_full}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
