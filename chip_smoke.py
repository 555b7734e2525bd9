#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (py4cast_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases — each passes or raises, so any failure ends the run with a
non-zero exit code and no result line:

1. the card: its name and power limit (nvidia-smi), TF32 off;
2. build every CUDA kernel of the main path from ``py4cast_tpu_torch/csrc``
   with nvcc (one process per source, all at once);
3. each kernel against its plain PyTorch version at the main path's
   shapes (GraphLAM at 500x500: the level-0 125x125 lattice for the
   stencil message, the 500x500 grid for the corner hop), inputs from a
   numpy seed, then both timed with CUDA events;
4. ``Trainer.predict`` on the Dummy dataset with GraphLAM at the width of
   config/CLI/model/graphlam.yaml: launch counts of both kernels, finite
   outputs, agreement with the same module run on the CPU (plain path);
5. the full-size GraphLAM rollout (500x500 grid, batch 1, 3 AR steps)
   through the same predict path: ms per step, peak memory, a profile of
   where the device time goes, and step 1 against the CPU;
6. one JSON line with every kernel's numbers, then the result line.

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
TOL = 1e-4

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


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference; raises when it exceeds TOL relative to the
    reference's scale (or TOL absolute below 1)."""
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not np.isfinite(err) or err > TOL * scale:
        raise AssertionError(f"{name}: max abs diff {err:.3e} exceeds {TOL:g} x {scale:.3g}")
    return err


def _rand(rng, *shape, scale=1.0, shift=0.0, device="cuda"):
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device)


# ------------------------------------------------------------------- phase 3
def check_stencil(rng, b=1, hr=125, w=125, h=64):
    from py4cast_tpu_torch.ops.stencil_kernel import fused_stencil_message, stencil_message_plain

    args = (
        _rand(rng, b, 8, hr, w, h), _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h),
        torch.from_numpy((rng.uniform(size=(8, hr, w, 1)) > 0.2).astype(np.float32)).cuda(),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )
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


# ------------------------------------------------------------------- phase 4
def reset_counts():
    from py4cast_tpu_torch.ops.hop_kernel import fused_corner_hop
    from py4cast_tpu_torch.ops.stencil_kernel import fused_stencil_message

    fused_stencil_message.launches = 0
    fused_corner_hop.launches = 0


def read_counts() -> dict:
    from py4cast_tpu_torch.ops.hop_kernel import fused_corner_hop
    from py4cast_tpu_torch.ops.stencil_kernel import fused_stencil_message

    return {"stencil_message": fused_stencil_message.launches,
            "corner_hop": fused_corner_hop.launches}


def graphlam_settings():
    from py4cast_tpu_torch.training import TrainingSettings

    return TrainingSettings(model_name="GraphLAM", settings_init_args=dict(GRAPHLAM_ARGS),
                            training_strategy="diff_ar")


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
    want = {"stencil_message": per_forward * forwards, "corner_hop": forwards}
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

    profile = profile_step(module, state, batch)
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
    ("host-to-device batch copy", "Memcpy HtoD"),
    ("layer_norm (torch)", "layer_norm"),
    ("matmuls (cuBLAS/CUTLASS)", "gemm"),
)


def profile_step(module, state, batch) -> dict:
    """Device time over one predict_step (torch.profiler), from the
    device activities only (kernels and copies; the profiler's own
    buffer requests excluded), summed by group. The full table goes to
    chiprun_out/smoke_profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    module.predict_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        module.predict_step(state, batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((float(e.self_device_time_total), e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for us, key, _ in rows:
        name = next((g for g, pat in GROUPS if pat in key), "other")
        groups[name] += us / 1e3
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_profile.txt").write_text(
        "\n".join(f"{us / 1e3:10.3f} ms  x{n:<5d} {key}" for us, key, n in rows if us > 0)
    )
    return {"device_busy_ms": busy_ms, "groups_ms": groups,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:8]]}


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

    # phase 3: each kernel against its plain version at the main path's shapes
    rng = np.random.default_rng(0)
    kernels = [check_stencil(rng), check_hop(rng)]
    for k in kernels:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3e} ms {k['ms']:.4f} "
            f"plain_ms {k['plain_ms']:.4f} bound_ms {k['bound_ms']:.4f} ({k['bound_by']})")

    # phase 4: Trainer.predict on Dummy, counted
    dummy = predict_dummy()
    log(f"predict dummy: {json.dumps(dummy)}")
    for k in kernels:
        k["launches"] = dummy["launches"][k["name"]]

    # phase 5: the full-size rollout
    full = full_size_rollout()
    log(f"full size: {json.dumps(full)}")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_report.json").write_text(json.dumps(
        {"card": card, "kind": kind, "kernels": kernels, "predict_dummy": dummy,
         "full_size": full}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
