"""Small shared utilities."""

from __future__ import annotations

import contextlib
import functools
import os
import warnings
from typing import Dict

import numpy as np
import torch
import torch.distributed


def merge_dicts(a: dict, b: dict) -> dict:
    """Recursively merge b into a copy of a (b wins on leaves)."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


#: maps trainer-style precision strings to torch dtypes
str_to_dtype: Dict[str, torch.dtype] = {
    "bf16-mixed": torch.bfloat16,
    "bf16": torch.bfloat16,
    "16-mixed": torch.bfloat16,
    "32": torch.float32,
    "32-true": torch.float32,
    "64": torch.float64,
    "64-true": torch.float64,
}


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array on the host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card: with
    no CUDA device the call raises instead of carrying on on the CPU,
    which a caller must ask for (``device="cpu"``). Under a process
    group, ``"cuda"`` means this rank's card, ``cuda:LOCAL_RANK``, made
    the current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU"
        )
    if (dev.type == "cuda" and dev.index is None and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if torch.cuda.current_device() != dev.index:
            torch.cuda.set_device(dev)
    return dev


def compute_dtype(precision: str) -> torch.dtype:
    """The activation dtype of a ``precision`` setting (``str_to_dtype``):
    float32, or bfloat16 for "bf16", "bf16-mixed" and "16-mixed", under
    which params are cast to bf16 inside each model call while their fp32
    masters stay in the optimizer. "64"/"64-true" run in fp32 with a
    warning, as the JAX package computes them without jax_enable_x64."""
    if precision not in str_to_dtype:
        raise ValueError(f"precision {precision!r} unknown; accepted: {sorted(str_to_dtype)}")
    dtype = str_to_dtype[precision]
    if dtype == torch.float64:
        warnings.warn(
            f"precision {precision!r} runs in fp32, as the JAX package computes "
            "it without jax_enable_x64"
        )
        return torch.float32
    return dtype


@contextlib.contextmanager
def exact_reductions():
    """Inside, cuBLAS and cuDNN reduce as XLA does; the previous flags
    are restored after. TF32 is off for fp32 products and convolutions
    (``torch.backends.cudnn.allow_tf32`` is True by default: about three
    decimal digits, outside the port's 1e-4 bar against the JAX package),
    bf16 products keep their split-K partial sums in fp32
    (``allow_bf16_reduced_precision_reduction`` is True by default and
    lets cuBLAS round them to bf16; XLA accumulates bf16 dots in fp32),
    and cuDNN picks deterministic algorithms only (its default choice
    for a weight gradient may add partial sums with atomics, so that a
    second backward differs in the last bits)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32,
              matmul.allow_bf16_reduced_precision_reduction, cudnn.deterministic)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction, cudnn.deterministic) = before


def exact_fp32(fn):
    """Decorator: run ``fn`` inside ``exact_reductions``, so that fp32
    steps are true fp32 and bf16 steps accumulate their products in
    fp32."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with exact_reductions():
            return fn(*args, **kwargs)

    return wrapper
