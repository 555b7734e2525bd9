"""Small shared utilities."""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch


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
    which a caller must ask for (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU"
        )
    return dev


def exact_fp32(fn):
    """Decorator: run ``fn`` in full fp32 in cuBLAS and cuDNN, the
    previous flags restored after. torch runs fp32 convolutions in TF32
    by default (``torch.backends.cudnn.allow_tf32`` is True): about three
    decimal digits, outside the port's 1e-4 bar against the JAX
    package."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        before = (matmul.allow_tf32, cudnn.allow_tf32)
        matmul.allow_tf32 = cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            matmul.allow_tf32, cudnn.allow_tf32 = before

    return wrapper
