"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``). The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs when the package is imported, and nothing falls back:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("stencil_message", "corner_hop", "stencil_message_bwd", "corner_hop_bwd")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda's,
    else the one on PATH. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of py4cast_tpu_torch cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: keyed by the
    source, the shared headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        # write under a private name, then rename: a concurrent build or
        # reader never sees a half-written library
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs.append((name, lib, tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failures = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}):\n"
                            f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            (path,) = build_all((name,))
            lib = ctypes.CDLL(str(path))
            lib.p4t_error_string.argtypes = [ctypes.c_int]
            lib.p4t_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def validate(what: str, args: Dict[str, tuple]) -> "torch.device":
    """Check the arguments of a kernel wrapper: ``args`` maps a name to
    ``(tensor, expected_shape)``. Every tensor must be fp32, contiguous,
    of that shape and on one device, which is returned. Raises
    ``ValueError`` naming the first offender."""
    device = None
    for name, (t, shape) in args.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} is {t.dtype}; only float32 is supported")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, the others on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {device} are not supported")
    return device


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if status != 0:
        msg = lib.p4t_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
