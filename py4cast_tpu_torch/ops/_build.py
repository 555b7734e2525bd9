"""Build the sources under ``csrc/`` into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``). The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded. ``build_all`` starts one ``nvcc`` per source, all at once; each
compile reports ptxas's registers and spills (``-Xptxas -v``), kept
beside the library (``ptxas_report``). ``build`` is the step both
compilers go through: ``nvcc`` here, the host C++ compiler for the npy
batch reader (``native.py``).

Nothing here runs when the package is imported, and nothing falls back:
a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: the kernels of the model paths; ``load`` also builds any other source
#: of csrc/ (the card tests' row_tiles_probe)
SOURCES = ("stencil_message", "corner_hop", "stencil_message_bwd", "corner_hop_bwd",
           "short_kv_attention", "short_kv_attention_bwd")

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


def build(jobs: Sequence[Tuple[str, Sequence[str], Path, Path]], what: str) -> None:
    """Compile each ``(label, compiler_and_flags, source, library)`` job
    whose library is missing, all started together, as
    ``compiler_and_flags -o <tmp> source``. Each writes under a private
    name, renamed to ``library`` when it succeeds (the compiler's output
    first, to ``library`` with the suffix ``.log``), so that a concurrent
    build or reader never sees half a file. Raises ``RuntimeError``
    naming ``what`` and each failed job, with its compiler's output."""
    procs, failures = [], []
    for label, cmd, source, lib in jobs:
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.so")
        full = [*cmd, "-o", str(tmp), str(source)]
        try:
            proc = subprocess.Popen(full, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        except OSError as e:
            failures.append((f"{label} ({' '.join(full)}: {e})", ""))
            continue
        procs.append((label, full, lib, tmp, proc))
    for label, full, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append((f"{label} ({' '.join(full)}: exit {proc.returncode})",
                             log.decode(errors="replace")))
        else:
            log_tmp = tmp.with_suffix(".log")
            log_tmp.write_bytes(log)
            os.replace(log_tmp, lib.with_suffix(".log"))
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError(f"{what} failed to build: "
                           + "; ".join(head for head, _ in failures) + "\n"
                           + "\n".join(f"--- {head}\n{log}" for head, log in failures if log))


def build_all(names=SOURCES) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns the library paths."""
    missing = [n for n in names if not library_path(n).exists()]
    if missing:
        nvcc = [nvcc_path(), *NVCC_FLAGS]
        build([(f"{n}.cu", nvcc, CSRC / f"{n}.cu", library_path(n)) for n in missing],
              "the CUDA kernels")
    return [library_path(n) for n in names]


def ptxas_report(name: str) -> str:
    """What ptxas said of the kernels of ``csrc/<name>.cu`` when its
    library was built (``-Xptxas -v``: each kernel's registers, stack,
    spill stores and loads); builds it first if needed."""
    (path,) = build_all((name,))
    return path.with_suffix(".log").read_text(errors="replace")


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


#: the dtypes the kernel wrappers take: the kernels read and write fp32,
#: and a wrapper given bf16 casts it to fp32 at its boundary and rounds
#: its outputs back, where the TPU kernel rounds them
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def validate(what: str, args: Dict[str, tuple]) -> "torch.device":
    """Check the arguments of a kernel wrapper: ``args`` maps a name to
    ``(tensor, expected_shape)``. Every tensor must be fp32 or bf16
    (``FLOAT_DTYPES``), contiguous, of that shape and on one device,
    which is returned. Raises ``ValueError`` naming the first offender."""
    device = None
    for name, (t, shape) in args.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype not in FLOAT_DTYPES:
            raise ValueError(f"{what}: {name} is {t.dtype}; supported: "
                             + ", ".join(str(d) for d in FLOAT_DTYPES))
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


def wide_instance(lib: ctypes.CDLL, entry: str, what: str, *widths: int) -> bool:
    """Whether the kernel launches its wide instance (``csrc/wide_rows.cuh``)
    for these widths, as its C entry ``entry`` (``p4t_<kernel>_wide``)
    says from the dispatch's own threshold. Raises ValueError when no
    instance on the card takes them (the plain versions, on the CPU, take
    any width)."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_int] * len(widths)
        fn.restype = ctypes.c_int
    wide = fn(*widths)
    if wide < 0:
        raise ValueError(f"{what}: no kernel instance on the card takes widths {widths} "
                         "(past csrc/wide_rows.cuh's MAX_HP; the CPU takes any)")
    return wide == 1
