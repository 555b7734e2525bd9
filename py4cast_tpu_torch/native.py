"""The parallel npy batch reader: ``csrc/p4t_io.cpp`` bound with ctypes.

A Titan-style sample is one small float32 npy file per (date, param).
``read_npy_float32_batch`` reads a whole batch of them on the C++
reader's thread pool, straight into one numpy buffer; ctypes releases
the GIL for the call, so the loader's threads overlap it.

The library is built with the host C++ compiler (``$CXX``, else
``g++``) at first use, never at import, into ``build/native/`` at the
root of the checkout (listed in ``.gitignore``). Its file name carries a
hash of the source, the flags, the compiler and the platform, so an
edited source gets a library of its own; it is built by
``ops/_build.build``, as the CUDA kernels are. The library must answer
``p4t_version() == ABI_VERSION`` before any other symbol is bound: one
that answers another version, which only a broken install can put at its
path, raises. A build or bind that fails raises with the compiler's
message; nothing falls back.

One case reads with numpy, because the data asks for it: a file the
C++ reader rejects as not little-endian float32 in C order (float64, a
Fortran-order array) is read by ``np.load`` and cast, with a warning
that names it. A file of another shape than the batch's raises, even a
transposed one of the same size.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import threading
import warnings
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from py4cast_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "p4t_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
#: must equal p4t_version() in csrc/p4t_io.cpp
ABI_VERSION = 3

_LOCK = threading.Lock()
_LIB = None


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the reader's library lives: keyed by the source, the flags,
    the compiler and the platform (a checkout shared by two machines
    builds one library each)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((compiler(), *CXX_FLAGS, platform.platform())).encode())
    return BUILD_DIR / f"libp4tio_{h.hexdigest()[:16]}.so"


def _bind(path: Path) -> ctypes.CDLL:
    """Load ``path`` and bind its entry point, after checking its ABI
    version (before any other symbol: a library of another version may
    lack them)."""
    lib = ctypes.CDLL(str(path))
    try:
        lib.p4t_version.restype = ctypes.c_int
        lib.p4t_version.argtypes = []
        version = int(lib.p4t_version())
    except AttributeError:
        version = None
    if version != ABI_VERSION:
        raise RuntimeError(f"the npy batch reader at {path} answers ABI {version}, expected "
                           f"{ABI_VERSION}: a broken install; delete it to rebuild")
    fn = lib.p4t_read_npy_batch_shaped
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    return lib


def load() -> ctypes.CDLL:
    """The bound reader, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            _build.build([(SOURCE.name, [compiler(), *CXX_FLAGS], SOURCE, path)],
                         "the npy batch reader")
            _LIB = _bind(path)
        return _LIB


def _header(path) -> Tuple[tuple, bool, np.dtype]:
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        if major == 1:
            return np.lib.format.read_array_header_1_0(f)
        return np.lib.format.read_array_header_2_0(f)


def read_npy_float32_batch(paths: Sequence[Path], item_shape: Tuple[int, ...]) -> np.ndarray:
    """Read ``len(paths)`` npy files of shape ``item_shape`` into one
    ``(N, *item_shape)`` float32 array, in parallel on the C++ reader.
    Every file's declared shape must equal ``item_shape`` dimension by
    dimension (``ValueError`` otherwise); a file that is not float32 in
    C order is read with numpy and cast, with a warning naming it."""
    item_shape = tuple(int(d) for d in item_shape)
    out = np.empty((len(paths),) + item_shape, dtype=np.float32)
    if not len(paths):
        return out
    lib = load()
    rc = _read(lib, [str(p) for p in paths], out, item_shape)
    if rc == 0:
        return out
    # the C++ reader names only the first file it rejected: find out why
    # from every header (cheap), then read what numpy must read
    raw = []
    for i, p in enumerate(paths):
        shape, fortran, dtype = _header(p)
        if tuple(shape) != item_shape:
            raise ValueError(
                f"npy batch shape mismatch: {p} has {tuple(shape)}, expected {item_shape}"
            )
        if dtype == np.dtype("<f4") and not fortran:
            raw.append(i)
            continue
        warnings.warn(f"{p} is {dtype} ({'Fortran' if fortran else 'C'} order), not "
                      "float32 in C order: read with numpy and cast to float32")
        out[i] = np.load(p)
    if raw:
        block = np.empty((len(raw),) + item_shape, dtype=np.float32)
        rc = _read(lib, [str(paths[i]) for i in raw], block, item_shape)
        if rc != 0:
            raise OSError(f"the npy batch reader could not read {paths[raw[rc - 1]]}")
        out[raw] = block
    return out


def _read(lib, paths, out: np.ndarray, item_shape: tuple) -> int:
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_dims = (ctypes.c_int64 * len(item_shape))(*item_shape)
    return lib.p4t_read_npy_batch_shaped(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(np.prod(item_shape)), c_dims, len(item_shape),
    )
