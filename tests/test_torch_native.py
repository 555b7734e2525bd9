"""The port's parallel npy batch reader (``py4cast_tpu_torch/native.py``
over ``csrc/p4t_io.cpp``) against numpy and the JAX package's reader:
bit for bit, shape and transposed-shape mismatches raise, a file that is
not float32 in C order goes through numpy with a warning naming it, a
library of an older source is rebuilt and one of another ABI at the
reader's own path raises, and a compiler that fails raises (nothing
falls back). No timing test: a test host's cores are shared."""

import subprocess
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from py4cast_tpu.native import read_npy_float32_batch as jax_read
from py4cast_tpu_torch import native


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("npys")
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((12, 17)).astype(np.float32) for _ in range(32)]
    paths = []
    for i, a in enumerate(arrays):
        p = d / f"f{i}.npy"
        np.save(p, a)
        paths.append(p)
    return paths, arrays


def test_reader_equals_numpy_and_the_jax_reader(npy_files):
    paths, arrays = npy_files
    out = native.read_npy_float32_batch(paths, (12, 17))
    assert out.dtype == np.float32 and out.shape == (32, 12, 17)
    np.testing.assert_array_equal(out, np.stack(arrays))
    np.testing.assert_array_equal(out, jax_read(paths, (12, 17)))
    assert native.read_npy_float32_batch([], (12, 17)).shape == (0, 12, 17)


def test_reader_is_right_under_concurrent_callers(npy_files):
    """Sixteen threads (more than this host's cores) call the reader at
    once, as the loader's workers do, each on its own order of the files,
    with the interpreter switching threads every 10 us: every batch is
    whole, and every call returns within the time bound."""
    paths, arrays = npy_files
    want = np.stack(arrays)

    def read(k):
        order = np.random.default_rng(k).permutation(len(paths))
        out = native.read_npy_float32_batch([paths[i] for i in order] * 4, (12, 17))
        return np.array_equal(out, np.concatenate([want[order]] * 4))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(read, k) for k in range(64)]
            assert all(f.result(timeout=60) for f in futures)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("bad_shape", [(4, 3), (3, 2)], ids=["larger", "transposed"])
def test_shape_mismatch_raises(tmp_path, bad_shape):
    """A file of more elements, or of the same count transposed, never
    fills a (2, 3) slot."""
    good, bad = tmp_path / "good.npy", tmp_path / "bad.npy"
    np.save(good, np.zeros((2, 3), np.float32))
    np.save(bad, np.arange(np.prod(bad_shape), dtype=np.float32).reshape(bad_shape))
    with pytest.raises(ValueError, match=f"shape mismatch: {bad}"):
        native.read_npy_float32_batch([good, bad], (2, 3))


@pytest.mark.parametrize("dtype,order", [(np.float64, "C"), (np.float32, "F"), (">f4", "C")])
def test_non_float32_file_goes_through_numpy_and_is_named(tmp_path, dtype, order):
    """float64, Fortran order, big-endian: the C++ reader rejects them,
    numpy reads them, a warning names the file; the other files of the
    batch still come from the C++ reader. Same values as the JAX
    package's reader gives."""
    ok, odd = tmp_path / "ok.npy", tmp_path / "odd.npy"
    first = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    second = np.asarray(np.arange(6).reshape(2, 3) / 3, dtype=dtype, order=order)
    np.save(ok, first)
    np.save(odd, second)
    with pytest.warns(UserWarning, match=str(odd)):
        out = native.read_npy_float32_batch([ok, odd, ok], (2, 3))
    np.testing.assert_array_equal(out, np.stack([first, second.astype(np.float32), first]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(out, jax_read([ok, odd, ok], (2, 3)))


def test_missing_file_raises(tmp_path):
    np.save(tmp_path / "a.npy", np.zeros((2, 3), np.float32))
    with pytest.raises(FileNotFoundError):
        native.read_npy_float32_batch([tmp_path / "a.npy", tmp_path / "gone.npy"], (2, 3))


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """The reader built into a private directory, with no library bound."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    yield tmp_path
    monkeypatch.setattr(native, "_LIB", None)


STUBS = pytest.mark.parametrize(
    "stub", ['extern "C" int p4t_version() { return 2; }',
             'extern "C" int p4t_unrelated() { return 0; }'], ids=["old_abi", "no_version"])


def _plant(private_build, stub) -> Path:
    """A library of ``stub`` at the path ``library_path()`` gives while
    ``SOURCE`` is the stub: what a build of that source leaves."""
    src = private_build / "stub.cpp"
    src.write_text(stub + "\n")
    lib = native.library_path()
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-o", str(lib), str(src)],
                   check=True)
    return lib


@STUBS
def test_stale_library_is_rebuilt(private_build, monkeypatch, stub, npy_files):
    """A library built from an older source, of another ABI version or
    none, is never bound: the current source's hash names another file,
    which is built and bound, and the stale one is left untouched."""
    real = native.SOURCE
    monkeypatch.setattr(native, "SOURCE", private_build / "stub.cpp")
    stale = _plant(private_build, stub)
    monkeypatch.setattr(native, "SOURCE", real)
    before = stale.read_bytes()
    bound = native.load()
    assert bound.p4t_version() == native.ABI_VERSION
    assert native.library_path() != stale and stale.read_bytes() == before
    paths, arrays = npy_files
    np.testing.assert_array_equal(native.read_npy_float32_batch(paths[:4], (12, 17)),
                                  np.stack(arrays[:4]))


@STUBS
def test_library_of_another_abi_at_its_path_raises(private_build, monkeypatch, stub):
    """A library at the reader's own path that answers another ABI
    version, or none, raises naming it: nothing is rebuilt over it and
    nothing is bound."""
    lib = _plant(private_build, stub)
    monkeypatch.setattr(native, "library_path", lambda: lib)
    with pytest.raises(RuntimeError, match=f"{lib} answers ABI (2|None), expected"):
        native.load()
    assert native._LIB is None
    assert sorted(lib.parent.iterdir()) == [lib]


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++"], ids=["fails", "missing"])
def test_failed_build_raises_and_nothing_falls_back(private_build, monkeypatch, cxx, npy_files):
    monkeypatch.setenv("CXX", cxx)
    paths, _ = npy_files
    with pytest.raises(RuntimeError, match="npy batch reader .*" + cxx.split("/")[-1]):
        native.read_npy_float32_batch(paths, (12, 17))
    assert native._LIB is None
    assert not list((private_build / "build").glob("*.so"))


def test_compiler_output_is_in_the_error(private_build, monkeypatch):
    """A source the compiler refuses: its message reaches the caller."""
    bad = private_build / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match=r"exit 1(?s:.*)error: "):
        native.load()


def test_library_is_built_once_and_keyed_by_source(private_build, monkeypatch):
    """Two loads bind one library; its file name carries the source's
    hash, so an edited source gets a library of its own."""
    first = native.load()
    assert native.load() is first
    (lib,) = (private_build / "build").glob("libp4tio_*.so")
    assert lib == native.library_path()
    edited = private_build / "p4t_io.cpp"
    edited.write_text(native.SOURCE.read_text() + "// edited\n")
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.library_path() != lib
