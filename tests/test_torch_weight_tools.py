"""The port's weight-making tools (``py4cast_tpu_torch/tools/``) against
the JAX package's scripts in ``bin/`` on the CPU, each script loaded from
its path: the random fields bit for bit, the perceptual features after 5
steps within 1e-5, a torchvision checkpoint's npz bit for bit (and
CustomUNet with ``encoder_norm: affine`` on it within 1e-4 of the JAX
package's), the GRIB template byte for byte; the memory canary."""

import importlib.util
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.models import unet as port_unet
from py4cast_tpu_torch.models.pretrained import load_encoder_npz
from py4cast_tpu_torch.testing import torchvision_resnet_state_dict
from py4cast_tpu_torch.tools import (
    convert_torchvision_encoder,
    make_grib_template,
    pretrain_encoder,
    train_perceptual_features,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tools run small here, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tool(name: str):
    """The JAX package's ``bin/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"_bin_{name}", ROOT / "bin" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(monkeypatch, name: str, *args) -> int:
    """The JAX script's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, args)])
    return jax_tool(name).main()


@pytest.mark.parametrize("tool,channels,size", [
    ("pretrain_encoder", 3, 64), ("pretrain_encoder", 3, 33),
    ("train_perceptual_features", 1, 64)])
def test_gaussian_random_fields_bit_for_bit(tool, channels, size):
    """The port's one field generator against each JAX script's own,
    from the same seed (the perceptual script's fields are one channel
    of 64x64), and the generator left at the same state."""
    rng_port, rng_jax = np.random.default_rng(3), np.random.default_rng(3)
    got = pretrain_encoder.gaussian_random_fields(rng_port, 4, size, channels=channels)
    fields = jax_tool(tool).gaussian_random_fields
    want = (fields(rng_jax, 4, size) if channels == 3 else fields(rng_jax, 4, size=size))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (4, size, size, channels)
    np.testing.assert_array_equal(got, want)
    assert rng_port.standard_normal() == rng_jax.standard_normal()


def test_noisy_batches_draw_in_order_on_many_threads():
    """The fields computed on 16 threads with a thread switch every
    microsecond are, bit for bit, one thread's draws in the JAX tools'
    order (fields, then noise, a step after the other), and a generator
    closed early leaves no thread waiting."""
    n, size, steps = 2, 16, 24
    rng = np.random.default_rng(7)
    want = []
    for _ in range(steps):
        clean = pretrain_encoder.gaussian_random_fields(rng, n, size)
        want.append((clean + 0.3 * rng.standard_normal(clean.shape).astype(np.float32), clean))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(pretrain_encoder.noisy_batches(np.random.default_rng(7), steps, n, size,
                                                  workers=16))
        early = pretrain_encoder.noisy_batches(np.random.default_rng(7), steps, n, size,
                                               workers=16)
        first = next(early)
        closer = threading.Thread(target=early.close)
        closer.start()
        closer.join(timeout=30)
        assert not closer.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == steps
    for (noisy, clean), (want_noisy, want_clean) in zip(got, want):
        np.testing.assert_array_equal(clean, want_clean)
        np.testing.assert_array_equal(noisy, want_noisy)
    np.testing.assert_array_equal(first[1], want[0][1])


def test_perceptual_features_follow_the_jax_trajectory(tmp_path, monkeypatch):
    """5 Adam steps at batch 4 from seed 0, everything drawn with numpy:
    the port's npz holds the JAX script's keys and shapes, each array
    within 1e-5."""
    port_out, jax_out = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert train_perceptual_features.main(
        ["--steps", "5", "--batch", "4", "--out", str(port_out), "--device", "cpu"]) == 0
    assert run_jax_main(monkeypatch, "train_perceptual_features", "--steps", 5, "--batch", 4,
                        "--out", jax_out) == 0
    with np.load(port_out) as got, np.load(jax_out) as want:
        assert sorted(got.files) == sorted(want.files) == ["b0", "b1", "b2", "k0", "k1", "k2"]
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    with np.load(ROOT / "py4cast_tpu_torch" / "data" / "perceptual_feats.npz") as shipped, \
            np.load(port_out) as got:
        assert {k: shipped[k].shape for k in shipped.files} == {k: got[k].shape
                                                                for k in got.files}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A seeded torchvision resnet18 checkpoint and both tools' npz of it."""
    tmp = tmp_path_factory.mktemp("tv")
    ckpt = tmp / "resnet18.pth"
    torch.save(torchvision_resnet_state_dict("resnet18"), ckpt)
    port_out, jax_out = tmp / "port.npz", tmp / "jax.npz"
    assert convert_torchvision_encoder.main([str(ckpt), "--out", str(port_out)]) == 0
    with pytest.MonkeyPatch.context() as mp:
        assert run_jax_main(mp, "convert_torchvision_encoder", ckpt, "--out", jax_out) == 0
    return port_out, jax_out


def test_torchvision_conversion_bit_for_bit(converted):
    """The same arrays, bit for bit, and the same meta (affine,
    torchvision): BatchNorm folded with eps 1e-5, kernels HWIO."""
    (got, got_meta), (want, want_meta) = map(load_encoder_npz, converted)
    assert got_meta == want_meta == {"encoder_name": "resnet18", "norm": "affine",
                                     "in_channels": 3, "source": "torchvision"}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def draw(shapes, seed=0):
    """Variables for ``shapes`` drawn with numpy: kernels of std
    1/sqrt(fan in), scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        a = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return a / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return 1.0 + 0.1 * a if name == "scale" else 0.1 * a

    return jax.tree_util.tree_map_with_path(one, shapes)


def test_customunet_on_converted_weights_matches_jax(converted):
    """CustomUNet (resnet18, ``encoder_norm: affine``, 5 inputs) loads the
    port's npz as the JAX package loads the JAX script's: the encoder's
    tensors bit for bit, the stem adapted to 5 channels, and the forward
    within 1e-4 of the largest JAX value."""
    port_npz, jax_npz = converted
    grid, f_in, f_out = (32, 32), 5, 3
    settings = dict(encoder_name="resnet18", encoder_norm="affine")
    jm = jax_unet.CustomUNet(num_input_features=f_in, num_output_features=f_out,
                             input_shape=grid, settings=jax_unet.CustomUNetSettings(
                                 **settings, encoder_weights=str(jax_npz)))
    x = np.random.default_rng(1).standard_normal((1, *grid, f_in)).astype(np.float32)
    drawn = draw(jax.eval_shape(jm.init, jax.random.key(0), x))
    loaded = jm.load_pretrained(drawn)
    want = np.asarray(jax.jit(jm.apply)(loaded, jnp.asarray(x)))

    pm = port_unet.CustomUNet(f_in, f_out, grid, port_unet.CustomUNetSettings(
        **settings, encoder_weights=str(port_npz)))
    pm.load_state_dict(params_from_jax(drawn), strict=True)
    params = pm.load_pretrained({k: v.detach() for k, v in pm.named_parameters()})
    want_params = params_from_jax(jax.tree.map(np.asarray, loaded))
    enc = [k for k in params if k.startswith("encoder.")]
    assert enc and all(torch.equal(params[k], want_params[k]) for k in enc)
    assert params["encoder.stem_conv.weight"].shape[1] == f_in
    pm.load_state_dict(params, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, *grid, f_out)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_grib_template_byte_for_byte(tmp_path, monkeypatch):
    """Dummy's grid widened by 3 cells a side and its output fields: the
    port's file is the JAX script's, byte for byte, and reads back with
    the port's codec as asked."""
    from py4cast_tpu_torch.io.grib2 import read_grib2

    port_out, jax_out = tmp_path / "port.grib", tmp_path / "jax.grib"
    assert make_grib_template.main(["--dataset", "dummy", "--output", str(port_out),
                                    "--margin", "3"]) == 0
    assert run_jax_main(monkeypatch, "make_grib_template", "--dataset", "dummy", "--output",
                        jax_out, "--margin", 3) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    from py4cast_tpu_torch.datasets import get_datasets

    grid = get_datasets("dummy", 2, 1, 1)[0].grid
    fields = read_grib2(port_out)
    assert fields and all(f.values.shape == (grid.lat.shape[0] + 6, grid.lat.shape[1] + 6)
                          for f in fields)


def test_host_memory_check_passes():
    """Two epochs of the Dummy loader: exit 0 and ``MEMCHECK OK``."""
    out = subprocess.run(
        [sys.executable, "-m", "py4cast_tpu_torch.tools.host_memory_check", "--epochs", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "MEMCHECK OK" in out.stdout
    assert out.stdout.count("batches, RSS") == 2
