"""Segformer in the port against the JAX package on the CPU: the same
variables (converted by ``convert.params_from_jax``) and the same inputs
through both, forward and gradients; the parameter tree at default
width; the Flax convolutions' padding, the kernel conversion and the
bilinear resize piece by piece; ``Trainer.predict`` on Dummy end to end.

Bars: a whole model 1e-4 of the largest JAX value (absolute below 1),
because the port sums in another order across stages, LayerNorms and
the attention; single convolutions and the resize 1e-5."""

import math

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.models import base as jax_base
from py4cast_tpu.models import segformer as jax_segformer
from py4cast_tpu.models.unet import _bilinear_resize as jax_resize
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import base as port_base
from py4cast_tpu_torch.models import segformer as port_segformer
from py4cast_tpu_torch.models.unet import _bilinear_resize

BAR = 1e-4
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
F_IN, F_OUT = 5, 3
#: tests/test_models.py's tiny Segformer (a 17x19 grid, padded to 32x32),
#: and one with Segformer's head dim 32 and a K/V of 16 tokens
CASES = {
    "tiny": ({"dims": (8, 16), "heads": (1, 2), "num_layers": 1, "decoder_dim": 16,
              "ff_expansion": (2, 2), "reduction_ratio": (2, 1)}, (17, 19)),
    "head_dim_32": ({"dims": (32, 64), "heads": (1, 2), "num_layers": 2, "decoder_dim": 16,
                     "ff_expansion": (2, 2), "reduction_ratio": (2, 1),
                     "num_downsampling_chans": 8}, (32, 32)),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX Segformer, its variables (numpy), an input, and the port's
    Segformer with the converted variables loaded."""
    args, grid = CASES[request.param]
    jm = jax_segformer.Segformer(num_input_features=F_IN, num_output_features=F_OUT,
                                 input_shape=grid,
                                 settings=jax_segformer.SegformerSettings(**args))
    x = np.random.default_rng(0).standard_normal((2, *grid, F_IN)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), x))
    pm = port_segformer.Segformer(F_IN, F_OUT, grid, port_segformer.SegformerSettings(**args))
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return jm, variables, x, pm


def test_params_from_jax_gives_the_ports_names_and_shapes(case):
    _, variables, _, pm = case
    state = params_from_jax(variables)
    want = {k: tuple(p.shape) for k, p in pm.named_parameters()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want


def test_forward_matches_jax(case):
    jm, variables, x, pm = case
    want = np.asarray(jm.apply(variables, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *x.shape[1:3], F_OUT)
    _close(got, want, BAR)


def test_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter."""
    jm, variables, x, pm = case
    want = params_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda v: jnp.sum(jm.apply(v, x) ** 2))(variables)))
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g.numpy(), want[name].numpy(), BAR, name)
        assert float(g.abs().max()) > 0, name


def test_default_width_tree_and_count():
    """config/CLI/model/segformer.yaml's width (the settings' defaults),
    5 input and 3 output features on 64x64: 3,822,275 parameters, the
    same names and shapes in both packages."""
    jm = jax_segformer.Segformer(num_input_features=F_IN, num_output_features=F_OUT,
                                 input_shape=(64, 64))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, F_IN))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    pm = port_segformer.Segformer(F_IN, F_OUT, (64, 64))
    state = params_from_jax(zeros)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    assert sum(math.prod(s.shape) for s in jax.tree.leaves(shapes)) == 3_822_275
    assert sum(p.numel() for p in pm.parameters()) == 3_822_275


# ---------------------------------------------------- Flax convs, piece by piece
class _OneConv(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.Conv_0 = conv


class _FlaxOneConv(flax_nn.Module):
    features: int
    kernel: tuple
    stride: int
    groups: int = 1

    @flax_nn.compact
    def __call__(self, x):
        return flax_nn.Conv(self.features, self.kernel, strides=(self.stride, self.stride),
                            feature_group_count=self.groups, padding="SAME")(x)


@pytest.mark.parametrize("hw,kernel,stride,c_in,c_out,groups", [
    ((64, 64), (5, 5), 4, 6, 8, 1),     # the stage-1 patch conv (pads (0, 1))
    ((16, 20), (3, 3), 2, 8, 16, 1),    # stages 2-4's patch convs
    ((17, 19), (3, 3), 2, 4, 4, 1),     # odd sizes
    ((16, 24), (8, 8), 8, 4, 4, 1),     # the reduction conv, k = s = r (no pad)
    ((18, 20), (4, 4), 4, 3, 3, 1),     # k = s = r, n not a multiple of r
    ((10, 12), (3, 3), 1, 12, 12, 12),  # MixFFN's depthwise 3x3 (pads (1, 1))
    ((9, 7), (3, 2), 1, 3, 5, 1),       # a non-square kernel
    ((13, 11), (3, 3), 1, 5, 4, 1),     # the stem
])
def test_flax_conv_matches_flax(hw, kernel, stride, c_in, c_out, groups):
    """FlaxConv2d, its weight converted by params_from_jax, against
    flax.linen.Conv(padding="SAME")."""
    rng = np.random.default_rng(sum(hw) + stride)
    x = rng.standard_normal((2, *hw, c_in)).astype(np.float32)
    fm = _FlaxOneConv(c_out, kernel, stride, groups)
    variables = jax.tree.map(np.asarray, fm.init(jax.random.key(1), x))
    variables["params"]["Conv_0"]["bias"] = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(fm.apply(variables, x))
    conv = port_base.FlaxConv2d(c_in, c_out, kernel, stride=stride, groups=groups)
    model = _OneConv(conv)
    model.load_state_dict(params_from_jax(variables), strict=True)
    assert tuple(conv.weight.shape) == (c_out, c_in // groups, *kernel)
    with torch.no_grad():
        got = model.Conv_0(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CONV_TOL)


def test_flax_same_pad_is_asymmetric_with_stride():
    assert port_base.flax_same_pad(64, 5, 4) == (0, 1)
    assert port_base.flax_same_pad(64, 3, 2) == (0, 1)
    assert port_base.flax_same_pad(64, 3, 1) == (1, 1)
    assert port_base.flax_same_pad(64, 8, 8) == (0, 0)
    assert port_base.flax_same_pad(18, 4, 4) == (1, 1)


def test_params_from_jax_converts_conv_kernels_by_rank():
    """HWIO (kh, kw, in, out) goes to OIHW (out, in, kh, kw): a plain
    transpose would give (out, in, kw, kh) and swap the spatial axes."""
    rng = np.random.default_rng(3)
    conv = rng.standard_normal((3, 2, 4, 5)).astype(np.float32)
    depthwise = rng.standard_normal((3, 3, 1, 7)).astype(np.float32)
    dense = rng.standard_normal((4, 6)).astype(np.float32)
    state = params_from_jax({"params": {"Conv_0": {"kernel": conv}, "Conv_1": {"kernel": depthwise},
                                        "Dense_0": {"kernel": dense}}})
    assert tuple(state["Conv_0.weight"].shape) == (5, 4, 3, 2)
    np.testing.assert_array_equal(state["Conv_0.weight"].numpy()[4, 1, 2, 0], conv[2, 0, 1, 4])
    assert tuple(state["Conv_1.weight"].shape) == (7, 1, 3, 3)
    np.testing.assert_array_equal(state["Conv_1.weight"].numpy()[6, 0, 0, 2], depthwise[0, 2, 0, 6])
    np.testing.assert_array_equal(state["Dense_0.weight"].numpy(), dense.T)
    with pytest.raises(ValueError, match="rank 3"):
        params_from_jax({"params": {"Conv_0": {"kernel": np.zeros((3, 4, 5), np.float32)}}})


# ------------------------------------------------------------ resize and pads
def test_bilinear_resize_upsamples_as_jax():
    x = np.random.default_rng(4).standard_normal((2, 16, 20, 3)).astype(np.float32)
    want = np.asarray(jax_resize(x, 64, 80))
    got = _bilinear_resize(torch.from_numpy(x), 64, 80).numpy()
    np.testing.assert_allclose(got, want, **CONV_TOL)
    same = torch.from_numpy(x)
    assert _bilinear_resize(same, 16, 20) is same
    # a shrink antialiases, as jax does (tests/test_torch_resnet.py covers more)
    np.testing.assert_allclose(_bilinear_resize(same, 8, 20).numpy(),
                               np.asarray(jax_resize(x, 8, 20)), **CONV_TOL)


def test_pad_to_multiple_and_crop_match_jax():
    x = np.random.default_rng(5).standard_normal((1, 17, 19, 2)).astype(np.float32)
    jp, jhw = jax_base.pad_to_multiple(jnp.asarray(x), 8)
    pp, phw = port_base.pad_to_multiple(torch.from_numpy(x), 8)
    assert jhw == phw == (17, 19) and tuple(pp.shape) == jp.shape == (1, 24, 24, 2)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(port_base.crop_to(pp, phw).numpy(), x)


# ------------------------------------------------------ Trainer.predict on Dummy
@pytest.fixture(scope="module")
def dummy_predictions():
    """JAX Trainer.predict on Dummy (params from module.init_state), and
    the port's from the same converted params, on the CPU."""
    import tempfile

    settings = dict(model_name="Segformer", settings_init_args=CASES["head_dim_32"][0],
                    training_strategy="diff_ar")
    _, _, jax_test = jax_get_datasets("dummy", 2, 1, 3)
    jax_module = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**settings), jax_test.dataset_info)
    state = jax_module.init_state(jax.random.key(0), 1)
    with tempfile.TemporaryDirectory() as tmp:
        want = jax_training.Trainer(
            jax_training.TrainerConfig(batch_size=8, save_path=tmp)
        ).predict(jax_module, jax_test, state)
    _, _, port_test = port_get_datasets("dummy", 2, 1, 3)
    port_module = port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**settings), port_test.dataset_info, device="cpu")
    got = port_training.Trainer(
        port_training.TrainerConfig(batch_size=8, device="cpu", num_workers=1)
    ).predict(port_module, port_test, params_from_jax(jax.tree.map(np.asarray, state.params)))
    return want, got


def test_predict_matches_jax_on_dummy(dummy_predictions):
    want, got = dummy_predictions
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.names == w.names and g.feature_names == w.feature_names
        assert g.shape == (8, 3, 64, 64, 1)
        assert np.isfinite(g.array).all()
        _close(g.array, np.asarray(w.array), BAR)


def test_init_weights_draw_convs_as_flax():
    """init_weights gives every Conv2d Flax's lecun-normal spread
    (fan_in = in_channels / groups · kh · kw) and zero biases, as it does
    the Dense kernels: the stem, the patch convs, the reduction convs,
    the depthwise convs and the 1x1 decoder convs."""
    pm = port_segformer.Segformer(F_IN, F_OUT, (64, 64))
    port_training.init_weights(pm, torch.Generator().manual_seed(0))
    convs = [(n, m) for n, m in pm.named_modules() if isinstance(m, nn.Conv2d)]
    assert len(convs) == 1 + 4 + 3 * 2 + 4 * 2 + 2  # stem, patch, reduction, depthwise, decoder
    for name, conv in convs:
        fan_in = conv.weight[0].numel()
        want = fan_in ** -0.5
        got = float(conv.weight.std())
        n = conv.weight.numel()
        assert abs(got / want - 1) < 6 / n ** 0.5 + 0.02, (name, got, want)
        assert float(conv.weight.abs().max()) <= 2 * want / 0.87962566103423978 + 1e-6, name
        assert float(conv.bias.abs().max()) == 0.0, name
