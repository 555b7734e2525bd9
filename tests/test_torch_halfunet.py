"""HalfUNet in the port against the JAX package on the CPU: the same
variables (converted by ``convert.params_from_jax``) and the same inputs
through both, forward and every gradient; its pieces one by one (the
2x2 max pool with ties, GroupNorm, ``norm_layer``, ``get_activation``,
dilated Flax convolutions); ``Trainer.predict`` on Dummy and three AdamW
steps end to end.

Bars: a whole model 1e-4 of the largest JAX value (absolute below 1),
because the port sums in another order across convolutions and
GroupNorms (torch's two-pass variance against Flax's E[x²] − E[x]²);
single pieces 1e-5, the pool exactly.

With one channel a GroupNorm group, the conv bias before it has a zero
gradient in exact arithmetic and both packages return rounding noise;
the bias-on cases use widths with two channels a group, so every
gradient compared is a real one."""

import tempfile

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
from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu.ops.pool import max_pool_2x2 as jax_max_pool
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import base as port_base
from py4cast_tpu_torch.models import unet as port_unet
from py4cast_tpu_torch.ops.pool import max_pool_2x2

BAR = 1e-4
PIECE_TOL = dict(rtol=1e-5, atol=1e-5)
F_IN, F_OUT = 5, 3
#: (settings, grid): odd grids that autopad pads to a multiple of 4 or 8
CASES = {
    "plain": (dict(num_filters=16, depth=3), (13, 11)),
    "ghost_bias_dilated_pos": (dict(num_filters=32, depth=4, use_ghost=True, bias=True,
                                    dilation=2, absolute_pos_embed=True,
                                    last_activation="GELU"), (17, 9)),
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
    """The JAX HalfUNet, its variables (numpy), an input, the JAX
    output and gradients of sum(y²), and the port's HalfUNet with the
    converted variables loaded."""
    args, grid = CASES[request.param]
    jm = jax_unet.HalfUNet(num_input_features=F_IN, num_output_features=F_OUT,
                           input_shape=grid, settings=jax_unet.HalfUNetSettings(**args))
    x = np.random.default_rng(0).standard_normal((2, *grid, F_IN)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), x))
    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    want = np.asarray(want)
    pm = port_unet.HalfUNet(F_IN, F_OUT, grid, port_unet.HalfUNetSettings(**args))
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return variables, x, want, params_from_jax(jax.tree.map(np.asarray, grads)), pm


def test_params_from_jax_fills_every_parameter(case):
    variables, _, _, _, pm = case
    state = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    if "pos_embed" in variables["params"]:
        np.testing.assert_array_equal(state["pos_embed"].numpy(),
                                      variables["params"]["pos_embed"])


def test_forward_matches_jax(case):
    _, x, want, _, pm = case
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *x.shape[1:3], F_OUT)
    _close(got, want, BAR)


def test_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter."""
    _, x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g.numpy(), want[name].numpy(), BAR, name)
        assert float(g.abs().max()) > 0, name


# --------------------------------------------------------- pieces, one by one
@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 7, 9, 2)])
def test_max_pool_matches_jax_with_ties(shape):
    """Values and the VJP against the JAX custom-VJP pool: integer
    inputs from a small range make most windows tie, and the cotangent
    must go to the first maximum in row-major window order; odd tails
    are cropped and get no gradient."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 3, shape).astype(np.float32)
    g = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2, shape[3])).astype(
        np.float32)
    want, vjp = jax.vjp(jax_max_pool, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = max_pool_2x2(xt)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_dx.numpy(), np.asarray(want_dx))
    windows = x[:, : shape[1] // 2 * 2, : shape[2] // 2 * 2]
    assert (windows == windows.max()).sum() > windows.size // 4  # ties are common


class _OneNorm(nn.Module):
    def __init__(self, norm):
        super().__init__()
        self.GroupNorm_0 = norm


class _FlaxOneNorm(flax_nn.Module):
    make: object

    @flax_nn.compact
    def __call__(self, x):
        return self.make()(x)


@pytest.mark.parametrize("kind,channels", [("gn", 12), ("gn", 6), ("gn", 5), ("group", 16),
                                           ("instance", 4), ("layer", 6)])
def test_group_norms_match_flax(kind, channels):
    """``_gn`` (8 groups halved until they divide the channels) and
    ``norm_layer`` against the JAX package's, eps 1e-6, with random
    scales and biases where the norm has them."""
    rng = np.random.default_rng(channels)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 7, channels))).astype(np.float32)
    if kind == "gn":
        jax_make = lambda: jax_base._gn(channels)  # noqa: E731
        port = port_base._gn(channels)
    else:
        jax_make, port = (lambda: jax_base.norm_layer(kind, channels)), port_base.norm_layer(
            kind, channels)
    fm = _FlaxOneNorm(jax_make)
    variables = jax.tree.map(np.asarray, fm.init(jax.random.key(0), x))
    variables = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), variables)
    want = np.asarray(fm.apply(variables, x))
    model = _OneNorm(port)
    model.load_state_dict(params_from_jax(variables), strict=True)
    assert port.eps == 1e-6
    with torch.no_grad():
        got = model.GroupNorm_0(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **PIECE_TOL)


def test_norm_layer_refuses_batch_and_unknown_names():
    with pytest.raises(ValueError, match="batch"):
        port_base.norm_layer("batch", 8)
    with pytest.raises(ValueError, match="Unknown norm_name"):
        port_base.norm_layer("weight", 8)


@pytest.mark.parametrize("name", [k for k in jax_base.ACTIVATIONS])
def test_activations_match_flax(name):
    x = np.linspace(-4, 4, 24, dtype=np.float32).reshape(2, 3, 4)
    want = np.asarray(jax_base.get_activation(name)(jnp.asarray(x)))
    got = port_base.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **PIECE_TOL)
    assert set(port_base.ACTIVATIONS) == set(jax_base.ACTIVATIONS)
    with pytest.raises(ValueError, match="Unknown activation"):
        port_base.get_activation("Swish")


class _FlaxDilatedConv(flax_nn.Module):
    features: int
    dilation: int
    stride: int
    groups: int = 1

    @flax_nn.compact
    def __call__(self, x):
        return flax_nn.Conv(self.features, (3, 3), strides=(self.stride, self.stride),
                            kernel_dilation=(self.dilation, self.dilation),
                            feature_group_count=self.groups, padding="SAME")(x)


@pytest.mark.parametrize("hw,dilation,stride,groups", [
    ((13, 11), 2, 1, 1), ((9, 10), 3, 1, 1), ((16, 15), 2, 2, 1), ((8, 8), 2, 1, 4)])
def test_dilated_flax_conv_matches_flax(hw, dilation, stride, groups):
    """FlaxConv2d pads SAME for the dilated extent (k − 1)·d + 1."""
    rng = np.random.default_rng(dilation + stride)
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    fm = _FlaxDilatedConv(8, dilation, stride, groups)
    variables = jax.tree.map(np.asarray, fm.init(jax.random.key(1), x))
    variables["params"]["Conv_0"]["bias"] = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(fm.apply(variables, x))
    conv = port_base.FlaxConv2d(4, 8, 3, stride=stride, groups=groups, dilation=dilation)
    model = nn.Module()
    model.Conv_0 = conv
    model.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **PIECE_TOL)


def test_init_weights_draw_as_flax():
    """init_weights: every conv lecun-normal (fan_in = in / groups · 9,
    the ghost blocks' depthwise-grouped convs included), GroupNorm scale
    one and bias zero, and pos_embed truncated normal of std 0.02
    (±2 std) as flax's truncated_normal(0.02)."""
    pm = port_unet.HalfUNet(F_IN, F_OUT, (64, 64), port_unet.HalfUNetSettings(
        use_ghost=True, absolute_pos_embed=True, bias=True))
    port_training.init_weights(pm, torch.Generator().manual_seed(0))
    convs = [(n, m) for n, m in pm.named_modules() if isinstance(m, nn.Conv2d)]
    assert len(convs) == 5 * 4 + 1
    for name, conv in convs:
        want = conv.weight[0].numel() ** -0.5
        got = float(conv.weight.std())
        assert abs(got / want - 1) < 6 / conv.weight.numel() ** 0.5 + 0.02, (name, got, want)
        assert float(conv.bias.abs().max()) == 0.0, name
    for name, gn in pm.named_modules():
        if isinstance(gn, nn.GroupNorm):
            assert float((gn.weight - 1).abs().max()) == 0 and float(gn.bias.abs().max()) == 0
    pos = pm.pos_embed.detach()
    assert tuple(pos.shape) == (1, 64, 64, 1)
    assert float(pos.abs().max()) <= 0.04
    # a unit normal cut at ±2 has std 0.8796
    assert abs(float(pos.std()) / (0.02 * 0.8796) - 1) < 0.05


def test_default_model_name_builds_a_halfunet():
    """TrainingSettings' default model name is the JAX package's default
    model, at halfunet.yaml's width (64 filters, depth 4, no bias)."""
    _, _, test_ds = port_get_datasets("dummy", 2, 1, 3)
    module = port_training.AutoRegressiveModule(port_training.TrainingSettings(),
                                                test_ds.dataset_info, device="cpu")
    assert isinstance(module.model, port_unet.HalfUNet)
    assert module.model.settings == port_unet.HalfUNetSettings()
    assert all(not name.endswith("Conv_0.bias") for name, _ in module.model.named_parameters())


# ----------------------------------------------------------- end to end, Dummy
SMALL = dict(num_filters=16, depth=3, bias=True)


@pytest.fixture(scope="module")
def dummy_data():
    return jax_get_datasets("dummy", 2, 2, 3), port_get_datasets("dummy", 2, 2, 3)


def test_predict_matches_jax_on_dummy(dummy_data):
    """JAX Trainer.predict (params from module.init_state) against the
    port's from the same converted params."""
    (_, _, jax_test), (_, _, port_test) = dummy_data
    settings = dict(model_name="HalfUNet", settings_init_args=SMALL,
                    training_strategy="diff_ar")
    jax_module = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**settings), jax_test.dataset_info)
    state = jax_module.init_state(jax.random.key(0), 1)
    with tempfile.TemporaryDirectory() as tmp:
        want = jax_training.Trainer(
            jax_training.TrainerConfig(batch_size=8, save_path=tmp)
        ).predict(jax_module, jax_test, state)
    port_module = port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**settings), port_test.dataset_info, device="cpu")
    got = port_training.Trainer(
        port_training.TrainerConfig(batch_size=8, device="cpu", num_workers=1)
    ).predict(port_module, port_test, params_from_jax(jax.tree.map(np.asarray, state.params)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.names == w.names and g.feature_names == w.feature_names
        assert g.shape == (8, 3, 64, 64, 1)
        assert np.isfinite(g.array).all()
        _close(g.array, np.asarray(w.array), BAR)


def test_adamw_step_losses_match_jax(dummy_data):
    """Three AdamW steps of HalfUNet from converted params (2 AR steps a
    batch): the losses track the JAX package's within 1e-4."""
    (jax_train, _, _), (port_train, _, _) = dummy_data
    settings = dict(model_name="HalfUNet", settings_init_args=SMALL,
                    training_strategy="diff_ar", num_pred_steps_train=2,
                    num_pred_steps_val_test=2, num_warmup_steps=2)
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                           jax_train.dataset_info)
    state = jm.init_state(jax.random.key(0), 3)
    pm = port_training.AutoRegressiveModule(port_training.TrainingSettings(**settings),
                                            port_train.dataset_info, device="cpu")
    pstate = pm.init_state(None, 3, params_from_jax(jax.tree.map(np.asarray, state.params)))
    j_losses, p_losses = [], []
    batches = zip(jax_train.loader(batch_size=8, num_workers=1),
                  port_train.loader(batch_size=8, num_workers=1))
    for _, (jb, pb) in zip(range(3), batches):
        state, loss = jm.train_step(state, jb, jax.random.key(2))
        j_losses.append(float(loss))
        p_losses.append(float(pm.train_step(pstate, pb)))
    assert pstate.step == 3
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    assert len(set(p_losses)) == 3
