"""UNet in the port against the JAX package on the CPU: the same
variables (converted by ``convert.params_from_jax``) and the same inputs
through both, forward and every gradient; Flax's ``ConvTranspose``
(k = s, SAME) against ``FlaxConvTranspose2d``, whose weight
``convert.py`` flips in both spatial axes; ``Trainer.predict`` on Dummy
and three AdamW steps end to end.

Bars: a whole model 1e-4 of the largest JAX value (absolute below 1),
single pieces 1e-5, as for HalfUNet (tests/test_torch_halfunet.py says
why). The widths give every GroupNorm group two channels or more, so
every conv bias has a real gradient."""

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
from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import base as port_base
from py4cast_tpu_torch.models import unet as port_unet

BAR = 1e-4
PIECE_TOL = dict(rtol=1e-5, atol=1e-5)
F_IN, F_OUT = 5, 3
#: (settings, grid): an odd grid autopad pads to a multiple of 8, and
#: one already a multiple of 4 with autopad off
CASES = {
    "autopad": (dict(init_features=16, depth=3), (13, 11)),
    "no_autopad": (dict(init_features=16, depth=2, autopad_enabled=False), (16, 8)),
}


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread runs them as fast
    and keeps this file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed=0):
    """Variables for ``shapes`` (jax.eval_shape of init) drawn with numpy
    instead of the jitted init, whose compile takes seconds: kernels of
    std 1/sqrt(fan in), biases away from zero, GroupNorm scales near 1."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        a = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "kernel":
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = (1.0 if name == "scale" else 0.0) + 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_state(jax_module, steps):
    """The JAX module's init_state with ``_draw``'s variables."""
    x = jnp.zeros((1, *jax_module.model.input_shape, jax_module.num_input_features))
    shapes = jax.eval_shape(jax_module.model.init, jax.random.key(0), x)

    def init_params(rng):
        jax_module._graph_buffers = {}  # as the JAX init_params leaves it for a grid model
        return _draw(shapes)

    jax_module.init_params = init_params
    return jax_module.init_state(jax.random.key(0), steps)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX UNet's variables (numpy), an input, the JAX output and
    gradients of sum(y²), and the port's UNet with the converted
    variables loaded."""
    args, grid = CASES[request.param]
    jm = jax_unet.UNet(num_input_features=F_IN, num_output_features=F_OUT, input_shape=grid,
                       settings=jax_unet.UNetSettings(**args))
    x = np.random.default_rng(0).standard_normal((2, *grid, F_IN)).astype(np.float32)
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x))

    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    pm = port_unet.UNet(F_IN, F_OUT, grid, port_unet.UNetSettings(**args))
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return variables, x, np.asarray(want), params_from_jax(jax.tree.map(np.asarray, grads)), pm


def test_params_from_jax_fills_every_parameter(case):
    variables, _, _, _, pm = case
    state = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    assert any(k.startswith("ConvTranspose_") for k in variables["params"])


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
class _FlaxConvTranspose(flax_nn.Module):
    features: int
    kernel: int

    @flax_nn.compact
    def __call__(self, x):
        return flax_nn.ConvTranspose(self.features, (self.kernel, self.kernel),
                                     strides=(self.kernel, self.kernel))(x)


@pytest.mark.parametrize("k,hw", [(2, (5, 7)), (4, (3, 6))])
def test_conv_transpose_matches_flax(k, hw):
    """FlaxConvTranspose2d at (k, s) = (2, 2) and (4, 4) against
    flax.linen.ConvTranspose (SAME), with a random kernel and bias:
    the output is the input's size times k, and convert.py's flip maps
    the kernel."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    fm = _FlaxConvTranspose(6, k)
    variables = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                             jax.eval_shape(fm.init, jax.random.key(0), x))
    want = np.asarray(fm.apply(variables, x))
    model = nn.Module()
    model.ConvTranspose_0 = port_base.FlaxConvTranspose2d(4, 6, k, k)
    model.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model.ConvTranspose_0(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] * k, hw[1] * k, 6)
    np.testing.assert_allclose(got, want, **PIECE_TOL)


def test_conv_transpose_refuses_kernel_other_than_stride():
    with pytest.raises(ValueError, match="kernel == stride"):
        port_base.FlaxConvTranspose2d(4, 6, 3, 2)


def test_unexpected_leaf_names_its_module():
    tree = {"params": {"EPABlock_0": {"EPA_0": {"gate": np.zeros(3, np.float32)}}}}
    with pytest.raises(ValueError, match="'gate' of module EPABlock_0/EPA_0"):
        params_from_jax(tree)


# ----------------------------------------------------------- end to end, Dummy
SMALL = dict(init_features=8, depth=2)


@pytest.fixture(scope="module")
def dummy_data():
    return jax_get_datasets("dummy", 2, 2, 3), port_get_datasets("dummy", 2, 2, 3)


def test_predict_matches_jax_on_dummy(dummy_data):
    """JAX Trainer.predict (params from ``_jax_state``) against the
    port's from the same converted params."""
    (_, _, jax_test), (_, _, port_test) = dummy_data
    settings = dict(model_name="UNet", settings_init_args=SMALL, training_strategy="diff_ar")
    jax_module = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**settings), jax_test.dataset_info)
    state = _jax_state(jax_module, 1)
    with tempfile.TemporaryDirectory() as tmp:
        want = jax_training.Trainer(
            jax_training.TrainerConfig(batch_size=8, save_path=tmp)
        ).predict(jax_module, jax_test, state)
    port_module = port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**settings), port_test.dataset_info, device="cpu")
    assert isinstance(port_module.model, port_unet.UNet)
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
    """Three AdamW steps of UNet from converted params (2 AR steps a
    batch): the losses track the JAX package's within 1e-4."""
    (jax_train, _, _), (port_train, _, _) = dummy_data
    settings = dict(model_name="UNet", settings_init_args=SMALL,
                    training_strategy="diff_ar", num_pred_steps_train=2,
                    num_pred_steps_val_test=2, num_warmup_steps=2)
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                           jax_train.dataset_info)
    state = _jax_state(jm, 3)
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
