"""SwinUNetR in the port against the JAX package on the CPU: the same
variables (converted by ``convert.params_from_jax``) and the same inputs
through both, forward and every gradient, at feature size 8, depths
(2, 2) (every stage has a shifted block) and heads (2, 4), on grids
whose stage sizes are not multiples of the window 7 (each stage pads);
plain, and with ``use_v2`` and ``normalize: false``. Also the shift
mask and the relative-position index bit for bit, the settings' errors,
``use_checkpoint``, dropout and stochastic depth from the step's
generator, and a bf16 forward and gradient.

Bars: a whole model 1e-4 of the largest JAX value (absolute below 1),
as tests/test_torch_unetrpp.py; bf16 the bars of
tests/test_torch_bf16.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.models import swin as jax_swin
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import base as port_base
from py4cast_tpu_torch.models import swin as port_swin
from tests.test_torch_bf16 import check_against_jax

BAR = 1e-4
F_IN, F_OUT = 5, 3
SMALL = dict(feature_size=8, depths=(2, 2), num_heads=(2, 4))
#: (settings, grid): stage 0 at 16x16 and 20x24, padded to 21x21 and 21x28
CASES = {
    "plain": (SMALL, (30, 27)),
    "v2_unnormalized": (dict(SMALL, use_v2=True, normalize=False), (37, 45)),
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


def _draw(shapes, seed=0):
    """Variables drawn with numpy: kernels of std 1/sqrt(fan in), biases
    and norms near their init, relative-position biases of std 1 so that
    the attention is far from uniform."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        a = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[-4 if len(s.shape) >= 4 else -2:-1]))
        if name == "rel_pos_bias":
            return a
        if name == "scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(lambda p, s: draw(p, s).astype(np.float32), shapes)


def _models(args, grid):
    jm = jax_swin.SwinUNetR(num_input_features=F_IN, num_output_features=F_OUT,
                            input_shape=grid, settings=jax_swin.SwinUNetRSettings(**args))
    pm = port_swin.SwinUNetR(F_IN, F_OUT, grid, port_swin.SwinUNetRSettings(**args))
    return jm, pm


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX SwinUNetR, its variables (numpy), an input, the JAX output
    and gradients of sum(y²), and the port's SwinUNetR with the converted
    variables loaded."""
    args, grid = CASES[request.param]
    jm, pm = _models(args, grid)
    x = np.random.default_rng(1).standard_normal((2, *grid, F_IN)).astype(np.float32)
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x))

    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return variables, x, np.asarray(want), params_from_jax(jax.tree.map(np.asarray, grads)), pm


def test_params_from_jax_fills_every_parameter(case):
    """Every leaf lands on a parameter of the same shape: the relative-
    position biases as they are, the transposed convs' kernels flipped."""
    variables, _, _, _, pm = case
    state = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    tree = variables["params"]
    np.testing.assert_array_equal(
        state["SwinStage_1.SwinBlock_1.WindowAttention_0.rel_pos_bias"].numpy(),
        tree["SwinStage_1"]["SwinBlock_1"]["WindowAttention_0"]["rel_pos_bias"])
    kernel = tree["UpBlock_0"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(state["UpBlock_0.ConvTranspose_0.weight"].numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    assert ("v2_block0" in tree) == pm.settings.use_v2
    assert ("LayerNorm_1" in tree) == pm.settings.normalize


def test_forward_matches_jax(case):
    _, x, want, _, pm = case
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *x.shape[1:3], F_OUT)
    _close(got, want, BAR)


def test_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter, rel_pos_bias included."""
    _, x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g.numpy(), want[name].numpy(), BAR, name)
        assert float(g.abs().max()) > 0, name


def test_shift_mask_matches_jax_bit_for_bit():
    """The mask on padded stage sizes (window 7 and 3, shift ws // 2):
    −1e9, not −inf, the same bits."""
    for h, w, ws in ((21, 21, 7), (21, 28, 7), (14, 7, 7), (9, 6, 3)):
        got = port_swin._shift_mask(h, w, ws, ws // 2)
        want = jax_swin._shift_mask(h, w, ws, ws // 2)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), (h, w, ws)
        assert set(np.unique(got)) == {0.0, np.float32(-1e9)}


@pytest.mark.parametrize("ws", [3, 7])
def test_relative_position_index_matches_jax(ws):
    """The JAX WindowAttention's bias gather read back through its
    output: with q = k = 0, v = the tokens (one-hot) and an identity
    projection, row t of the output is softmax(bias[t]); bias values
    0.05·j for column j of rel_pos_bias give each pair's column, which
    must be the port's ``_rel_idx``; the port's 0/1 product gives the
    same bias."""
    t = ws * ws
    jm = jax_swin.WindowAttention(dim=t, heads=1, ws=ws)
    qkv = np.zeros((t, 3 * t), np.float32)
    qkv[:, 2 * t:] = np.eye(t)
    rpb = (0.05 * np.arange((2 * ws - 1) ** 2, dtype=np.float32))[None]
    variables = {"params": {
        "Dense_0": {"kernel": qkv, "bias": np.zeros(3 * t, np.float32)},
        "Dense_1": {"kernel": np.eye(t, dtype=np.float32), "bias": np.zeros(t, np.float32)},
        "rel_pos_bias": rpb}}
    p = np.asarray(jm.apply(variables, np.eye(t, dtype=np.float32)[None]))[0]
    centre = (ws - 1) * (2 * ws - 1) + ws - 1  # offset (0, 0)
    logp = np.log(p.astype(np.float64))
    want = np.rint((logp - np.diag(logp)[:, None]) / 0.05).astype(np.int64) + centre
    got = port_swin._rel_idx(ws)
    np.testing.assert_array_equal(got, want)
    pa = port_swin.WindowAttention(t, 1, ws)
    bias = (torch.from_numpy(rpb) @ pa.bias_select).reshape(t, t)
    assert torch.equal(bias, torch.from_numpy(rpb[0][got]))


def test_settings_validate_as_the_jax_package():
    """The JAX package's config-time errors: the drop rates' and
    downsample's word for word, norm "batch" (the port's norm_layer
    words it for the port)."""
    for bad in (dict(norm_name="batch"), dict(drop_rate=1.0), dict(attn_drop_rate=-0.1),
                dict(dropout_path_rate=1.5), dict(downsample="conv")):
        with pytest.raises(ValueError) as want:
            jax_swin.SwinUNetRSettings(**bad)
        with pytest.raises(ValueError) as got:
            port_swin.SwinUNetRSettings(**bad)
        if "norm_name" not in bad:
            assert str(got.value) == str(want.value), bad
    assert port_swin.SwinUNetRSettings.DROPOUT_FIELDS == jax_swin.SwinUNetRSettings.DROPOUT_FIELDS
    assert {f.name for f in dataclasses.fields(port_swin.SwinUNetRSettings)} == {
        f.name for f in dataclasses.fields(jax_swin.SwinUNetRSettings)}
    assert port_training._dropout_active(port_swin.SwinUNetRSettings(dropout_path_rate=0.1))
    assert not port_training._dropout_active(port_swin.SwinUNetRSettings())


def test_init_draws_rel_pos_bias_as_flax():
    """init_weights: rel_pos_bias flax's truncated_normal(0.02), cut at
    ±2 std (std 0.02 x 0.8796)."""
    pm = port_swin.SwinUNetR(F_IN, F_OUT, (64, 64), port_swin.SwinUNetRSettings(**SMALL))
    port_training.init_weights(pm, torch.Generator().manual_seed(0))
    biases = torch.cat([m.rel_pos_bias.detach().ravel() for m in pm.modules()
                        if isinstance(m, port_swin.WindowAttention)])
    assert biases.numel() == (2 + 2 + 4 + 4) * 169
    assert float(biases.abs().max()) <= 0.04
    assert abs(float(biases.std()) / (0.02 * 0.8796) - 1) < 6 / biases.numel() ** 0.5 + 0.02


def test_bf16_matches_jax():
    """Forward within max(2·d, 2⁻⁷) of scale of the JAX package's bf16
    (d: its own bf16-vs-fp32 gap), the master gradients within twice its
    own bf16 error: fp32 logits, sqrt(head_dim) rounded to bf16, fp32
    bias, mask and softmax, bf16 value product."""
    jm, pm = _models(SMALL, (24, 20))
    x = np.random.default_rng(2).standard_normal((2, 24, 20, F_IN)).astype(np.float32)
    check_against_jax("SwinUNetR", jm, pm, x)


# ---------------------------------------------------- dropout, trainer paths
def test_drop_path_keeps_whole_samples_from_the_generator():
    """One keep draw a sample, survivors scaled by 1 / (1 − rate), the
    same mask for the same seed, no draw from the global RNG, and the
    identity without a generator or at rate 0."""
    x = torch.ones(4000, 3, 5)
    before = torch.random.get_rng_state()
    y = port_base.drop_path(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), before)
    per_sample = y.reshape(4000, -1)
    assert torch.equal(per_sample.min(dim=1).values, per_sample.max(dim=1).values)
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / 0.75]))
    kept = float((per_sample[:, 0] != 0).float().mean())
    assert abs(kept - 0.75) < 5 * (0.25 * 0.75 / 4000) ** 0.5
    assert torch.equal(y, port_base.drop_path(x, 0.25, torch.Generator().manual_seed(1)))
    assert port_base.drop_path(x, 0.25, None) is x
    assert port_base.drop_path(x, 0.0, torch.Generator()) is x


@pytest.fixture(scope="module")
def dummy_train():
    return port_get_datasets("dummy", 2, 1, 3)[0]


def _module(train_ds, **args):
    settings = port_training.TrainingSettings(
        model_name="SwinUNetR", settings_init_args={**SMALL, **args},
        training_strategy="diff_ar", num_pred_steps_train=1, num_warmup_steps=2)
    return port_training.AutoRegressiveModule(settings, train_ds.dataset_info, device="cpu")


def test_dropout_and_drop_path_draw_from_the_step_and_repeat(dummy_train):
    """With drop_rate, attn_drop_rate and dropout_path_rate on, a train
    step's loss repeats bit for bit at the same optimizer step, differs
    at the next and from the deterministic loss, and never draws from
    the global RNG; eval (no seed) is the deterministic model."""
    batch = next(iter(dummy_train.loader(batch_size=2, num_workers=1)))
    module = _module(dummy_train, drop_rate=0.1, attn_drop_rate=0.1, dropout_path_rate=0.2)
    params = module.init_params(torch.Generator().manual_seed(0))
    state = module.init_state(None, 10, params)
    before = torch.random.get_rng_state()
    a, _ = module.loss_and_grads(state, batch)
    b, _ = module.loss_and_grads(state, batch)
    state.step += 1
    c, _ = module.loss_and_grads(state, batch)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = _module(dummy_train)
    d, _ = plain.loss_and_grads(params, batch)
    assert not torch.equal(a, d)
    x = torch.randn(1, 64, 64, module.num_input_features,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(torch.func.functional_call(module.model, params, (x,)),
                           torch.func.functional_call(plain.model, params, (x,)))


def test_use_checkpoint_gives_the_same_gradients(dummy_train):
    """use_checkpoint (the model's own flag, as the JAX trainer honours
    it) recomputes the forward in the backward: loss and gradients equal
    the run without it, dropout masks included."""
    batch = next(iter(dummy_train.loader(batch_size=2, num_workers=1)))
    out = []
    for ckpt in (False, True):
        module = _module(dummy_train, use_checkpoint=ckpt, dropout_path_rate=0.2)
        params = module.init_params(torch.Generator().manual_seed(0))
        out.append(module.loss_and_grads(params, batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)
