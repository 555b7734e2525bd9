"""CustomUNet, DeepLabV3 and DeepLabV3Plus (the ResNet-encoder models) in
the port against the JAX package on the CPU: the same variables (drawn
with numpy from ``jax.eval_shape``, converted by
``convert.params_from_jax``) and the same inputs through both, forward
and every gradient, each model with both encoder norms ("group" and
"affine"), encoder depth 3 and the real atrous rates (12, 24, 36),
larger than the deepest map (4x4); CustomUNet with autopad off at side
65, where each decoder level shrinks its upsampled map onto the skip;
the pieces: the explicit-padding stem and strided convs, the padded max
pool, AffineNorm's init, the antialiased bilinear shrink.

Bars: a whole model 1e-4 of the largest JAX value (absolute below 1),
as for HalfUNet (tests/test_torch_halfunet.py says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.models import deeplab as jax_deeplab
from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.models import deeplab as port_deeplab
from py4cast_tpu_torch.models import unet as port_unet
from py4cast_tpu_torch.training import init_weights

BAR = 1e-4
PIECE_TOL = dict(rtol=1e-5, atol=1e-5)
F_IN, F_OUT = 5, 3
MODELS = {
    "CustomUNet": (jax_unet.CustomUNet, jax_unet.CustomUNetSettings,
                   port_unet.CustomUNet, port_unet.CustomUNetSettings,
                   dict(encoder_depth=3, decoder_channels=(32, 16, 8))),
    "DeepLabV3": (jax_deeplab.DeepLabV3, jax_deeplab.DeepLabSettings,
                  port_deeplab.DeepLabV3, port_deeplab.DeepLabSettings,
                  dict(encoder_depth=3, decoder_channels=16)),
    "DeepLabV3Plus": (jax_deeplab.DeepLabV3Plus, jax_deeplab.DeepLabSettings,
                      port_deeplab.DeepLabV3Plus, port_deeplab.DeepLabSettings,
                      dict(encoder_depth=3, decoder_channels=16)),
}
#: (model, encoder norm, extra settings, grid, batch): odd grids padded
#: to a multiple of 8; the last case is not padded
CASES = {
    f"{model}_{norm}": (model, norm, {}, (30, 27), 2)
    for model in MODELS for norm in ("group", "affine")
}
CASES["CustomUNet_no_autopad_65"] = ("CustomUNet", "group", dict(autopad_enabled=False),
                                     (65, 65), 1)


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


def draw_variables(shapes, seed=0):
    """Variables for ``shapes`` (jax.eval_shape of init) drawn with numpy:
    kernels of std 1/sqrt(fan in), norms' scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        a = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(lambda p, s: draw(p, s).astype(np.float32), shapes)


def build(model, norm, extra, grid):
    """The JAX model and the port's, same settings."""
    jkls, jset, pkls, pset, args = MODELS[model]
    args = {**args, "encoder_norm": norm, **extra}
    jm = jkls(num_input_features=F_IN, num_output_features=F_OUT, input_shape=grid,
              settings=jset(**args))
    return jm, pkls(F_IN, F_OUT, grid, pset(**args))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX model's variables, an input, its output and gradients of
    sum(y²) (one jit), and the port's model with the variables loaded."""
    model, norm, extra, grid, batch = CASES[request.param]
    jm, pm = build(model, norm, extra, grid)
    x = np.random.default_rng(1).standard_normal((batch, *grid, F_IN)).astype(np.float32)
    variables = draw_variables(jax.eval_shape(jm.init, jax.random.key(0), x))

    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return (request.param, variables, x, np.asarray(want),
            params_from_jax(jax.tree.map(np.asarray, grads)), pm)


def test_params_from_jax_fills_every_parameter(case):
    """Flax's names (the encoder's stable ones, ASPP's and the heads'
    auto names) are the port's: every leaf lands on a parameter of its
    shape, AffineNorm's scale on its weight."""
    name, variables, _, _, _, pm = case
    state = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    if "affine" in name:
        assert "encoder.stage0_block0.norm1.weight" in state
        assert isinstance(pm.encoder.stage0_block0.norm1, port_unet.AffineNorm)
    if "DeepLab" in name:
        assert "ASPP_0.Conv_5.weight" in state and "ASPP_0.Conv_0.bias" not in state


def test_forward_matches_jax(case):
    name, _, x, want, _, pm = case
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    # CustomUNet without autopad ends on twice the stem's side (66)
    side = (66, 66) if "no_autopad" in name else x.shape[1:3]
    assert got.shape == want.shape == (x.shape[0], *side, F_OUT)
    _close(got, want, BAR, name)


def test_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter, within 1e-4 of the
    largest gradient of its module (a conv's weight and bias share one
    scale): CustomUNet's last ConvBlock has 8 channels, so its GroupNorms
    take a group a channel and the exact gradient of the conv biases
    before them is zero; both packages return rounding noise there, of
    the size that the module's weight gradient sets."""
    name, _, x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    module_scale = {}
    for k, w in want.items():
        module = k.rsplit(".", 1)[0]
        module_scale[module] = max(module_scale.get(module, 1.0), float(w.abs().max()))
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        scale = module_scale[k.rsplit(".", 1)[0]]
        assert err <= BAR * scale, f"{name} {k}: {err:.3e} > {BAR} x {scale:.3g}"
        assert float(g.abs().max()) > 0, k


# --------------------------------------------------------- pieces, one by one
@pytest.mark.parametrize("hw", [(16, 16), (15, 10)])
def test_resnet_stem_and_strided_conv_pad_as_torch_not_same(hw):
    """The stem (7x7 stride 2, padded (3, 3)) and a block's conv1 (3x3
    stride 2, padded (1, 1)) against Flax's explicit padding; on an even
    side SAME would pad (2, 3) and (0, 1)."""
    import flax.linen as flax_nn

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    for k, p in ((7, 3), (3, 1)):
        conv = flax_nn.Conv(4, (k, k), strides=(2, 2), padding=((p, p), (p, p)))
        v = draw_variables(jax.eval_shape(conv.init, jax.random.key(0), x), seed=k)
        want = np.asarray(conv.apply(v, x))
        port = port_unet.FlaxConv2d(3, 4, k, stride=2, padding=p)
        port.load_state_dict(params_from_jax(v))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 4)
        np.testing.assert_allclose(got, want, **PIECE_TOL)


def test_encoder_max_pool_pads_with_minus_infinity():
    """The stem's 3x3 stride-2 max pool padded (1, 1), values and VJP: on
    all-negative maps a zero pad would win at the borders; integer
    values make windows tie, and the cotangent goes to the first max."""
    import flax.linen as flax_nn

    rng = np.random.default_rng(3)
    x = -1.0 - rng.integers(0, 3, (2, 9, 8, 2)).astype(np.float32)
    g = rng.standard_normal((2, 5, 4, 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: flax_nn.max_pool(a, (3, 3), strides=(2, 2),
                                                   padding=((1, 1), (1, 1))), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_unet.max_pool_3x3(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **PIECE_TOL)


def test_affine_norm_initialises_to_identity():
    """init_weights leaves every AffineNorm at scale 1 and bias 0, as
    Flax's ones/zeros initializers, even after a load changed them."""
    pm = port_unet.CustomUNet(F_IN, F_OUT, (32, 32), port_unet.CustomUNetSettings(
        encoder_depth=3, decoder_channels=(16, 8, 8), encoder_norm="affine"))
    norms = [m for m in pm.modules() if isinstance(m, port_unet.AffineNorm)]
    assert len(norms) == 1 + 4 + 4 + 1  # stem, 2 + 2 blocks x 2, one proj
    with torch.no_grad():
        for m in norms:
            m.weight.fill_(3.0)
            m.bias.fill_(2.0)
    init_weights(pm, torch.Generator().manual_seed(0))
    for m in norms:
        assert torch.equal(m.weight, torch.ones_like(m.weight))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))


@pytest.mark.parametrize("src, dst", [((6, 6), (5, 5)), ((10, 12), (9, 11)), ((8, 8), (4, 4)),
                                      ((6, 10), (5, 5)), ((6, 5), (4, 9)), ((5, 7), (11, 3))])
def test_bilinear_resize_shrinks_as_jax(src, dst):
    """A shrinking axis antialiases as jax.image.resize does; one that
    grows while the other shrinks stays plain bilinear; values and the
    VJP."""
    x = np.random.default_rng(4).standard_normal((2, *src, 3)).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((2, *dst, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_unet._bilinear_resize(a, *dst), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_unet._bilinear_resize(xt, *dst)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **PIECE_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **PIECE_TOL)


@pytest.mark.parametrize("src, dst", [((4, 5), (16, 20)), ((16, 20), (128, 160)),
                                      ((5, 7), (13, 9)), ((3, 3), (12, 12))])
def test_grow_bilinear_function_matches_interpolate_and_jax(src, dst):
    """The models' growth (``_GrowBilinear``, whose backward is two
    fixed-order products): F.interpolate's forward bit for bit, and the
    VJP of jax.image.resize."""
    x = np.random.default_rng(6).standard_normal((2, *src, 3)).astype(np.float32)
    g = np.random.default_rng(7).standard_normal((2, *dst, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_unet._bilinear_resize(a, *dst), jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = port_unet._GrowBilinear.apply(xt, *dst)
    plain = torch.nn.functional.interpolate(xt.detach(), size=dst, mode="bilinear",
                                            align_corners=False)
    assert torch.equal(got.detach(), plain)
    got.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               **PIECE_TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **PIECE_TOL)


def test_deeplab_refuses_aux_params_and_unknown_encoders():
    with pytest.raises(ValueError, match="aux_params"):
        port_deeplab.DeepLabSettings(aux_params={"classes": 2})
    with pytest.raises(ValueError, match="Unknown encoder resnet50"):
        port_deeplab.DeepLabV3(F_IN, F_OUT, (32, 32),
                               port_deeplab.DeepLabSettings(encoder_name="resnet50"))
