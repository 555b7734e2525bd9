"""The bf16 mixed-precision policy in the port against the JAX package on
the CPU (``precision: bf16``): the kernel Functions at their bf16
boundary against the Pallas kernels in interpret mode, the grid models'
bf16 forward and gradients against the JAX package's, every ported
model's output dtype and the precision helpers. The graph models are
in ``test_torch_bf16_graph.py``, the trainer and the CLI in
``test_torch_bf16_train.py``.

Bars, relative to the JAX package's own bf16 error (bf16 keeps about
three digits, so no fixed bar fits every model):
- a kernel Function: the Pallas kernel's dtypes, and each output and
  gradient within one bf16 ulp of it (rtol 2⁻⁷, atol 2⁻⁷·1e-3 of the
  largest value): both compute in fp32 from the same bf16 values and
  round once at the same points;
- a model's forward: max|port − jax_bf16| ≤ max(2·d, 2⁻⁷) of the
  largest fp32 value, d = max|jax_bf16 − fp32| of it;
- a model's gradients into the fp32 masters, over the whole vector:
  ‖g_port − g_jax_bf16‖₂ ≤ 2·‖g_jax_bf16 − g_fp32‖₂ (a single leaf
  whose exact gradient is near zero is all rounding noise).
The fp32 values are the port's fp32 model's, held within 1e-4 of the
JAX package's by the fp32 parity tests (``check_against_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from py4cast_tpu.models import segformer as jax_segformer
from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu.models import unetrpp as jax_unetrpp
from py4cast_tpu.ops import attention as jax_attention
from py4cast_tpu.ops import hop_kernel as jax_hop
from py4cast_tpu.ops import lattice_ops as jax_lat
from py4cast_tpu.ops import stencil_kernel as jax_stencil
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.models import base as port_base
from py4cast_tpu_torch.models import graph as port_graph
from py4cast_tpu_torch.models import segformer as port_segformer
from py4cast_tpu_torch.models import unet as port_unet
from py4cast_tpu_torch.models import unetrpp as port_unetrpp
from py4cast_tpu_torch.models.graph import _corners_rc
from py4cast_tpu_torch.ops import _build
from py4cast_tpu_torch.ops import lattice_ops as port_lat
from py4cast_tpu_torch.ops.attention import ShortKVAttentionFn, fused_short_kv_attention
from py4cast_tpu_torch.ops.hop_kernel import CornerHopFn
from py4cast_tpu_torch.ops.stencil_kernel import StencilMessageFn
from py4cast_tpu_torch.utils import compute_dtype, exact_fp32, exact_reductions

BF16 = torch.bfloat16
ULP = 2.0 ** -7
F_IN, F_OUT = 5, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread runs them as fast
    and keeps this file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_arrays(seed, shapes):
    """fp32 arrays drawn with numpy and rounded to bf16 values (still
    stored as fp32), so that both packages start from the same bits."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, scale, shift in shapes:
        a = rng.standard_normal(shape).astype(np.float32) * scale + shift
        out.append(torch.from_numpy(a).to(BF16).float().numpy())
    return out


def _to_port(arrays, grad=True):
    return [torch.from_numpy(a).to(BF16).requires_grad_(grad) for a in arrays]


def _within_one_ulp(got, want, name):
    """got (torch) against want (jax): the same dtype, and one bf16 ulp."""
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16, (name, got.dtype, want.dtype)
    w = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(w).max())
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=ULP, atol=ULP * 1e-3 * scale,
                               err_msg=name)


# ------------------------------------------------------- kernel boundaries
B, H, W, HID, FF = 2, 8, 8, 16, 3
#: a ragged 9x7 grid over a 3x3 mesh level 0 (the last row and column clip)
GH, GW, MH, MW = 9, 7, 3, 3


@pytest.mark.parametrize("residual", [False, True])
def test_stencil_function_bf16_matches_pallas(residual):
    """StencilMessageFn on bf16 against jax.vjp of the Pallas kernel in
    interpret mode fed the JAX package's shift stack: out and agg, de,
    dps (the shift stack's VJP, summed as JAX sums it), dpd and the six
    weight gradients (fp32 sums cast to bf16)."""
    e, ps, pd, g_out, g_agg = _bf16_arrays(30, [
        ((B, 8, H, W, HID), 1.0, 0.0), ((B, H, W, HID), 1.0, 0.0), ((B, H, W, HID), 1.0, 0.0),
        ((B, 8, H, W, HID), 1.0, 0.0), ((B, H, W, HID), 1.0, 0.0)])
    mask = (np.random.default_rng(31).uniform(size=(8, H, W, 1)) > 0.2).astype(np.float32)
    weights = _bf16_arrays(32, [((HID, HID), 0.3, 0.0), ((HID,), 0.1, 0.0),
                                ((HID, HID), 0.3, 0.0), ((HID,), 0.1, 0.0),
                                ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0)])
    jmask = jnp.asarray(mask).astype(jnp.bfloat16)

    @jax.jit
    def reference(e, ps, pd, weights, g_out, g_agg):
        def fwd(e, ps, pd, *w):
            vs = jnp.stack([jax_lat.shift2d(ps, di, dj) for di, dj in jax_lat.DIRS8], axis=1)
            return jax_stencil.fused_stencil_message(e, vs, pd, jmask, *w, interpret=True,
                                                     mode=1, residual=residual)

        outs, vjp = jax.vjp(fwd, e, ps, pd, *weights)
        return outs, vjp((g_out, g_agg))

    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    (want_out, want_agg), want_grads = reference(bf(e), bf(ps), bf(pd), [bf(w) for w in weights],
                                                 bf(g_out), bf(g_agg))
    leaves = _to_port([e, ps, pd]) + _to_port(weights)
    out, agg = StencilMessageFn.apply(*leaves[:3], torch.from_numpy(mask).to(BF16),
                                      *leaves[3:], residual)
    _within_one_ulp(out, want_out, "out")
    _within_one_ulp(agg, want_agg, "agg")
    got = torch.autograd.grad((out, agg), leaves, (torch.from_numpy(g_out).to(BF16),
                                                   torch.from_numpy(g_agg).to(BF16)))
    names = ("de", "dps", "dpd", "dwe", "dbe", "dwo", "dbo", "dlns", "dlnb")
    for name, g, w in zip(names, got, want_grads):
        _within_one_ulp(g, w, name)


@pytest.mark.parametrize("mean", [False, True])
def test_hop_function_bf16_matches_pallas(mean):
    """CornerHopFn on bf16 against jax.vjp of the Pallas kernel in
    interpret mode fed the JAX package's sep_take_mm of each corner:
    v_out, dps (the corners' VJP, folded as JAX folds it), dvd and the
    fourteen weight gradients."""
    (r0, r1), (c0, c1) = _corners_rc((GH, GW), (MH, MW))
    rows = torch.from_numpy(np.stack([r0, r1]).astype(np.int32))
    cols = torch.from_numpy(np.stack([c0, c1]).astype(np.int32))
    ar = np.stack([port_lat.sel_matrix(r, MH) for r in (r0, r1)])
    ac = np.stack([port_lat.sel_matrix(c, MW) for c in (c0, c1)])
    ps, vd, feats, g = _bf16_arrays(33, [((B, MH, MW, HID), 1.0, 0.0), ((B, GH, GW, HID), 1.0, 0.0),
                                         ((4, GH, GW, FF), 0.5, 0.0), ((B, GH, GW, HID), 1.0, 0.0)])
    weights = _bf16_arrays(34, [
        ((FF, HID), 0.5, 0.0), ((HID,), 0.1, 0.0), ((HID, HID), 0.25, 0.0),
        ((HID, HID), 0.25, 0.0), ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),
        ((HID, HID), 0.2, 0.0), ((HID, HID), 0.2, 0.0), ((HID,), 0.1, 0.0),
        ((HID, HID), 0.25, 0.0), ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0)])
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    jar, jac, jfeats = bf(ar), bf(ac), bf(feats)

    @jax.jit
    def reference(ps, vd, weights, g):
        def fwd(ps, vd, *w):
            psg = [jax_lat.sep_take_mm(ps, jar[k // 2], jac[k % 2]) for k in range(4)]
            return jax_hop.fused_corner_hop(psg, vd, jfeats, *w, mean=mean, interpret=True,
                                            mode=1)

        out, vjp = jax.vjp(fwd, ps, vd, *weights)
        return out, vjp(g)

    want_out, want_grads = reference(bf(ps), bf(vd), [bf(w) for w in weights], bf(g))
    leaves = _to_port([ps, vd]) + _to_port(weights)
    out = CornerHopFn.apply(leaves[0], rows, cols, torch.from_numpy(ar).to(BF16),
                            torch.from_numpy(ac).to(BF16), leaves[1],
                            torch.from_numpy(feats).to(BF16), *leaves[2:], mean)
    _within_one_ulp(out, want_out, "v_out")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(BF16))
    names = ("dps", "dvd", "dwf", "dbf", "dwd", "dwo", "dbo", "dlns", "dlnb",
             "dnd0a", "dnd0b", "dnb0", "dnd1", "dnb1", "dnlns", "dnlnb")
    assert len(got) == len(want_grads) == len(names)
    for name, gr, w in zip(names, got, want_grads):
        _within_one_ulp(gr, w, name)


@pytest.mark.parametrize("shape", [(3, 40, 9, 16), (2, 33, 4, 64)])
def test_attention_function_bf16_matches_pallas(shape):
    """ShortKVAttentionFn on bf16 q, k, v against jax.vjp of the Pallas
    short-KV kernel in interpret mode: o and dq in q's dtype, dk and dv
    summed in fp32 and cast to k's and v's."""
    bh, lq, lk, d = shape
    q, k, v, do = _bf16_arrays(35 + d, [((bh, lq, d), 1.0, 0.0), ((bh, lk, d), 1.0, 0.0),
                                        ((bh, lk, d), 1.0, 0.0), ((bh, lq, d), 1.0, 0.0)])
    scale = 1.0 / np.sqrt(d)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731

    @jax.jit
    def reference(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: jax_attention.short_kv_attention(
            q, k, v, scale, interpret=True), q, k, v)
        return o, vjp(do)

    want_o, want_grads = reference(bf(q), bf(k), bf(v), bf(do))
    leaves = _to_port([q, k, v])
    o = ShortKVAttentionFn.apply(*leaves, scale)
    _within_one_ulp(o, want_o, "o")
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do).to(BF16))
    for name, g, w in zip(("dq", "dk", "dv"), got, want_grads):
        _within_one_ulp(g, w, name)
    _, lse = fused_short_kv_attention(*(t.detach() for t in leaves), scale)
    assert lse.dtype == torch.float32


def test_wrappers_take_fp32_and_bf16_only():
    """fp16 and fp64 still raise, naming what is supported."""
    assert _build.FLOAT_DTYPES == (torch.float32, torch.bfloat16)
    q = torch.zeros(1, 4, 8)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16"):
            fused_short_kv_attention(q.to(dtype), q, q, 1.0)


# --------------------------------------------------------- precision helpers
def test_compute_dtype_maps_the_precision_strings():
    for name in ("bf16", "bf16-mixed", "16-mixed"):
        assert compute_dtype(name) == BF16
    for name in ("32", "32-true"):
        assert compute_dtype(name) == torch.float32
    for name in ("64", "64-true"):
        with pytest.warns(UserWarning, match="fp32"):
            assert compute_dtype(name) == torch.float32
    with pytest.raises(ValueError, match="unknown"):
        compute_dtype("fp8")


def test_exact_reductions_sets_and_restores_the_cublas_flags():
    """TF32 off, bf16 split-K sums in fp32 and cuDNN's deterministic
    algorithms inside; the flags as they were after, also on an error."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32,
              matmul.allow_bf16_reduced_precision_reduction, cudnn.deterministic)
    matmul.allow_bf16_reduced_precision_reduction = True
    cudnn.deterministic = False

    @exact_fp32
    def inside():
        return (matmul.allow_tf32, cudnn.allow_tf32,
                matmul.allow_bf16_reduced_precision_reduction, cudnn.deterministic)

    try:
        assert inside() == (False, False, False, True)
        assert matmul.allow_bf16_reduced_precision_reduction and not cudnn.deterministic
        with pytest.raises(KeyError), exact_reductions():
            raise KeyError("restored on the way out")
        assert matmul.allow_bf16_reduced_precision_reduction and not cudnn.deterministic
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction, cudnn.deterministic) = before


@pytest.mark.parametrize("norm", ["layer", "group", "instance"])
def test_norms_take_fp32_statistics_and_round_once(norm):
    """LayerNorm and GroupNorm on bf16 (params bf16, as inside a model
    call): the fp32 computation on the same bf16 values, rounded once,
    within one bf16 ulp; Flax's force_float32_reductions does the same."""
    gen = torch.Generator().manual_seed(3)
    x = (3 * torch.randn(2, 9, 11, 16, generator=gen) + 1).to(BF16)
    if norm == "layer":
        mod = port_base.LayerNorm(16)
    else:
        mod = port_base.norm_layer(norm, 16)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_((1 + 0.1 * torch.randn(p.shape, generator=gen)).to(BF16))
        want = mod(x.float())
        got = mod.to(BF16)(x)
    assert got.dtype == BF16
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.float().numpy(), want.to(BF16).float().numpy(),
                               rtol=ULP, atol=ULP * 1e-3 * scale)


# ------------------------------------------------------------ grid models
def _draw(shapes, seed=0):
    """Variables for ``shapes`` (jax.eval_shape of init) drawn with numpy:
    kernels of std 1/sqrt(fan in), biases and norms near their init,
    EPA's temperature near 1 and projections of std 1/sqrt(tokens)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        a = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[-4 if len(s.shape) >= 4 else -2:-1]))
        if name in ("proj_k", "proj_v"):
            return a / np.sqrt(s.shape[-2])
        if name in ("scale", "temperature"):
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(lambda p, s: draw(p, s).astype(np.float32), shapes)


def jax_bf16(jm, variables, x):
    """The JAX model under its package's bf16 policy (``_model_apply``:
    float params and x cast to bf16 inside apply, the output back to
    fp32): (y, d mean(y²) / d params)."""

    def loss(v):
        vv = jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
        y = jm.apply(vv, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)
        return jnp.mean(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    return np.asarray(y), params_from_jax(jax.tree.map(np.asarray, g))


def port_run(pm, variables, x, dtype):
    """The port's model under the policy of ``dtype``: fp32 masters cast
    to it by differentiable casts, x too; (y in fp32, {name: grad of the
    master})."""
    pm.load_state_dict(params_from_jax(variables), strict=True)
    masters = {k: p.detach().clone().requires_grad_(True) for k, p in pm.named_parameters()}
    y = functional_call(pm, {k: v.to(dtype) for k, v in masters.items()},
                        (torch.from_numpy(x).to(dtype),))
    assert y.dtype == dtype
    y = y.float()
    grads = torch.autograd.grad((y ** 2).mean(), list(masters.values()), allow_unused=True,
                                materialize_grads=True)
    return y.detach().numpy(), dict(zip(masters, grads))


def check_against_jax(name, jm, pm, x, seed=0):
    """The forward and gradient bars of the module docstring. The fp32
    reference is the port's fp32 model, which the fp32 parity tests
    (``test_torch_<model>.py``) hold within 1e-4 of the JAX package's:
    a second JAX compile in fp32 would double this check's cost."""
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x), seed)
    y16, g16 = jax_bf16(jm, variables, x)
    y32, g32 = port_run(pm, variables, x, torch.float32)
    got, grads = port_run(pm, variables, x, BF16)
    scale = float(np.abs(y32).max())
    d = float(np.abs(y16 - y32).max()) / scale
    err = float(np.abs(got - y16).max()) / scale
    print(f"{name} forward: port vs jax bf16 {err:.3e}, jax bf16 vs fp32 {d:.3e} of {scale:.3g}")
    assert np.isfinite(got).all()
    assert err <= max(2 * d, ULP), f"{name}: {err:.3e} > max(2 x {d:.3e}, 2^-7)"

    def flat(g):
        return np.concatenate([np.asarray(g[k], np.float64).ravel() for k in sorted(g)])

    assert all(g.dtype == torch.float32 for g in grads.values())
    w16 = flat(g16)
    w32, gp = (flat({k: g.numpy() for k, g in gr.items()}) for gr in (g32, grads))
    own = float(np.linalg.norm(w16 - w32))
    gerr = float(np.linalg.norm(gp - w16))
    print(f"{name} gradients: |port - jax bf16| {gerr:.3e}, |jax bf16 - fp32| {own:.3e}, "
          f"|g| {np.linalg.norm(w32):.3e}")
    assert gerr <= 2 * own, f"{name}: {gerr:.3e} > 2 x {own:.3e}"


GRID_CASES = {
    "Segformer": (jax_segformer.Segformer, jax_segformer.SegformerSettings,
                  port_segformer.Segformer, port_segformer.SegformerSettings,
                  dict(dims=(32, 64), heads=(1, 2), num_layers=1, decoder_dim=16,
                       ff_expansion=(2, 2), reduction_ratio=(2, 1), num_downsampling_chans=8),
                  (32, 32)),
    "HalfUNet": (jax_unet.HalfUNet, jax_unet.HalfUNetSettings,
                 port_unet.HalfUNet, port_unet.HalfUNetSettings,
                 dict(num_filters=16, depth=3, use_ghost=True, bias=True, dilation=2,
                      absolute_pos_embed=True, last_activation="GELU"), (17, 9)),
    "UNet": (jax_unet.UNet, jax_unet.UNetSettings, port_unet.UNet, port_unet.UNetSettings,
             dict(init_features=8, depth=3), (16, 16)),
    "UNetRPP": (jax_unetrpp.UNetRPP, jax_unetrpp.UNetRPPSettings,
                port_unetrpp.UNetRPP, port_unetrpp.UNetRPPSettings,
                dict(hidden_size=32, num_heads_encoder=2, num_heads_decoder=2,
                     decoder_proj_size=8, depths=(1, 2), encoder_proj_sizes=(16, 8),
                     linear_upsampling=False, attention_code="pallas"), (29, 31)),
}


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_grid_model_bf16_matches_jax(name):
    """Forward and every master's gradient in bf16 against the JAX
    package's bf16, from the same numpy variables and input. UNetRPP
    runs its spatial attention through ShortKVAttentionFn (the JAX
    package on the CPU takes its einsum path) and its other EPA
    attention in fp32 logits, as the JAX package's."""
    jkls, jset, pkls, pset, args, grid = GRID_CASES[name]
    jm = jkls(num_input_features=F_IN, num_output_features=F_OUT, input_shape=grid,
              settings=jset(**args))
    pm = pkls(F_IN, F_OUT, grid, pset(**args))
    x = np.random.default_rng(1).standard_normal((2, *grid, F_IN)).astype(np.float32)
    check_against_jax(name, jm, pm, x)


def test_unetrpp_torch_attention_keeps_fp32_logits():
    """attention_code torch (the einsum path) on bf16: the logits and the
    softmax in fp32, the weights rounded once, as the JAX package's plain
    path; it agrees with the kernel path within bf16 rounding."""
    args = dict(GRID_CASES["UNetRPP"][4], attention_code="torch")
    grid = (29, 31)
    pm = port_unetrpp.UNetRPP(F_IN, F_OUT, grid, port_unetrpp.UNetRPPSettings(**args))
    pk = port_unetrpp.UNetRPP(F_IN, F_OUT, grid, port_unetrpp.UNetRPPSettings(
        **dict(args, attention_code="flash_attn")))
    pk.load_state_dict(pm.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, *grid, F_IN))
                         .astype(np.float32)).to(BF16)
    with torch.no_grad():
        a, b = pm.to(BF16)(x), pk.to(BF16)(x)
    assert a.dtype == b.dtype == BF16
    scale = float(b.float().abs().max())
    assert float((a.float() - b.float()).abs().max()) <= 4 * ULP * scale


# ------------------------------------------------------------ output dtype
MESHGRID = np.stack(np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32),
                                indexing="ij")).astype(np.float32)


def _port_graph(name):
    s = port_graph.GraphModelSettings(hidden_dims=8, processor_layers=1, mesh_levels=2)
    return getattr(port_graph, name)(F_IN, F_OUT, (1024,), s,
                                     port_graph.build_graph_artifacts(MESHGRID, s))


@pytest.mark.parametrize("name", ["GraphLAM", "HiLAM", "HiLAMParallel", "Segformer",
                                  "HalfUNet", "UNet", "UNetRPP"])
def test_model_returns_bf16_under_bf16_params(name):
    """The port's analogue of the JAX package's no-silent-upcast test
    (tests/test_models.py): bf16 params and a bf16 input give a bf16
    output, every float buffer cast at use, no fp32 leaking back in."""
    if name in GRID_CASES:
        _, _, pkls, pset, args, grid = GRID_CASES[name]
        model, shape = pkls(F_IN, F_OUT, grid, pset(**args)), grid
    else:
        model, shape = _port_graph(name), (1024,)
    params = {k: p.detach().to(BF16) for k, p in model.named_parameters()}
    x = torch.randn((1, *shape, F_IN), generator=torch.Generator().manual_seed(0)).to(BF16)
    with torch.no_grad():
        y = functional_call(model, params, (x,))
    assert y.dtype == BF16 and y.shape == (1, *shape, F_OUT)
    assert torch.isfinite(y.float()).all()
    if name not in GRID_CASES:  # the graph buffers stay fp32 in the module
        assert model.lat_m2g_feats.dtype == torch.float32
