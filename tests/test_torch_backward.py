"""The port's plain backwards of the stencil message and the corner hop
against the JAX package (``jax.vjp`` of its Pallas kernels in interpret
mode and of their XLA formulas), and the port's autograd Functions
against torch autograd through the plain forwards, on the CPU, where the
wrappers run their plain PyTorch versions.

StencilMessageFn takes the source projection ps (its forward shifts it
onto each cell); its gradients, dps included, are also held against
``jax.vjp`` of the JAX kernel composed with the JAX package's shift
stack. CornerHopFn takes the mesh projection ps and the corner maps (its
forward gathers the corners); its gradients, dps included, are also held
against ``jax.vjp`` of the JAX kernel composed with the JAX package's
``sep_take_mm`` of each corner.

Bars: 2e-4, the JAX kernel tests' gradient bar
(tests/test_stencil_kernel.py, tests/test_hop_kernel.py), against JAX;
1e-5 of the largest value (absolute below 1) for the Functions, which
run the same fp32 arithmetic as autograd in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.ops import hop_kernel as jax_hop
from py4cast_tpu.ops import lattice_ops as jax_lat
from py4cast_tpu.ops import stencil_kernel as jax_stencil
from py4cast_tpu_torch.models.graph import _corners_rc
from py4cast_tpu_torch.ops import lattice_ops as port_lat
from py4cast_tpu_torch.ops.hop_kernel import (
    CornerHopFn,
    corner_hop_bwd_plain,
    corner_hop_plain,
    fused_corner_hop_bwd,
)
from py4cast_tpu_torch.ops.stencil_kernel import (
    StencilMessageFn,
    fused_stencil_message_bwd,
    stencil_message_bwd_plain,
    stencil_message_plain,
)

JAX_TOL = dict(rtol=2e-4, atol=2e-4)
FN_BAR = 1e-5
#: level 0 of a 32x32 grid (coarsen factor 4), small width
B, H, W, HID = 2, 8, 8, 16
FF = 3
#: CornerHopFn: a ragged 9x7 grid over a 3x3 mesh level 0, whose last row
#: and column clip (r1 = r0, c1 = c0)
GH, GW, MH, MW = 9, 7, 3, 3
HOP_FN_NAMES = ("dps", "dvd", "dwf", "dbf", "dwd", "dwo", "dbo", "dlns", "dlnb",
                "dnd0a", "dnd0b", "dnb0", "dnd1", "dnb1", "dnlns", "dnlnb")
STENCIL_NAMES = ("de", "dvs", "dpd", "dwe", "dbe", "dwo", "dbo", "dlns", "dlnb")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc + sh for s, sc, sh in shapes]


def _t(arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.fixture(scope="module")
def stencil_case():
    """Inputs and the cotangents of (out, agg)."""
    e, vs, pd = _arrays(10, [((B, 8, H, W, HID), 1.0, 0.0), ((B, 8, H, W, HID), 1.0, 0.0),
                             ((B, H, W, HID), 1.0, 0.0)])
    mask = (np.random.default_rng(11).uniform(size=(8, H, W, 1)) > 0.2).astype(np.float32)
    params = _arrays(12, [
        ((HID, HID), 0.3, 0.0), ((HID,), 0.1, 0.0),  # we, be
        ((HID, HID), 0.3, 0.0), ((HID,), 0.1, 0.0),  # wo, bo
        ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),      # lns, lnb
    ])
    g_out, g_agg = _arrays(13, [((B, 8, H, W, HID), 1.0, 0.0), ((B, H, W, HID), 1.0, 0.0)])
    return [e, vs, pd, mask] + params, g_out, g_agg


@pytest.fixture(scope="module")
def stencil_fn_case():
    """StencilMessageFn's inputs (ps in place of vs) and the cotangents
    of (out, agg)."""
    e, ps, pd = _arrays(14, [((B, 8, H, W, HID), 1.0, 0.0), ((B, H, W, HID), 1.0, 0.0),
                             ((B, H, W, HID), 1.0, 0.0)])
    mask = (np.random.default_rng(15).uniform(size=(8, H, W, 1)) > 0.2).astype(np.float32)
    params = _arrays(16, [
        ((HID, HID), 0.3, 0.0), ((HID,), 0.1, 0.0),  # we, be
        ((HID, HID), 0.3, 0.0), ((HID,), 0.1, 0.0),  # wo, bo
        ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),      # lns, lnb
    ])
    g_out, g_agg = _arrays(17, [((B, 8, H, W, HID), 1.0, 0.0), ((B, H, W, HID), 1.0, 0.0)])
    return [e, ps, pd, mask] + params, g_out, g_agg


@pytest.fixture(scope="module")
def hop_case():
    psg = _arrays(20, [((B, H, W, HID), 1.0, 0.0)] * 4)
    vd, feats = _arrays(21, [((B, H, W, HID), 1.0, 0.0), ((4, H, W, FF), 0.5, 0.0)])
    params = _arrays(22, [
        ((FF, HID), 0.5, 0.0), ((HID,), 0.1, 0.0),                  # wf, bf
        ((HID, HID), 0.25, 0.0), ((HID, HID), 0.25, 0.0),            # wd, wo
        ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),  # bo, lns, lnb
        ((HID, HID), 0.2, 0.0), ((HID, HID), 0.2, 0.0),              # nd0a, nd0b
        ((HID,), 0.1, 0.0), ((HID, HID), 0.25, 0.0),                 # nb0, nd1
        ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),  # nb1, nlns, nlnb
    ])
    (g,) = _arrays(23, [((B, H, W, HID), 1.0, 0.0)])
    return psg, [vd, feats] + params, g


@pytest.fixture(scope="module")
def hop_fn_case():
    """CornerHopFn's inputs: (ps, rows, cols, ar, ac), [vd, feats,
    weights...], and the cotangent of v_out."""
    (ps,) = _arrays(24, [((B, MH, MW, HID), 1.0, 0.0)])
    (r0, r1), (c0, c1) = _corners_rc((GH, GW), (MH, MW))
    rows = np.stack([r0, r1]).astype(np.int32)
    cols = np.stack([c0, c1]).astype(np.int32)
    ar = np.stack([port_lat.sel_matrix(r, MH) for r in rows])
    ac = np.stack([port_lat.sel_matrix(c, MW) for c in cols])
    vd, feats = _arrays(25, [((B, GH, GW, HID), 1.0, 0.0), ((4, GH, GW, FF), 0.5, 0.0)])
    params = _arrays(26, [
        ((FF, HID), 0.5, 0.0), ((HID,), 0.1, 0.0),                  # wf, bf
        ((HID, HID), 0.25, 0.0), ((HID, HID), 0.25, 0.0),            # wd, wo
        ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),  # bo, lns, lnb
        ((HID, HID), 0.2, 0.0), ((HID, HID), 0.2, 0.0),              # nd0a, nd0b
        ((HID,), 0.1, 0.0), ((HID, HID), 0.25, 0.0),                 # nb0, nd1
        ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),  # nb1, nlns, nlnb
    ])
    (g,) = _arrays(27, [((B, GH, GW, HID), 1.0, 0.0)])
    return (ps, rows, cols, ar, ac), [vd, feats] + params, g


def _hop_fn_grads(src, rest, g, fn):
    """Gradients of sum(fn(ps, maps, vd, feats, weights) * g) for ps, vd
    and the weights."""
    ps = torch.from_numpy(src[0]).requires_grad_()
    maps = _t(src[1:])
    lr = [a.clone().requires_grad_(i != 1) for i, a in enumerate(_t(rest))]
    loss = (fn(ps, maps, lr) * torch.from_numpy(g)).sum()
    return torch.autograd.grad(loss, [ps] + [a for i, a in enumerate(lr) if i != 1])


def _stencil_xla(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual):
    """_StencilMessage's unfused XLA formula (flax LayerNorm)."""
    import flax.linen as nn

    pre = e @ we + be + vs + pd[:, None]
    t = jax.nn.silu(pre) @ wo + bo
    e_new = nn.LayerNorm().apply({"params": {"scale": lns, "bias": lnb}}, t)
    agg = (e_new * mask[None]).sum(axis=1)
    return (e + e_new if residual else e_new), agg


def _hop_xla(p0, p1, p2, p3, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
             nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean):
    """LatticeEncodeDecode's unfused 'corners' formula (flax LayerNorm)."""
    import flax.linen as nn

    def ln(x, s, b):
        return nn.LayerNorm().apply({"params": {"scale": s, "bias": b}}, x)

    psg = (p0, p1, p2, p3)
    pd = vd @ wd
    pf = feats @ wf + bf
    agg = sum(ln(jax.nn.silu(pf[k] + psg[k] + pd) @ wo + bo, lns, lnb) for k in range(4))
    if mean:
        agg = agg / 4.0
    u = jax.nn.silu(jnp.concatenate([vd, agg], -1) @ jnp.concatenate([nd0a, nd0b], 0) + nb0)
    return vd + ln(u @ nd1 + nb1, nlns, nlnb)


# ----------------------------------------------------------- (i) a-bwd vs JAX
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("residual", [False, True])
def test_stencil_bwd_plain_matches_jax_vjp(stencil_case, residual, reference):
    args, g_out, g_agg = stencil_case
    jargs = [jnp.asarray(a) for a in args]
    if reference == "pallas_interpret":
        def fwd(e, vs, pd, we, be, wo, bo, lns, lnb):
            return jax_stencil.fused_stencil_message(
                e, vs, pd, jargs[3], we, be, wo, bo, lns, lnb,
                interpret=True, mode=1, residual=residual)
    else:
        def fwd(e, vs, pd, we, be, wo, bo, lns, lnb):
            return _stencil_xla(e, vs, pd, jargs[3], we, be, wo, bo, lns, lnb, residual)
    diff = jargs[:3] + jargs[4:]
    _, vjp = jax.vjp(fwd, *diff)
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_agg)))
    got = stencil_message_bwd_plain(*_t(args), *_t([g_out, g_agg]), residual=residual)
    for name, g, w in zip(STENCIL_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL, err_msg=name)


# ----------------------------------------------------------- (ii) b-bwd vs JAX
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("mean", [False, True])
def test_hop_bwd_plain_matches_jax_vjp(hop_case, mean, reference):
    psg, rest, g = hop_case
    jpsg = [jnp.asarray(p) for p in psg]
    jrest = [jnp.asarray(a) for a in rest]
    feats = jrest[1]
    if reference == "pallas_interpret":
        def fwd(p0, p1, p2, p3, vd, *weights):
            return jax_hop.fused_corner_hop([p0, p1, p2, p3], vd, feats, *weights,
                                            mean=mean, interpret=True, mode=1)
    else:
        def fwd(p0, p1, p2, p3, vd, *weights):
            return _hop_xla(p0, p1, p2, p3, vd, feats, *weights, mean)
    _, vjp = jax.vjp(fwd, *jpsg, jrest[0], *jrest[2:])
    want = vjp(jnp.asarray(g))
    got = corner_hop_bwd_plain(_t(psg), *_t(rest), torch.from_numpy(g), mean=mean)
    assert len(got) == len(want) == 19
    for i, (gr, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gr.numpy(), np.asarray(w), **JAX_TOL, err_msg=f"grad {i}")


# ------------------------------------------------ (iii) Functions vs autograd
def _assert_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= FN_BAR * scale, f"{what} grad {i}: {err:.3e} > {FN_BAR} x {scale:.3g}"


@pytest.mark.parametrize("case", ["residual", "plain", "out_unused"])
def test_stencil_function_matches_autograd(stencil_fn_case, case):
    """StencilMessageFn's gradients (saved tensors, grad order, residual
    flag, dps through unshift_sum) against autograd through the plain
    forward and its shift stack. ``out_unused``: only agg feeds the loss,
    so g_out reaches the backward as zeros."""
    args, g_out, g_agg = stencil_fn_case
    residual = case == "residual"
    go, ga = _t([g_out, g_agg])

    def grads(fn):
        leaves = [a.clone().requires_grad_(i != 3) for i, a in enumerate(_t(args))]
        out, agg = fn(leaves)
        loss = (agg * ga).sum() if case == "out_unused" else (out * go).sum() + (agg * ga).sum()
        return torch.autograd.grad(loss, [a for i, a in enumerate(leaves) if i != 3])

    got = grads(lambda a: StencilMessageFn.apply(*a, residual))
    want = grads(lambda a: stencil_message_plain(*a, residual=residual))
    _assert_close(got, want, "StencilMessageFn")


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("residual", [False, True])
def test_stencil_function_matches_jax_vjp(stencil_fn_case, residual, reference):
    """StencilMessageFn's gradients, dps included, against jax.vjp of the
    JAX kernel (or its XLA formula) fed the JAX package's shift stack."""
    args, g_out, g_agg = stencil_fn_case
    jargs = [jnp.asarray(a) for a in args]

    def fwd(e, ps, pd, we, be, wo, bo, lns, lnb):
        vs = jnp.stack([jax_lat.shift2d(ps, di, dj) for di, dj in jax_lat.DIRS8], axis=1)
        if reference == "xla":
            return _stencil_xla(e, vs, pd, jargs[3], we, be, wo, bo, lns, lnb, residual)
        return jax_stencil.fused_stencil_message(
            e, vs, pd, jargs[3], we, be, wo, bo, lns, lnb,
            interpret=True, mode=1, residual=residual)

    _, vjp = jax.vjp(fwd, *(jargs[:3] + jargs[4:]))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_agg)))
    leaves = [a.clone().requires_grad_(i != 3) for i, a in enumerate(_t(args))]
    out, agg = StencilMessageFn.apply(*leaves, residual)
    loss = (out * torch.from_numpy(g_out)).sum() + (agg * torch.from_numpy(g_agg)).sum()
    got = torch.autograd.grad(loss, [a for i, a in enumerate(leaves) if i != 3])
    names = ("de", "dps") + STENCIL_NAMES[2:]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL, err_msg=name)


@pytest.mark.parametrize("mean", [False, True])
def test_hop_function_matches_autograd(hop_fn_case, mean):
    """CornerHopFn's gradients (saved tensors, grad order, mean flag, dps
    through sep_aggregate) against autograd through the plain forward
    and its gather."""
    src, rest, g = hop_fn_case
    got = _hop_fn_grads(src, rest, g, lambda ps, m, lr: CornerHopFn.apply(ps, *m, *lr, mean))
    want = _hop_fn_grads(src, rest, g,
                         lambda ps, m, lr: corner_hop_plain(ps, *m[:2], *lr, mean=mean))
    _assert_close(got, want, "CornerHopFn")


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("mean", [False, True])
def test_hop_function_matches_jax_vjp(hop_fn_case, mean, reference):
    """CornerHopFn's gradients, dps included, against jax.vjp of the JAX
    kernel (or its XLA formula) fed the JAX package's sep_take_mm of each
    corner."""
    src, rest, g = hop_fn_case
    ar, ac = jnp.asarray(src[3]), jnp.asarray(src[4])
    jrest = [jnp.asarray(a) for a in rest]
    feats = jrest[1]

    def fwd(ps, vd, *weights):
        psg = [jax_lat.sep_take_mm(ps, ar[k // 2], ac[k % 2]) for k in range(4)]
        if reference == "xla":
            return _hop_xla(*psg, vd, feats, *weights, mean)
        return jax_hop.fused_corner_hop(psg, vd, feats, *weights, mean=mean,
                                        interpret=True, mode=1)

    _, vjp = jax.vjp(fwd, jnp.asarray(src[0]), jrest[0], *jrest[2:])
    want = vjp(jnp.asarray(g))
    got = _hop_fn_grads(src, rest, g, lambda ps, m, lr: CornerHopFn.apply(ps, *m, *lr, mean))
    assert len(got) == len(want) == len(HOP_FN_NAMES)
    for name, gr, w in zip(HOP_FN_NAMES, got, want):
        np.testing.assert_allclose(gr.numpy(), np.asarray(w), **JAX_TOL, err_msg=name)


def test_functions_give_no_gradient_to_mask_and_feats(stencil_fn_case, hop_fn_case):
    args = [a.clone().requires_grad_() for a in _t(stencil_fn_case[0])]
    out, agg = StencilMessageFn.apply(*args, True)
    (out.sum() + agg.sum()).backward()
    assert args[3].grad is None and args[0].grad is not None
    src, rest, _ = hop_fn_case
    ps, rows, cols, ar, ac = _t(src)
    ps, ar, ac = (t.clone().requires_grad_() for t in (ps, ar, ac))
    lr = [a.clone().requires_grad_() for a in _t(rest)]
    CornerHopFn.apply(ps, rows, cols, ar, ac, *lr, False).sum().backward()
    assert lr[1].grad is None and ar.grad is None and ac.grad is None
    assert lr[0].grad is not None and ps.grad is not None


def test_cpu_backward_calls_leave_launch_counters_at_zero(stencil_case, hop_case):
    fused_stencil_message_bwd.launches = 0
    fused_corner_hop_bwd.launches = 0
    args, g_out, g_agg = stencil_case
    fused_stencil_message_bwd(*_t(args), *_t([g_out, g_agg]), residual=True)
    psg, rest, g = hop_case
    fused_corner_hop_bwd(_t(psg), *_t(rest), torch.from_numpy(g))
    assert fused_stencil_message_bwd.launches == 0
    assert fused_corner_hop_bwd.launches == 0


def _widened(arrays, width, seed):
    """Arrays of the same shapes with every HID axis at ``width``, drawn
    as the fixtures draw them (weights scaled to unit-spread products)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in arrays:
        shape = tuple(width if d == HID else d for d in a.shape)
        if len(shape) == 2 and shape[0] == shape[1] == width:  # an h x h weight
            out.append((rng.standard_normal(shape) * width ** -0.5).astype(np.float32))
        elif a.ndim == 4 and a.shape[-1] == 1 or a.shape == (4, H, W, FF):  # mask, feats
            out.append(a)
        else:
            out.append((rng.standard_normal(shape) * 0.3 + (a.mean() > 0.5)).astype(np.float32))
    return out


@pytest.mark.parametrize("fault", ["width", "cotangent_shape", "cotangent_dtype"])
def test_bwd_wrappers_reject_bad_arguments(stencil_case, hop_case, fault):
    """Shapes and dtypes the backward wrappers refuse. A width above the
    CUDA kernels' row-tile instances is not one of them: at such a width
    ("width") both wrappers run (on the CPU, their plain versions) and
    agree with jax.vjp of the JAX package's XLA formulas."""
    args, g_out, g_agg = stencil_case
    s_args, s_cot = _t(args), _t([g_out, g_agg])
    psg, rest, g = hop_case
    h_psg, h_rest, h_g = _t(psg), _t(rest), torch.from_numpy(g)
    if fault == "width":  # above the backward kernels' row-tile instances
        wide = 80  # past the row-tile instances (64)
        w_args = _widened(args + [g_out, g_agg], wide, 60)
        jargs = [jnp.asarray(a) for a in w_args]
        _, vjp = jax.vjp(lambda e, vs, pd, *wts: _stencil_xla(e, vs, pd, jargs[3], *wts, True),
                         *jargs[:3], *jargs[4:10])
        want = vjp((jargs[10], jargs[11]))
        got = fused_stencil_message_bwd(*_t(w_args), residual=True)
        for name, gr, w in zip(STENCIL_NAMES, got, want):
            np.testing.assert_allclose(gr.numpy(), np.asarray(w), **JAX_TOL, err_msg=name)
        wide = 80
        w_psg, w_rest, (w_g,) = (_widened(psg, wide, 61), _widened(rest, wide, 62),
                                 _widened([g], wide, 63))
        jr = [jnp.asarray(a) for a in w_rest]
        _, vjp = jax.vjp(lambda p0, p1, p2, p3, vd, *wts: _hop_xla(p0, p1, p2, p3, vd, jr[1], *wts,
                                                                  False),
                         *[jnp.asarray(p) for p in w_psg], jr[0], *jr[2:])
        want = vjp(jnp.asarray(w_g))
        got = fused_corner_hop_bwd(_t(w_psg), *_t(w_rest), torch.from_numpy(w_g))
        assert len(got) == len(want) == 19
        for i, (gr, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(gr.numpy(), np.asarray(w), **JAX_TOL, err_msg=f"grad {i}")
        return
    if fault == "cotangent_shape":
        s_cot[1] = s_cot[1][:, :-1]
        h_g = h_g[:, :-1]
    else:
        s_cot[0] = s_cot[0].double()
        h_g = h_g.double()
    with pytest.raises(ValueError):
        fused_stencil_message_bwd(*s_args, *s_cot)
    with pytest.raises(ValueError):
        fused_corner_hop_bwd(h_psg, *h_rest, h_g)
