"""The port's plain backwards of the stencil message and the corner hop
against the JAX package (``jax.vjp`` of its Pallas kernels in interpret
mode and of their XLA formulas), and the port's autograd Functions
against torch autograd through the plain forwards, on the CPU, where the
wrappers run their plain PyTorch versions.

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
from py4cast_tpu.ops import stencil_kernel as jax_stencil
from py4cast_tpu_torch.ops import hop_kernel, stencil_kernel
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
STENCIL_NAMES = ("de", "dvs", "dpd", "dwe", "dbe", "dwo", "dbo", "dlns", "dlnb")


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
def test_stencil_function_matches_autograd(stencil_case, case):
    """StencilMessageFn's gradients (saved tensors, grad order, residual
    flag) against autograd through the plain forward. ``out_unused``:
    only agg feeds the loss, so g_out reaches the backward as zeros."""
    args, g_out, g_agg = stencil_case
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


@pytest.mark.parametrize("mean", [False, True])
def test_hop_function_matches_autograd(hop_case, mean):
    psg, rest, g = hop_case
    gt = torch.from_numpy(g)

    def grads(fn):
        lp = [p.clone().requires_grad_() for p in _t(psg)]
        lr = [a.clone().requires_grad_(i != 1) for i, a in enumerate(_t(rest))]
        loss = (fn(lp, lr) * gt).sum()
        return torch.autograd.grad(loss, lp + [a for i, a in enumerate(lr) if i != 1])

    got = grads(lambda lp, lr: CornerHopFn.apply(*lp, *lr, mean))
    want = grads(lambda lp, lr: corner_hop_plain(lp, *lr, mean=mean))
    _assert_close(got, want, "CornerHopFn")


def test_functions_give_no_gradient_to_mask_and_feats(stencil_case, hop_case):
    args = [a.clone().requires_grad_() for a in _t(stencil_case[0])]
    out, agg = StencilMessageFn.apply(*args, True)
    (out.sum() + agg.sum()).backward()
    assert args[3].grad is None and args[0].grad is not None
    psg, rest, _ = hop_case
    lp = [p.clone().requires_grad_() for p in _t(psg)]
    lr = [a.clone().requires_grad_() for a in _t(rest)]
    CornerHopFn.apply(*lp, *lr, False).sum().backward()
    assert lr[1].grad is None and lr[0].grad is not None


def test_cpu_backward_calls_leave_launch_counters_at_zero(stencil_case, hop_case):
    fused_stencil_message_bwd.launches = 0
    fused_corner_hop_bwd.launches = 0
    args, g_out, g_agg = stencil_case
    fused_stencil_message_bwd(*_t(args), *_t([g_out, g_agg]), residual=True)
    psg, rest, g = hop_case
    fused_corner_hop_bwd(_t(psg), *_t(rest), torch.from_numpy(g))
    assert fused_stencil_message_bwd.launches == 0
    assert fused_corner_hop_bwd.launches == 0


@pytest.mark.parametrize("fault", ["width", "cotangent_shape", "cotangent_dtype"])
def test_bwd_wrappers_reject_bad_arguments(stencil_case, hop_case, fault):
    args, g_out, g_agg = stencil_case
    s_args, s_cot = _t(args), _t([g_out, g_agg])
    psg, rest, g = hop_case
    h_psg, h_rest, h_g = _t(psg), _t(rest), torch.from_numpy(g)
    if fault == "width":  # above the backward kernels' caps
        wide = stencil_kernel.MAX_BWD_WIDTH + 16
        s_args = [torch.zeros(tuple(wide if d == HID else d for d in t.shape)) for t in s_args]
        s_cot = [torch.zeros(tuple(wide if d == HID else d for d in t.shape)) for t in s_cot]
        wide = hop_kernel.MAX_BWD_WIDTH + 16
        h_psg = [torch.zeros(B, H, W, wide)] * 4
        h_rest = [torch.zeros(tuple(wide if d == HID else d for d in t.shape)) for t in h_rest]
        h_g = torch.zeros(B, H, W, wide)
    elif fault == "cotangent_shape":
        s_cot[1] = s_cot[1][:, :-1]
        h_g = h_g[:, :-1]
    else:
        s_cot[0] = s_cot[0].double()
        h_g = h_g.double()
    with pytest.raises(ValueError):
        fused_stencil_message_bwd(*s_args, *s_cot)
    with pytest.raises(ValueError):
        fused_corner_hop_bwd(h_psg, *h_rest, h_g)
