"""The six kernel launches as ``torch.library`` custom ops, on the CPU.

Each autograd Function (``StencilMessageFn``, ``CornerHopFn``,
``ShortKVAttentionFn``) reaches the plain versions through its ops
(``p4t::*``), and must give what the plain versions give, bit for bit:
its outputs those of the plain forward, its gradients those of the
plain backward composed as the Function composes them (the shifts of
ps and ``unshift_sum``; the corner gathers and ``sep_aggregate``). And
``torch.library.opcheck`` passes on each op (its schema, its fake
implementation against the real one, and a trace with dynamic shapes)
at a small shape."""

import numpy as np
import pytest
import torch

from py4cast_tpu_torch.ops import attention, hop_kernel, stencil_kernel
from py4cast_tpu_torch.ops.lattice_ops import sel_matrix, sep_aggregate, stack_shifts, unshift_sum


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as every port test file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
            for s in shapes]


def stencil_args(seed=0, b=2, hr=5, w=6, f_in=8, h=8):
    """(e, ps, pd, mask, we, be, wo, bo, lns, lnb) and the cotangents of
    (out, agg)."""
    e, ps, pd, we, be, wo, bo, lns, lnb, g_out, g_agg = _arrays(seed, [
        (b, 8, hr, w, f_in), (b, hr, w, h), (b, hr, w, h), (f_in, h), (h,), (h, h), (h,),
        (h,), (h,), (b, 8, hr, w, h), (b, hr, w, h)])
    mask = (torch.from_numpy(np.random.default_rng(seed + 1).uniform(size=(8, hr, w, 1)))
            > 0.2).float()
    return [e, ps, pd, mask, we, be, wo, bo, lns + 1.0, lnb], (g_out, g_agg)


def hop_args(seed=0, b=2, gh=7, gw=9, mh=3, mw=4, h=8, ff=3):
    """(ps, rows, cols, ar, ac), [vd, feats, 14 weights] and the
    cotangent of v_out, on a gh x gw grid over an mh x mw level 0."""
    def corners(n, m):
        r0 = (np.arange(n) * m) // n
        return np.stack([r0, np.minimum(r0 + 1, m - 1)]).astype(np.int32)

    rows, cols = corners(gh, mh), corners(gw, mw)
    ar = torch.from_numpy(np.stack([sel_matrix(r, mh) for r in rows]))
    ac = torch.from_numpy(np.stack([sel_matrix(c, mw) for c in cols]))
    ps, vd, feats, g, *weights = _arrays(seed, [
        (b, mh, mw, h), (b, gh, gw, h), (4, gh, gw, ff), (b, gh, gw, h),
        (ff, h), (h,), (h, h), (h, h), (h,), (h,), (h,),  # wf, bf, wd, wo, bo, lns, lnb
        (h, h), (h, h), (h,), (h, h), (h,), (h,), (h,)])  # nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb
    maps = [ps, torch.from_numpy(rows), torch.from_numpy(cols), ar, ac]
    return maps, [vd, feats, *weights], g


def attention_args(seed=0, bh=3, lq=37, lk=5, d=16):
    return _arrays(seed, [(bh, lq, d), (bh, lk, d), (bh, lk, d), (bh, lq, d)], scale=1.0)


def _leaves(ts):
    return [t.clone().requires_grad_(True) for t in ts]


def _equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}[{i}]: max |diff| {(g - w).abs().max().item():.3e}"


@pytest.mark.parametrize("residual", [False, True])
def test_stencil_message_fn_is_the_plain_version_bit_for_bit(residual):
    args, (g_out, g_agg) = stencil_args()
    e, ps, pd, mask, *weights = args
    leaves = _leaves([e, ps, pd, *weights])
    out, agg = stencil_kernel.StencilMessageFn.apply(*leaves[:3], mask, *leaves[3:], residual)
    ((out * g_out).sum() + (agg * g_agg).sum()).backward()

    want = stencil_kernel.stencil_message_plain(*args, residual)
    _equal((out, agg), want, "forward")
    de, dvs, dpd, *dw = stencil_kernel.stencil_message_bwd_plain(
        e, stack_shifts(ps), pd, mask, *weights, g_out, g_agg, residual)
    _equal([t.grad for t in leaves], [de, unshift_sum(dvs), dpd, *dw], "gradients")


@pytest.mark.parametrize("mean", [False, True])
def test_corner_hop_fn_is_the_plain_version_bit_for_bit(mean):
    (ps, rows, cols, ar, ac), rest, g = hop_args()
    vd, feats, *weights = rest
    leaves = _leaves([ps, vd, *weights])
    out = hop_kernel.CornerHopFn.apply(leaves[0], rows, cols, ar, ac, leaves[1], feats,
                                       *leaves[2:], mean)
    (out * g).sum().backward()

    _equal([out], [hop_kernel.corner_hop_plain(ps, rows, cols, *rest, mean=mean)], "forward")
    grads = hop_kernel.corner_hop_bwd_plain(hop_kernel.gather_corners(ps, rows, cols), vd,
                                            feats, *weights, g, mean)
    dps = sep_aggregate(grads[0], ar[0], ac[0])
    for k in range(1, 4):
        dps = dps + sep_aggregate(grads[k], ar[k // 2], ac[k % 2])
    _equal([t.grad for t in leaves], [dps, grads[4], *grads[5:]], "gradients")


def test_short_kv_attention_fn_is_the_plain_version_bit_for_bit():
    q, k, v, do = attention_args()
    leaves = _leaves([q, k, v])
    o = attention.ShortKVAttentionFn.apply(*leaves, 0.25)
    (o * do).sum().backward()
    _equal([o], [attention.short_kv_attention_plain(q, k, v, 0.25)], "forward")
    _equal([t.grad for t in leaves], attention.short_kv_attention_bwd_plain(q, k, v, do, 0.25),
           "gradients")


def _op_cases():
    s_args, (g_out, g_agg) = stencil_args(seed=3, b=1, hr=3, w=4, f_in=4, h=4)
    (ps, rows, cols, _, _), rest, g = hop_args(seed=4, b=1, gh=5, gw=6, mh=2, mw=3, h=4, ff=2)
    psg = hop_kernel.gather_corners(ps, rows, cols)
    q, k, v, do = attention_args(seed=5, bh=2, lq=9, lk=3, d=8)
    o, lse = attention.short_kv_attention_fwd(q, k, v, 0.5)
    return {
        "stencil_message_fwd": (stencil_kernel.stencil_message_fwd, (*s_args, False)),
        "stencil_message_bwd": (stencil_kernel.stencil_message_bwd,
                                (s_args[0], stack_shifts(s_args[1]), *s_args[2:], g_out, g_agg,
                                 False)),
        "corner_hop_fwd": (hop_kernel.corner_hop_fwd, (ps, rows, cols, *rest, True)),
        "corner_hop_bwd": (hop_kernel.corner_hop_bwd, (*psg, *rest, g, False)),
        "short_kv_attention_fwd": (attention.short_kv_attention_fwd, (q, k, v, 0.5)),
        "short_kv_attention_bwd": (attention.short_kv_attention_bwd, (q, k, v, o, lse, do, 0.5)),
    }


@pytest.mark.parametrize("name", ["stencil_message_fwd", "stencil_message_bwd",
                                  "corner_hop_fwd", "corner_hop_bwd",
                                  "short_kv_attention_fwd", "short_kv_attention_bwd"])
def test_opcheck(name):
    op, args = _op_cases()[name]
    assert str(op._opoverload) == f"p4t.{name}.default"
    torch.library.opcheck(op, args)


def test_cpu_calls_count_no_launch():
    """On CPU tensors the ops run the plain versions: no launch counted."""
    before = {name: fn.launches for name, fn in (
        ("a", stencil_kernel.fused_stencil_message), ("b", hop_kernel.fused_corner_hop),
        ("c", attention.fused_short_kv_attention))}
    for op, args in _op_cases().values():
        op(*args)
    assert before == {"a": stencil_kernel.fused_stencil_message.launches,
                      "b": hop_kernel.fused_corner_hop.launches,
                      "c": attention.fused_short_kv_attention.launches}
