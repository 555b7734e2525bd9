"""The port's stencil-message and corner-hop functions against the JAX
package's Pallas kernels (interpret mode) and their XLA formulas, on the
CPU, where the port's wrappers run their plain PyTorch versions. The
port's stencil message takes the source projection ps and shifts it
itself; the JAX kernel is fed the stack of the JAX package's own
``shift2d(ps)`` in DIRS8 order. The port's corner hop takes the mesh
projection ps and the int32 corner maps and gathers the corners itself;
the JAX kernel is fed the JAX package's ``sep_take_mm(ps, ar, ac)`` of
each corner.

Bar: rtol/atol 1e-5, the JAX kernel tests' own forward bar
(tests/test_stencil_kernel.py, tests/test_hop_kernel.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.ops import hop_kernel as jax_hop
from py4cast_tpu.ops import lattice_ops as jax_lat
from py4cast_tpu.ops import stencil_kernel as jax_stencil
from py4cast_tpu_torch.models.graph import _corners_rc
from py4cast_tpu_torch.ops import hop_kernel, stencil_kernel
from py4cast_tpu_torch.ops import lattice_ops as port_lat
from py4cast_tpu_torch.ops.hop_kernel import fused_corner_hop, gather_corners
from py4cast_tpu_torch.ops.stencil_kernel import fused_stencil_message

TOL = dict(rtol=1e-5, atol=1e-5)
#: level 0 of a 32x32 grid (coarsen factor 4), small width
B, H, W, HID = 2, 8, 8, 16
FF = 3  # corner features (dx, dy, length)
#: the corner hop: a ragged 9x7 grid over a 3x3 mesh level 0, whose last
#: row and column clip (r1 = r0, c1 = c0)
GH, GW, MH, MW = 9, 7, 3, 3


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc + sh for s, sc, sh in shapes]


def _stencil_case(b, hr, w, hid, seed=0):
    """(e, ps, pd, mask, we, be, wo, bo, lns, lnb) as numpy arrays."""
    arrs = _arrays(seed, [
        ((b, 8, hr, w, hid), 1.0, 0.0),  # e
        ((b, hr, w, hid), 1.0, 0.0),     # ps
        ((b, hr, w, hid), 1.0, 0.0),     # pd
    ])
    rng = np.random.default_rng(seed + 1)
    mask = (rng.uniform(size=(8, hr, w, 1)) > 0.2).astype(np.float32)
    params = _arrays(seed + 2, [
        ((hid, hid), 0.3, 0.0), ((hid,), 0.1, 0.0),  # we, be
        ((hid, hid), 0.3, 0.0), ((hid,), 0.1, 0.0),  # wo, bo
        ((hid,), 0.2, 1.0), ((hid,), 0.1, 0.0),      # lns, lnb
    ])
    return arrs[:3] + [mask] + params


@pytest.fixture(scope="module")
def stencil_inputs():
    return _stencil_case(B, H, W, HID)


def _jax_shifted(args):
    """The JAX arguments with ps replaced by the stack of the JAX
    package's shift2d(ps) in DIRS8 order."""
    j = [jnp.asarray(a) for a in args]
    j[1] = jnp.stack([jax_lat.shift2d(j[1], di, dj) for di, dj in jax_lat.DIRS8], axis=1)
    return j


def corner_maps(fine_hw, coarse_hw):
    """(rows (2, H), cols (2, W)) int32 and their selection matrices
    (ar (2, Hc, H), ac (2, Wc, W)), as build_graph_artifacts makes them."""
    (r0, r1), (c0, c1) = _corners_rc(fine_hw, coarse_hw)
    rows = np.stack([r0, r1]).astype(np.int32)
    cols = np.stack([c0, c1]).astype(np.int32)
    ar = np.stack([port_lat.sel_matrix(r, coarse_hw[0]) for r in rows])
    ac = np.stack([port_lat.sel_matrix(c, coarse_hw[1]) for c in cols])
    return rows, cols, ar, ac


@pytest.fixture(scope="module")
def hop_inputs():
    """(ps, rows, cols, ar, ac) and [vd, feats, weights...]."""
    (ps,) = _arrays(3, [((B, MH, MW, HID), 1.0, 0.0)])
    vd, feats = _arrays(4, [((B, GH, GW, HID), 1.0, 0.0), ((4, GH, GW, FF), 0.5, 0.0)])
    params = _arrays(5, [
        ((FF, HID), 0.5, 0.0), ((HID,), 0.1, 0.0),                  # wf, bf
        ((HID, HID), 0.25, 0.0), ((HID, HID), 0.25, 0.0),            # wd, wo
        ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),  # bo, lns, lnb
        ((HID, HID), 0.2, 0.0), ((HID, HID), 0.2, 0.0),              # nd0a, nd0b
        ((HID,), 0.1, 0.0), ((HID, HID), 0.25, 0.0),                 # nb0, nd1
        ((HID,), 0.1, 0.0), ((HID,), 0.2, 1.0), ((HID,), 0.1, 0.0),  # nb1, nlns, nlnb
    ])
    return (ps, *corner_maps((GH, GW), (MH, MW))), [vd, feats] + params


def _jax_corners(src):
    """The JAX package's corner upsamples of ps: sep_take_mm of each
    corner's selection matrices."""
    ps, _, _, ar, ac = (jnp.asarray(a) for a in src)
    return [jax_lat.sep_take_mm(ps, ar[k // 2], ac[k % 2]) for k in range(4)]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _stencil_xla(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual):
    """_StencilMessage's unfused XLA formula (flax LayerNorm)."""
    import flax.linen as nn

    pre = e @ we + be + vs + pd[:, None]
    t = jax.nn.silu(pre) @ wo + bo
    ln = nn.LayerNorm()
    e_new = ln.apply({"params": {"scale": lns, "bias": lnb}}, t)
    agg = (e_new * mask[None]).sum(axis=1)
    return (e + e_new if residual else e_new), agg


@pytest.mark.parametrize("residual", [False, True])
def test_stencil_plain_matches_pallas_interpret(stencil_inputs, residual):
    want = jax_stencil.fused_stencil_message(
        *_jax_shifted(stencil_inputs), interpret=True, mode=1, residual=residual,
    )
    got = fused_stencil_message(*_t(stencil_inputs), residual=residual)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("residual", [False, True])
def test_stencil_plain_matches_xla_formula(stencil_inputs, residual):
    want = _stencil_xla(*_jax_shifted(stencil_inputs), residual)
    got = stencil_kernel.stencil_message_plain(*_t(stencil_inputs), residual=residual)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("b,hr,w", [(1, 1, 1), (1, 1, 5), (2, 2, 3), (1, 3, 7)])
def test_stencil_plain_where_shifts_fall_off_the_lattice(b, hr, w):
    """Lattices where every direction's shift leaves some side (a single
    cell has no neighbour at all): the port's shifts against the JAX
    package's, through the XLA formula."""
    args = _stencil_case(b, hr, w, 8, seed=30)
    want = _stencil_xla(*_jax_shifted(args), True)
    got = fused_stencil_message(*_t(args), residual=True)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def _hop_xla(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
             nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean):
    """LatticeEncodeDecode's unfused 'corners' formula (flax LayerNorm)."""
    import flax.linen as nn

    def ln(x, s, b):
        return nn.LayerNorm().apply({"params": {"scale": s, "bias": b}}, x)

    pd = vd @ wd
    pf = feats @ wf + bf
    agg = sum(ln(jax.nn.silu(pf[k] + psg[k] + pd) @ wo + bo, lns, lnb) for k in range(4))
    if mean:
        agg = agg / 4.0
    u = jax.nn.silu(jnp.concatenate([vd, agg], -1) @ jnp.concatenate([nd0a, nd0b], 0) + nb0)
    return vd + ln(u @ nd1 + nb1, nlns, nlnb)


@pytest.mark.parametrize("mean", [False, True])
def test_hop_plain_matches_pallas_interpret(hop_inputs, mean):
    src, rest = hop_inputs
    want = jax_hop.fused_corner_hop(
        _jax_corners(src), *[jnp.asarray(a) for a in rest],
        mean=mean, interpret=True, mode=1,
    )
    got = fused_corner_hop(*_t(src[:3]), *_t(rest), mean=mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mean", [False, True])
def test_hop_plain_matches_xla_formula(hop_inputs, mean):
    src, rest = hop_inputs
    want = _hop_xla(_jax_corners(src), *[jnp.asarray(a) for a in rest], mean)
    got = hop_kernel.corner_hop_plain(*_t(src[:3]), *_t(rest), mean=mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", range(4))
def test_hop_gather_equals_selection_matmuls(hop_inputs, k):
    """Corner k gathered by indexing is, bit for bit, the port's
    sep_take_mm of its selection matrices, which the model's unfused
    path and the JAX package use."""
    ps, rows, cols, ar, ac = _t(hop_inputs[0])
    got = gather_corners(ps, rows, cols)[k]
    assert torch.equal(got, port_lat.sep_take_mm(ps, ar[k // 2], ac[k % 2]))


def test_cpu_calls_leave_launch_counters_at_zero(stencil_inputs, hop_inputs):
    fused_stencil_message.launches = 0
    fused_corner_hop.launches = 0
    fused_stencil_message(*_t(stencil_inputs), residual=True)
    src, rest = hop_inputs
    fused_corner_hop(*_t(src[:3]), *_t(rest))
    assert fused_stencil_message.launches == 0
    assert fused_corner_hop.launches == 0


@pytest.mark.parametrize("fault", ["dtype", "shape", "shifted_ps", "contiguity", "width",
                                   "residual"])
def test_stencil_wrapper_rejects_bad_arguments(stencil_inputs, fault):
    """Arguments the forward wrapper refuses. Edge features wider than
    the CUDA kernel's row-tile instances are not among them: at such a
    width ("width") the wrapper runs (on the CPU, its plain version) and
    agrees with the JAX package's XLA formula."""
    args = _t(stencil_inputs)
    residual = False
    if fault == "width":  # above the forward kernel's row-tile instances
        wide = 258  # past the forward's row-tile instances (128): not a multiple of 4
        e, we = _arrays(70, [((B, 8, H, W, wide), 1.0, 0.0), ((wide, HID), wide ** -0.5, 0.0)])
        w_args = [e] + list(stencil_inputs[1:4]) + [we] + list(stencil_inputs[5:])
        want = _stencil_xla(*_jax_shifted(w_args), False)
        got = fused_stencil_message(*_t(w_args))
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
        return
    if fault == "dtype":
        args[0] = args[0].double()
    elif fault == "shape":
        args[2] = args[2][:, :-1]
    elif fault == "shifted_ps":  # the forward takes ps, not its eight shifts
        args[1] = torch.zeros(B, 8, H, W, HID)
    elif fault == "contiguity":
        args[4] = args[4].t()
    else:  # residual fold needs edge width == hidden width
        args[0] = args[0][..., :8].contiguous()
        args[4] = args[4][:8].contiguous()
        residual = True
    with pytest.raises(ValueError):
        fused_stencil_message(*args, residual=residual)


@pytest.mark.parametrize("fault", ["corners", "dtype", "feats", "width", "device_mix",
                                   "map_dtype", "map_shape", "ps_batch", "ps_width"])
def test_hop_wrapper_rejects_bad_arguments(hop_inputs, fault):
    """Arguments the forward wrapper refuses. A hidden width above the
    CUDA kernel's row-tile and warp-row instances is not among them: at
    such a width ("width") the wrapper runs (on the CPU, its plain
    version) and agrees with the JAX package's XLA formula."""
    (ps, rows, cols), rest = _t(hop_inputs[0][:3]), _t(hop_inputs[1])
    if fault == "width":  # above the forward kernel's warp-row instance
        wide = 128  # past the forward's warp-row instance (96)
        rng = np.random.default_rng(71)
        w_ps = rng.standard_normal((B, MH, MW, wide)).astype(np.float32)
        w_rest = []
        for a in hop_inputs[1]:
            if a.shape == (4, GH, GW, FF):  # the corner features keep their width
                w_rest.append(a)
                continue
            shape = tuple(wide if d == HID else d for d in a.shape)
            spread = wide ** -0.5 if len(shape) == 2 and shape[0] == wide else 0.1
            base = 1.0 if a.ndim == 1 and a.mean() > 0.5 else 0.0  # LayerNorm scales
            spread = 1.0 if a.ndim == 4 else spread  # vd
            w_rest.append((rng.standard_normal(shape) * spread + base).astype(np.float32))
        w_src = (w_ps, *hop_inputs[0][1:])
        want = _hop_xla(_jax_corners(w_src), *[jnp.asarray(a) for a in w_rest], False)
        got = fused_corner_hop(*_t(w_src[:3]), *_t(w_rest))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    if fault == "corners":  # one row map where each corner pair needs its own
        rows = rows[:1]
    elif fault == "dtype":
        rest[0] = rest[0].half()
    elif fault == "feats":
        rest[1] = torch.zeros(4, GH, GW, hop_kernel.MAX_FEATS + 1)
        rest[2] = torch.zeros(hop_kernel.MAX_FEATS + 1, HID)
    elif fault == "device_mix":
        rest[0] = rest[0].to("meta")
    elif fault == "map_dtype":
        cols = cols.long()
    elif fault == "map_shape":
        cols = torch.zeros(2, GW + 1, dtype=torch.int32)
    elif fault == "ps_batch":
        ps = torch.zeros(B + 1, MH, MW, HID)
    else:
        ps = torch.zeros(B, MH, MW, HID + 4)
    with pytest.raises(ValueError):
        fused_corner_hop(ps, rows, cols, *rest)
