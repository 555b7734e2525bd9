"""The lattice mesh→grid corner hop (m2g): CUDA kernels for the forward
and the backward, their plain PyTorch versions, and the autograd
Function that joins them.

    pd    = vd @ Wd
    t_k   = LN(silu(feats_k @ Wf + bf + psg_k + pd) @ Wo + bo)   (4 corners)
    agg   = sum_k t_k                     (/4 for mean aggregation)
    u     = silu(vd @ Nd0a + agg @ Nd0b + nb0)
    v_out = vd + LN(u @ Nd1 + nb1)

The forward kernel (``csrc/corner_hop.cu``) replaces the TPU kernel
``py4cast_tpu/ops/hop_kernel.py::_fwd_kernel``, the backward
(``csrc/corner_hop_bwd.cu``: a node pass and a corner pass, launched
together) its ``_bwd_kernel``; each source says what bounds it on the
H100 and what its design does about it. The TPU
kernels' W padding and column tiling were Mosaic constraints: here the
corner upsamples arrive at the grid width. On a CUDA tensor
``fused_corner_hop`` and ``fused_corner_hop_bwd`` launch their kernel
or raise; on a CPU tensor they run ``corner_hop_plain`` and
``corner_hop_bwd_plain``, which are also what the kernels are held
against on the card. Models call ``CornerHopFn``, whose backward is the
backward kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from py4cast_tpu_torch.ops import _build

LN_EPS = 1e-6  # flax nn.LayerNorm default
#: the five h x h weight matrices must fit the 227 KB of shared memory a
#: block may use: 96 is the largest width (a multiple of 32) that does
MAX_WIDTH = 96
MAX_FEATS = 32
#: the backward's node pass holds the five h x h weight matrices, five
#: row tiles of its cells and three h x h weight-gradient patch sets in
#: one block's shared memory (223 KB at h=64); at 96 the weights and
#: tiles alone would take ~300 KB, so the backward stops at 64
MAX_BWD_WIDTH = 64


def corner_hop_plain(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                     nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean=False):
    """The corner hop in plain PyTorch (same layouts as the kernel)."""
    h = wd.shape[-1]
    pd = vd @ wd
    agg = torch.zeros_like(vd)
    for k in range(4):
        pre = feats[k] @ wf + bf + psg[k] + pd
        t = F.silu(pre) @ wo + bo
        agg = agg + F.layer_norm(t, (h,), lns, lnb, eps=LN_EPS)
    if mean:
        agg = agg * 0.25
    u = F.silu(vd @ nd0a + agg @ nd0b + nb0)
    return vd + F.layer_norm(u @ nd1 + nb1, (h,), nlns, nlnb, eps=LN_EPS)


def _ln_bwd(g, xhat, inv, scale):
    """d/dt of LayerNorm(t) * scale + bias for the cotangent g."""
    gx = g * scale
    return (gx - gx.mean(dim=-1, keepdim=True)
            - xhat * (gx * xhat).mean(dim=-1, keepdim=True)) * inv


def _ln_stats(t):
    mu = t.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(((t - mu) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    return (t - mu) * inv, inv


def corner_hop_bwd_plain(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                         nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g, mean=False):
    """The corner hop's backward in plain PyTorch, following the TPU
    ``_bwd_kernel``: recompute, node backward, per-corner backward, then
    ``dvd += dpd @ Wd^T``. g is the cotangent of v_out. Returns
    ``(dpsg0, dpsg1, dpsg2, dpsg3, dvd, dwf, dbf, dwd, dwo, dbo, dlns,
    dlnb, dnd0a, dnd0b, dnb0, dnd1, dnb1, dnlns, dnlnb)``; feats gets no
    gradient. Works in any float dtype."""
    h = wd.shape[-1]
    ff = feats.shape[-1]

    def colsum(x):
        return x.reshape(-1, x.shape[-1]).sum(0)

    def xty(x, y):  # sum over every cell of x^T y
        return x.reshape(-1, x.shape[-1]).t() @ y.reshape(-1, y.shape[-1])

    # ---- recompute, keeping each corner's internals
    pd = vd @ wd
    agg = torch.zeros_like(vd)
    corners = []
    for k in range(4):
        pre = feats[k] @ wf + bf + psg[k] + pd
        sig = torch.sigmoid(pre)
        xhat, inv = _ln_stats((pre * sig) @ wo + bo)
        agg = agg + xhat * lns + lnb
        corners.append((pre, sig, xhat, inv))
    if mean:
        agg = agg * 0.25
    u_pre = vd @ nd0a + agg @ nd0b + nb0
    sig_u = torch.sigmoid(u_pre)
    u = u_pre * sig_u
    xhat_n, inv_n = _ln_stats(u @ nd1 + nb1)

    # ---- node backward
    dnlns, dnlnb = colsum(g * xhat_n), colsum(g)
    dy = _ln_bwd(g, xhat_n, inv_n, nlns)
    dnd1, dnb1 = xty(u, dy), colsum(dy)
    dupre = (dy @ nd1.t()) * (sig_u * (1.0 + u_pre * (1.0 - sig_u)))
    dnd0a, dnd0b, dnb0 = xty(vd, dupre), xty(agg, dupre), colsum(dupre)
    dvd = g + dupre @ nd0a.t()  # the residual and the node path
    dagg = dupre @ nd0b.t()
    if mean:
        dagg = dagg * 0.25

    # ---- per-corner backward
    dpsg = []
    dpd = torch.zeros_like(vd)
    dwf = torch.zeros((ff, h), dtype=vd.dtype, device=vd.device)
    dwo = torch.zeros((h, h), dtype=vd.dtype, device=vd.device)
    dbf, dbo, dlns, dlnb = (torch.zeros(h, dtype=vd.dtype, device=vd.device) for _ in range(4))
    for k, (pre, sig, xhat, inv) in enumerate(corners):
        dlns = dlns + colsum(dagg * xhat)
        dlnb = dlnb + colsum(dagg)
        dt = _ln_bwd(dagg, xhat, inv, lns)
        dwo = dwo + xty(pre * sig, dt)
        dbo = dbo + colsum(dt)
        dpre = (dt @ wo.t()) * (sig * (1.0 + pre * (1.0 - sig)))
        dpsg.append(dpre)
        dpd = dpd + dpre
        dwf = dwf + xty(feats[k].expand(dpre.shape[:-1] + (ff,)), dpre)
        dbf = dbf + colsum(dpre)

    dvd = dvd + dpd @ wd.t()
    dwd = xty(vd, dpd)
    return (*dpsg, dvd, dwf, dbf, dwd, dwo, dbo, dlns, dlnb,
            dnd0a, dnd0b, dnb0, dnd1, dnb1, dnlns, dnlnb)


def _lib():
    lib = _build.load("corner_hop")
    fn = lib.p4t_corner_hop_fwd
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("corner_hop_bwd")
    fn = lib.p4t_corner_hop_bwd
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * 29 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        grid = lib.p4t_corner_hop_bwd_grid
        grid.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
        attrs = lib.p4t_corner_hop_bwd_attributes
        attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


def bwd_kernel_attributes(h) -> dict:
    """The two backward kernels that width ``h`` launches, the node pass
    and the corner pass, as the card reports them: registers a thread,
    local (spill) bytes a thread, dynamic shared memory, resident blocks
    an SM, and the cells of a tile. Needs the card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 10)()
    _build.check(lib, lib.p4t_corner_hop_bwd_attributes(h, out), "corner_hop_bwd attributes")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "tile_cells")
    return {name: {k: out[5 * i + j] for j, k in enumerate(keys)}
            for i, name in enumerate(("node", "corner"))}


def _validate(what, psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
              nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, max_width, extra=None):
    """The checks the forward and the backward wrapper share; returns
    the device."""
    if len(psg) != 4:
        raise ValueError(f"{what} takes 4 corner arrays, got {len(psg)}")
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    shapes = {f"psg{k}": (p, (b, hr, w, h)) for k, p in enumerate(psg)}
    shapes.update({
        "vd": (vd, (b, hr, w, h)), "feats": (feats, (4, hr, w, ff)),
        "wf": (wf, (ff, h)), "bf": (bf, (h,)), "wd": (wd, (h, h)),
        "wo": (wo, (h, h)), "bo": (bo, (h,)), "lns": (lns, (h,)),
        "lnb": (lnb, (h,)), "nd0a": (nd0a, (h, h)), "nd0b": (nd0b, (h, h)),
        "nb0": (nb0, (h,)), "nd1": (nd1, (h, h)), "nb1": (nb1, (h,)),
        "nlns": (nlns, (h,)), "nlnb": (nlnb, (h,)),
    })
    shapes.update(extra or {})
    device = _build.validate(what, shapes)
    if h > max_width or ff > MAX_FEATS:
        raise ValueError(
            f"{what} supports hidden width up to {max_width} and up "
            f"to {MAX_FEATS} corner features, got {h} and {ff}"
        )
    return device


def fused_corner_hop(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                     nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean=False):
    """v_out of the m2g corner hop.

    psg: sequence of FOUR (B, H, W, h) corner-upsampled source
    projections, corner order r0c0, r0c1, r1c0, r1c1; vd: (B, H, W, h)
    destination grid states; feats: (4, H, W, ff) static corner
    features. wf: (ff, h), wd/wo/nd0a/nd0b/nd1: (h, h) — Dense kernels in
    (in, out) layout, nd0a/nd0b the node MLP's first kernel split at the
    [v_dst, agg] concat; the rest (h,). h at most 96, ff at most 32,
    everything fp32 and contiguous. The output carries no gradient:
    differentiate through ``CornerHopFn``.
    """
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    device = _validate("fused_corner_hop", psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                       nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, MAX_WIDTH)
    if device.type == "cpu":
        return corner_hop_plain(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                                nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean)

    out = torch.empty((b, hr, w, h), device=device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_corner_hop_fwd(
            *(p.data_ptr() for p in psg), vd.data_ptr(), feats.data_ptr(),
            wf.data_ptr(), bf.data_ptr(), wd.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), lns.data_ptr(), lnb.data_ptr(), nd0a.data_ptr(),
            nd0b.data_ptr(), nb0.data_ptr(), nd1.data_ptr(), nb1.data_ptr(),
            nlns.data_ptr(), nlnb.data_ptr(), out.data_ptr(),
            b, hr, w, h, ff, int(mean), stream,
        )
    _build.check(lib, status, "corner_hop kernel")
    fused_corner_hop.launches += 1
    return out


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count)
fused_corner_hop.launches = 0


def fused_corner_hop_bwd(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                         nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g, mean=False):
    """The corner hop's backward for the cotangent g (B, H, W, h) of
    v_out: the 19 gradients of ``corner_hop_bwd_plain``, in its order.
    The forward's arguments and checks; h at most 64
    (``MAX_BWD_WIDTH``). The weight gradients are summed in a fixed
    order, so a call repeats bit for bit."""
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    device = _validate("fused_corner_hop_bwd", psg, vd, feats, wf, bf, wd, wo, bo, lns,
                       lnb, nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, MAX_BWD_WIDTH,
                       {"g": (g, (b, hr, w, h))})
    if device.type == "cpu":
        return corner_hop_bwd_plain(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                                    nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g, mean)

    dpsg = [torch.empty_like(vd) for _ in range(4)]
    dvd = torch.empty_like(vd)
    dagg = torch.empty_like(vd)  # scratch: the node pass's dagg for the corner pass
    # dwf, dbf, dwd, dwo, dbo, dlns, dlnb, dnd0a, dnd0b, dnb0, dnd1, dnb1, dnlns, dnlnb
    sizes = (ff * h, h, h * h, h * h, h, h, h, h * h, h * h, h, h * h, h, h, h)
    dw = torch.empty(sum(sizes), device=device, dtype=torch.float32)
    lib = _bwd_lib()
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        _build.check(lib, lib.p4t_corner_hop_bwd_grid(b, hr, w, h, ff, ctypes.byref(blocks)),
                     "corner_hop_bwd grid")
        # one fp32 partial of every weight gradient per block, summed by
        # a second kernel in a fixed order
        partial = torch.empty(blocks.value * dw.numel(), device=device, dtype=torch.float32)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_corner_hop_bwd(
            *(p.data_ptr() for p in psg), vd.data_ptr(), feats.data_ptr(),
            wf.data_ptr(), bf.data_ptr(), wd.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), lns.data_ptr(), lnb.data_ptr(), nd0a.data_ptr(),
            nd0b.data_ptr(), nb0.data_ptr(), nd1.data_ptr(), nb1.data_ptr(),
            nlns.data_ptr(), nlnb.data_ptr(), g.data_ptr(),
            *(d.data_ptr() for d in dpsg), dvd.data_ptr(), dagg.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), b, hr, w, h, ff, int(mean), blocks.value, stream,
        )
    _build.check(lib, status, "corner_hop_bwd kernel")
    fused_corner_hop_bwd.launches += 1
    parts = list(torch.split(dw, sizes))
    for i, shape in ((0, (ff, h)), (2, (h, h)), (3, (h, h)), (7, (h, h)), (8, (h, h)),
                     (10, (h, h))):
        parts[i] = parts[i].view(shape)
    return (*dpsg, dvd, *parts)


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count)
fused_corner_hop_bwd.launches = 0


class CornerHopFn(torch.autograd.Function):
    """``fused_corner_hop`` with its backward kernel as the gradient:
    ``CornerHopFn.apply(psg0, psg1, psg2, psg3, vd, feats, wf, bf, wd,
    wo, bo, lns, lnb, nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean)``.
    feats and the mean flag get no gradient. On CPU tensors both
    directions run the plain versions."""

    @staticmethod
    def forward(ctx, psg0, psg1, psg2, psg3, vd, feats, *weights_and_mean):
        *weights, mean = weights_and_mean
        ctx.mean = bool(mean)
        ctx.save_for_backward(psg0, psg1, psg2, psg3, vd, feats, *weights)
        return fused_corner_hop([psg0, psg1, psg2, psg3], vd, feats, *weights, mean=ctx.mean)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        psg0, psg1, psg2, psg3, vd, feats, *weights = ctx.saved_tensors
        grads = fused_corner_hop_bwd([psg0, psg1, psg2, psg3], vd, feats, *weights,
                                     g.contiguous(), mean=ctx.mean)
        return (*grads[:5], None, *grads[5:], None)
