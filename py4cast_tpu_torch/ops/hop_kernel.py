"""The lattice mesh→grid corner hop (m2g): CUDA kernels for the forward
and the backward, their plain PyTorch versions, and the autograd
Function that joins them.

    psg_k = ps gathered onto the grid by the corner maps  (4 corners)
    pd    = vd @ Wd
    t_k   = LN(silu(feats_k @ Wf + bf + psg_k + pd) @ Wo + bo)
    agg   = sum_k t_k                     (/4 for mean aggregation)
    u     = silu(vd @ Nd0a + agg @ Nd0b + nb0)
    v_out = vd + LN(u @ Nd1 + nb1)

The forward takes the source projection ``ps`` on mesh level 0 and the
int32 corner maps ``rows`` (2, H) and ``cols`` (2, W), and gathers each
corner's row of ``ps`` itself (``gather_corners``); the backward takes
the four gathered ``psg_k`` and returns their cotangents, which
``CornerHopFn`` moves back onto ``ps`` (``sep_aggregate``).

The forward kernel (``csrc/corner_hop.cu``) replaces the TPU kernel
``py4cast_tpu/ops/hop_kernel.py::_fwd_kernel``, the backward
(``csrc/corner_hop_bwd.cu``: a node pass and a corner pass, launched
together) its ``_bwd_kernel``; each source says what bounds it on the
H100 and what its design does about it. The TPU kernels' W padding and
column tiling were Mosaic constraints, and so were the corner upsamples
built before the call. On a CUDA tensor ``fused_corner_hop`` and
``fused_corner_hop_bwd`` launch their kernel or raise; on a CPU tensor
they run ``corner_hop_plain`` and ``corner_hop_bwd_plain``, which are
also what the kernels are held against on the card. Models call
``CornerHopFn``, whose backward is the backward kernel.

Any width runs: on the CPU the plain versions take every width, and on
the card the kernels take widths up to 512, each through its row-tile
(and, forward, warp-row) instances up to its source's ``WIDE_ABOVE`` (96
forward, 64 backward) and through the wide instance of
``csrc/wide_rows.cuh`` above it; the C entry ``p4t_<kernel>_wide`` says
which one a launch takes, and ``launches_wide`` counts those on the wide
instance.

Each wrapper checks its arguments, casts them to fp32 and calls a
``torch.library`` custom op (``p4t::corner_hop_fwd``,
``p4t::corner_hop_bwd``): its CPU implementation is the plain version,
its CUDA implementation the kernel's launch, and its fake
implementation gives the outputs' shapes alone, so that
``torch.export`` and ``torch.utils.flop_counter`` see the op
(``ops/flops.py`` gives its FLOP formula).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from py4cast_tpu_torch.ops import _build
from py4cast_tpu_torch.ops.lattice_ops import sep_aggregate, sep_take_mm_vjp

LN_EPS = 1e-6  # flax nn.LayerNorm default
MAX_FEATS = 32


def gather_corners(ps, rows, cols):
    """The four corner upsamples of ps (B, Hc, Wc, h) on the (H, W) grid,
    in the corner order r0c0, r0c1, r1c0, r1c1:
    ``psg_k[b, i, j] = ps[b, rows[k // 2, i], cols[k % 2, j]]``. Each grid
    cell selects one source cell, so this is exactly what
    ``lattice_ops.sep_take_mm(ps, ar[k // 2], ac[k % 2])`` gives."""
    by_row = [ps.index_select(1, rows[r]) for r in range(2)]
    return [by_row[k // 2].index_select(2, cols[k % 2]) for k in range(4)]


def corner_hop_plain(ps, rows, cols, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                     nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean=False):
    """The corner hop in plain PyTorch (same layouts as the kernel): the
    corners gathered by indexing, then the formula."""
    h = wd.shape[-1]
    psg = gather_corners(ps, rows, cols)
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
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        attrs = lib.p4t_corner_hop_fwd_attributes
        attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
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
        scratch = lib.p4t_corner_hop_bwd_scratch
        scratch.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        scratch.restype = ctypes.c_int
        attrs = lib.p4t_corner_hop_bwd_attributes
        attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


_ATTRIBUTE_KEYS = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "tile_cells")


def fwd_kernel_attributes(h) -> dict:
    """The forward kernel that width ``h`` launches, as the card reports
    it: registers a thread, local (spill) bytes a thread, dynamic shared
    memory, resident blocks an SM, and the cells of a tile (for 64 < h
    <= 96, the warp-row instance: its shared memory at 32 corner
    features, and the cells a block takes at once; above 96, the wide
    instance). Needs the card."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.p4t_corner_hop_fwd_attributes(h, out), "corner_hop attributes")
    return dict(zip(_ATTRIBUTE_KEYS, out))


def bwd_kernel_attributes(h) -> dict:
    """The two backward kernels that width ``h`` launches, the node pass
    and the corner pass (above width 64, the wide instance's),
    as the card reports them: registers a thread, local (spill) bytes a
    thread, dynamic shared memory, resident blocks an SM, and the cells
    of a tile. Needs the card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 10)()
    _build.check(lib, lib.p4t_corner_hop_bwd_attributes(h, out), "corner_hop_bwd attributes")
    return {name: {k: out[5 * i + j] for j, k in enumerate(_ATTRIBUTE_KEYS)}
            for i, name in enumerate(("node", "corner"))}


def _validate(what, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
              nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, extra):
    """The checks the forward and the backward wrapper share, and theirs
    (``extra``: name -> (tensor, expected shape)); returns the device.
    Any hidden width passes: the card's limit is checked where the kernel
    launches."""
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    shapes = {
        **extra,
        "vd": (vd, (b, hr, w, h)), "feats": (feats, (4, hr, w, ff)),
        "wf": (wf, (ff, h)), "bf": (bf, (h,)), "wd": (wd, (h, h)),
        "wo": (wo, (h, h)), "bo": (bo, (h,)), "lns": (lns, (h,)),
        "lnb": (lnb, (h,)), "nd0a": (nd0a, (h, h)), "nd0b": (nd0b, (h, h)),
        "nb0": (nb0, (h,)), "nd1": (nd1, (h, h)), "nb1": (nb1, (h,)),
        "nlns": (nlns, (h,)), "nlnb": (nlnb, (h,)),
    }
    device = _build.validate(what, shapes)
    if ff > MAX_FEATS:
        raise ValueError(f"{what} supports up to {MAX_FEATS} corner features, got {ff}")
    return device


def _validate_maps(what, rows, cols, hr, w, device):
    """The corner maps: int32, (2, H) and (2, W), contiguous, on the
    tensors' device. Their values are checked where the graph is built
    (``models/graph.py::build_graph_artifacts``), not here: that would
    wait for the card."""
    for name, m, n in (("rows", rows, hr), ("cols", cols, w)):
        if m.dtype != torch.int32:
            raise ValueError(f"{what}: {name} is {m.dtype}; the corner maps are int32")
        if tuple(m.shape) != (2, n):
            raise ValueError(f"{what}: {name} has shape {tuple(m.shape)}, expected {(2, n)}")
        if not m.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if m.device != device:
            raise ValueError(f"{what}: {name} is on {m.device}, the others on {device}")


def fused_corner_hop(ps, rows, cols, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                     nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean=False):
    """v_out of the m2g corner hop.

    ps: (B, Hc, Wc, h) source projection on mesh level 0; rows (2, H) and
    cols (2, W): int32 corner maps, corner k of grid cell (i, j) reading
    ``ps[b, rows[k // 2, i], cols[k % 2, j]]`` in the corner order r0c0,
    r0c1, r1c0, r1c1 (``gather_corners``); vd: (B, H, W, h) destination
    grid states; feats: (4, H, W, ff) static corner features. wf: (ff, h),
    wd/wo/nd0a/nd0b/nd1: (h, h) — Dense kernels in (in, out) layout,
    nd0a/nd0b the node MLP's first kernel split at the [v_dst, agg]
    concat; the rest (h,). Any h (on the card at most 512), ff at most
    32, everything but
    the maps fp32 or bf16, all contiguous: bf16 is cast to fp32 at the
    boundary and v_out rounded to vd's dtype, as the TPU kernel rounds
    it. The output carries no gradient: differentiate through
    ``CornerHopFn``.
    """
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    hc, wc = ps.shape[1:3] if ps.dim() == 4 else (-1, -1)
    device = _validate("fused_corner_hop", vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                       nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb,
                       {"ps": (ps, (b, hc, wc, h))})
    _validate_maps("fused_corner_hop", rows, cols, hr, w, device)
    return corner_hop_fwd(
        ps.float(), rows, cols,
        *(t.float() for t in (vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                              nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb)),
        bool(mean)).to(vd.dtype)


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count), and those of them on the wide instance
fused_corner_hop.launches = 0
fused_corner_hop.launches_wide = 0


@torch.library.custom_op("p4t::corner_hop_fwd", mutates_args=(), device_types="cpu")
def corner_hop_fwd(ps: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   vd: torch.Tensor, feats: torch.Tensor, wf: torch.Tensor,
                   bf: torch.Tensor, wd: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                   lns: torch.Tensor, lnb: torch.Tensor, nd0a: torch.Tensor,
                   nd0b: torch.Tensor, nb0: torch.Tensor, nd1: torch.Tensor,
                   nb1: torch.Tensor, nlns: torch.Tensor, nlnb: torch.Tensor,
                   mean: bool) -> torch.Tensor:
    """``p4t::corner_hop_fwd``: v_out in fp32 for the fp32 arguments
    (and int32 maps) ``fused_corner_hop`` has checked. Its CPU
    implementation is ``corner_hop_plain``; on the card it launches the
    forward kernel."""
    return corner_hop_plain(ps, rows, cols, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                            nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean)


@corner_hop_fwd.register_kernel("cuda")
def _corner_hop_fwd_cuda(ps, rows, cols, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                         nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean):
    b, hr, w, h = vd.shape
    hc, wc = ps.shape[1:3]
    ff = feats.shape[-1]
    lib = _lib()
    wide = _build.wide_instance(lib, "p4t_corner_hop_fwd_wide", "fused_corner_hop", h)
    device = vd.device
    out = torch.empty((b, hr, w, h), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_corner_hop_fwd(
            ps.data_ptr(), rows.data_ptr(), cols.data_ptr(), vd.data_ptr(), feats.data_ptr(),
            wf.data_ptr(), bf.data_ptr(), wd.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), lns.data_ptr(), lnb.data_ptr(), nd0a.data_ptr(),
            nd0b.data_ptr(), nb0.data_ptr(), nd1.data_ptr(), nb1.data_ptr(),
            nlns.data_ptr(), nlnb.data_ptr(), out.data_ptr(),
            b, hc, wc, hr, w, h, ff, int(mean), stream,
        )
    _build.check(lib, status, "corner_hop kernel")
    fused_corner_hop.launches += 1
    fused_corner_hop.launches_wide += wide
    return out


@corner_hop_fwd.register_fake
def _corner_hop_fwd_fake(ps, rows, cols, vd, *rest):
    return torch.empty_like(vd)


def fused_corner_hop_bwd(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                         nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g, mean=False):
    """The corner hop's backward for the cotangent g (B, H, W, h) of
    v_out: the 19 gradients of ``corner_hop_bwd_plain``, in its order.
    The forward's arguments and checks, with the four gathered corner
    upsamples psg, (B, H, W, h) each (``gather_corners``), in place of
    ps and the maps; on the card the wide instance above width 64. bf16
    is cast to fp32 at the boundary; the dpsg_k
    are rounded to the dtype of the psg_k and dvd to vd's, as the TPU
    kernel rounds them, and the weight
    gradients stay fp32 (``CornerHopFn`` casts them to each weight's
    dtype). They are summed in a fixed order, so a call repeats bit for
    bit."""
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    if len(psg) != 4:
        raise ValueError(f"fused_corner_hop_bwd takes 4 corner arrays, got {len(psg)}")
    extra = {f"psg{k}": (p, (b, hr, w, h)) for k, p in enumerate(psg)}
    extra["g"] = (g, (b, hr, w, h))
    _validate("fused_corner_hop_bwd", vd, feats, wf, bf, wd, wo, bo, lns,
              lnb, nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, extra)
    dtypes = (*(p.dtype for p in psg), vd.dtype)
    *grads, dw = corner_hop_bwd(
        *(t.float() for t in (*psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                              nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g)),
        bool(mean))
    parts = list(torch.split(dw, _dw_sizes(ff, h)))
    for i, shape in ((0, (ff, h)), (2, (h, h)), (3, (h, h)), (7, (h, h)), (8, (h, h)),
                     (10, (h, h))):
        parts[i] = parts[i].view(shape)
    return (*(d.to(dt) for d, dt in zip(grads, dtypes)), *parts)


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count), and those of them on the wide instance
fused_corner_hop_bwd.launches = 0
fused_corner_hop_bwd.launches_wide = 0


def _dw_sizes(ff, h) -> tuple:
    """The weight gradients' sizes in the backward op's flat ``dw``:
    dwf, dbf, dwd, dwo, dbo, dlns, dlnb, dnd0a, dnd0b, dnb0, dnd1, dnb1,
    dnlns, dnlnb."""
    return (ff * h, h, h * h, h * h, h, h, h, h * h, h * h, h, h * h, h, h, h)


@torch.library.custom_op("p4t::corner_hop_bwd", mutates_args=(), device_types="cpu")
def corner_hop_bwd(psg0: torch.Tensor, psg1: torch.Tensor, psg2: torch.Tensor,
                   psg3: torch.Tensor, vd: torch.Tensor, feats: torch.Tensor,
                   wf: torch.Tensor, bf: torch.Tensor, wd: torch.Tensor, wo: torch.Tensor,
                   bo: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor,
                   nd0a: torch.Tensor, nd0b: torch.Tensor, nb0: torch.Tensor,
                   nd1: torch.Tensor, nb1: torch.Tensor, nlns: torch.Tensor,
                   nlnb: torch.Tensor, g: torch.Tensor, mean: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """``p4t::corner_hop_bwd``: (dpsg0, dpsg1, dpsg2, dpsg3, dvd, dw) in
    fp32 for the fp32 arguments ``fused_corner_hop_bwd`` has checked, dw
    the fourteen weight gradients flat in ``_dw_sizes`` order (one
    buffer: an op's outputs may not alias one another). Its CPU
    implementation is ``corner_hop_bwd_plain``; on the card it launches
    the backward kernels."""
    grads = corner_hop_bwd_plain([psg0, psg1, psg2, psg3], vd, feats, wf, bf, wd, wo, bo,
                                 lns, lnb, nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g, mean)
    return (*grads[:5], torch.cat([d.reshape(-1) for d in grads[5:]]))


@corner_hop_bwd.register_kernel("cuda")
def _corner_hop_bwd_cuda(psg0, psg1, psg2, psg3, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                         nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, g, mean):
    b, hr, w, h = vd.shape
    ff = feats.shape[-1]
    lib = _bwd_lib()
    wide = _build.wide_instance(lib, "p4t_corner_hop_bwd_wide", "fused_corner_hop_bwd", h)
    device = vd.device
    psg = (psg0, psg1, psg2, psg3)
    dpsg = [torch.empty_like(vd) for _ in range(4)]
    dvd = torch.empty_like(vd)
    dagg = torch.empty_like(vd)  # scratch: the node pass's dagg for the corner pass
    dw = torch.empty(sum(_dw_sizes(ff, h)), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        _build.check(lib, lib.p4t_corner_hop_bwd_grid(b, hr, w, h, ff, ctypes.byref(blocks)),
                     "corner_hop_bwd grid")
        scratch = ctypes.c_longlong(0)
        _build.check(lib, lib.p4t_corner_hop_bwd_scratch(b, hr, w, h, ctypes.byref(scratch)),
                     "corner_hop_bwd scratch")
        # one fp32 partial of every weight gradient per block, summed by
        # a second kernel in a fixed order; then the wide instance's
        # scratch rows (none below it)
        partial = torch.empty(blocks.value * dw.numel() + scratch.value, device=device,
                              dtype=torch.float32)
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
    fused_corner_hop_bwd.launches_wide += wide
    return (*dpsg, dvd, dw)


@corner_hop_bwd.register_fake
def _corner_hop_bwd_fake(psg0, psg1, psg2, psg3, vd, feats, *rest):
    return (*(torch.empty_like(vd) for _ in range(5)),
            vd.new_empty((sum(_dw_sizes(feats.shape[-1], vd.shape[-1])),)))


class CornerHopFn(torch.autograd.Function):
    """``fused_corner_hop`` with its backward kernel as the gradient:
    ``CornerHopFn.apply(ps, rows, cols, ar, ac, vd, feats, wf, bf, wd, wo,
    bo, lns, lnb, nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean)``. ar
    (2, Hc, H) and ac (2, Wc, W) are the corner maps' 0/1 selection
    matrices (``lattice_ops.sel_matrix`` of rows[r] and cols[c]). It saves
    ps, not its four corner upsamples: the backward gathers them again for
    the backward kernel and moves each dpsg_k back onto ps with 0/1
    matmuls in a fixed order (``sep_aggregate``; under bf16 in the
    order the JAX package's VJP rounds in, ``sep_take_mm_vjp``), so a
    second call repeats bit for bit. The weight gradients, summed
    in fp32, are cast to each weight's dtype, as the JAX package's VJP
    casts them. The maps, ar, ac, feats and the mean flag get no
    gradient. Both directions go through the wrappers' custom ops
    (``p4t::corner_hop_fwd``, ``p4t::corner_hop_bwd``): the kernels on
    CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, ps, rows, cols, ar, ac, vd, feats, *weights_and_mean):
        *weights, mean = weights_and_mean
        ctx.mean = bool(mean)
        ctx.save_for_backward(ps, rows, cols, ar, ac, vd, feats, *weights)
        return fused_corner_hop(ps, rows, cols, vd, feats, *weights, mean=ctx.mean)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ps, rows, cols, ar, ac, vd, feats, *weights = ctx.saved_tensors
        grads = fused_corner_hop_bwd(gather_corners(ps, rows, cols), vd, feats, *weights,
                                     g.contiguous(), mean=ctx.mean)
        # bf16 rounds each contraction and each add: fold the corners as
        # jax.vjp of the JAX package's four sep_take_mm does, the last
        # corner first, columns before rows
        fp32 = ps.dtype == torch.float32
        fold = sep_aggregate if fp32 else sep_take_mm_vjp
        ar, ac = ar.to(ps.dtype), ac.to(ps.dtype)
        dps = None
        for k in (range(4) if fp32 else range(3, -1, -1)):
            moved = fold(grads[k], ar[k // 2], ac[k % 2])
            dps = moved if dps is None else dps + moved
        dw = [d.to(w.dtype) for d, w in zip(grads[5:], weights)]
        return (dps, None, None, None, None, grads[4], None, *dw, None)
