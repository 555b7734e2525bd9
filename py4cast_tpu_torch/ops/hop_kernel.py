"""The lattice mesh→grid corner hop (m2g): a CUDA kernel and its plain
PyTorch version.

    pd    = vd @ Wd
    t_k   = LN(silu(feats_k @ Wf + bf + psg_k + pd) @ Wo + bo)   (4 corners)
    agg   = sum_k t_k                     (/4 for mean aggregation)
    u     = silu(vd @ Nd0a + agg @ Nd0b + nb0)
    v_out = vd + LN(u @ Nd1 + nb1)

The kernel (``csrc/corner_hop.cu``) replaces the TPU kernel
``py4cast_tpu/ops/hop_kernel.py::_fwd_kernel``; its source says what
bounds it on the H100 and what its design does about it. The TPU
kernel's W padding and column tiling were Mosaic constraints: here the
corner upsamples arrive at the grid width. On a CUDA tensor
``fused_corner_hop`` launches the kernel or raises; on a CPU tensor it
runs ``corner_hop_plain``, which is also what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from py4cast_tpu_torch.ops import _build

LN_EPS = 1e-6  # flax nn.LayerNorm default
#: the five h x h weight matrices must fit the 227 KB of shared memory a
#: block may use: 96 is the largest width (a multiple of 32) that does
MAX_WIDTH = 96
MAX_FEATS = 32


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


def _lib():
    lib = _build.load("corner_hop")
    fn = lib.p4t_corner_hop_fwd
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_corner_hop(psg, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
                     nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, mean=False):
    """v_out of the m2g corner hop.

    psg: sequence of FOUR (B, H, W, h) corner-upsampled source
    projections, corner order r0c0, r0c1, r1c0, r1c1; vd: (B, H, W, h)
    destination grid states; feats: (4, H, W, ff) static corner
    features. wf: (ff, h), wd/wo/nd0a/nd0b/nd1: (h, h) — Dense kernels in
    (in, out) layout, nd0a/nd0b the node MLP's first kernel split at the
    [v_dst, agg] concat; the rest (h,). h at most 96, ff at most 32,
    everything fp32 and contiguous.
    """
    if len(psg) != 4:
        raise ValueError(f"fused_corner_hop takes 4 corner arrays, got {len(psg)}")
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
    device = _build.validate("fused_corner_hop", shapes)
    if h > MAX_WIDTH or ff > MAX_FEATS:
        raise ValueError(
            f"fused_corner_hop supports hidden width up to {MAX_WIDTH} and up "
            f"to {MAX_FEATS} corner features, got {h} and {ff}"
        )
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
