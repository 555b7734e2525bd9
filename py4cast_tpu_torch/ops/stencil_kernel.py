"""The lattice stencil edge-message stage: CUDA kernels for the forward
and the backward, their plain PyTorch versions, and the autograd
Function that joins them.

    e_new = LN(silu(e @ We + be + vs + pd) @ Wo + bo)     (8 directions)
    out   = e_new (+ e when residual)
    agg   = sum_k e_new[k] * mask[k]                      (raw e_new)

The forward kernel (``csrc/stencil_message.cu``) replaces the TPU kernel
``py4cast_tpu/ops/stencil_kernel.py::_fwd_kernel``, the backward kernel
(``csrc/stencil_message_bwd.cu``) its ``_bwd_kernel``; each source says
what bounds it on the H100 and what its design does about it. On a
CUDA tensor ``fused_stencil_message`` and ``fused_stencil_message_bwd``
launch their kernel or raise; on a CPU tensor they run
``stencil_message_plain`` and ``stencil_message_bwd_plain``, which are
also what the kernels are held against on the card. Models call
``StencilMessageFn``, whose backward is the backward kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from py4cast_tpu_torch.ops import _build

LN_EPS = 1e-6  # flax nn.LayerNorm default
MAX_WIDTH = 128
#: the backward kernel keeps both weight matrices, both weight-gradient
#: accumulators and a tile of rows in one block's shared memory, and
#: twice the forward's live rows in registers: 64 is the widest it takes
MAX_BWD_WIDTH = 64


def stencil_message_plain(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual=False):
    """The stencil message in plain PyTorch (same layouts as the kernel)."""
    h = we.shape[-1]
    pre = e @ we + be + vs + pd[:, None]
    t = F.silu(pre) @ wo + bo
    e_new = F.layer_norm(t, (h,), lns, lnb, eps=LN_EPS)
    agg = (e_new * mask[None]).sum(dim=1)
    return (e + e_new if residual else e_new), agg


def stencil_message_bwd_plain(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                              g_out, g_agg, residual=False):
    """The stencil message's backward in plain PyTorch: the recompute
    formula of the TPU ``_bwd_kernel``, written out by hand. g_out and
    g_agg are the cotangents of (out, agg). Returns
    ``(de, dvs, dpd, dwe, dbe, dwo, dbo, dlns, dlnb)``; the weight and
    LayerNorm gradients are summed over every cell and direction.
    Works in any float dtype (the card's check runs it in fp64 too)."""
    h = we.shape[-1]
    f_in = e.shape[-1]
    # ---- recompute the forward internals
    pre = e @ we + be + vs + pd[:, None]
    sig = torch.sigmoid(pre)
    z = pre * sig
    t = z @ wo + bo
    mu = t.mean(dim=-1, keepdim=True)
    var = ((t - mu) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (t - mu) * inv
    # ---- upstream gradient: edge output + masked aggregate
    g = g_out + g_agg[:, None] * mask[None]
    # ---- LayerNorm backward
    dlns = (g * xhat).reshape(-1, h).sum(0)
    dlnb = g.reshape(-1, h).sum(0)
    gx = g * lns
    dt = (gx - gx.mean(dim=-1, keepdim=True)
          - xhat * (gx * xhat).mean(dim=-1, keepdim=True)) * inv
    # ---- out Dense backward
    dwo = z.reshape(-1, h).t() @ dt.reshape(-1, h)
    dbo = dt.reshape(-1, h).sum(0)
    dz = dt @ wo.t()
    # ---- silu backward
    dpre = dz * (sig * (1.0 + pre * (1.0 - sig)))
    # ---- edge Dense backward and the input gradients
    dwe = e.reshape(-1, f_in).t() @ dpre.reshape(-1, h)
    dbe = dpre.reshape(-1, h).sum(0)
    de = dpre @ we.t()
    if residual:  # the direct path of out = e + e_new
        de = de + g_out
    return de, dpre, dpre.sum(dim=1), dwe, dbe, dwo, dbo, dlns, dlnb


def _lib():
    lib = _build.load("stencil_message")
    fn = lib.p4t_stencil_message_fwd
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("stencil_message_bwd")
    fn = lib.p4t_stencil_message_bwd
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        grid = lib.p4t_stencil_message_bwd_grid
        grid.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
    return lib


def _validate(what, e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual, max_width, extra=None):
    """The checks the forward and the backward wrapper share; returns
    the device."""
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    shapes = {
        "e": (e, (b, 8, hr, w, f_in)), "vs": (vs, (b, 8, hr, w, h)),
        "pd": (pd, (b, hr, w, h)), "mask": (mask, (8, hr, w, 1)),
        "we": (we, (f_in, h)), "be": (be, (h,)), "wo": (wo, (h, h)),
        "bo": (bo, (h,)), "lns": (lns, (h,)), "lnb": (lnb, (h,)),
    }
    shapes.update(extra or {})
    device = _build.validate(what, shapes)
    if f_in > max_width or h > max_width:
        raise ValueError(
            f"{what} supports widths up to {max_width}, got "
            f"edge features {f_in} and hidden {h}"
        )
    if residual and f_in != h:
        raise ValueError(
            "residual fold requires edge features == hidden width, got "
            f"{f_in} vs {h}"
        )
    return device


def fused_stencil_message(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual=False):
    """(out, agg) of the stencil edge-message stage.

    e: (B, 8, H, W, F) edge states in ``lattice_ops.DIRS8`` order;
    vs: (B, 8, H, W, h) source projections shifted onto each cell;
    pd: (B, H, W, h) destination projection; mask: (8, H, W, 1) edge
    existence. we: (F, h), wo: (h, h) — Dense kernels in (in, out)
    layout; be, bo, lns, lnb: (h,). F and h at most 128, everything
    fp32 and contiguous. ``residual`` returns ``e + e_new`` as the first
    output (needs F == h); agg always sums the raw e_new. The outputs
    carry no gradient: differentiate through ``StencilMessageFn``.
    """
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    device = _validate("fused_stencil_message", e, vs, pd, mask, we, be, wo, bo,
                       lns, lnb, residual, MAX_WIDTH)
    if device.type == "cpu":
        return stencil_message_plain(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual)

    out = torch.empty((b, 8, hr, w, h), device=device, dtype=torch.float32)
    agg = torch.empty((b, hr, w, h), device=device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_stencil_message_fwd(
            e.data_ptr(), vs.data_ptr(), pd.data_ptr(), mask.data_ptr(),
            we.data_ptr(), be.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), out.data_ptr(), agg.data_ptr(),
            b, hr, w, f_in, h, int(residual), stream,
        )
    _build.check(lib, status, "stencil_message kernel")
    fused_stencil_message.launches += 1
    return out, agg


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count)
fused_stencil_message.launches = 0


def fused_stencil_message_bwd(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                              g_out, g_agg, residual=False):
    """The stencil message's backward: ``(de, dvs, dpd, dwe, dbe, dwo,
    dbo, dlns, dlnb)`` for the cotangents g_out (B, 8, H, W, h) of out
    and g_agg (B, H, W, h) of agg. The forward's arguments and checks;
    F and h at most 64 (``MAX_BWD_WIDTH``). The weight gradients are
    summed in a fixed order, so a call repeats bit for bit."""
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    device = _validate(
        "fused_stencil_message_bwd", e, vs, pd, mask, we, be, wo, bo, lns, lnb,
        residual, MAX_BWD_WIDTH,
        {"g_out": (g_out, (b, 8, hr, w, h)), "g_agg": (g_agg, (b, hr, w, h))},
    )
    if device.type == "cpu":
        return stencil_message_bwd_plain(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                                         g_out, g_agg, residual)

    de = torch.empty_like(e)
    dvs = torch.empty((b, 8, hr, w, h), device=device, dtype=torch.float32)
    dpd = torch.empty((b, hr, w, h), device=device, dtype=torch.float32)
    sizes = (f_in * h, h, h * h, h, h, h)  # dwe, dbe, dwo, dbo, dlns, dlnb
    dw = torch.empty(sum(sizes), device=device, dtype=torch.float32)
    lib = _bwd_lib()
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        _build.check(lib, lib.p4t_stencil_message_bwd_grid(b, hr, w, f_in, h, ctypes.byref(blocks)),
                     "stencil_message_bwd grid")
        # one fp32 partial of every weight gradient per block, summed by
        # a second kernel in a fixed order
        partial = torch.empty(blocks.value * dw.numel(), device=device, dtype=torch.float32)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_stencil_message_bwd(
            e.data_ptr(), vs.data_ptr(), pd.data_ptr(), mask.data_ptr(),
            we.data_ptr(), be.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), g_out.data_ptr(), g_agg.data_ptr(),
            de.data_ptr(), dvs.data_ptr(), dpd.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), b, hr, w, f_in, h, int(residual), blocks.value, stream,
        )
    _build.check(lib, status, "stencil_message_bwd kernel")
    fused_stencil_message_bwd.launches += 1
    dwe, dbe, dwo, dbo, dlns, dlnb = torch.split(dw, sizes)
    return de, dvs, dpd, dwe.view(f_in, h), dbe, dwo.view(h, h), dbo, dlns, dlnb


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count)
fused_stencil_message_bwd.launches = 0


class StencilMessageFn(torch.autograd.Function):
    """``fused_stencil_message`` with its backward kernel as the
    gradient: ``StencilMessageFn.apply(e, vs, pd, mask, we, be, wo, bo,
    lns, lnb, residual)``. mask and the residual flag get no gradient.
    On CPU tensors both directions run the plain versions."""

    @staticmethod
    def forward(ctx, e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual):
        ctx.residual = bool(residual)
        ctx.save_for_backward(e, vs, pd, mask, we, be, wo, bo, lns, lnb)
        return fused_stencil_message(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                                     ctx.residual)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_agg):
        # an unused output arrives as zeros (grad materialisation is on)
        grads = fused_stencil_message_bwd(*ctx.saved_tensors, g_out.contiguous(),
                                          g_agg.contiguous(), ctx.residual)
        de, dvs, dpd, dwe, dbe, dwo, dbo, dlns, dlnb = grads
        return de, dvs, dpd, None, dwe, dbe, dwo, dbo, dlns, dlnb, None
