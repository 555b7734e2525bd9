"""The lattice stencil edge-message stage: CUDA kernels for the forward
and the backward, their plain PyTorch versions, and the autograd
Function that joins them.

    vs    = lattice_ops.stack_shifts(ps)                  (8 neighbours)
    e_new = LN(silu(e @ We + be + vs + pd) @ Wo + bo)     (8 directions)
    out   = e_new (+ e when residual)
    agg   = sum_k e_new[k] * mask[k]                      (raw e_new)

The forward takes the source projection ``ps`` and shifts it onto each
cell itself; the backward takes the shifted ``vs`` and returns its
cotangent ``dvs``, which ``StencilMessageFn`` moves back onto ``ps``
(``lattice_ops.unshift_sum``).

The forward kernel (``csrc/stencil_message.cu``) replaces the TPU kernel
``py4cast_tpu/ops/stencil_kernel.py::_fwd_kernel``, the backward kernel
(``csrc/stencil_message_bwd.cu``) its ``_bwd_kernel``; each source says
what bounds it on the H100 and what its design does about it. On a
CUDA tensor ``fused_stencil_message`` and ``fused_stencil_message_bwd``
launch their kernel or raise; on a CPU tensor they run
``stencil_message_plain`` and ``stencil_message_bwd_plain``, which are
also what the kernels are held against on the card. Models call
``StencilMessageFn``, whose backward is the backward kernel.

Any width runs: on the CPU the plain versions take every width, and on
the card the kernels take widths up to 512, each through row-tile
instances up to its source's ``WIDE_ABOVE`` (128 forward, 64 backward)
and through the wide instance of ``csrc/wide_rows.cuh`` above it; the C
entry ``p4t_<kernel>_wide`` says which one a launch takes, and
``launches_wide`` counts those on the wide instance.

Each wrapper checks its arguments, casts them to fp32 and calls a
``torch.library`` custom op (``p4t::stencil_message_fwd``,
``p4t::stencil_message_bwd``): its CPU implementation is the plain
version, its CUDA implementation the kernel's launch, and its fake
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
from py4cast_tpu_torch.ops.lattice_ops import stack_shifts, unshift_sum

LN_EPS = 1e-6  # flax nn.LayerNorm default


def stencil_message_plain(e, ps, pd, mask, we, be, wo, bo, lns, lnb, residual=False):
    """The stencil message in plain PyTorch (same layouts as the kernel):
    the eight shifts of ps stacked, then the edge MLP."""
    h = we.shape[-1]
    pre = e @ we + be + stack_shifts(ps) + pd[:, None]
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
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        attrs = lib.p4t_stencil_message_fwd_attributes
        attrs.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
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
        scratch = lib.p4t_stencil_message_bwd_scratch
        scratch.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        scratch.restype = ctypes.c_int
        attrs = lib.p4t_stencil_message_bwd_attributes
        attrs.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


def _attributes(lib, entry, f_in, h) -> dict:
    out = (ctypes.c_int * 5)()
    _build.check(lib, getattr(lib, entry)(f_in, h, out), entry)
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3], "tile_rows": out[4]}


def fwd_kernel_attributes(f_in, h) -> dict:
    """The forward kernel that widths ``(f_in, h)`` launch (the wide
    instance above 128), as the card reports it: registers
    a thread, local (spill) bytes a thread, dynamic shared memory,
    resident blocks an SM, and the rows of its tile. Needs the card."""
    return _attributes(_lib(), "p4t_stencil_message_fwd_attributes", f_in, h)


def bwd_kernel_attributes(f_in, h) -> dict:
    """The backward kernel's, as ``fwd_kernel_attributes`` (the wide
    instance above 64: its fused pass)."""
    return _attributes(_bwd_lib(), "p4t_stencil_message_bwd_attributes", f_in, h)


def _validate(what, e, pd, mask, we, be, wo, bo, lns, lnb, residual, extra):
    """The checks the forward and the backward wrapper share, and theirs
    (``extra``: name -> (tensor, expected shape)). Any width passes: the
    card's limit is checked where the kernel launches."""
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    shapes = {
        "e": (e, (b, 8, hr, w, f_in)), **extra,
        "pd": (pd, (b, hr, w, h)), "mask": (mask, (8, hr, w, 1)),
        "we": (we, (f_in, h)), "be": (be, (h,)), "wo": (wo, (h, h)),
        "bo": (bo, (h,)), "lns": (lns, (h,)), "lnb": (lnb, (h,)),
    }
    _build.validate(what, shapes)
    if residual and f_in != h:
        raise ValueError(
            "residual fold requires edge features == hidden width, got "
            f"{f_in} vs {h}"
        )


def fused_stencil_message(e, ps, pd, mask, we, be, wo, bo, lns, lnb, residual=False):
    """(out, agg) of the stencil edge-message stage.

    e: (B, 8, H, W, F) edge states in ``lattice_ops.DIRS8`` order;
    ps: (B, H, W, h) source projection, which the kernel shifts onto each
    cell for each direction (``lattice_ops.stack_shifts``, 0 off the
    lattice); pd: (B, H, W, h) destination projection; mask: (8, H, W, 1) edge
    existence. we: (F, h), wo: (h, h) — Dense kernels in (in, out)
    layout; be, bo, lns, lnb: (h,). Any F and h (on the card at most
    512), everything
    fp32 or bf16 and contiguous: bf16 is cast to fp32 at the boundary,
    and both outputs are rounded to e's dtype, as the TPU kernel rounds
    them. ``residual`` returns ``e + e_new`` as the first output (needs
    F == h); agg always sums the raw e_new. The outputs carry no
    gradient: differentiate through ``StencilMessageFn``.
    """
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    _validate("fused_stencil_message", e, pd, mask, we, be, wo, bo, lns, lnb,
              residual, {"ps": (ps, (b, hr, w, h))})
    dtype = e.dtype
    out, agg = stencil_message_fwd(
        *(t.float() for t in (e, ps, pd, mask, we, be, wo, bo, lns, lnb)), bool(residual))
    return out.to(dtype), agg.to(dtype)


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count), and those of them on the wide instance
fused_stencil_message.launches = 0
fused_stencil_message.launches_wide = 0


@torch.library.custom_op("p4t::stencil_message_fwd", mutates_args=(), device_types="cpu")
def stencil_message_fwd(e: torch.Tensor, ps: torch.Tensor, pd: torch.Tensor,
                        mask: torch.Tensor, we: torch.Tensor, be: torch.Tensor,
                        wo: torch.Tensor, bo: torch.Tensor, lns: torch.Tensor,
                        lnb: torch.Tensor, residual: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``p4t::stencil_message_fwd``: (out, agg) in fp32 for the fp32
    arguments ``fused_stencil_message`` has checked. Its CPU
    implementation is ``stencil_message_plain``; on the card it launches
    the forward kernel."""
    return stencil_message_plain(e, ps, pd, mask, we, be, wo, bo, lns, lnb, residual)


@stencil_message_fwd.register_kernel("cuda")
def _stencil_message_fwd_cuda(e, ps, pd, mask, we, be, wo, bo, lns, lnb, residual):
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    lib = _lib()
    wide = _build.wide_instance(lib, "p4t_stencil_message_fwd_wide", "fused_stencil_message",
                                f_in, h)
    device = e.device
    out = torch.empty((b, 8, hr, w, h), device=device, dtype=torch.float32)
    agg = torch.empty((b, hr, w, h), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_stencil_message_fwd(
            e.data_ptr(), ps.data_ptr(), pd.data_ptr(), mask.data_ptr(),
            we.data_ptr(), be.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), out.data_ptr(), agg.data_ptr(),
            b, hr, w, f_in, h, int(residual), stream,
        )
    _build.check(lib, status, "stencil_message kernel")
    fused_stencil_message.launches += 1
    fused_stencil_message.launches_wide += wide
    return out, agg


@stencil_message_fwd.register_fake
def _stencil_message_fwd_fake(e, ps, pd, mask, we, be, wo, bo, lns, lnb, residual):
    b, _, hr, w, _ = e.shape
    h = we.shape[-1]
    return e.new_empty((b, 8, hr, w, h)), e.new_empty((b, hr, w, h))


def fused_stencil_message_bwd(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                              g_out, g_agg, residual=False):
    """The stencil message's backward: ``(de, dvs, dpd, dwe, dbe, dwo,
    dbo, dlns, dlnb)`` for the cotangents g_out (B, 8, H, W, h) of out
    and g_agg (B, H, W, h) of agg. The forward's arguments and checks,
    with vs = ``stack_shifts(ps)`` (B, 8, H, W, h) in place of ps; on the
    card the wide instance above width 64. bf16 is cast to fp32 at the
    boundary; de, dvs and dpd are rounded to the dtypes of e, vs and pd,
    as the TPU kernel rounds them, and the weight gradients stay fp32
    (``StencilMessageFn`` casts them to each weight's dtype). They are
    summed in a fixed order, so a call repeats bit for bit."""
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    _validate(
        "fused_stencil_message_bwd", e, pd, mask, we, be, wo, bo, lns, lnb, residual,
        {"vs": (vs, (b, 8, hr, w, h)), "g_out": (g_out, (b, 8, hr, w, h)),
         "g_agg": (g_agg, (b, hr, w, h))},
    )
    dtypes = e.dtype, vs.dtype, pd.dtype
    de, dvs, dpd, dw = stencil_message_bwd(
        *(t.float() for t in (e, vs, pd, mask, we, be, wo, bo, lns, lnb, g_out, g_agg)),
        bool(residual))
    dwe, dbe, dwo, dbo, dlns, dlnb = torch.split(dw, _dw_sizes(f_in, h))
    return (*(g.to(dt) for g, dt in zip((de, dvs, dpd), dtypes)),
            dwe.view(f_in, h), dbe, dwo.view(h, h), dbo, dlns, dlnb)


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count), and those of them on the wide instance
fused_stencil_message_bwd.launches = 0
fused_stencil_message_bwd.launches_wide = 0


def _dw_sizes(f_in, h) -> tuple:
    """The weight gradients' sizes in the backward op's flat ``dw``:
    dwe, dbe, dwo, dbo, dlns, dlnb."""
    return (f_in * h, h, h * h, h, h, h)


@torch.library.custom_op("p4t::stencil_message_bwd", mutates_args=(), device_types="cpu")
def stencil_message_bwd(e: torch.Tensor, vs: torch.Tensor, pd: torch.Tensor,
                        mask: torch.Tensor, we: torch.Tensor, be: torch.Tensor,
                        wo: torch.Tensor, bo: torch.Tensor, lns: torch.Tensor,
                        lnb: torch.Tensor, g_out: torch.Tensor, g_agg: torch.Tensor,
                        residual: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``p4t::stencil_message_bwd``: (de, dvs, dpd, dw) in fp32 for the
    fp32 arguments ``fused_stencil_message_bwd`` has checked, dw the six
    weight gradients flat in ``_dw_sizes`` order (one buffer: an op's
    outputs may not alias one another). Its CPU implementation is
    ``stencil_message_bwd_plain``; on the card it launches the backward
    kernel."""
    de, dvs, dpd, *dw = stencil_message_bwd_plain(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                                                  g_out, g_agg, residual)
    return de, dvs, dpd, torch.cat([g.reshape(-1) for g in dw])


@stencil_message_bwd.register_kernel("cuda")
def _stencil_message_bwd_cuda(e, vs, pd, mask, we, be, wo, bo, lns, lnb, g_out, g_agg,
                              residual):
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    lib = _bwd_lib()
    wide = _build.wide_instance(lib, "p4t_stencil_message_bwd_wide",
                                "fused_stencil_message_bwd", f_in, h)
    device = e.device
    de = torch.empty_like(e)
    dvs = torch.empty((b, 8, hr, w, h), device=device, dtype=torch.float32)
    dpd = torch.empty((b, hr, w, h), device=device, dtype=torch.float32)
    dw = torch.empty(sum(_dw_sizes(f_in, h)), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        _build.check(lib, lib.p4t_stencil_message_bwd_grid(b, hr, w, f_in, h, ctypes.byref(blocks)),
                     "stencil_message_bwd grid")
        scratch = ctypes.c_longlong(0)
        _build.check(lib, lib.p4t_stencil_message_bwd_scratch(b, hr, w, f_in, h,
                                                              ctypes.byref(scratch)),
                     "stencil_message_bwd scratch")
        # one fp32 partial of every weight gradient per block, summed by
        # a second kernel in a fixed order; then the wide instance's
        # scratch rows (none below it)
        partial = torch.empty(blocks.value * dw.numel() + scratch.value, device=device,
                              dtype=torch.float32)
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
    fused_stencil_message_bwd.launches_wide += wide
    return de, dvs, dpd, dw


@stencil_message_bwd.register_fake
def _stencil_message_bwd_fake(e, vs, pd, mask, we, be, wo, bo, lns, lnb, g_out, g_agg,
                              residual):
    return (torch.empty_like(e), torch.empty_like(vs), torch.empty_like(pd),
            e.new_empty((sum(_dw_sizes(e.shape[-1], we.shape[-1])),)))


class StencilMessageFn(torch.autograd.Function):
    """``fused_stencil_message`` with its backward kernel as the
    gradient: ``StencilMessageFn.apply(e, ps, pd, mask, we, be, wo, bo,
    lns, lnb, residual)``. mask and the residual flag get no gradient.
    It saves ps (bf16 under the bf16 policy), not its eight shifts: the
    backward shifts it again for the backward kernel and moves dvs back
    onto ps (``unshift_sum``, in dvs's dtype). The weight gradients,
    summed in fp32, are cast to each weight's dtype, as the JAX
    package's VJP casts them. Both directions go through the wrappers'
    custom ops (``p4t::stencil_message_fwd``, ``p4t::stencil_message_bwd``):
    the kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, e, ps, pd, mask, we, be, wo, bo, lns, lnb, residual):
        ctx.residual = bool(residual)
        ctx.save_for_backward(e, ps, pd, mask, we, be, wo, bo, lns, lnb)
        return fused_stencil_message(e, ps, pd, mask, we, be, wo, bo, lns, lnb,
                                     ctx.residual)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_agg):
        e, ps, *rest = ctx.saved_tensors
        # an unused output arrives as zeros (grad materialisation is on)
        grads = fused_stencil_message_bwd(e, stack_shifts(ps), *rest, g_out.contiguous(),
                                          g_agg.contiguous(), ctx.residual)
        de, dvs, dpd, *dw = grads
        dw = [g.to(p.dtype) for g, p in zip(dw, rest[2:])]
        return (de, unshift_sum(dvs), dpd, None, *dw, None)
