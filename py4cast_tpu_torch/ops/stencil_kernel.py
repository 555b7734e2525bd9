"""The lattice stencil edge-message stage: a CUDA kernel and its plain
PyTorch version.

    e_new = LN(silu(e @ We + be + vs + pd) @ Wo + bo)     (8 directions)
    out   = e_new (+ e when residual)
    agg   = sum_k e_new[k] * mask[k]                      (raw e_new)

The kernel (``csrc/stencil_message.cu``) replaces the TPU kernel
``py4cast_tpu/ops/stencil_kernel.py::_fwd_kernel``; its source says
what bounds it on the H100 and what its design does about it. On a
CUDA tensor ``fused_stencil_message`` launches the kernel or raises; on
a CPU tensor it runs ``stencil_message_plain``, which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from py4cast_tpu_torch.ops import _build

LN_EPS = 1e-6  # flax nn.LayerNorm default
MAX_WIDTH = 128


def stencil_message_plain(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual=False):
    """The stencil message in plain PyTorch (same layouts as the kernel)."""
    h = we.shape[-1]
    pre = e @ we + be + vs + pd[:, None]
    t = F.silu(pre) @ wo + bo
    e_new = F.layer_norm(t, (h,), lns, lnb, eps=LN_EPS)
    agg = (e_new * mask[None]).sum(dim=1)
    return (e + e_new if residual else e_new), agg


def _lib():
    lib = _build.load("stencil_message")
    fn = lib.p4t_stencil_message_fwd
    if fn.argtypes is None:  # first use: declare the C signature
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_stencil_message(e, vs, pd, mask, we, be, wo, bo, lns, lnb, residual=False):
    """(out, agg) of the stencil edge-message stage.

    e: (B, 8, H, W, F) edge states in ``lattice_ops.DIRS8`` order;
    vs: (B, 8, H, W, h) source projections shifted onto each cell;
    pd: (B, H, W, h) destination projection; mask: (8, H, W, 1) edge
    existence. we: (F, h), wo: (h, h) — Dense kernels in (in, out)
    layout; be, bo, lns, lnb: (h,). F and h at most 128, everything
    fp32 and contiguous. ``residual`` returns ``e + e_new`` as the first
    output (needs F == h); agg always sums the raw e_new.
    """
    b, _, hr, w, f_in = e.shape
    h = we.shape[-1]
    device = _build.validate("fused_stencil_message", {
        "e": (e, (b, 8, hr, w, f_in)), "vs": (vs, (b, 8, hr, w, h)),
        "pd": (pd, (b, hr, w, h)), "mask": (mask, (8, hr, w, 1)),
        "we": (we, (f_in, h)), "be": (be, (h,)), "wo": (wo, (h, h)),
        "bo": (bo, (h,)), "lns": (lns, (h,)), "lnb": (lnb, (h,)),
    })
    if f_in > MAX_WIDTH or h > MAX_WIDTH:
        raise ValueError(
            f"fused_stencil_message supports widths up to {MAX_WIDTH}, got "
            f"edge features {f_in} and hidden {h}"
        )
    if residual and f_in != h:
        raise ValueError(
            "residual fold requires edge features == hidden width, got "
            f"{f_in} vs {h}"
        )
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
