"""Long-query / short-KV attention: CUDA kernels for the forward and the
backward, their plain PyTorch versions, and the autograd Function that
joins them.

    o = softmax(q @ k^T * scale) @ v      q (BH, Lq, D), k, v (BH, Lk, D)

Segformer's efficient self-attention attends every token of a stage
(up to 20,480 at 512x640) to a spatially reduced K/V (320 tokens there).
The forward kernel (``csrc/short_kv_attention.cu``) replaces the TPU
kernel ``py4cast_tpu/ops/attention.py::_fwd_kernel``, the backward kernel
(``csrc/short_kv_attention_bwd.cu``) its ``_bwd_kernel``; each source says
what bounds it on the H100 and what its design does about it. On a CUDA
tensor ``fused_short_kv_attention`` and ``fused_short_kv_attention_bwd``
launch their kernel or raise; on a CPU tensor they run the plain
versions, which are also what the kernels are held against on the card.
Models call ``dot_product_attention_short_kv`` (the JAX package's
``(B, L, H, D)`` entry), which goes through ``ShortKVAttentionFn``.
Each wrapper checks its arguments, casts them to fp32 and calls a
``torch.library`` custom op (``p4t::short_kv_attention_fwd``,
``p4t::short_kv_attention_bwd``): its CPU implementation is the plain
version, its CUDA implementation the kernel's launch, and its fake
implementation gives the outputs' shapes alone, so that
``torch.export`` and ``torch.utils.flop_counter`` see the op
(``ops/flops.py`` gives its FLOP formula).

The JAX package gates its kernel on the TPU, on a K/V length that fits
VMEM and on spatial sharding; the port has none of that: on the card it
always takes the kernels, whose K/V tiles pass through shared memory, so
no length caps Lk.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from py4cast_tpu_torch.ops import _build

#: the kernels hold a row's channels in registers, 16 a lane, up to
#: eight lanes a row
MAX_HEAD_DIM = 128
#: streaming multiprocessors of the H100 the grids are sized for
NUM_SMS = 132
#: keys a split of the forward (and of the backward's dq pass) takes from
#: one shared-memory stage (``BK`` in ``csrc/attention_tiles.cuh``)
FWD_KEY_TILE = 8
#: query rows a tile of the backward's dK/dV walk (``BM`` of ``DkvShape``
#: in ``csrc/short_kv_attention_bwd.cu``)
BWD_QUERY_TILE = 64
#: the fewest blocks the dK/dV pass's grid should have: at most 4 of the
#: 132 SMs idle
BWD_MIN_BLOCKS = 128
#: the dK/dV partials (one a query split) stay under this. At D <= 32 a
#: grid has at most 2 NUM_SMS = 264 blocks, and a key tile's dk and dv take
#: 2 x 64 x 32 floats: 4.3 MB. At D > 32 there are more splits than one
#: only while key tiles x BH < BWD_MIN_BLOCKS, so splits x key tiles x BH
#: < 2 BWD_MIN_BLOCKS = 256, and a key tile's dk and dv take 2 x BN x D
#: <= 2 x 4,096 floats (``bwd_launch_shape``): 8 MiB.
MAX_BWD_PARTIAL_BYTES = 8 << 20
_MAX_GRID_Y = 65535


def short_kv_attention_plain(q, k, v, scale):
    """softmax(q·kᵀ·scale)·v in plain PyTorch (explicit einsum, softmax,
    einsum), as the TPU ``_fwd_kernel`` computes it."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)


def short_kv_attention_bwd_plain(q, k, v, do, scale):
    """The attention's backward in plain PyTorch: the formulas of the TPU
    ``_bwd_kernel`` (P recomputed, dS = P ∘ (dP − rowsum(dP ∘ P))).
    Returns ``(dq, dk, dv)``. Works in any float dtype (the card's check
    runs it in fp64 too)."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = scale * torch.einsum("bqk,bkd->bqd", ds, k)
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return dq, dk, dv


def _lib():
    lib = _build.load("short_kv_attention")
    fn = lib.p4t_short_kv_attention_fwd
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        attrs = lib.p4t_short_kv_attention_fwd_attributes
        attrs.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


def lanes_per_row(d) -> int:
    """T, the forward's lanes a query row: 16 channels each, 1, 2, 4 or 8."""
    return 1 if d <= 16 else 2 if d <= 32 else 4 if d <= 64 else 8


def fwd_launch_shape(bh, lq, lk, d) -> tuple:
    """``(rows, splits)`` of the forward kernel for a call: R, the query
    rows a thread holds, and S, the key splits (one warp each) of a block
    of 32·R/T rows (T = ``lanes_per_row(d)``). Each K/V float a lane
    reads feeds R FMAs, so R = 2 unless that leaves more than half the
    SMs without a block (then R = 1, on a grid of fewer blocks than SMs:
    the kernel's R = 1 instances are built for one block an SM). S = 4,
    or 8 where the blocks are
    fewer than the SMs and each split keeps at least two key tiles
    (S·T within 32: the K/V ring's shared memory). Depends on the shape
    alone, so a call repeats bit for bit."""
    t = lanes_per_row(d)

    def blocks(rows):
        return bh * -(-lq // (rows * 32 // t))

    rows = 2 if blocks(2) >= NUM_SMS // 2 else 1
    tiles = -(-lk // FWD_KEY_TILE)
    splits = 8 if blocks(rows) < NUM_SMS and 8 * t <= 32 and tiles >= 16 else 4
    return rows, splits


def fwd_kernel_attributes(d, rows, splits) -> dict:
    """The forward kernel that ``(d, rows, splits)`` launches, as the
    card reports it: registers a thread, local (spill) bytes a thread,
    dynamic shared memory, resident blocks an SM. Needs the card."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.p4t_short_kv_attention_fwd_attributes(d, rows, splits, out),
                 "short_kv_attention attributes")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3]}


def bwd_blocks_per_sm(d) -> int:
    """Blocks of the dK/dV pass an SM holds at once: 2 at D <= 32 (128
    registers, 97 KB of shared memory each), else 1."""
    return 2 if d <= 32 else 1


def bwd_launch_shape(bh, lq, lk, d) -> tuple:
    """``(rows, splits, key_tile, query_splits)`` of the backward's two
    kernels for a call. The dq pass, query-major, takes the forward's
    ``(rows, splits)`` (``fwd_launch_shape``). The dK/dV pass, key-major,
    runs a grid of ceil(Lk / key_tile) key tiles x query_splits x BH
    blocks, each walking its run of the ceil(Lq / 64) query tiles:
    query_splits is the most whose blocks all fit on the card at once
    (``bwd_blocks_per_sm``), but at least as many as give BWD_MIN_BLOCKS
    blocks, and at most one a query tile. Depends on the shape alone, so
    a call repeats bit for bit."""
    rows, splits = fwd_launch_shape(bh, lq, lk, d)
    # keys a dK/dV block holds: 32 at D > 64, where its 4 x 4 patches of
    # dK and dV already cover the 256 threads
    bn = 32 if d > 64 else 64
    blocks = bh * -(-lk // bn)
    fill = NUM_SMS * bwd_blocks_per_sm(d) // blocks
    query_splits = min(-(-lq // BWD_QUERY_TILE), max(1, fill, -(-BWD_MIN_BLOCKS // blocks)))
    return rows, splits, bn, query_splits


def _bwd_lib():
    lib = _build.load("short_kv_attention_bwd")
    fn = lib.p4t_short_kv_attention_bwd
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        attrs = lib.p4t_short_kv_attention_bwd_attributes
        attrs.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return lib


def bwd_kernel_attributes(d, rows, splits) -> dict:
    """The backward's two kernels that ``(d, rows, splits)`` launches, as
    the card reports them: ``{"dq": ..., "dkdv": ...}``, each with
    registers a thread, local (spill) bytes a thread, dynamic shared
    memory and resident blocks an SM. Needs the card."""
    lib = _bwd_lib()
    out = (ctypes.c_int * 8)()
    _build.check(lib, lib.p4t_short_kv_attention_bwd_attributes(d, rows, splits, out),
                 "short_kv_attention_bwd attributes")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {"dq": dict(zip(keys, out[:4])), "dkdv": dict(zip(keys, out[4:]))}


def _validate(what, q, k, v, extra=None):
    """The checks the forward and the backward wrapper share."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"{what}: q and k must be (BH, L, D), got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    bh, lq, d = q.shape
    lk = k.shape[1]
    shapes = {"q": (q, (bh, lq, d)), "k": (k, (bh, lk, d)), "v": (v, (bh, lk, d))}
    shapes.update(extra(bh, lq, lk, d) if extra else {})
    _build.validate(what, shapes)
    if min(bh, lq, lk, d) < 1:
        raise ValueError(f"{what}: empty input (BH, Lq, Lk, D) = {(bh, lq, lk, d)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what} supports head dims up to {MAX_HEAD_DIM}, got {d}")
    if bh > _MAX_GRID_Y:
        raise ValueError(f"{what} supports BH up to {_MAX_GRID_Y} (one grid row each), "
                         f"got {bh}")


def fused_short_kv_attention(q, k, v, scale):
    """``(o, lse)``: softmax(q·kᵀ·scale)·v for q (BH, Lq, D) and k, v
    (BH, Lk, D), and the row logsumexp of q·kᵀ·scale (BH, Lq), which the
    backward takes as its residual. Any BH, Lq and Lk, D at most 128,
    everything fp32 or bf16 and contiguous. bf16 is cast to fp32 at the
    boundary and o rounded to q's dtype, as the TPU kernel rounds it; lse
    stays fp32. The outputs carry no gradient: differentiate through
    ``ShortKVAttentionFn``."""
    o, lse = _short_kv_attention_fp32(q, k, v, scale)
    return o.to(q.dtype), lse


def _short_kv_attention_fp32(q, k, v, scale):
    """``fused_short_kv_attention`` before o is rounded: o in fp32."""
    _validate("fused_short_kv_attention", q, k, v)
    return short_kv_attention_fwd(q.float(), k.float(), v.float(), float(scale))


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count)
fused_short_kv_attention.launches = 0


@torch.library.custom_op("p4t::short_kv_attention_fwd", mutates_args=(), device_types="cpu")
def short_kv_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``p4t::short_kv_attention_fwd``: (o, lse) in fp32 for the fp32
    q, k, v ``fused_short_kv_attention`` has checked. Its CPU
    implementation is ``short_kv_attention_plain`` and the logsumexp of
    the logits; on the card it launches the forward kernel."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    return short_kv_attention_plain(q, k, v, scale), torch.logsumexp(s, dim=-1)


@short_kv_attention_fwd.register_kernel("cuda")
def _short_kv_attention_fwd_cuda(q, k, v, scale):
    bh, lq, d = q.shape
    lk = k.shape[1]
    device = q.device
    rows, splits = fwd_launch_shape(bh, lq, lk, d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, lq), device=device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_short_kv_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, lq, lk, d, float(scale), rows, splits, stream,
        )
    _build.check(lib, status, "short_kv_attention kernel")
    fused_short_kv_attention.launches += 1
    return o, lse


@short_kv_attention_fwd.register_fake
def _short_kv_attention_fwd_fake(q, k, v, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:2])


def fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale):
    """The attention's backward: ``(dq, dk, dv)`` for the cotangent do
    (BH, Lq, D) of o, given the forward's o and lse. The forward's
    checks; bf16 is cast to fp32 at the boundary, and dq is rounded to
    q's dtype, dk and dv to k's and v's, as the TPU kernel rounds them
    (o should be the forward's fp32 o: the card's kernel takes delta =
    rowsum(dO ∘ o) from it). On the card: a dq pass, which also writes
    delta into a (BH, Lq) scratch, then a dK/dV pass on the launch shape
    of ``bwd_launch_shape``, whose query splits' partials (if more than
    one) a third kernel adds in split order: a call repeats bit for
    bit."""
    _validate(
        "fused_short_kv_attention_bwd", q, k, v,
        lambda bh, lq, lk, d: {"o": (o, (bh, lq, d)), "lse": (lse, (bh, lq)),
                               "do": (do, (bh, lq, d))},
    )
    dtypes = q.dtype, k.dtype, v.dtype
    dq, dkv = short_kv_attention_bwd(*(t.float() for t in (q, k, v, o, lse, do)),
                                     float(scale))
    return tuple(g.to(dt) for g, dt in zip((dq, dkv[0], dkv[1]), dtypes))


#: kernel launches since the last reset (a CPU call runs the plain
#: version and does not count)
fused_short_kv_attention_bwd.launches = 0


@torch.library.custom_op("p4t::short_kv_attention_bwd", mutates_args=(), device_types="cpu")
def short_kv_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``p4t::short_kv_attention_bwd``: (dq, dkv) in fp32 for the fp32
    arguments ``fused_short_kv_attention_bwd`` has checked, dkv (2, BH,
    Lk, D) holding dk then dv (one buffer: an op's outputs may not alias
    one another). Its CPU implementation is
    ``short_kv_attention_bwd_plain``; on the card it launches the
    backward kernels."""
    dq, dk, dv = short_kv_attention_bwd_plain(q, k, v, do, scale)
    return dq, torch.stack([dk, dv])


@short_kv_attention_bwd.register_kernel("cuda")
def _short_kv_attention_bwd_cuda(q, k, v, o, lse, do, scale):
    bh, lq, d = q.shape
    lk = k.shape[1]
    device = q.device
    rows, splits, key_tile, query_splits = bwd_launch_shape(bh, lq, lk, d)
    dq = torch.empty_like(q)
    dkv = torch.empty((2, bh, lk, d), device=device, dtype=torch.float32)
    delta = torch.empty((bh, lq), device=device, dtype=torch.float32)
    # one fp32 partial of dK and dV a query split, when there are several
    partial = (torch.empty((query_splits, 2, bh, lk, d), device=device, dtype=torch.float32)
               if query_splits > 1 else None)
    lib = _bwd_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.p4t_short_kv_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            None if partial is None else partial.data_ptr(), dkv.data_ptr(),
            bh, lq, lk, d, float(scale), rows, splits, key_tile, query_splits, stream,
        )
    _build.check(lib, status, "short_kv_attention_bwd kernel")
    fused_short_kv_attention_bwd.launches += 1
    return dq, dkv


@short_kv_attention_bwd.register_fake
def _short_kv_attention_bwd_fake(q, k, v, o, lse, do, scale):
    return torch.empty_like(q), k.new_empty((2, *k.shape))


class ShortKVAttentionFn(torch.autograd.Function):
    """``fused_short_kv_attention`` with its backward kernel as the
    gradient: ``ShortKVAttentionFn.apply(q, k, v, scale)`` returns o.
    It saves the fp32 o (for bf16 inputs, o before rounding), so that
    the backward's delta is the TPU kernel's. Both directions go
    through the wrappers' custom ops (``p4t::short_kv_attention_fwd``,
    ``p4t::short_kv_attention_bwd``): the kernels on CUDA tensors, the
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _short_kv_attention_fp32(q, k, v, scale)
        ctx.scale = float(scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o.to(q.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        dq, dk, dv = fused_short_kv_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                                  ctx.scale)
        return dq, dk, dv, None


def short_kv_attention(q, k, v, scale):
    """Differentiable softmax(q·kᵀ·scale)·v on (BH, Lq, D) / (BH, Lk, D)."""
    return ShortKVAttentionFn.apply(q, k, v, scale)


def dot_product_attention_short_kv(q, k, v):
    """The JAX package's entry: (B, L, H, D) q, k, v (k and v of length
    Lk), scale 1/sqrt(D), returns (B, Lq, H, D)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]

    def heads_first(t, n):
        return t.permute(0, 2, 1, 3).reshape(b * h, n, d).contiguous()

    of = short_kv_attention(heads_first(q, lq), heads_first(k, lk), heads_first(v, lk),
                            1.0 / math.sqrt(d))
    return of.reshape(b, h, lq, d).permute(0, 2, 1, 3)
