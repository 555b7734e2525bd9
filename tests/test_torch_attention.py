"""The port's short-KV attention against the JAX package on the CPU: the
plain forward against the Pallas kernel in interpret mode and against
``flax.linen.dot_product_attention``; the gradients of
``ShortKVAttentionFn`` on CPU tensors (plain backward) against
``jax.grad`` of the interpret-mode kernel; the (B, L, H, D) entry; and
the wrappers' checks.

Bars: forward 1e-5 (the same fp32 products, another summation order);
gradients 2e-4 of the largest JAX value (absolute below 1), the JAX
kernel tests' gradient bar (tests/test_stencil_kernel.py)."""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.ops import attention as jax_attention
from py4cast_tpu_torch.ops import attention
from py4cast_tpu_torch.ops.attention import (
    ShortKVAttentionFn,
    dot_product_attention_short_kv,
    fused_short_kv_attention,
    fused_short_kv_attention_bwd,
    short_kv_attention_bwd_plain,
    short_kv_attention_plain,
)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_BAR = 2e-4
#: (BH, Lq, Lk, D): the JAX kernel test's shape (Lq not a block
#: multiple), Segformer's head dim 32 with Lk > 1, and the tiny
#: Segformer of tests/test_models.py (Lk 4 at stage 1 of a 32x32 grid)
SHAPES = [(3, 300, 64, 32), (2, 80, 20, 32), (2, 16, 4, 8)]


def _qkv(bh, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, lq, d), (bh, lk, d), (bh, lk, d))]


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_plain_forward_matches_the_pallas_kernel(bh, lq, lk, d):
    q, k, v = _qkv(bh, lq, lk, d)
    scale = 1.0 / d ** 0.5
    want = jax_attention.short_kv_attention(q, k, v, scale, 128, True)  # interpret mode
    got = short_kv_attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_plain_forward_matches_flax(bh, lq, lk, d):
    """Heads as a batch of one head each, flax's (B, L, H, D) layout."""
    q, k, v = _qkv(bh, lq, lk, d, seed=1)
    want = flax_nn.dot_product_attention(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
    got = short_kv_attention_plain(*map(torch.from_numpy, (q, k, v)), 1.0 / d ** 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_function_gradients_match_the_pallas_kernel(bh, lq, lk, d):
    """jax.grad through the interpret-mode kernel (its custom VJP, the
    Pallas backward) against ShortKVAttentionFn on CPU tensors."""
    q, k, v = _qkv(bh, lq, lk, d, seed=2)
    g = np.random.default_rng(3).standard_normal((bh, lq, d)).astype(np.float32)
    scale = 1.0 / d ** 0.5

    def loss(q, k, v):
        return jnp.sum(jax_attention.short_kv_attention(q, k, v, scale, 128, True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ShortKVAttentionFn.apply(tq, tk, tv, scale)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got, want):
        _close(a.numpy(), b, GRAD_BAR, f"d{name}")


#: (BH, Lq, Lk, D) at UNetRPP's new head dims (8 at its encoder's first
#: stage, 16 at the second, 128 in the decoder's deepest block) and its
#: K/V lengths (projections of 4 tokens on Dummy's deepest stage, 32 and
#: 64 at full size); Lq not a multiple of the TPU kernel's block
EPA_SHAPES = [(2, 40, lk, d) for d in (8, 16, 128) for lk in (4, 32, 64)]


@pytest.mark.parametrize("bh,lq,lk,d", EPA_SHAPES)
def test_plain_matches_the_pallas_kernel_at_unetrpp_head_dims(bh, lq, lk, d):
    """The plain forward and ShortKVAttentionFn's gradients on CPU
    tensors against the interpret-mode kernel and jax.grad through it,
    at the bars above."""
    q, k, v = _qkv(bh, lq, lk, d, seed=d + lk)
    g = np.random.default_rng(d).standard_normal((bh, lq, d)).astype(np.float32)
    scale = 1.0 / d ** 0.5

    def loss(q, k, v):
        return jnp.sum(jax_attention.short_kv_attention(q, k, v, scale, 128, True) * g)

    want = jax_attention.short_kv_attention(q, k, v, scale, 128, True)
    got = short_kv_attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ShortKVAttentionFn.apply(tq, tk, tv, scale)
    got_grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got_grads, want_grads):
        _close(a.numpy(), b, GRAD_BAR, f"d{name}")


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """The hand-written formulas against autograd, in fp64."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in _qkv(2, 40, 7, 16, 4))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 40, 16)))
    out = short_kv_attention_plain(q, k, v, 0.3)
    want = torch.autograd.grad((out * do).sum(), (q, k, v))
    got = short_kv_attention_bwd_plain(q.detach(), k.detach(), v.detach(), do, 0.3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_bhld_entry_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 300, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    want = jax_attention.dot_product_attention_short_kv(q, k, v, interpret=True)
    got = dot_product_attention_short_kv(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 300, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_cpu_wrappers_run_the_plain_versions_uncounted():
    q, k, v = map(torch.from_numpy, _qkv(2, 50, 9, 24, 7))
    before = (fused_short_kv_attention.launches, fused_short_kv_attention_bwd.launches)
    o, lse = fused_short_kv_attention(q, k, v, 0.2)
    torch.testing.assert_close(o, short_kv_attention_plain(q, k, v, 0.2), rtol=0, atol=0)
    torch.testing.assert_close(
        lse, torch.logsumexp(torch.einsum("bqd,bkd->bqk", q, k) * 0.2, dim=-1))
    do = torch.ones_like(q)
    for a, b in zip(fused_short_kv_attention_bwd(q, k, v, o, lse, do, 0.2),
                    short_kv_attention_bwd_plain(q, k, v, do, 0.2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (fused_short_kv_attention.launches,
            fused_short_kv_attention_bwd.launches) == before


@pytest.mark.parametrize("case,match", [
    ("wide", "head dims up to 128"),
    ("fp64", "float32"),
    ("kv_mismatch", "expected"),
    ("empty", "empty"),
    ("rank", r"\(BH, L, D\)"),
])
def test_wrappers_refuse_what_the_kernels_cannot_take(case, match):
    q, k, v = map(torch.from_numpy, _qkv(2, 8, 3, 16))
    if case == "wide":
        q, k, v = torch.zeros(1, 4, 129), torch.zeros(1, 2, 129), torch.zeros(1, 2, 129)
    elif case == "fp64":
        q = q.double()
    elif case == "kv_mismatch":
        v = v[:, :2].contiguous()
    elif case == "empty":
        q = torch.zeros(2, 0, 16)
    elif case == "rank":
        q = q[0]
    with pytest.raises(ValueError, match=match):
        fused_short_kv_attention(q, k, v, 0.25)


#: (BH, Lq, Lk, D) -> the backward's (rows, splits, key tile, query
#: splits): the four Segformer stages at 512x640 and phase 3c's long K/V,
#: then each side of every boundary where the choice changes (the dq
#: pass's (rows, splits) are the forward's, tested above): one query tile
#: or two; at D <= 32 (two blocks an SM) 132 key tiles x BH or 133, at
#: D > 32 127 or 128 (BWD_MIN_BLOCKS); D 64 or 65 (the key tile)
BWD_LAUNCH_SHAPES = [
    ((1, 20480, 320, 32), (2, 4, 64, 52)),   # 5 key tiles x 52 splits: 260 blocks
    ((2, 5120, 320, 32), (2, 4, 64, 26)),
    ((5, 1280, 320, 32), (2, 4, 64, 10)),
    ((8, 320, 320, 32), (2, 8, 64, 5)),      # one split a query tile
    ((2, 2048, 4097, 64), (2, 4, 64, 1)),    # 2 x 65 key tiles: no partial
    ((1, 64, 320, 32), (1, 8, 64, 1)),       # one query tile: one split
    ((1, 65, 320, 32), (1, 8, 64, 2)),
    ((2, 2048, 4224, 32), (2, 8, 64, 2)),    # 2 x 66 key tiles: 264 blocks fit
    ((2, 2048, 4225, 32), (2, 8, 64, 1)),    # 2 x 67
    ((1, 2048, 8128, 64), (2, 8, 64, 2)),    # 127 key tiles
    ((1, 2048, 8129, 64), (2, 8, 64, 1)),    # 128
    ((1, 2048, 4064, 128), (2, 4, 32, 2)),   # 127 key tiles of 32
    ((1, 2048, 4065, 128), (2, 4, 32, 1)),
    ((1, 700, 320, 64), (1, 8, 64, 11)),     # 64 keys a block
    ((1, 700, 320, 65), (2, 4, 32, 11)),     # 32 keys a block at D > 64
    ((3, 7, 2, 128), (1, 4, 32, 1)),
]


@pytest.mark.parametrize("shape,want", BWD_LAUNCH_SHAPES)
def test_backward_launch_shape(shape, want):
    assert attention.bwd_launch_shape(*shape) == want


def test_backward_launch_shapes_are_ones_the_kernels_have():
    """Every choice is an instance of the two kernels (the dq pass's
    (rows, splits) as the forward's; a key tile of 32 at D > 64, else
    64), gives the dK/dV pass at least min(BWD_MIN_BLOCKS, possible)
    blocks (possible: one a key tile and query tile), never more splits
    than query tiles, more than one only where they all fit on the card
    at once or are the fewest that reach BWD_MIN_BLOCKS, and keeps the
    partials under MAX_BWD_PARTIAL_BYTES."""
    rng = np.random.default_rng(1)
    for _ in range(3000):
        bh = int(rng.integers(1, 200))
        lq, lk = (int(x) for x in 10 ** rng.uniform(0, [5.5, 4.5]))
        d = int(rng.integers(1, attention.MAX_HEAD_DIM + 1))
        rows, splits, bn, qs = attention.bwd_launch_shape(bh, lq, lk, d)
        assert (rows, splits) == attention.fwd_launch_shape(bh, lq, lk, d)
        assert bn == (32 if d > 64 else 64)
        q_tiles, key_tiles = -(-lq // attention.BWD_QUERY_TILE), -(-lk // bn)
        assert 1 <= qs <= q_tiles
        blocks = bh * key_tiles * qs
        assert blocks >= min(attention.BWD_MIN_BLOCKS, bh * key_tiles * q_tiles)
        fits = blocks <= attention.NUM_SMS * attention.bwd_blocks_per_sm(d)
        assert qs == 1 or fits or bh * key_tiles * (qs - 1) < attention.BWD_MIN_BLOCKS
        partial_bytes = 0 if qs == 1 else qs * 2 * bh * lk * d * 4
        assert partial_bytes <= attention.MAX_BWD_PARTIAL_BYTES


#: (BH, Lq, Lk, D) -> the forward's (rows a thread, key splits): the
#: four Segformer stages at 512x640, then each side of every boundary
#: where the choice changes, for each count of lanes a row (D <= 16,
#: <= 32, <= 64, <= 128)
FWD_LAUNCH_SHAPES = [
    ((1, 20480, 320, 32), (2, 4)),
    ((2, 5120, 320, 32), (2, 4)),
    ((5, 1280, 320, 32), (2, 4)),
    ((8, 320, 320, 32), (2, 8)),
    ((1, 4224, 320, 32), (2, 4)),      # 132 blocks of 32 rows: one an SM
    ((1, 4192, 320, 32), (2, 8)),      # 131
    ((1, 4192, 128, 32), (2, 8)),      # 16 key tiles: two for each of 8 splits
    ((1, 4192, 120, 32), (2, 4)),      # 15
    ((1, 2112, 320, 32), (2, 8)),      # 66 blocks: half the SMs
    ((1, 2080, 320, 32), (1, 8)),      # 65: 16 rows a block
    ((1, 2080, 120, 32), (1, 4)),
    ((1, 5, 320, 32), (1, 8)),         # fewer rows than one block
    ((2, 10, 3, 32), (1, 4)),          # one key tile: three splits see no key
    ((1, 40, 257, 32), (1, 8)),        # 33 tiles: split 7 sees no key
    ((1, 8448, 320, 16), (2, 4)),
    ((1, 8384, 320, 16), (2, 8)),
    ((1, 4160, 320, 8), (1, 8)),
    ((1, 2112, 320, 64), (2, 4)),
    ((1, 1040, 320, 64), (1, 8)),      # S * T reaches 32
    ((1, 528, 320, 100), (2, 4)),      # T = 8: no more than 4 splits
    ((1, 520, 320, 128), (1, 4)),
    ((3, 7, 2, 128), (1, 4)),
]


@pytest.mark.parametrize("shape,want", FWD_LAUNCH_SHAPES)
def test_forward_launch_shape(shape, want):
    assert attention.fwd_launch_shape(*shape) == want


def test_forward_launch_shapes_are_ones_the_kernel_has():
    """Every choice is one of the kernel's instances: (R, S) in (2, 4),
    (2, 8), (1, 4), (1, 8), with S * T <= 32."""
    rng = np.random.default_rng(0)
    for _ in range(2000):
        bh, lq, lk = (int(x) for x in rng.integers(1, [64, 40000, 5000]))
        d = int(rng.integers(1, attention.MAX_HEAD_DIM + 1))
        rows, splits = attention.fwd_launch_shape(bh, lq, lk, d)
        assert (rows, splits) in {(2, 4), (2, 8), (1, 4), (1, 8)}
        assert splits * attention.lanes_per_row(d) <= 32
