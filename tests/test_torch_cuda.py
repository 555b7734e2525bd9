"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at widths and shapes beyond the main path's (every template
instance, ragged cell counts, batch > 1), forward and backward, and the
autograd Functions on the card against the CPU. Needs an NVIDIA card
and nvcc: every test carries the ``cuda`` marker and skips without a
CUDA device. On the card, run without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from py4cast_tpu_torch.models import graph as graph_models
from py4cast_tpu_torch.models.graph import _corners_rc
from py4cast_tpu_torch.ops import attention, hop_kernel, stencil_kernel
from py4cast_tpu_torch.ops.attention import (
    ShortKVAttentionFn,
    fused_short_kv_attention,
    fused_short_kv_attention_bwd,
    short_kv_attention_bwd_plain,
    short_kv_attention_plain,
)
from py4cast_tpu_torch.ops.hop_kernel import (
    CornerHopFn,
    corner_hop_bwd_plain,
    corner_hop_plain,
    fused_corner_hop,
    fused_corner_hop_bwd,
    gather_corners,
)
from py4cast_tpu_torch.ops.lattice_ops import sel_matrix
from py4cast_tpu_torch.ops.stencil_kernel import (
    StencilMessageFn,
    fused_stencil_message,
    fused_stencil_message_bwd,
    stencil_message_bwd_plain,
    stencil_message_plain,
)

pytestmark = pytest.mark.cuda

#: fp32 sums in another order than the plain version's matmuls
TOL = dict(rtol=1e-4, atol=1e-4)
#: gradients: the JAX kernel tests' bar (tests/test_stencil_kernel.py),
#: relative to the largest reference value (or absolute below 1); the
#: reference is the plain backward in fp64, so that the weight gradients'
#: sums over every cell are not held to one fp32 summation order
GRAD_BAR = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    ).cuda()


def _stencil_fwd_args(rng, b, hr, w, f_in, h):
    """The forward's arguments: e, ps (the source projection the kernel
    shifts itself), pd, mask and the weights."""
    return (
        _rand(rng, b, 8, hr, w, f_in), _rand(rng, b, hr, w, h), _rand(rng, b, hr, w, h),
        torch.from_numpy((rng.uniform(size=(8, hr, w, 1)) > 0.3).astype(np.float32)).cuda(),
        _rand(rng, f_in, h, scale=f_in ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )


@pytest.mark.parametrize("b,hr,w,f_in,h,residual", [
    (1, 125, 125, 64, 64, True),   # GraphLAM level 0
    (2, 7, 9, 16, 16, True),       # one lane word, ragged cell count
    (3, 5, 4, 24, 40, False),      # edge width != hidden width
    (1, 6, 6, 96, 96, True),
    (2, 3, 5, 128, 128, False),
    (1, 4, 4, 8, 128, False),
    (1, 63, 63, 64, 64, True),     # GraphLAM level 1
    (1, 32, 32, 64, 64, True),     # GraphLAM level 2
    (1, 1, 1, 64, 64, True),       # one cell: every shift falls off the lattice
    (1, 1, 5, 64, 64, False),      # one row: the vertical shifts fall off
    (2, 2, 3, 32, 32, True),       # B = 2: a tile spans both batch entries
    (1, 3, 3, 64, 64, False),      # one cell past a tile (8 cells at width 64)
    (1, 1, 17, 32, 32, True),      # one cell past a tile (16 cells at width 32)
    (1, 9, 1, 128, 128, True),     # one cell past a tile (8 cells at width 128)
    (1, 4, 5, 30, 30, True),       # widths not a multiple of 4: no 128-bit loads
    (2, 3, 7, 6, 10, False),       # F != h, neither a multiple of 4
    (1, 5, 6, 126, 126, True),     # width 128's instance, not a multiple of 4
    (1, 125, 125, 256, 256, True), # the wide instance (HP 256) at GraphLAM level 0
    (1, 5, 6, 130, 130, True),     # the wide instance, not a multiple of 4
    (2, 3, 5, 256, 256, False),
    (1, 4, 5, 200, 140, False),    # F != h, the wide instance
    (1, 2, 3, 100, 300, False),    # F < h, HP 512
    (1, 9, 1, 256, 256, True),     # one cell past a tile (4 cells at HP 256)
    (1, 3, 3, 512, 512, True),     # the widest the card takes
    (1, 4, 5, 250, 250, True),     # HP 256, not a multiple of 4
])
def test_stencil_kernel_matches_plain(cuda, b, hr, w, f_in, h, residual):
    rng = np.random.default_rng(h + f_in)
    args = _stencil_fwd_args(rng, b, hr, w, f_in, h)
    before = fused_stencil_message.launches
    got = fused_stencil_message(*args, residual=residual)
    torch.cuda.synchronize()
    assert fused_stencil_message.launches == before + 1
    want = stencil_message_plain(*args, residual=residual)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, **TOL)
    # agg sums each cell's 8 rows in a fixed order: bit for bit again
    again = fused_stencil_message(*args, residual=residual)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


def test_stencil_kernels_do_not_spill(cuda):
    """Every instance of the stencil forward (widths up to 32, 64 and
    128; the wide instance at 256 and 512) keeps its state in registers
    and fits a block an SM (-s prints each instance's attributes)."""
    for width in (32, 64, 128, 256, 512):
        a = stencil_kernel.fwd_kernel_attributes(width, width)
        print(f"stencil_message forward width<={width}: {a}")
        assert a["local_bytes"] == 0, (width, a)
        assert a["blocks_per_sm"] >= 1, (width, a)


def _hop_weights(rng, b, hr, w, h, ff):
    """vd, feats and the weights of the corner hop."""
    return (
        _rand(rng, b, hr, w, h), _rand(rng, 4, hr, w, ff, scale=0.5),
        _rand(rng, ff, h, scale=ff ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, h, scale=h ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=(2 * h) ** -0.5), _rand(rng, h, h, scale=(2 * h) ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )


def _hop_fwd_args(rng, b, hr, w, h, ff):
    """The forward's source: (ps, rows, cols, ar, ac) for an hr x w grid
    over a mesh level 0 coarsened by 4 as GraphLAM's (at least 2x2), and
    vd, feats and the weights."""
    coarse = (max(2, hr // 4), max(2, w // 4))
    (r0, r1), (c0, c1) = _corners_rc((hr, w), coarse)
    rows = np.stack([r0, r1]).astype(np.int32)
    cols = np.stack([c0, c1]).astype(np.int32)
    src = (
        _rand(rng, b, *coarse, h),
        torch.from_numpy(rows).cuda(), torch.from_numpy(cols).cuda(),
        torch.from_numpy(np.stack([sel_matrix(r, coarse[0]) for r in rows])).cuda(),
        torch.from_numpy(np.stack([sel_matrix(c, coarse[1]) for c in cols])).cuda(),
    )
    return src, _hop_weights(rng, b, hr, w, h, ff)


@pytest.mark.parametrize("b,hr,w,h,ff,mean", [
    (1, 500, 500, 64, 3, False),   # GraphLAM grid
    (2, 7, 11, 16, 3, True),
    (1, 9, 5, 80, 2, False),
    (3, 4, 6, 96, 5, True),        # the widest the hop takes
    (1, 3, 5, 64, 3, False),       # fewer cells than one tile (64 at width 64)
    (1, 5, 13, 64, 3, True),       # one cell past a tile
    (1, 1, 129, 32, 3, False),     # one cell past a tile (128 at width 32)
    (2, 5, 9, 64, 3, False),       # B = 2: a tile spans both batch entries
    (1, 6, 7, 30, 3, True),        # width not a multiple of 4: no 128-bit loads
    (1, 9, 9, 64, 1, False),       # one corner feature
    (1, 5, 7, 32, 32, False),      # the most corner features the kernel takes
    (1, 7, 9, 66, 3, False),       # width 65-96's warp-row instance, not a multiple of 4
    (1, 500, 500, 128, 3, False),  # the wide instance (HP 128) at the GraphLAM grid
    (1, 9, 5, 100, 3, False),      # the wide instance, HP 128
    (2, 7, 6, 130, 3, True),       # HP 256, not a multiple of 4
    (1, 1, 65, 128, 3, False),     # one cell past a tile (64 at HP 128)
    (1, 5, 5, 256, 3, False),
    (1, 7, 9, 250, 3, True),       # HP 256, not a multiple of 4
    (1, 4, 4, 512, 2, True),       # the widest the card takes
])
def test_hop_kernel_matches_plain(cuda, b, hr, w, h, ff, mean):
    rng = np.random.default_rng(h + ff)
    src, rest = _hop_fwd_args(rng, b, hr, w, h, ff)
    before = fused_corner_hop.launches
    got = fused_corner_hop(*src[:3], *rest, mean=mean)
    torch.cuda.synchronize()
    assert fused_corner_hop.launches == before + 1
    torch.testing.assert_close(got, corner_hop_plain(*src[:3], *rest, mean=mean), **TOL)
    # each cell's sums run in a fixed order: bit for bit again
    assert torch.equal(got, fused_corner_hop(*src[:3], *rest, mean=mean))


def test_hop_fwd_kernels_do_not_spill(cuda):
    """Every instance of the corner-hop forward (widths up to 32 and 64 on
    row tiles, up to 96 on warp rows, 128, 256 and 512 on wide rows)
    keeps its state in registers and fits a block an SM (-s prints each
    instance's attributes)."""
    for h in (32, 64, 96, 128, 256, 512):
        a = hop_kernel.fwd_kernel_attributes(h)
        print(f"corner_hop forward h<={h}: {a}")
        assert a["local_bytes"] == 0, (h, a)
        assert a["blocks_per_sm"] >= 1, (h, a)


def test_row_tiles_swizzled_reads_are_free_of_bank_conflicts(cuda):
    """row_tiles.cuh's swizzled [HP][HP] weights, read as tile_mm (X @ W)
    and tile_mm_t (X @ W^T) read them, take no longer than the plain row
    read, which no two lanes of a quarter-warp share a bank in, at HP =
    32, 64 and 128 (csrc/row_tiles_probe.cu times a block of 32 warps);
    the plain layout under the W^T pattern, which conflicts, takes at
    least twice as long, so the probe does see conflicts."""
    import ctypes

    from py4cast_tpu_torch.ops import _build

    lib = _build.load("row_tiles_probe")
    fn = lib.p4t_row_tiles_read_cycles
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1024, device="cuda")

    def measure(hp, transposed, swizzled):
        runs = []
        for _ in range(3):
            _build.check(lib, fn(hp, transposed, swizzled, cycles.data_ptr(), sink.data_ptr()),
                         "row_tiles_probe")
            torch.cuda.synchronize()
            runs.append(int(cycles.item()))
        return min(runs)

    for hp in (32, 64, 128):
        row = measure(hp, 0, 0)
        got = {"W swizzled": measure(hp, 0, 1), "W^T swizzled": measure(hp, 1, 1),
               "W^T row-major": measure(hp, 1, 0)}
        print(f"row_tiles_probe HP={hp}: W row-major {row} cycles, "
              + ", ".join(f"{name} {c}" for name, c in got.items()))
        for name in ("W swizzled", "W^T swizzled"):
            assert got[name] <= 1.15 * row, (hp, name, got, row)
        assert got["W^T row-major"] >= 2 * row, (hp, got, row)


def test_kernels_follow_the_current_stream(cuda):
    """A launch on a side stream orders with that stream's work."""
    rng = np.random.default_rng(0)
    h = 32
    args = [
        _rand(rng, 1, 8, 6, 6, h), _rand(rng, 1, 6, 6, h), _rand(rng, 1, 6, 6, h),
        torch.ones(8, 6, 6, 1, device="cuda"), _rand(rng, h, h, scale=h ** -0.5),
        _rand(rng, h), _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h),
        torch.ones(h, device="cuda"), torch.zeros(h, device="cuda"),
    ]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        args[0] = args[0] * 2.0
        got = fused_stencil_message(*args)
    torch.cuda.current_stream().wait_stream(side)
    want = stencil_message_plain(*args)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, **TOL)


def _close_to_fp64(name, got, want64):
    err = float((got.double() - want64).abs().max())
    scale = max(1.0, float(want64.abs().max()))
    assert err <= GRAD_BAR * scale, f"{name}: {err:.3e} > {GRAD_BAR} x {scale:.3g}"


def _stencil_args(rng, b, hr, w, f_in, h):
    return (
        _rand(rng, b, 8, hr, w, f_in), _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h),
        torch.from_numpy((rng.uniform(size=(8, hr, w, 1)) > 0.3).astype(np.float32)).cuda(),
        _rand(rng, f_in, h, scale=f_in ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )


def _hop_args(rng, b, hr, w, h, ff):
    """The backward's four corner upsamples psg, independent of each
    other, and vd, feats and the weights."""
    psg = [_rand(rng, b, hr, w, h) for _ in range(4)]
    return psg, _hop_weights(rng, b, hr, w, h, ff)


@pytest.mark.parametrize("b,hr,w,f_in,h,residual", [
    (1, 125, 125, 64, 64, True),   # GraphLAM level 0
    (2, 7, 9, 16, 16, True),       # one lane word, ragged cell count
    (3, 5, 4, 24, 40, False),      # edge width != hidden width
    (1, 6, 6, 64, 64, False),
    (2, 3, 5, 8, 64, False),
    (1, 63, 63, 64, 64, True),     # GraphLAM level 1
    (1, 32, 32, 64, 64, True),     # GraphLAM level 2
    (1, 2, 3, 64, 64, True),       # fewer cells than one tile (8 at width 64)
    (1, 3, 3, 64, 64, False),      # one cell past a tile
    (1, 1, 17, 32, 32, True),      # one cell past a tile (16 at width 32)
    (1, 5, 7, 64, 32, False),      # F = 64, h = 32
    (1, 5, 7, 32, 64, False),      # F = 32, h = 64
    (2, 9, 11, 64, 64, True),      # B = 2: a tile spans both batch entries
    (1, 4, 5, 30, 30, True),       # widths not a multiple of 4: no 128-bit loads
    (1, 125, 125, 128, 128, True), # the wide instance (HP 128) at GraphLAM level 0
    (1, 4, 5, 65, 65, True),       # the wide instance, not a multiple of 4
    (1, 3, 5, 100, 100, False),
    (2, 3, 4, 130, 130, True),     # HP 256, B = 2
    (1, 9, 1, 128, 128, True),     # one cell past a tile (8 cells at HP 128)
    (1, 3, 4, 96, 40, False),      # F != h, the wide instance
    (1, 3, 3, 256, 256, True),
    (1, 2, 3, 512, 512, False),    # the widest the card takes
])
def test_stencil_bwd_kernel_matches_plain(cuda, b, hr, w, f_in, h, residual):
    rng = np.random.default_rng(100 + h + f_in)
    args = _stencil_args(rng, b, hr, w, f_in, h)
    g_out, g_agg = _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h)
    before = fused_stencil_message_bwd.launches
    got = fused_stencil_message_bwd(*args, g_out, g_agg, residual=residual)
    torch.cuda.synchronize()
    assert fused_stencil_message_bwd.launches == before + 1
    want = stencil_message_bwd_plain(*(a.double() for a in args), g_out.double(),
                                     g_agg.double(), residual=residual)
    names = ("de", "dvs", "dpd", "dwe", "dbe", "dwo", "dbo", "dlns", "dlnb")
    for name, g, wnt in zip(names, got, want):
        assert g.shape == wnt.shape, name
        _close_to_fp64(name, g, wnt)
    # the weight gradients are summed in a fixed order: bit for bit again
    again = fused_stencil_message_bwd(*args, g_out, g_agg, residual=residual)
    for g, g2 in zip(got[3:], again[3:]):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("b,hr,w,h,ff,mean", [
    (1, 500, 500, 64, 3, False),   # GraphLAM grid
    (2, 7, 11, 16, 3, True),
    (1, 9, 5, 48, 2, False),
    (3, 4, 6, 64, 5, True),
    (1, 5, 7, 32, 32, False),      # the most corner features the kernel takes
    (1, 3, 5, 64, 3, False),       # fewer cells than one tile (64 at width 64)
    (1, 5, 13, 64, 3, False),      # one cell past a tile
    (1, 1, 129, 32, 3, True),      # one cell past a tile (128 at width 32)
    (2, 5, 9, 64, 3, False),       # B = 2: a tile spans both batch entries
    (1, 6, 7, 30, 3, True),        # width not a multiple of 4: no 128-bit loads
    (1, 9, 9, 64, 1, False),       # one corner feature
    (2, 8, 9, 32, 3, True),        # width 32 with mean aggregation
    (1, 9, 9, 65, 3, False),       # the wide instance (HP 128), not a multiple of 4
    (1, 7, 6, 100, 3, True),
    (1, 1, 65, 128, 3, False),     # one cell past a tile (64 at HP 128)
    (2, 5, 5, 130, 3, False),      # HP 256, B = 2
    (1, 5, 5, 256, 3, True),
    (1, 3, 4, 512, 3, False),      # the widest the card takes
])
def test_hop_bwd_kernel_matches_plain(cuda, b, hr, w, h, ff, mean):
    rng = np.random.default_rng(200 + h + ff)
    psg, rest = _hop_args(rng, b, hr, w, h, ff)
    g = _rand(rng, b, hr, w, h)
    before = fused_corner_hop_bwd.launches
    got = fused_corner_hop_bwd(psg, *rest, g, mean=mean)
    torch.cuda.synchronize()
    assert fused_corner_hop_bwd.launches == before + 1
    want = corner_hop_bwd_plain([p.double() for p in psg], *(a.double() for a in rest),
                                g.double(), mean=mean)
    assert len(got) == len(want) == 19
    for i, (gr, wnt) in enumerate(zip(got, want)):
        assert gr.shape == wnt.shape, i
        _close_to_fp64(f"hop grad {i}", gr, wnt)
    again = fused_corner_hop_bwd(psg, *rest, g, mean=mean)
    for gr, g2 in zip(got[5:], again[5:]):
        assert torch.equal(gr, g2)


def test_stencil_bwd_kernels_do_not_spill(cuda):
    """Every instance of the stencil backward (widths up to 32 and up to
    64; the wide instance at 128, 256 and 512) keeps its state in
    registers and fits a block an SM (-s prints each one's attributes)."""
    for f_in, h in ((32, 32), (64, 64), (128, 128), (256, 256), (512, 512)):
        a = stencil_kernel.bwd_kernel_attributes(f_in, h)
        print(f"stencil_message backward width<={h}: {a}")
        assert a["local_bytes"] == 0, (f_in, h, a)
        assert a["blocks_per_sm"] >= 1, (f_in, h, a)


def test_hop_bwd_kernels_do_not_spill(cuda):
    """Both passes of every instance of the corner-hop backward (widths
    up to 32 and up to 64; the wide instance at 128, 256 and 512) keep
    their state in registers and fit a block an SM (-s prints each
    one's attributes)."""
    for h in (32, 64, 128, 256, 512):
        for name, a in hop_kernel.bwd_kernel_attributes(h).items():
            print(f"corner_hop backward h<={h} {name}: {a}")
            assert a["local_bytes"] == 0, (h, name, a)
            assert a["blocks_per_sm"] >= 1, (h, name, a)


def test_bwd_kernels_raise_above_their_width_cap(cuda):
    """Past the widest the card takes (512) all four wrappers raise on the
    card, before any launch (the CPU's plain versions take any width)."""
    rng = np.random.default_rng(5)
    h = 513  # past wide_rows.cuh's MAX_HP
    args = _stencil_args(rng, 1, 2, 2, h, h)
    cot = (_rand(rng, 1, 8, 2, 2, h), _rand(rng, 1, 2, 2, h))
    before = [k.launches for k in (fused_stencil_message, fused_stencil_message_bwd,
                                   fused_corner_hop, fused_corner_hop_bwd)]
    with pytest.raises(ValueError, match="no kernel instance on the card takes widths"):
        fused_stencil_message(*_stencil_fwd_args(rng, 1, 2, 2, h, h))
    with pytest.raises(ValueError, match="no kernel instance on the card takes widths"):
        fused_stencil_message_bwd(*args, *cot)
    src, rest = _hop_fwd_args(rng, 1, 3, 3, h, 3)
    with pytest.raises(ValueError, match="no kernel instance on the card takes widths"):
        fused_corner_hop(*src[:3], *rest)
    with pytest.raises(ValueError, match="no kernel instance on the card takes widths"):
        fused_corner_hop_bwd(gather_corners(*src[:3]), *rest, _rand(rng, 1, 3, 3, h))
    assert before == [k.launches for k in (fused_stencil_message, fused_stencil_message_bwd,
                                           fused_corner_hop, fused_corner_hop_bwd)]


@pytest.mark.parametrize("h", [65, 100, 130, 256])
def test_wide_instances_match_plain(cuda, h):
    """Each of the four kernels at width h, on its wide instance where h
    is past the row-tile (and warp-row) instances' caps: a-fwd above 128,
    b-fwd above 96, a-bwd and b-bwd above 64; against its plain version
    (the backward's weight gradients against the plain backward in fp64)
    and a second call bit for bit; launches_wide counts those launches."""
    rng = np.random.default_rng(900 + h)
    wrappers = (fused_stencil_message, fused_stencil_message_bwd, fused_corner_hop,
                fused_corner_hop_bwd)
    before = [(k.launches, k.launches_wide) for k in wrappers]
    fargs = _stencil_fwd_args(rng, 1, 7, 6, h, h)
    got = fused_stencil_message(*fargs, residual=True)
    for g, want in zip(got, stencil_message_plain(*fargs, residual=True)):
        torch.testing.assert_close(g, want, **TOL)
    assert all(torch.equal(x, y) for x, y in zip(got, fused_stencil_message(*fargs, residual=True)))
    args = _stencil_args(rng, 1, 7, 6, h, h)
    cot = (_rand(rng, 1, 8, 7, 6, h), _rand(rng, 1, 7, 6, h))
    got = fused_stencil_message_bwd(*args, *cot, residual=True)
    want = stencil_message_bwd_plain(*(a.double() for a in args), *(c.double() for c in cot),
                                     residual=True)
    for name, g, w in zip(("de", "dvs", "dpd", "dwe", "dbe", "dwo", "dbo", "dlns", "dlnb"),
                          got, want):
        _close_to_fp64(name, g, w)
    again = fused_stencil_message_bwd(*args, *cot, residual=True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    src, rest = _hop_fwd_args(rng, 2, 13, 11, h, 3)
    got = fused_corner_hop(*src[:3], *rest, mean=True)
    torch.testing.assert_close(got, corner_hop_plain(*src[:3], *rest, mean=True), **TOL)
    assert torch.equal(got, fused_corner_hop(*src[:3], *rest, mean=True))
    psg, g = gather_corners(*src[:3]), _rand(rng, 2, 13, 11, h)
    got = fused_corner_hop_bwd(psg, *rest, g, mean=True)
    want = corner_hop_bwd_plain([p.double() for p in psg], *(a.double() for a in rest),
                                g.double(), mean=True)
    for i, (gr, w) in enumerate(zip(got, want)):
        _close_to_fp64(f"hop grad {i}", gr, w)
    again = fused_corner_hop_bwd(psg, *rest, g, mean=True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    torch.cuda.synchronize()
    caps = (128, 64, 96, 64)  # the sources' WIDE_ABOVE: above it the wide instance
    assert [(k.launches - n, k.launches_wide - nw) for k, (n, nw) in zip(wrappers, before)] == [
        (2, 2 * (h > cap)) for cap in caps]


def test_functions_give_the_cpu_gradients_on_the_card(cuda):
    """torch.autograd.grad through StencilMessageFn and CornerHopFn on
    the card (both kernels each way) against the same on the CPU, dps of
    each included."""
    rng = np.random.default_rng(7)
    s_args = _stencil_fwd_args(rng, 2, 9, 7, 32, 32)
    src, rest = _hop_fwd_args(rng, 2, 9, 7, 32, 3)
    s_cot = (_rand(rng, 2, 8, 9, 7, 32), _rand(rng, 2, 9, 7, 32))
    h_cot = _rand(rng, 2, 9, 7, 32)

    def grads(device):
        sa = [a.detach().to(device).requires_grad_(i != 3) for i, a in enumerate(s_args)]
        out, agg = StencilMessageFn.apply(*sa, True)
        loss = (out * s_cot[0].to(device)).sum() + (agg * s_cot[1].to(device)).sum()
        hp = src[0].detach().to(device).requires_grad_()
        maps = [t.to(device) for t in src[1:]]
        hr = [a.detach().to(device).requires_grad_(i != 1) for i, a in enumerate(rest)]
        loss = loss + (CornerHopFn.apply(hp, *maps, *hr, False) * h_cot.to(device)).sum()
        wrt = [a for i, a in enumerate(sa) if i != 3] + [hp]
        wrt += [a for i, a in enumerate(hr) if i != 1]
        return [t.cpu() for t in torch.autograd.grad(loss, wrt)]

    before = (fused_stencil_message_bwd.launches, fused_corner_hop_bwd.launches)
    on_card = grads("cuda")
    assert (fused_stencil_message_bwd.launches, fused_corner_hop_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for g, want in zip(on_card, grads("cpu")):
        scale = max(1.0, float(want.abs().max()))
        assert float((g - want).abs().max()) <= GRAD_BAR * scale


#: a whole model's gradients, card against CPU (chip_smoke.py's bar):
#: fp32 sums in another order through every layer and LayerNorm
MODEL_GRAD_BAR = 1e-3


@pytest.mark.parametrize("model,aggr", [("HiLAM", "sum"), ("HiLAMParallel", "mean")])
def test_hierarchical_models_give_the_cpu_gradients_on_the_card(cuda, model, aggr):
    """HiLAM and HiLAMParallel at a 64x64 grid (mesh lattices 16², 8²,
    4², tiles smaller than a block), 2 processor layers, h = 32: the
    output and the gradients of every parameter and of the input, on
    the card (kernels a and b each way) against the CPU. Launches: a
    stencil stage a level pair of the sweep (HiLAM) or a level
    (HiLAMParallel) a layer forward; backward only the stages whose
    outputs reach the loss (HiLAMParallel's last layer reaches level 0
    from level 0 alone, the one before from levels 0 and 1)."""
    settings = graph_models.GraphModelSettings(hidden_dims=32, processor_layers=2,
                                               mesh_aggr=aggr)
    axis = np.linspace(0, 1, 64)
    mg = np.stack(np.meshgrid(axis, axis, indexing="ij")).astype(np.float32)
    graph = graph_models.build_graph_artifacts(mg, settings)
    assert graph.level_hw == [(16, 16), (8, 8), (4, 4)]
    from py4cast_tpu_torch.training import init_weights

    cpu_model = getattr(graph_models, model)(7, 3, (4096,), settings, graph)
    init_weights(cpu_model, torch.Generator().manual_seed(0))
    card_model = getattr(graph_models, model)(7, 3, (4096,), settings, graph).to(cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(11)
    x, cot = _rand(rng, 2, 4096, 7), _rand(rng, 2, 4096, 3)

    def run(m, device):
        xi = x.to(device).requires_grad_()
        y = m(xi)
        params = list(m.parameters())
        grads = torch.autograd.grad((y * cot.to(device)).sum(), [xi] + params,
                                    allow_unused=True, materialize_grads=True)
        return [t.detach().cpu() for t in (y, *grads)]

    kernels = (fused_stencil_message, fused_corner_hop, fused_stencil_message_bwd,
               fused_corner_hop_bwd)
    before = [k.launches for k in kernels]
    on_card = run(card_model, cuda)
    stages = 2 * 2 * 2 if model == "HiLAM" else 3 * 2
    stages_bwd = stages if model == "HiLAM" else 1 + 2
    assert [k.launches - b for k, b in zip(kernels, before)] == [stages, 1, stages_bwd, 1]
    for i, (g, want) in enumerate(zip(on_card, run(cpu_model, "cpu"))):
        scale = max(1.0, float(want.abs().max()))
        bar = TOL["atol"] if i == 0 else MODEL_GRAD_BAR
        assert float((g - want).abs().max()) <= bar * scale, i


#: (BH, Lq, Lk, D): Segformer's stages 1 to 4 at 512x640, a ragged
#: Lq, K/V tiles that spill (Lk 4097), one key, every thread-slice count
#: (D 8, 32, 64, 100, 128)
ATTENTION_SHAPES = [
    (1, 20480, 320, 32),
    (2, 5120, 320, 32),
    (5, 1280, 320, 32),
    (8, 320, 320, 32),
    (2, 20481, 320, 32),
    (1, 300, 4097, 64),
    (3, 77, 1, 8),
    (2, 130, 4, 128),
    (4, 65, 33, 64),
    (1, 1, 5, 100),
    (2, 200, 4097, 128),
]


def _attention_args(rng, bh, lq, lk, d):
    return _rand(rng, bh, lq, d), _rand(rng, bh, lk, d), _rand(rng, bh, lk, d)


@pytest.mark.parametrize("bh,lq,lk,d", ATTENTION_SHAPES)
def test_attention_kernels_match_plain(cuda, bh, lq, lk, d):
    rng = np.random.default_rng(300 + d + lk)
    q, k, v = _attention_args(rng, bh, lq, lk, d)
    scale = d ** -0.5
    before = (fused_short_kv_attention.launches, fused_short_kv_attention_bwd.launches)
    o, lse = fused_short_kv_attention(q, k, v, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, short_kv_attention_plain(q, k, v, scale), **TOL)
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, dim=-1), **TOL)
    do = _rand(rng, bh, lq, d)
    got = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (fused_short_kv_attention.launches, fused_short_kv_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = short_kv_attention_bwd_plain(q.double(), k.double(), v.double(), do.double(), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        _close_to_fp64(name, g, w)
    # dk and dv are summed in a fixed order: bit for bit again
    again = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


def test_attention_function_gives_the_cpu_gradients_on_the_card(cuda):
    rng = np.random.default_rng(8)
    args = _attention_args(rng, 3, 300, 64, 32)
    cot = _rand(rng, 3, 300, 32)

    def grads(device):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        out = ShortKVAttentionFn.apply(*leaves, 32 ** -0.5)
        return [t.cpu() for t in torch.autograd.grad((out * cot.to(device)).sum(), leaves)]

    before = fused_short_kv_attention_bwd.launches
    on_card = grads("cuda")
    assert fused_short_kv_attention_bwd.launches == before + 1
    for g, want in zip(on_card, grads("cpu")):
        scale = max(1.0, float(want.abs().max()))
        assert float((g - want).abs().max()) <= GRAD_BAR * scale


#: (BH, Lq, Lk): each side of every boundary where the forward's launch
#: shape (rows a thread, key splits) changes, by lanes a row (D <= 16,
#: <= 32, <= 64, <= 128; ``fwd_launch_shape``), with fewer rows than a
#: block and splits that see no key
FWD_BOUNDARIES = {
    1: [(1, 8448, 320), (1, 8384, 320), (1, 4224, 320), (1, 4160, 320), (1, 4160, 120),
        (1, 5, 320), (2, 10, 3), (1, 40, 257)],
    2: [(1, 4224, 320), (1, 4192, 320), (1, 4192, 128), (1, 4192, 120), (1, 2112, 320),
        (1, 2080, 320), (1, 2080, 120), (1, 5, 320), (2, 10, 3), (1, 40, 257)],
    4: [(1, 2112, 320), (1, 2096, 320), (1, 1056, 320), (1, 1040, 320), (1, 1040, 120),
        (1, 3, 40)],
    8: [(1, 528, 320), (1, 520, 320), (3, 7, 2)],
}
FWD_SHAPES = [(bh, lq, lk, d) for t, dims in ((1, (8,)), (2, (32,)), (4, (64,)), (8, (100, 128)))
              for d in dims for bh, lq, lk in FWD_BOUNDARIES[t]]


def test_forward_boundaries_cover_every_launch_shape():
    chosen = {(attention.lanes_per_row(s[3]), *attention.fwd_launch_shape(*s))
              for s in FWD_SHAPES}
    instances = {(t, r, s) for t in (1, 2, 4, 8)
                 for r, s in ((2, 4), (2, 8), (1, 4), (1, 8)) if s * t <= 32}
    assert chosen == instances


@pytest.mark.parametrize("bh,lq,lk,d", FWD_SHAPES + [(2, 5120, 320, 32), (8, 320, 320, 32)])
def test_attention_forward_at_every_launch_shape(cuda, bh, lq, lk, d):
    """o against the plain version, lse against the fp64 logsumexp, and
    a second call bit for bit."""
    rng = np.random.default_rng(500 + d + lk)
    q, k, v = _attention_args(rng, bh, lq, lk, d)
    scale = d ** -0.5
    before = fused_short_kv_attention.launches
    o, lse = fused_short_kv_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert fused_short_kv_attention.launches == before + 1
    torch.testing.assert_close(o, short_kv_attention_plain(q, k, v, scale), **TOL)
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, dim=-1), **TOL)
    o2, lse2 = fused_short_kv_attention(q, k, v, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_attention_forward_kernels_do_not_spill(cuda):
    """Every instance of the forward kernel keeps its state in registers
    and fits at least one block an SM."""
    for t, d in ((1, 16), (2, 32), (4, 64), (8, 128)):
        for rows, splits in ((2, 4), (2, 8), (1, 4), (1, 8)):
            if splits * t > 32:
                continue
            a = attention.fwd_kernel_attributes(d, rows, splits)
            assert a["local_bytes"] == 0, (d, rows, splits, a)
            assert a["blocks_per_sm"] >= 1, (d, rows, splits, a)


def test_attention_bwd_one_query_split_and_several_agree(cuda, monkeypatch):
    """The dK/dV pass with one query split (dk and dv written by the
    pass) and with several (partials added in split order) gives the
    same dq, dk and dv within 1e-5, each within the fp64 bar."""
    rng = np.random.default_rng(400)
    q, k, v = _attention_args(rng, 2, 1000, 40, 32)
    o, lse = fused_short_kv_attention(q, k, v, 0.2)
    do = _rand(rng, 2, 1000, 32)
    rows, splits, key_tile, query_splits = attention.bwd_launch_shape(2, 1000, 40, 32)
    assert query_splits == 16
    several = fused_short_kv_attention_bwd(q, k, v, o, lse, do, 0.2)
    monkeypatch.setattr(attention, "bwd_launch_shape",
                        lambda *shape: (rows, splits, key_tile, 1))
    one = fused_short_kv_attention_bwd(q, k, v, o, lse, do, 0.2)
    want = short_kv_attention_bwd_plain(q.double(), k.double(), v.double(), do.double(), 0.2)
    for name, a, b, w in zip(("dq", "dk", "dv"), one, several, want):
        _close_to_fp64(name, a, w)
        _close_to_fp64(name, b, w)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


#: (BH, Lq, Lk, D): each side of every boundary where the backward's
#: dK/dV launch shape changes (``bwd_launch_shape``): one query tile or
#: two, 132 key tiles x BH or 133 at D <= 32, 127 or 128 above, D 64 or
#: 65 (64 or 32 keys a block),
#: and every count of thread groups a tile (D 16: 4, D 32: 2, D 64 and
#: 128: 1), with D not a multiple of 4 and keys past a key tile
BWD_SHAPES = [
    (1, 64, 320, 32), (1, 65, 320, 32),
    (1, 2048, 8128, 64), (1, 2048, 8129, 64),
    (2, 2048, 4224, 32), (2, 2048, 4225, 32),
    (1, 2048, 4064, 128), (1, 2048, 4065, 128),
    (1, 700, 320, 64), (1, 700, 320, 65),
    (3, 333, 77, 16), (2, 500, 100, 30), (1, 130, 70, 100), (2, 129, 1, 13),
]


@pytest.mark.parametrize("bh,lq,lk,d", BWD_SHAPES + FWD_SHAPES)
def test_attention_backward_at_every_launch_shape(cuda, bh, lq, lk, d):
    """dq, dk and dv against the plain backward in fp64, one launch
    counted, and a second call bit for bit: at each side of the dK/dV
    pass's boundaries, then at every launch shape of the dq pass (the
    forward's)."""
    rng = np.random.default_rng(600 + d + lk)
    q, k, v = _attention_args(rng, bh, lq, lk, d)
    scale = d ** -0.5
    o, lse = fused_short_kv_attention(q, k, v, scale)
    do = _rand(rng, bh, lq, d)
    before = fused_short_kv_attention_bwd.launches
    got = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert fused_short_kv_attention_bwd.launches == before + 1
    want = short_kv_attention_bwd_plain(q.double(), k.double(), v.double(), do.double(), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_to_fp64(name, g, w)
    again = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


def test_attention_bwd_kernels_do_not_spill(cuda, capsys):
    """Both kernels of every backward instance keep their state in
    registers and fit at least one block an SM (-s prints them)."""
    for t, d in ((1, 16), (2, 32), (4, 64), (8, 128)):
        for rows, splits in ((2, 4), (2, 8), (1, 4), (1, 8)):
            if splits * t > 32:
                continue
            a = attention.bwd_kernel_attributes(d, rows, splits)
            with capsys.disabled():
                print(f"\nc-bwd d={d} rows={rows} splits={splits}: {a}")
            for kernel in ("dq", "dkdv"):
                assert a[kernel]["local_bytes"] == 0, (d, rows, splits, a)
                assert a[kernel]["blocks_per_sm"] >= 1, (d, rows, splits, a)


# ------------------------------------------ gather-table path, SwinUNetR
@pytest.mark.parametrize("model", ["GraphLAM", "HiLAM"])
def test_table_path_repeats_bit_for_bit_and_gives_the_cpu_gradients(cuda, model):
    """The gather-table path (``use_lattice: false``) at a 64x64 grid on
    the card: forward and backward (every parameter and the input) twice
    bit for bit, no hand kernel launched, and the CPU's output within
    1e-4 and gradients within MODEL_GRAD_BAR of scale."""
    from py4cast_tpu_torch.training import init_weights

    settings = graph_models.GraphModelSettings(hidden_dims=32, processor_layers=2,
                                               use_lattice=False)
    axis = np.linspace(0, 1, 64)
    mg = np.stack(np.meshgrid(axis, axis, indexing="ij")).astype(np.float32)
    graph = graph_models.build_graph_artifacts(mg, settings)
    cpu_model = getattr(graph_models, model)(7, 3, (4096,), settings, graph)
    init_weights(cpu_model, torch.Generator().manual_seed(0))
    card_model = getattr(graph_models, model)(7, 3, (4096,), settings, graph).to(cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    assert card_model.table_path
    rng = np.random.default_rng(12)
    x, cot = _rand(rng, 2, 4096, 7), _rand(rng, 2, 4096, 3)

    def run(m, device):
        xi = x.to(device).requires_grad_()
        y = m(xi)
        grads = torch.autograd.grad((y * cot.to(device)).sum(), [xi] + list(m.parameters()))
        return [t.detach().cpu() for t in (y, *grads)]

    kernels = (fused_stencil_message, fused_corner_hop, fused_stencil_message_bwd,
               fused_corner_hop_bwd)
    before = [k.launches for k in kernels]
    first, second = run(card_model, cuda), run(card_model, cuda)
    assert [k.launches for k in kernels] == before
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for i, (g, want) in enumerate(zip(first, run(cpu_model, "cpu"))):
        scale = max(1.0, float(want.abs().max()))
        bar = TOL["atol"] if i == 0 else MODEL_GRAD_BAR
        assert float((g - want).abs().max()) <= bar * scale, i


def test_swin_rel_pos_bias_gradient_repeats_bit_for_bit(cuda):
    """SwinUNetR's relative-position-bias gradient (the 0/1 product's
    backward, no atomics) on the card: two backward passes give the same
    bits, and the CPU's gradients within MODEL_GRAD_BAR of scale."""
    from py4cast_tpu_torch.models.swin import SwinUNetR, SwinUNetRSettings
    from py4cast_tpu_torch.training import init_weights
    from py4cast_tpu_torch.utils import exact_reductions

    settings = SwinUNetRSettings(feature_size=12, depths=(2, 2), num_heads=(3, 6))
    cpu_model = SwinUNetR(5, 3, (60, 52), settings)
    init_weights(cpu_model, torch.Generator().manual_seed(0))
    card_model = SwinUNetR(5, 3, (60, 52), settings).to(cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    x = _rand(np.random.default_rng(13), 2, 60, 52, 5)

    def rpb_grads(m, device):
        m.zero_grad()
        with exact_reductions():  # TF32 off in cuDNN's convolutions too
            (m(x.to(device)) ** 2).sum().backward()
        return {k: p.grad.detach().cpu() for k, p in m.named_parameters()
                if k.endswith("rel_pos_bias")}

    first, second = rpb_grads(card_model, cuda), rpb_grads(card_model, cuda)
    assert len(first) == 4
    assert all(torch.equal(first[k], second[k]) for k in first)
    for k, want in rpb_grads(cpu_model, "cpu").items():
        scale = max(1.0, float(want.abs().max()))
        assert float((first[k] - want).abs().max()) <= MODEL_GRAD_BAR * scale, k


def test_bilinear_growth_backward_repeats_bit_for_bit(cuda):
    """The models' bilinear growth (Segformer's decoder, DeepLab's,
    UNet's and UNetRPP's skips) on the card: two backward passes give
    the same bits (CUDA's own backward adds with atomics), and the CPU's
    gradient within TOL. Each pass takes a leaf of its own: ``x`` lies on
    the card already, so ``x.to(cuda)`` is ``x`` itself, whose ``.grad``
    the second pass would add to."""
    from py4cast_tpu_torch.models.unet import _bilinear_resize

    x = _rand(np.random.default_rng(14), 2, 16, 20, 64)
    g = _rand(np.random.default_rng(15), 2, 128, 160, 64)

    def grad(device):
        xd = x.to(device).detach().requires_grad_(True)
        _bilinear_resize(xd, 128, 160).backward(g.to(device))
        return xd.grad.cpu()

    first, second = grad(cuda), grad(cuda)
    assert torch.equal(first, second)
    torch.testing.assert_close(first, grad("cpu"), **TOL)


def test_pretrain_encoder_graph_replays_match_the_cpu(cuda):
    """``tools/pretrain_encoder`` on the card: its eager steps and the
    replays of its captured step give the CPU's losses within 1e-4
    relative (the same weights and fields; at side 48 a decoder growth
    from 2 to 3 rows is not a whole factor), and a second run the same
    bits, losses and weights."""
    from py4cast_tpu_torch.tools import pretrain_encoder

    def run(device):
        model, losses = pretrain_encoder.pretrain("resnet18", steps=7, batch=2, size=48,
                                                  device=device, log=lambda _: None)
        return losses, {k: v.cpu() for k, v in model.state_dict().items()}

    (first, params), (second, params2) = run(cuda), run(cuda)
    want, _ = run("cpu")
    assert pretrain_encoder.EAGER_STEPS < len(first)
    assert first == second and all(torch.equal(params[k], params2[k]) for k in params)
    np.testing.assert_allclose(first, want, rtol=1e-4, atol=0)
