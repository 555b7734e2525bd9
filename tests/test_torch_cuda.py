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

from py4cast_tpu_torch.ops import hop_kernel, stencil_kernel
from py4cast_tpu_torch.ops.hop_kernel import (
    CornerHopFn,
    corner_hop_bwd_plain,
    corner_hop_plain,
    fused_corner_hop,
    fused_corner_hop_bwd,
)
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


@pytest.mark.parametrize("b,hr,w,f_in,h,residual", [
    (1, 125, 125, 64, 64, True),   # GraphLAM level 0
    (2, 7, 9, 16, 16, True),       # one lane word, ragged cell count
    (3, 5, 4, 24, 40, False),      # edge width != hidden width
    (1, 6, 6, 96, 96, True),
    (2, 3, 5, 128, 128, False),
    (1, 4, 4, 8, 128, False),
])
def test_stencil_kernel_matches_plain(cuda, b, hr, w, f_in, h, residual):
    rng = np.random.default_rng(h + f_in)
    args = (
        _rand(rng, b, 8, hr, w, f_in), _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h),
        torch.from_numpy((rng.uniform(size=(8, hr, w, 1)) > 0.3).astype(np.float32)).cuda(),
        _rand(rng, f_in, h, scale=f_in ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )
    before = fused_stencil_message.launches
    got = fused_stencil_message(*args, residual=residual)
    torch.cuda.synchronize()
    assert fused_stencil_message.launches == before + 1
    want = stencil_message_plain(*args, residual=residual)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, **TOL)


@pytest.mark.parametrize("b,hr,w,h,ff,mean", [
    (1, 500, 500, 64, 3, False),   # GraphLAM grid
    (2, 7, 11, 16, 3, True),
    (1, 9, 5, 80, 2, False),
    (3, 4, 6, 96, 5, True),        # the widest the hop takes
])
def test_hop_kernel_matches_plain(cuda, b, hr, w, h, ff, mean):
    rng = np.random.default_rng(h + ff)
    psg = [_rand(rng, b, hr, w, h) for _ in range(4)]
    rest = (
        _rand(rng, b, hr, w, h), _rand(rng, 4, hr, w, ff, scale=0.5),
        _rand(rng, ff, h, scale=ff ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, h, scale=h ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=(2 * h) ** -0.5), _rand(rng, h, h, scale=(2 * h) ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )
    before = fused_corner_hop.launches
    got = fused_corner_hop(psg, *rest, mean=mean)
    torch.cuda.synchronize()
    assert fused_corner_hop.launches == before + 1
    torch.testing.assert_close(got, corner_hop_plain(psg, *rest, mean=mean), **TOL)


def test_kernels_follow_the_current_stream(cuda):
    """A launch on a side stream orders with that stream's work."""
    rng = np.random.default_rng(0)
    h = 32
    args = [
        _rand(rng, 1, 8, 6, 6, h), _rand(rng, 1, 8, 6, 6, h), _rand(rng, 1, 6, 6, h),
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
    psg = [_rand(rng, b, hr, w, h) for _ in range(4)]
    rest = (
        _rand(rng, b, hr, w, h), _rand(rng, 4, hr, w, ff, scale=0.5),
        _rand(rng, ff, h, scale=ff ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, h, scale=h ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=(2 * h) ** -0.5), _rand(rng, h, h, scale=(2 * h) ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )
    return psg, rest


@pytest.mark.parametrize("b,hr,w,f_in,h,residual", [
    (1, 125, 125, 64, 64, True),   # GraphLAM level 0
    (2, 7, 9, 16, 16, True),       # one lane word, ragged cell count
    (3, 5, 4, 24, 40, False),      # edge width != hidden width
    (1, 6, 6, 64, 64, False),
    (2, 3, 5, 8, 64, False),
    (1, 63, 63, 64, 64, True),     # GraphLAM level 1
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


def test_bwd_kernels_raise_above_their_width_cap(cuda):
    rng = np.random.default_rng(5)
    h = stencil_kernel.MAX_BWD_WIDTH + 32
    args = _stencil_args(rng, 1, 3, 3, h, h)
    with pytest.raises(ValueError, match="widths up to"):
        fused_stencil_message_bwd(*args, _rand(rng, 1, 8, 3, 3, h), _rand(rng, 1, 3, 3, h))
    h = hop_kernel.MAX_BWD_WIDTH + 32
    psg, rest = _hop_args(rng, 1, 3, 3, h, 3)
    fused_corner_hop(psg, *rest)  # the forward still takes it
    with pytest.raises(ValueError, match="hidden width up to"):
        fused_corner_hop_bwd(psg, *rest, _rand(rng, 1, 3, 3, h))


def test_functions_give_the_cpu_gradients_on_the_card(cuda):
    """torch.autograd.grad through StencilMessageFn and CornerHopFn on
    the card (both kernels each way) against the same on the CPU."""
    rng = np.random.default_rng(7)
    s_args = _stencil_args(rng, 2, 9, 7, 32, 32)
    psg, rest = _hop_args(rng, 2, 9, 7, 32, 3)
    s_cot = (_rand(rng, 2, 8, 9, 7, 32), _rand(rng, 2, 9, 7, 32))
    h_cot = _rand(rng, 2, 9, 7, 32)

    def grads(device):
        sa = [a.detach().to(device).requires_grad_(i != 3) for i, a in enumerate(s_args)]
        out, agg = StencilMessageFn.apply(*sa, True)
        loss = (out * s_cot[0].to(device)).sum() + (agg * s_cot[1].to(device)).sum()
        hp = [p.detach().to(device).requires_grad_() for p in psg]
        hr = [a.detach().to(device).requires_grad_(i != 1) for i, a in enumerate(rest)]
        loss = loss + (CornerHopFn.apply(*hp, *hr, False) * h_cot.to(device)).sum()
        wrt = [a for i, a in enumerate(sa) if i != 3] + hp + [a for i, a in enumerate(hr) if i != 1]
        return [t.cpu() for t in torch.autograd.grad(loss, wrt)]

    before = (fused_stencil_message_bwd.launches, fused_corner_hop_bwd.launches)
    on_card = grads("cuda")
    assert (fused_stencil_message_bwd.launches, fused_corner_hop_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for g, want in zip(on_card, grads("cpu")):
        scale = max(1.0, float(want.abs().max()))
        assert float((g - want).abs().max()) <= GRAD_BAR * scale
