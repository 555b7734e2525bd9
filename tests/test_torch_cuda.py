"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at widths and shapes beyond the main path's (every template
instance, ragged cell counts, batch > 1). Needs an NVIDIA card and nvcc:
every test carries the ``cuda`` marker and skips without a CUDA device.
On the card, run without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from py4cast_tpu_torch.ops.hop_kernel import corner_hop_plain, fused_corner_hop
from py4cast_tpu_torch.ops.stencil_kernel import fused_stencil_message, stencil_message_plain

pytestmark = pytest.mark.cuda

#: fp32 sums in another order than the plain version's matmuls
TOL = dict(rtol=1e-4, atol=1e-4)


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
