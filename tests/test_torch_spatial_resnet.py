"""The spatial axis of the ResNet-encoder models, the perceptual loss and
``mask_ratio``, in one process, on the CPU.

Every band of a grid runs in this process (``testing.run_on_bands``):
each exchange of ``parallel.spatial`` is answered with what the other
bands send to it. Each piece is held against the unsharded op on the
whole grid, forward and backward, within BAR of scale (the bars of
``test_torch_spatial_attention.py``): the bands' outputs concatenated
against the whole output, and the gradients of the input and of the
weights, summed over the bands, against the whole op's. Covered, on 2
and 4 bands: ``halo_rows`` deeper than a band and with a ``-inf`` fill;
the explicitly padded convs (the 7x7 stride-2 stem, a strided
``ResNetBlock``); ``max_pool_3x3`` with all-zero windows planted on a
band edge and at the global top; ASPP at rates whose halos span several
bands; ``PerceptualLossPy4Cast``; and
``mask_blocks``, also against the JAX package's formula given the same
draw; and, on 2 bands in fp64, the three models whole. The gloo ranks,
the trainer and the JAX package's spatial mesh are in
``test_torch_spatial_resnet_ranks.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from py4cast_tpu_torch.losses import CombinedLoss, PerceptualLossPy4Cast
from py4cast_tpu_torch.models.base import FlaxConv2d
from py4cast_tpu_torch.models.deeplab import ASPP, DeepLabSettings, DeepLabV3, DeepLabV3Plus
from py4cast_tpu_torch.models.unet import (
    CustomUNet,
    CustomUNetSettings,
    ResNetBlock,
    max_pool_3x3,
)
from py4cast_tpu_torch.parallel.spatial import Band, halo_rows, on_band
from py4cast_tpu_torch.rollout import mask_blocks
from py4cast_tpu_torch.testing import run_on_bands, synthetic_dataset_info
from py4cast_tpu_torch.training import init_weights

#: a band's piece against the whole op, relative to scale (fp32: only
#: the order of the sums over the bands changes)
BAR = 1e-5
COUNTS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(got, want, what, bar=BAR):
    got, want = got.detach(), want.detach()
    assert got.shape == want.shape, f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}"
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= bar, f"{what}: {err:.3e}"


def _grads(out, g, leaves):
    return torch.autograd.grad((out * g).sum(), leaves, allow_unused=True,
                               materialize_grads=True)


def _on_bands(op, x, g, leaves, count):
    """``op`` on each of ``count`` bands of ``x`` run together: the bands'
    outputs concatenated and the gradients of sum(out · g), summed over
    the bands in band order."""

    def band_step(band):
        out = op(band.cut(x, 1))
        return out.detach(), _grads(out, band.cut(g, 1), leaves)

    results = run_on_bands(band_step, count)
    return (torch.cat([r[0] for r in results], dim=1),
            [sum(r[1][i] for r in results) for i in range(len(leaves))])


def _hold(op, x, g, count, what, params=()):
    """``op`` on bands against the whole grid: the output within BAR of
    scale; the gradient elements within BAR of the largest gradient of
    zero on the whole grid (rounding noise: a conv's bias before a
    GroupNorm is zero in exact arithmetic) held below BAR of the largest
    on the bands too, the others within BAR of scale."""
    names, leaves = ["x", *(n for n, _ in params)], [x, *(p for _, p in params)]
    want = op(x)
    want_grads = _grads(want, g, leaves)
    got, got_grads = _on_bands(op, x, g, leaves, count)
    _close(got, want, f"{what} on {count} bands")
    largest = max(float(b.abs().max()) for b in want_grads)
    for name, a, b in zip(names, got_grads, want_grads):
        noise = b.abs() <= BAR * largest
        if noise.any():
            assert float(a[noise].abs().max()) <= BAR * largest, name
        if not noise.all():
            _close(a[~noise], b[~noise], f"{what} on {count} bands: d{name}")


def _drawn(module):
    init_weights(module, torch.Generator().manual_seed(0))
    return module


# ------------------------------------------------------- the exchange
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("top,bottom", [(3, 2), (6, 6), (5, 0), (0, 9)])
@pytest.mark.parametrize("fill", [0.0, float("-inf")])
def test_halo_deeper_than_a_band_is_the_whole_pad(count, top, bottom, fill):
    """Bands of 2 rows: a halo of up to 9 rows takes whole bands and the
    edge rows of the farthest, ``fill`` beyond the grid, bit for bit the
    rows of the whole grid padded with ``fill``; each halo row's
    cotangent reaches the row it came from."""
    x = _randn(2, 2 * count, 3, 2, seed=count).double().requires_grad_()
    whole = F.pad(x, (0, 0, 0, 0, top, bottom), value=fill)
    g = _randn(2, 2 + top + bottom, 3, 2, seed=1).double()

    def band_step(band):
        y = halo_rows(band.cut(x, 1), top, bottom, fill=fill)
        return y.detach(), torch.autograd.grad(y, x, g)[0]

    results = run_on_bands(band_step, count)
    want_grad = torch.zeros_like(whole)
    for s, (y, _) in enumerate(results):
        assert torch.equal(y, whole[:, 2 * s:2 * s + 2 + top + bottom].detach()), s
        want_grad[:, 2 * s:2 * s + 2 + top + bottom] += g
    torch.testing.assert_close(sum(r[1] for r in results),
                               want_grad[:, top:top + 2 * count], rtol=0, atol=1e-12)


def test_a_clamped_halo_deeper_than_a_band_raises():
    with on_band(Band(0, 2)), pytest.raises(ValueError, match="cannot send a clamped halo of 3"):
        halo_rows(_randn(1, 2, 2, 1), 3, 0, clamp=True)


# ------------------------------------------------------ the encoder
def test_explicit_padding_reads_p_rows_above_and_k_minus_s_minus_p_below():
    assert FlaxConv2d(2, 2, 7, stride=2, padding=3).band_halo() == (3, 2)
    assert FlaxConv2d(2, 2, 3, stride=2, padding=1).band_halo() == (1, 0)
    assert FlaxConv2d(2, 2, 3, padding=1).band_halo() == (1, 1)
    assert FlaxConv2d(2, 2, 1, stride=2).band_halo() == (0, 0)


@pytest.mark.parametrize("count", COUNTS)
def test_stem_conv_on_bands_matches_the_whole_grid(count):
    """The 7x7 stride-2 stem, padded 3 on every side, on bands of 4 rows:
    3 rows of the band above, 2 of the band below."""
    conv = _drawn(FlaxConv2d(3, 8, 7, stride=2, padding=3))
    x = _randn(2, 4 * count, 9, 3).requires_grad_()
    g = _randn(2, 2 * count, 5, 8, seed=1)
    _hold(conv, x, g, count, "7x7/s2 stem", list(conv.named_parameters()))


def _relu_with_ties(rows, seed):
    """Post-ReLU NHWC input with exact zeros, and all-zero 3x3 windows
    planted at the global top and across every band edge of 2 rows."""
    x = F.relu(_randn(1, rows, 7, 2, seed=seed))
    x[:, 0:2, 0:3] = 0.0  # the global top window: -inf above, zeros below
    for edge in range(2, rows, 2):
        x[:, edge - 1:edge + 2, 3:6] = 0.0
    return x.requires_grad_()


@pytest.mark.parametrize("count", COUNTS)
def test_max_pool_on_bands_routes_ties_as_the_whole_grid(count):
    """The -inf-padded 3x3 stride-2 pool on bands of 2 and 4 rows: one
    row of the band above, -inf at the global top, so that a window of
    zeros routes its cotangent to the row one process picks, bit for
    bit."""
    for band_rows in (2, 4):
        x = _relu_with_ties(band_rows * count, seed=band_rows)
        g = _randn(1, band_rows * count // 2, 4, 2, seed=3)
        want = max_pool_3x3(x)
        want_grad = _grads(want, g, [x])[0]
        got, (got_grad,) = _on_bands(max_pool_3x3, x, g, [x], count)
        assert torch.equal(got, want.detach())
        assert torch.equal(got_grad, want_grad)
        assert float(want_grad[:, 0:2, 0:3].abs().sum()) > 0  # a tie was routed there


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("norm", ["group", "affine"])
def test_strided_resnet_block_on_bands_matches_the_whole_grid(count, norm):
    """A stride-2 block that widens 4 -> 8: conv1 padded 1 on a (1, 0)
    halo, conv2 SAME on (1, 1), the 1x1 stride-2 proj on none, GroupNorm
    on band statistics (AffineNorm each band's own)."""
    block = _drawn(ResNetBlock(4, 8, stride=2, norm=norm))
    x = _randn(2, 4 * count, 6, 4).requires_grad_()
    g = _randn(2, 2 * count, 3, 8, seed=1)
    _hold(block, x, g, count, f"ResNetBlock ({norm})", list(block.named_parameters()))


@pytest.mark.parametrize("count", COUNTS)
def test_aspp_halos_span_several_bands(count):
    """ASPP at rates (2, 4, 6) on a 4-row map: at 2 bands of 2 rows the
    halos of 4 and 6 rows span 2 and 3 bands, at 4 bands of 1 row up to
    6; the image-level mean is the bands' summed sums."""
    aspp = _drawn(ASPP(6, 8, (2, 4, 6)))
    x = _randn(2, 4, 5, 6).requires_grad_()
    g = _randn(2, 4, 5, 8, seed=1)
    _hold(aspp, x, g, count, "ASPP (2, 4, 6)", list(aspp.named_parameters()))


def _model_case(kls, settings, count, lon=16, seed=0):
    """The model whole on bands of 8 rows, in fp64: a ReLU input within
    fp32 rounding of zero (the encoder's sums are long) would flip a
    gradient element on one side of the kink alone; fp64 leaves none, so
    the bars hold the bands' arithmetic itself."""
    model = _drawn(kls(5, 3, (8 * count, lon), settings)).double()
    x = _randn(1, 8 * count, lon, 5, seed=seed).double().requires_grad_()
    g = _randn(*model(x).shape, seed=seed + 1).double()
    _hold(model, x, g, count, kls.__name__, list(model.named_parameters()))


@pytest.mark.parametrize("count", [2])
def test_custom_unet_on_bands_matches_the_whole_grid(count):
    """CustomUNet at encoder depth 3 (bands of 8 rows), and with autopad
    off on a lon of 13, where the stem's skip has 7 columns and the
    upsample 8: the lon-only resize is each band's own."""
    _model_case(CustomUNet, CustomUNetSettings(encoder_depth=3, decoder_channels=(8, 4, 4)),
                count)
    _model_case(CustomUNet, CustomUNetSettings(encoder_depth=3, decoder_channels=(8, 4, 4),
                                               encoder_norm="affine", autopad_enabled=False),
                count, lon=13, seed=2)


@pytest.mark.parametrize("count", [2])
def test_deeplab_on_bands_matches_the_whole_grid(count):
    """DeepLabV3 and DeepLabV3Plus at encoder depth 3: ASPP's rates 12,
    24 and 36 on the 1-row bands of the deepest map, the x8 (V3) and x2
    and x4 (V3Plus) growths on a clamped halo row."""
    settings = DeepLabSettings(encoder_depth=3, decoder_channels=8)
    _model_case(DeepLabV3, settings, count)
    _model_case(DeepLabV3Plus, DeepLabSettings(encoder_depth=3, decoder_channels=8,
                                               encoder_norm="affine"), count, seed=2)


def test_models_declare_bands_of_their_encoder_stride():
    for kls, settings in ((CustomUNet, CustomUNetSettings()), (DeepLabV3, DeepLabSettings()),
                          (DeepLabV3Plus, DeepLabSettings(encoder_depth=4))):
        assert kls.spatial_shardable
        assert kls.spatial_lat_multiple(settings) == 2 ** settings.encoder_depth


# ------------------------------------------------ perceptual loss
def _perceptual(scales=3):
    loss = PerceptualLossPy4Cast(num_scales=scales, trained=False)
    info = synthetic_dataset_info(grid_shape=(16, 12), weather_features=2, forcing_features=5)
    loss.prepare(np.ones((16, 12, 1), np.float32), info, info.output_feature_names)
    return loss


@pytest.mark.parametrize("count", COUNTS)
def test_perceptual_loss_on_bands_sums_to_the_whole_loss(count):
    """Three scales on bands of 8 and of 4 rows: the bands' shares sum to
    the whole loss, and the prediction's gradient is the whole one's; a
    band of 3 rows, which the subsamples cannot split, raises."""
    loss = _perceptual()
    pred = _randn(2, 2, 16, 12, 2).requires_grad_()
    tgt = _randn(2, 2, 16, 12, 2, seed=1)
    mask = torch.ones_like(tgt)

    def call(p, t, m):
        return loss(SimpleNamespace(array=p), SimpleNamespace(array=t), m)

    want = call(pred, tgt, mask)
    want_grad = torch.autograd.grad(want.sum(), pred)[0]
    if count == 4:
        with on_band(Band(0, 4)), pytest.raises(ValueError, match="multiple of 4 rows"):
            call(pred[:, :, :4 - 1], tgt[:, :, :4 - 1], mask[:, :, :4 - 1])

    def band_step(band):
        cut = [band.cut(a, 2) for a in (pred, tgt, mask)]
        share = call(*cut)
        return share.detach(), torch.autograd.grad(share.sum(), pred)[0]

    results = run_on_bands(band_step, count)
    _close(sum(r[0] for r in results), want, "perceptual loss")
    _close(sum(r[1] for r in results), want_grad, "perceptual loss: dpred")


def test_perceptual_loss_needs_bands_of_its_subsamples():
    assert _perceptual(3).spatial_lat_multiple() == 4
    assert _perceptual(2).spatial_lat_multiple() == 2
    combined = CombinedLoss([{"class": "WeightedLoss", "weight": 1.0, "params": {}},
                             {"class": "PerceptualLossPy4Cast", "weight": 0.1, "params": {}}])
    trained = PerceptualLossPy4Cast()
    assert combined.spatial_lat_multiple() == trained.spatial_lat_multiple() == 4


# ------------------------------------------------------- mask_blocks
@pytest.mark.parametrize("count", COUNTS)
def test_mask_blocks_on_bands_cut_the_whole_grids_draw(count):
    """Each band keeps its rows of the masks one process draws (blocks of
    the whole lat's height: 6 rows at 24 rows, where a 6-row band alone
    would take 3), and its generator ends where one process's does; each
    data rank keeps its rows of the global batch's draw."""
    x = _randn(4, 24, 10, 3) + 5.0
    gen = torch.Generator().manual_seed(3)
    want = mask_blocks(x, gen, 0.5)
    want_state = gen.get_state()
    assert 0 < int((want == 0).all(dim=-1).sum()) < 4 * 24 * 10
    assert torch.equal((want[0, :6] == 0), (want[0, :1] == 0).expand(6, 10, 3))

    def band_step(band):
        g = torch.Generator().manual_seed(3)
        out = mask_blocks(band.cut(x, 1), g, 0.5)
        return out, torch.equal(g.get_state(), want_state)

    results = run_on_bands(band_step, count)
    assert torch.equal(torch.cat([r[0] for r in results], dim=1), want)
    assert all(r[1] for r in results)
    for d in range(2):
        got = mask_blocks(x[2 * d:2 * d + 2], torch.Generator().manual_seed(3), 0.5, (d, 2))
        assert torch.equal(got, want[2 * d:2 * d + 2])


def test_mask_blocks_matches_the_jax_formula_on_the_same_draw(monkeypatch):
    """The JAX package's ``mask_blocks`` given the port's uniform draw
    (``jax.random.uniform`` answered with it) zeroes the same blocks."""
    import jax
    import jax.numpy as jnp

    from py4cast_tpu.rollout import mask_blocks as jax_mask_blocks

    x = _randn(2, 23, 17, 3) + 5.0
    draws, real = [], torch.rand

    def rand(shape, generator=None, device=None):
        draws.append(real(shape, generator=generator, device=device))
        return draws[-1]

    monkeypatch.setattr(torch, "rand", rand)
    got = mask_blocks(x, torch.Generator().manual_seed(0), 0.4)
    monkeypatch.undo()
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(draws[0].numpy()))
    want = np.asarray(jax_mask_blocks(jnp.asarray(x.numpy()), jax.random.key(0), 0.4))
    np.testing.assert_array_equal(got.numpy(), want)
