"""The spatial axis of the attention models, in one process, on the CPU.

Every band of a grid runs in this process (``testing.run_on_bands``):
each exchange of ``parallel.spatial`` is answered with what the other
bands send to it, so the bands run the modules' own code, collectives
included, without a process group. Each piece is held against the
unsharded op on the whole grid, forward and backward: the bands'
outputs concatenated against the whole output, and the gradients of
the whole input and of the weights, summed over the bands (as
``all_reduce_grads`` sums them), against the whole op's; within BAR of
scale. Covered, on 2 and 4 bands: ``gather_rows``, ``roll_rows`` and
the clamped ``halo_rows``; the strided SAME convs; the bilinear growth;
the dropout masks; kernel c's plain versions at a band's shapes;
Segformer's ``EfficientSelfAttention``, UNetRPP's ``EPA`` and
``EPABlock`` (both attention codes) and a shifted ``SwinBlock``; and
the three models whole. The collectives across gloo ranks, the trainer
and the JAX package's spatial mesh are in
``test_torch_spatial_attention_ranks.py``."""

import numpy as np
import pytest
import torch

from py4cast_tpu_torch.models.base import FlaxConv2d, dropout
from py4cast_tpu_torch.models.segformer import EfficientSelfAttention, Segformer, SegformerSettings
from py4cast_tpu_torch.models.swin import SwinStage, SwinUNetR, SwinUNetRSettings
from py4cast_tpu_torch.models.unet import _bilinear_resize
from py4cast_tpu_torch.models.unetrpp import EPA, EPABlock, UNetRPP, UNetRPPSettings
from py4cast_tpu_torch.ops import flops
from py4cast_tpu_torch.ops.attention import (
    fused_short_kv_attention,
    fused_short_kv_attention_bwd,
)
from py4cast_tpu_torch.parallel.spatial import (
    Band,
    gather_rows,
    halo_rows,
    on_band,
    roll_rows,
)
from py4cast_tpu_torch.testing import run_on_bands
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


def _close(got, want, what, bar=BAR):
    got, want = got.detach(), want.detach()
    assert got.shape == want.shape, f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}"
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= bar, f"{what}: {err:.3e}"


def _randn(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _on_bands(op, x, g, leaves, count, axis=1):
    """``op`` on each of ``count`` bands of ``x`` (its rows along
    ``axis``), run together (``run_on_bands``): the bands' outputs
    concatenated, and the gradients of sum(out · g) with respect to
    ``leaves`` (``x`` first) summed over the bands in band order."""

    def band_step(band):
        out = op(band.cut(x, axis))
        grads = torch.autograd.grad((out * band.cut(g, axis)).sum(), leaves,
                                    allow_unused=True, materialize_grads=True)
        return out.detach(), grads

    results = run_on_bands(band_step, count)
    out = torch.cat([r[0] for r in results], dim=axis)
    grads = [sum(r[1][i] for r in results) for i in range(len(leaves))]
    return out, grads


def _whole(op, x, g, leaves):
    out = op(x)
    return out.detach(), torch.autograd.grad((out * g).sum(), leaves, allow_unused=True,
                                             materialize_grads=True)


def _hold(module_or_op, x, g, count, what, params=()):
    """``module_or_op`` on bands against the whole grid. ``params`` are
    (name, tensor) pairs. The gradient elements within BAR of the largest
    gradient of zero on the whole grid (rounding noise: a conv's bias
    before an instance norm is zero in exact arithmetic) are held below
    BAR of the largest on the bands too, the others within BAR of scale."""
    names, leaves = ["x", *(n for n, _ in params)], [x, *(p for _, p in params)]
    want, want_grads = _whole(module_or_op, x, g, leaves)
    got, got_grads = _on_bands(module_or_op, x, g, leaves, count, 1)
    _close(got, want, f"{what} on {count} bands")
    largest = max(float(b.abs().max()) for b in want_grads)
    for name, a, b in zip(names, got_grads, want_grads):
        noise = b.abs() <= BAR * largest
        if noise.any():
            assert float(a[noise].abs().max()) <= BAR * largest, name
        if not noise.all():
            _close(a[~noise], b[~noise], f"{what} on {count} bands: d{name}")


def _params(module):
    return list(module.named_parameters())


# ------------------------------------------------------- the exchanges
@pytest.mark.parametrize("count", COUNTS)
def test_gather_rows_is_the_whole_with_summed_cotangents(count):
    """Each band gathers the whole; each band's cotangent of the whole is
    its own (g cut from a per-band draw), and x's gradient is their sum."""
    x = _randn(2, 8, 3, 4).requires_grad_()
    gs = [_randn(2, 8, 3, 4, seed=1 + s) for s in range(count)]

    def band_step(band):
        out = gather_rows(band.cut(x, 1), 1)
        (dx,) = torch.autograd.grad((out * gs[band.index]).sum(), [x])
        return out.detach(), dx

    results = run_on_bands(band_step, count)
    for out, _ in results:
        assert torch.equal(out, x.detach())
    _close(sum(dx for _, dx in results), sum(gs), "d(gather_rows)")


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("shift", [-3, 2, 4])
def test_roll_rows_is_the_whole_roll(count, shift):
    x = _randn(2, 16, 5, 3).requires_grad_()
    g = _randn(2, 16, 5, 3, seed=1)
    _hold(lambda t: roll_rows(t, shift), x, g, count, f"roll_rows({shift})")
    assert torch.equal(roll_rows(x, shift), torch.roll(x, shift, dims=1))  # off a band


@pytest.mark.parametrize("count", COUNTS)
def test_clamped_halo_is_the_whole_edge_padded_grid(count):
    """A band's clamped halo rows are its rows of the whole grid padded
    with its edge rows repeated; the halo rows' gradients reach their
    owners, the repeated edge rows' the edge row."""
    top, bottom, h = 2, 1, 16
    x = _randn(2, h, 3, 4).requires_grad_()
    m = h // count
    gs = [_randn(2, m + top + bottom, 3, 4, seed=1 + s) for s in range(count)]
    padded = torch.cat([x[:, :1].expand(-1, top, -1, -1), x,
                        x[:, -1:].expand(-1, bottom, -1, -1)], dim=1)
    want = [padded[:, s * m:s * m + m + top + bottom] for s in range(count)]
    (want_dx,) = torch.autograd.grad(sum((w * gb).sum() for w, gb in zip(want, gs)), [x])
    assert torch.equal(halo_rows(x, top, bottom, clamp=True), padded)  # off a band

    def band_step(band):
        out = halo_rows(band.cut(x, 1), top, bottom, clamp=True)
        (dx,) = torch.autograd.grad((out * gs[band.index]).sum(), [x])
        return out.detach(), dx

    results = run_on_bands(band_step, count)
    for s, (out, _) in enumerate(results):
        assert torch.equal(out, want[s].detach())
    _close(sum(dx for _, dx in results), want_dx, "d(clamped halo)")


# ------------------------------------------------- convs, growth, dropout
@pytest.mark.parametrize("kernel,stride", [(5, 4), (3, 2), (2, 2), (4, 4)])
@pytest.mark.parametrize("count", COUNTS)
def test_strided_conv_on_bands_matches_the_whole(kernel, stride, count):
    """Segformer's patch embeddings (k 5 / s 4, k 3 / s 2: halo (0, 1))
    and the k = stride convs (no halo) on bands of a multiple of the
    stride."""
    torch.manual_seed(0)
    conv = FlaxConv2d(3, 5, kernel, stride=stride)
    assert conv.band_halo() == ((0, 1) if kernel == stride + 1 else (0, 0))
    x = _randn(2, 32, 12, 3).requires_grad_()
    g = _randn(2, 32 // stride, 12 // stride, 5, seed=1)
    _hold(conv, x, g, count, f"k{kernel}/s{stride} conv", _params(conv))


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("count", COUNTS)
def test_band_growth_matches_the_whole_growth(factor, count):
    """``_bilinear_resize`` growing the lat by a whole factor (and the lon
    by another) on each band: one clamped halo row a side."""
    x = _randn(2, 8, 5, 3).requires_grad_()
    g = _randn(2, 8 * factor, 9, 3, seed=1)
    _hold(lambda t: _bilinear_resize(t, t.shape[1] * factor, 9), x, g, count,
          f"x{factor} growth")


def test_band_shrink_refuses():
    """A lat shrink (or a fractional lat growth) raises on a band; no
    model reaches one, as bands hold whole multiples of what it pools."""
    with on_band(Band(0, 2)):
        with pytest.raises(ValueError, match="from 8 to 4 rows is no whole-factor growth"):
            _bilinear_resize(_randn(1, 8, 8, 2), 4, 4)
        with pytest.raises(ValueError, match="from 8 to 12 rows is no whole-factor growth"):
            _bilinear_resize(_randn(1, 8, 8, 2), 12, 8)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (2, 48, 5)])
def test_dropout_on_a_band_cuts_the_whole_draw(shape):
    """Each band keeps its rows (or row-major tokens) of the mask one
    process draws, and its generator ends where one process's does."""
    x = _randn(*shape) + 3.0
    gen = torch.Generator().manual_seed(7)
    want = dropout(x, 0.5, gen)
    after = torch.rand(3, generator=gen)
    for band in (Band(s, 4) for s in range(4)):
        gen = torch.Generator().manual_seed(7)
        with on_band(band):
            got = dropout(band.cut(x, 1), 0.5, gen)
        assert torch.equal(got, band.cut(want, 1))
        assert torch.equal(torch.rand(3, generator=gen), after)


# -------------------------------------------------------------- kernel c
@pytest.mark.parametrize("count", COUNTS)
def test_kernel_c_plain_versions_at_a_band_shape_match_the_whole(count):
    """c-fwd at a band's queries is the band's rows of the whole call, and
    c-bwd's dK/dV partials summed over the bands the whole call's; one
    band's FLOPs are the whole's over the bands."""
    bh, lq, lk, d, scale = 3, 64, 10, 8, 0.35
    q, k, v, do = (_randn(bh, n, d, seed=i) for i, n in enumerate((lq, lk, lk, lq)))
    o, lse = fused_short_kv_attention(q, k, v, scale)
    dq, dk, dv = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
    parts = []
    for band in (Band(s, count) for s in range(count)):
        qb, dob = band.cut(q, 1).contiguous(), band.cut(do, 1).contiguous()
        ob, lseb = fused_short_kv_attention(qb, k, v, scale)
        _close(ob, band.cut(o, 1), "c-fwd o")
        _close(lseb, band.cut(lse, 1), "c-fwd lse")
        parts.append(fused_short_kv_attention_bwd(qb, k, v, ob, lseb, dob, scale))
        _close(parts[-1][0], band.cut(dq, 1), "c-bwd dq")
        assert flops.short_kv_attention_fwd_flop(qb.shape, k.shape, v.shape) * count == \
            flops.short_kv_attention_fwd_flop(q.shape, k.shape, v.shape)
        assert flops.short_kv_attention_bwd_flop(qb.shape, k.shape, v.shape) * count == \
            flops.short_kv_attention_bwd_flop(q.shape, k.shape, v.shape)
    _close(sum(p[1] for p in parts), dk, "c-bwd dk summed")
    _close(sum(p[2] for p in parts), dv, "c-bwd dv summed")


# ------------------------------------------------------- attention pieces
def _drawn(module, seed=0):
    init_weights(module, torch.Generator().manual_seed(seed))
    return module


@pytest.mark.parametrize("reduction", [1, 2])
@pytest.mark.parametrize("count", COUNTS)
def test_efficient_self_attention_on_bands(reduction, count):
    """Segformer's attention: the band's queries against K/V gathered from
    every band (kernel c's plain versions here)."""
    attn = _drawn(EfficientSelfAttention(8, 2, reduction))
    x = _randn(2, 16, 6, 8).requires_grad_()
    g = _randn(2, 16, 6, 8, seed=1)
    _hold(attn, x, g, count, f"EfficientSelfAttention r{reduction}", _params(attn))


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("count", COUNTS)
def test_epa_on_bands(kernel, count):
    """UNetRPP's EPA on each band's run of the tokens: norms, channel
    logits and projected K/V summed over the bands, ``proj_k`` and
    ``proj_v`` cut to the band's rows."""
    h, w = 8, 6
    epa = _drawn(EPA(8, 2, 5, h * w, kernel=kernel))
    x = _randn(2, h * w, 8).requires_grad_()
    g = _randn(2, h * w, 8, seed=1)
    _hold(epa, x, g, count, f"EPA (kernel {kernel})", _params(epa))


@pytest.mark.parametrize("count", COUNTS)
def test_epa_block_on_bands(count):
    """The EPABlock: EPA, then its two 3x3 convs on halo rows."""
    block = _drawn(EPABlock(8, 2, 5, 16 * 6, kernel=True))
    x = _randn(2, 16, 6, 8).requires_grad_()
    g = _randn(2, 16, 6, 8, seed=1)
    _hold(block, x, g, count, "EPABlock", _params(block))


@pytest.mark.parametrize("count", COUNTS)
def test_shifted_swin_block_on_bands(count):
    """A SwinStage's shifted block: the lat roll across the bands, each
    band's windows of the whole grid's shift mask."""
    ws, h, w = 4, 16, 12
    stage = _drawn(SwinStage(8, 2, 2, ws, 0.0, 0.0, (0.0, 0.0), (h, w)))
    block = stage.SwinBlock_1
    assert block.shift == ws // 2

    def shifted(t):
        return block(t, stage._mask(t.shape[1], t.shape[2]))

    x = _randn(2, h, w, 8).requires_grad_()
    g = _randn(2, h, w, 8, seed=1)
    _hold(shifted, x, g, count, "shifted SwinBlock", _params(block))


# ---------------------------------------------------------- whole models
SEGFORMER = SegformerSettings(dims=(8, 16), heads=(1, 2), ff_expansion=(2, 2),
                              reduction_ratio=(2, 1), num_layers=1, decoder_dim=8,
                              num_downsampling_chans=4)
UNETRPP = dict(hidden_size=16, depths=(1, 1), num_heads_encoder=2, num_heads_decoder=2,
               encoder_proj_sizes=(16, 16), downsampling_rate=2, decoder_proj_size=8)
SWIN = SwinUNetRSettings(feature_size=8, depths=(2, 2), num_heads=(2, 2), window_size=4)
MODELS = {
    "Segformer": (Segformer, SEGFORMER, 8),
    "UNetRPP_pallas": (UNetRPP, UNetRPPSettings(**UNETRPP, attention_code="pallas"), 4),
    "UNetRPP_torch_linear": (UNetRPP, UNetRPPSettings(**UNETRPP, attention_code="torch",
                                                      linear_upsampling=True), 4),
    "SwinUNetR": (SwinUNetR, SWIN, 16),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_on_two_bands_match_the_whole(name):
    """Each model's forward and every parameter's gradient on two bands
    of a 32x24 grid; the rows a band needs (``spatial_lat_multiple``).
    UNetRPP's stem and head conv biases feed instance norms: their
    gradients are rounding noise on both sides."""
    kls, settings, need = MODELS[name]
    model = _drawn(kls(5, 3, (32, 24), settings))
    assert model.spatial_shardable and kls.spatial_lat_multiple(settings) == need
    x = _randn(2, 32, 24, 5).requires_grad_()
    g = _randn(2, 32, 24, 3, seed=1)
    _hold(model, x, g, 2, name, _params(model))


@pytest.mark.parametrize("count", COUNTS)
def test_each_band_calls_kernel_c_as_often_as_one_process(count, monkeypatch):
    """UNetRPP under ``pallas``: each band calls c-fwd and c-bwd (their
    custom ops) as many times a forward and backward as one process, at
    the band's queries."""
    from py4cast_tpu_torch.ops import attention

    calls = []
    for kind in ("fwd", "bwd"):
        op = getattr(attention, f"short_kv_attention_{kind}")
        monkeypatch.setattr(attention, f"short_kv_attention_{kind}",
                            lambda *a, op=op, kind=kind: calls.append((kind, a[0].shape[1]))
                            or op(*a))
    model = _drawn(UNetRPP(5, 3, (32, 24), MODELS["UNetRPP_pallas"][1]))
    x = _randn(1, 32, 24, 5)

    def step(_band=None):
        out = model(x if _band is None else _band.cut(x, 1))
        out.square().sum().backward()

    step()
    whole = list(calls)
    assert len(whole) == 2 * 3 and {k for k, _ in whole} == {"fwd", "bwd"}
    run_on_bands(step, count, before_last=calls.clear)
    assert sorted(calls) == sorted((k, n // count) for k, n in whole * count)


def test_a_band_without_whole_windows_refuses():
    stage = SwinStage(8, 2, 2, 4, 0.0, 0.0, (0.0, 0.0), (16, 8))
    with on_band(Band(0, 2)), pytest.raises(ValueError, match="6 rows does not hold whole"):
        stage(_randn(1, 6, 8, 8))


@pytest.mark.parametrize("model,args,rows,need", [
    ("SwinUNetR", {"feature_size": 8, "depths": (2, 2), "num_heads": (2, 2), "window_size": 4},
     18, 16),
    ("Segformer", {"dims": (8, 16), "heads": (1, 2), "reduction_ratio": (4, 1),
                   "num_layers": 1, "decoder_dim": 8}, 20, 16),
    ("UNetRPP", dict(UNETRPP, depths=(1, 1, 1), encoder_proj_sizes=(8, 8, 8)), 18, 8),
])
def test_module_names_the_lat_multiple_a_band_needs(model, args, rows, need):
    """Under spatial 2 the attention models pad the lat to whole bands of
    the rows they need by default; a ``lat_multiple`` that leaves a band
    of too few rows raises naming the one that pads it so."""
    from py4cast_tpu_torch.parallel.mesh import Mesh
    from py4cast_tpu_torch.testing import synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule, TrainingSettings

    info = synthetic_dataset_info(grid_shape=(2 * rows, 32), weather_features=3,
                                  forcing_features=6, border_size=2)
    settings = TrainingSettings(model_name=model, settings_init_args=args,
                                training_strategy="scaled_ar", num_input_steps=2)
    mesh = Mesh(world_size=2, data=1, spatial=2)
    with pytest.raises(ValueError, match=f"band of {rows} rows.*multiple of {need} rows.*"
                                         f"lat_multiple={2 * need}"):
        AutoRegressiveModule(settings, info, device="cpu", mesh=mesh, lat_multiple=2)
    for multiple in (2 * need, None):
        module = AutoRegressiveModule(settings, info, device="cpu", mesh=mesh,
                                      lat_multiple=multiple)
        assert module._buffers["grid_statics"].shape[0] == -(-rows // need) * need
