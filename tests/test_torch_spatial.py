"""The spatial axis's local parts, in one process, on the CPU.

Each lat band's piece is fed by hand what its neighbours would send
(halo rows cut from a whole-grid tensor, band sums added up over every
band) and held against the unsharded op on the whole grid, forward and
backward: the bands' outputs concatenated against the whole output, and
the gradients of the whole input and of the weights, which autograd sums
over the bands, against the whole op's. Covered: the band cuts of the
statics and of the lattice metadata; ``FlaxConv2d`` (k 1 and 3,
dilation 1 and 2); ``GroupNorm``; ``max_pool_2x2``; HalfUNet's upsample
sum; the g2m hop's partial aggregates and the m2g corner hop
(``CornerHopFn``'s plain version) on each band against the same rows of
the whole grid. The refusals of what does not run on bands yet. The
collectives themselves run across gloo ranks in
``test_torch_spatial_ranks.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from py4cast_tpu_torch.models.base import FlaxConv2d, GroupNorm
from py4cast_tpu_torch.models.graph import GRID_LAT_AXES, GraphLAM, GraphModelSettings
from py4cast_tpu_torch.models.unet import _upsample
from py4cast_tpu_torch.ops.pool import max_pool_2x2
from py4cast_tpu_torch.parallel.mesh import Mesh
from py4cast_tpu_torch.parallel.spatial import Band, gather_lat, halo_rows, on_band
from py4cast_tpu_torch.testing import run_on_bands, synthetic_dataset_info, synthetic_statics
from py4cast_tpu_torch.training import AutoRegressiveModule, TrainingSettings, init_weights

#: a band's piece against the whole op, relative to scale (fp32: only
#: the order of the sums over the bands changes)
BAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, bar=BAR):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= bar, f"{what}: {err:.3e}"


def _randn(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _fed_halo(x, band: Band, halo: int):
    """Band ``band``'s rows of NHWC ``x`` with ``halo`` rows a side from
    its neighbours, zeros at the global edges: what ``halo_rows`` hands
    a band, cut by hand from the whole grid."""
    padded = F.pad(x, (0, 0, 0, 0, halo, halo))
    rows = band.rows(x.shape[1])
    return padded[:, rows.start:rows.stop + 2 * halo]


def _bands(count):
    return [Band(s, count) for s in range(count)]


# ------------------------------------------------------------- band cuts
def test_statics_band_cuts_the_whole():
    st = synthetic_statics((12, 10), border_size=2)
    assert st.band(0, 1) is st
    bands = [st.band(s, 3) for s in range(3)]
    for s, b in enumerate(bands):
        rows = slice(4 * s, 4 * s + 4)
        assert b.grid_shape == (4, 10)
        np.testing.assert_array_equal(b.grid_statics.array, st.grid_statics.array[rows])
        np.testing.assert_array_equal(b.border_mask, st.border_mask[rows])
        np.testing.assert_array_equal(b.interior_mask, st.interior_mask[rows])
        np.testing.assert_array_equal(b.meshgrid, st.meshgrid[:, rows])
    assert sum(b.interior_mask.sum() for b in bands) == st.interior_mask.sum()
    with pytest.raises(ValueError, match="do not split into 5 bands"):
        st.band(0, 5)


def _graphlam(band=None, grid=(16, 16), aggr="sum"):
    settings = GraphModelSettings(hidden_dims=8, mesh_levels=2, processor_layers=1,
                                  mesh_aggr=aggr)
    graph = GraphLAM.build_graph(settings, synthetic_statics(grid, 2).meshgrid)
    torch.manual_seed(0)
    return GraphLAM(5, 3, (grid[0] * grid[1],), settings, graph, band=band)


def test_lattice_metadata_band_cuts_the_whole():
    """Grid-side metadata: the band's rows of the whole model's; mesh-side
    metadata (levels, counts, column maps): whole on every band."""
    whole = _graphlam()
    for s in range(2):
        part = _graphlam((s, 2))
        assert part.grid_hw == (8, 16) and whole.grid_hw == (16, 16)
        for name, buf in whole.named_buffers():
            got = getattr(part, name)
            want = Band(s, 2).cut(buf, GRID_LAT_AXES[name]) if name in GRID_LAT_AXES else buf
            assert got.is_contiguous(), name
            assert torch.equal(got, want), name
    assert {"lat_g2m_feats", "lat_g2m_ar", "lat_m2g_feats", "lat_m2g_rows",
            "lat_m2g_ar"} <= {n for n, _ in whole.named_buffers()}


# -------------------------------------------------------------- the convs
@pytest.mark.parametrize("kernel,dilation,count", [(1, 1, 2), (3, 1, 2), (3, 2, 2), (3, 1, 4)])
def test_conv_on_fed_halos_matches_the_whole(kernel, dilation, count):
    torch.manual_seed(0)
    conv = FlaxConv2d(3, 5, kernel, dilation=dilation)
    x = _randn(2, 16, 12, 3).requires_grad_()
    g = _randn(2, 16, 12, 5, seed=1)
    want = conv(x)
    want_grads = torch.autograd.grad((want * g).sum(), [x, conv.weight, conv.bias])
    halo, bottom = conv.band_halo()
    assert halo == bottom == (kernel - 1) * dilation // 2
    got = torch.cat([conv.forward_halo(_fed_halo(x, b, halo)) for b in _bands(count)], dim=1)
    _close(got, want, "forward")
    got_grads = torch.autograd.grad((got * g).sum(), [x, conv.weight, conv.bias])
    for name, a, b in zip(("x", "weight", "bias"), got_grads, want_grads):
        _close(a, b, name)


def test_halo_rows_off_a_band_pads_zeros():
    x = _randn(1, 4, 3, 2)
    np.testing.assert_array_equal(halo_rows(x, 1, 2).numpy(), F.pad(x, (0, 0, 0, 0, 1, 2)))
    with on_band(Band(0, 1)):  # a band of one is no band
        np.testing.assert_array_equal(halo_rows(x, 1, 1).numpy(), F.pad(x, (0, 0, 0, 0, 1, 1)))
    assert gather_lat(x, 1) is x


def test_group_norm_on_summed_band_statistics_matches_the_whole():
    torch.manual_seed(0)
    gn = GroupNorm(2, 6)
    with torch.no_grad():
        gn.weight.copy_(_randn(6, seed=2))
        gn.bias.copy_(_randn(6, seed=3))
    x = (_randn(2, 16, 10, 6) * 3.0 + 1.5).requires_grad_()
    g = _randn(2, 16, 10, 6, seed=1)
    want = gn(x)
    want_grads = torch.autograd.grad((want * g).sum(), [x, gn.weight, gn.bias])
    bands = _bands(4)
    sums = sum(gn.band_sums(b.cut(x, 1)) for b in bands)
    got = torch.cat([gn.normalize(b.cut(x, 1), sums, 16 * 10 * 3) for b in bands], dim=1)
    _close(got, want, "forward")
    got_grads = torch.autograd.grad((got * g).sum(), [x, gn.weight, gn.bias])
    for name, a, b in zip(("x", "weight", "bias"), got_grads, want_grads):
        _close(a, b, name)


def test_pool_of_each_band_is_the_whole_pool():
    x = _randn(2, 16, 10, 3).requires_grad_()
    g = _randn(2, 8, 5, 3, seed=1)
    want = max_pool_2x2(x)
    (want_dx,) = torch.autograd.grad((want * g).sum(), [x])
    got = torch.cat([max_pool_2x2(b.cut(x, 1)) for b in _bands(4)], dim=1)
    assert torch.equal(got, want)
    (got_dx,) = torch.autograd.grad((got * g).sum(), [x])
    assert torch.equal(got_dx, want_dx)
    with on_band(Band(0, 2)), pytest.raises(ValueError, match="5 rows cannot pool"):
        max_pool_2x2(x[:, :5])


def test_upsample_sum_of_each_band_is_the_whole_sum():
    """HalfUNet's sum of its levels' nearest upsamples."""
    levels = [_randn(1, 16 // 2 ** l, 8 // 2 ** l, 4, seed=l) for l in range(3)]
    whole = sum(_upsample(f, 2 ** l) if l else f for l, f in enumerate(levels))
    for b in _bands(2):
        part = sum(_upsample(b.cut(f, 1), 2 ** l) if l else b.cut(f, 1)
                   for l, f in enumerate(levels))
        assert torch.equal(part, b.cut(whole, 1))


# ----------------------------------------------------------- the graph hops
@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_g2m_partial_aggregates_add_up_to_the_whole(aggr):
    """The bands' partial aggregates (each band's cut of the metadata, from
    a model built on that band) summed, then the count division and the
    node update, against the whole hop; gradients through both."""
    whole = _graphlam(aggr=aggr)
    lats = [_graphlam((s, 2), aggr=aggr)._lat("g2m", torch.float32) for s in range(2)]
    grid_v = _randn(2, 16, 16, 8).requires_grad_()
    mesh_v = _randn(2, *whole.graph.level_hw[0], 8, seed=1).requires_grad_()
    g = _randn(*mesh_v.shape, seed=2)
    hop = whole.g2m
    leaves = [grid_v, mesh_v, *hop.parameters()]
    want = hop(grid_v, mesh_v, whole._lat("g2m", torch.float32))
    want_grads = torch.autograd.grad((want * g).sum(), leaves)
    agg = sum(hop.aggregate(b.cut(grid_v, 1), mesh_v, lat) for b, lat in zip(_bands(2), lats))
    got = hop.update(mesh_v, agg, whole._lat("g2m", torch.float32))
    _close(got, want, "forward")
    got_grads = torch.autograd.grad((got * g).sum(), leaves)
    names = ["grid_v", "mesh_v", *(k for k, _ in hop.named_parameters())]
    for name, a, b in zip(names, got_grads, want_grads):
        _close(a, b, name)


def test_m2g_corner_hop_on_each_band_matches_the_whole_rows():
    """``CornerHopFn`` (its plain version here) on each band's rows,
    against the whole mesh projection: the bands' outputs are the whole
    grid's rows; ``dps`` and the weight gradients summed over the bands
    are the whole's."""
    whole = _graphlam()
    lats = [_graphlam((s, 2))._lat("m2g", torch.float32) for s in range(2)]
    mesh_v = _randn(2, *whole.graph.level_hw[0], 8).requires_grad_()
    grid_v = _randn(2, 16, 16, 8, seed=1).requires_grad_()
    g = _randn(2, 16, 16, 8, seed=2)
    hop = whole.m2g
    leaves = [mesh_v, grid_v, *hop.parameters()]
    want = hop(mesh_v, grid_v, whole._lat("m2g", torch.float32))
    want_grads = torch.autograd.grad((want * g).sum(), leaves, allow_unused=True,
                                     materialize_grads=True)
    got = torch.cat([hop(mesh_v, b.cut(grid_v, 1), lat) for b, lat in zip(_bands(2), lats)],
                    dim=1)
    _close(got, want, "forward")
    got_grads = torch.autograd.grad((got * g).sum(), leaves, allow_unused=True,
                                    materialize_grads=True)
    names = ["dps (mesh_v)", "grid_v", *(k for k, _ in hop.named_parameters())]
    for name, a, b in zip(names, got_grads, want_grads):
        _close(a, b, name)


# ------------------------------------------------------------- refusals
def _settings(model, args, **kw):
    return TrainingSettings(model_name=model, settings_init_args=args,
                            training_strategy="scaled_ar", num_input_steps=2, **kw)


SPATIAL_TWO = Mesh(world_size=2, data=1, spatial=2)
INFO = synthetic_dataset_info(grid_shape=(32, 32), weather_features=3, forcing_features=6,
                              border_size=2)


@pytest.mark.parametrize("kw,match", [
    ({"mask_ratio": 0.5}, 16),
    ({"losses": [{"class": "PerceptualLossPy4Cast", "weight": 1.0, "params": {}}]}, 16),
])
def test_module_refuses_what_reads_the_whole_grid(kw, match):
    """``mask_ratio`` and the perceptual loss build on a spatial mesh:
    each band keeps 16 of the 32 rows, a multiple of what the model's
    pool and the loss's subsamples need."""
    module = AutoRegressiveModule(_settings("HalfUNet", {"num_filters": 8, "depth": 2}, **kw),
                                  INFO, device="cpu", mesh=SPATIAL_TWO)
    assert module._buffers["grid_statics"].shape[0] == match
    assert module._lat_pad == 0


def test_module_refuses_bands_its_pools_cannot_split():
    """HalfUNet of depth 3 pools twice: a ``lat_multiple`` of 2 leaves
    bands of 18 rows (lat 36 at spatial 2) and raises, naming the
    lat_multiple that fixes it, which is the default."""
    info = synthetic_dataset_info(grid_shape=(36, 32), weather_features=3, forcing_features=6,
                                  border_size=2)
    with pytest.raises(ValueError, match="band of 18 rows.*multiple of 4.*lat_multiple=8"):
        AutoRegressiveModule(_settings("HalfUNet", {"num_filters": 8, "depth": 3}), info,
                             device="cpu", mesh=SPATIAL_TWO, lat_multiple=2)
    for multiple in (8, None):
        module = AutoRegressiveModule(_settings("HalfUNet", {"num_filters": 8, "depth": 3}),
                                      info, device="cpu", mesh=SPATIAL_TWO,
                                      lat_multiple=multiple)
        assert module._lat_pad == 4
        assert module._buffers["grid_statics"].shape[:2] == (20, 32)


def test_strided_or_asymmetric_convs_refuse_a_band():
    """A strided conv refuses a band whose rows its stride does not
    split; an explicitly padded one (the ResNet encoder's) runs on bands
    that it splits, as on the whole grid."""
    x = _randn(1, 5, 4, 2)
    with on_band(Band(0, 2)):
        with pytest.raises(ValueError, match="band of 5 rows does not split into the stride 2"):
            FlaxConv2d(2, 2, 3, stride=2)(x)
        with pytest.raises(ValueError, match="band of 5 rows does not split into the stride 2"):
            FlaxConv2d(2, 2, 3, stride=2, padding=1)(x)
    conv = FlaxConv2d(2, 3, 3, stride=2, padding=1)
    init_weights(conv, torch.Generator().manual_seed(0))
    whole, g = _randn(1, 8, 4, 2).requires_grad_(), _randn(1, 4, 2, 3, seed=1)
    leaves = [whole, conv.weight, conv.bias]
    want = conv(whole)
    want_grads = torch.autograd.grad((want * g).sum(), leaves)

    def band_step(band):
        out = conv(band.cut(whole, 1))
        return out.detach(), torch.autograd.grad((out * band.cut(g, 1)).sum(), leaves)

    got = run_on_bands(band_step, 2)
    _close(torch.cat([r[0] for r in got], dim=1), want, "explicitly padded conv on 2 bands")
    for i, w in enumerate(want_grads):
        _close(got[0][1][i] + got[1][1][i], w, f"explicitly padded conv on 2 bands: grad {i}")


def test_band_modules_keep_their_band_of_the_statics():
    """Each spatial rank's buffers are its band's rows; the loss still
    counts the whole grid's interior."""
    whole = AutoRegressiveModule(_settings("HiLAM", {"hidden_dims": 8, "mesh_levels": 2}), INFO,
                                 device="cpu", mesh=Mesh())
    for s in range(2):
        part = AutoRegressiveModule(_settings("HiLAM", {"hidden_dims": 8, "mesh_levels": 2}),
                                    INFO, device="cpu",
                                    mesh=Mesh(rank=s, local_rank=s, world_size=2, data=1,
                                              spatial=2))
        rows = slice(s * 512, (s + 1) * 512)
        for name in ("grid_statics", "border_mask", "interior_mask"):
            assert torch.equal(part._buffers[name], whole._buffers[name][rows]), name
        assert part.model.grid_hw == (16, 32)
        assert part.interior_mask_np.sum() == whole.interior_mask_np.sum()
