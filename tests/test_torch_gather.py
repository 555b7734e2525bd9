"""The gather-table GNN path in the port against the JAX package on the
CPU (``use_lattice: false``, and GraphLAM on a multimesh whose union
repeats edges): the graph arrays and tables bit for bit, the two
gather primitives and their VJPs against ``jax.vjp``, GraphLAM, HiLAM
and HiLAMParallel forward and every gradient against the JAX package's
table path, the port's table path against its lattice path under one
state dict, and one bf16 forward and gradient.

Bars: the primitives 1e-5 (forward) and 2e-4 (VJP), the JAX kernel
tests' bars; a whole model 1e-4 of the largest JAX value (absolute
below 1), as tests/test_torch_hilam.py; the port's two paths 1e-5; bf16
the bars of tests/test_torch_bf16.py."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu.ops import graph_ops as jax_ops
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.models import graph as port_graph
from py4cast_tpu_torch.ops import graph_ops as port_ops
from tests.test_torch_bf16 import check_against_jax

BAR = 1e-4
F_IN, F_OUT = 5, 3
H, W = 24, 20  # tests/test_lattice_graph.py's grid
SMALL = dict(hidden_dims=8, processor_layers=2, mesh_levels=3)
MESHGRID = np.stack(np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


def _draw(shapes, seed=0):
    """Variables drawn with numpy: kernels of lecun-normal spread over
    the input axis, LayerNorm scales about 1, biases about 0."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(name, meshgrid=MESHGRID, **settings):
    """The JAX and port models ``name`` on one graph each."""
    js = jax_graph.GraphModelSettings(**settings)
    ps = port_graph.GraphModelSettings(**settings)
    n = meshgrid.shape[1] * meshgrid.shape[2]
    jm = getattr(jax_graph, name)(num_input_features=F_IN, num_output_features=F_OUT,
                                  input_shape=(n,), settings=js,
                                  graph=jax_graph.build_graph_artifacts(meshgrid, js))
    pm = getattr(port_graph, name)(F_IN, F_OUT, (n,), ps,
                                   port_graph.build_graph_artifacts(meshgrid, ps))
    return jm, pm


# --------------------------------------------------------------- graph data
def test_graph_arrays_equal_the_jax_package_bit_for_bit():
    """Every key of graph_arrays (mesh positions, each edge set's src,
    dst, features, padded inverse tables and in-degrees, the lattice
    metadata) and the regular-K map, on the 24x20 grid."""
    js = jax_graph.GraphModelSettings(**SMALL)
    g = jax_graph.build_graph_artifacts(MESHGRID, js)
    want = jax_graph._GraphModelBase.graph_arrays(g)
    got, regular = port_graph.graph_arrays(
        port_graph.build_graph_artifacts(MESHGRID, port_graph.GraphModelSettings(**SMALL)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert regular == g._regular_k == {"m2g": 4, "intra_2": 3, "down_0": 1, "down_1": 1}


def test_build_table_equals_the_jax_package():
    """Rows with no entry, ragged counts, the pad value len(idx)."""
    idx = np.array([3, 0, 3, 3, 1, 0, 5], np.int32)
    np.testing.assert_array_equal(port_ops.build_table(idx, 7), jax_ops.build_table(idx, 7))
    np.testing.assert_array_equal(port_ops.build_table(idx, 7)[[2, 4, 6]], 7)


# --------------------------------------------------------------- primitives
def _edge_set(seed=0, n_src=9, n_dst=7, n_e=23):
    """A random edge set whose destinations 2 and 5 receive nothing and
    whose sources 3 and 6 send nothing, so that their table rows are all
    padding."""
    rng = np.random.default_rng(seed)
    dst = rng.choice([0, 1, 3, 4, 6], size=n_e).astype(np.int32)
    src = rng.choice([0, 1, 2, 4, 5, 7, 8], size=n_e).astype(np.int32)
    return src, dst, jax_ops.build_table(src, n_src), jax_ops.build_table(dst, n_dst)


def test_edge_aggregate_and_its_vjp_match_jax():
    src, dst, _, dst_table = _edge_set()
    rng = np.random.default_rng(1)
    e = rng.standard_normal((2, len(dst), 6)).astype(np.float32)
    g = rng.standard_normal((2, dst_table.shape[0], 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_ops.edge_aggregate(a, dst_table, dst), e)
    (want_de,) = vjp(g)
    et = torch.from_numpy(e).requires_grad_()
    got = port_ops.edge_aggregate(et, torch.from_numpy(dst_table).long(),
                                  torch.from_numpy(dst).long())
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(got.detach()[:, [2, 5]].abs().max()) == 0.0
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want_de), rtol=2e-4, atol=2e-4)


def test_gather_nodes_and_its_vjp_match_jax():
    src, _, src_table, _ = _edge_set(seed=2)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((2, src_table.shape[0], 6)).astype(np.float32)
    g = rng.standard_normal((2, len(src), 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_ops.gather_nodes(a, src, src_table), v)
    (want_dv,) = vjp(g)
    vt = torch.from_numpy(v).requires_grad_()
    got = port_ops.gather_nodes(vt, torch.from_numpy(src).long(),
                                torch.from_numpy(src_table).long())
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want_dv), rtol=2e-4, atol=2e-4)
    assert float(vt.grad[:, [3, 6]].abs().max()) == 0.0


def test_primitives_backward_through_their_own_gathers():
    """Both backward passes are gathers through the tables (the autograd
    Functions' own backward), not autograd through index_select, whose
    backward is index_add_."""
    src, dst, src_table, dst_table = _edge_set()
    v = torch.randn(1, src_table.shape[0], 4, requires_grad=True)
    e = port_ops.gather_nodes(v, torch.from_numpy(src).long(), torch.from_numpy(src_table).long())
    agg = port_ops.edge_aggregate(e, torch.from_numpy(dst_table).long(),
                                  torch.from_numpy(dst).long())
    assert type(agg.grad_fn).__name__ == "EdgeAggregateFnBackward"
    assert type(e.grad_fn).__name__ == "GatherNodesFnBackward"


# ------------------------------------------------------------------- models
@pytest.fixture(scope="module", params=["GraphLAM", "HiLAM", "HiLAMParallel"])
def case(request):
    """The JAX model on its table path (``use_lattice: false``, sum), its
    variables, an input, its output and gradients of sum(y²), and the
    port's model on its table path with the variables loaded."""
    jm, pm = _models(request.param, **SMALL, use_lattice=False)
    x = np.random.default_rng(1).standard_normal((2, H * W, F_IN)).astype(np.float32)
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x))

    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return request.param, x, np.asarray(want), params_from_jax(
        jax.tree.map(np.asarray, grads)), pm


def test_table_path_forward_matches_jax(case):
    name, x, want, _, pm = case
    assert pm.table_path and not hasattr(pm, "lat_m2g_feats")
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H * W, F_OUT)
    _close(got, want, BAR, name)


def test_table_path_gradients_match_jax(case):
    """Every parameter's gradient; HiLAMParallel's parameters that cannot
    reach level 0 get none in the port and zeros in JAX."""
    name, x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    for k, p in pm.named_parameters():
        if p.grad is None:
            assert name == "HiLAMParallel" and float(want[k].abs().max()) == 0.0, k
            continue
        _close(p.grad.numpy(), want[k].numpy(), BAR, k)


def test_table_path_equals_the_lattice_path_on_one_state_dict(case):
    """The port's lattice path (kernels a and b's plain versions here)
    from the same state dict, within 1e-5; and a checkpoint of either
    path loads strictly into the other."""
    name, x, _, _, table = case
    _, lattice = _models(name, **SMALL)
    assert not lattice.table_path
    buf = io.BytesIO()
    torch.save(table.state_dict(), buf)
    buf.seek(0)
    lattice.load_state_dict(torch.load(buf), strict=True)
    assert list(lattice.state_dict()) == list(table.state_dict())
    with torch.no_grad():
        a, b = lattice(torch.from_numpy(x)), table(torch.from_numpy(x))
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        table.load_state_dict(lattice.state_dict(), strict=True)
        assert torch.equal(table(torch.from_numpy(x)), b)


def test_graphlam_mean_forward_matches_jax():
    jm, pm = _models("GraphLAM", **SMALL, use_lattice=False, mesh_aggr="mean")
    x = np.random.default_rng(4).standard_normal((1, H * W, F_IN)).astype(np.float32)
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x), seed=5)
    want = jax.jit(jm.apply)(variables, x)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)).numpy(), want, BAR)


def test_graphlam_takes_the_table_path_on_a_degenerate_multimesh():
    """An 8x8 grid at mesh_levels 2 gives a 2x2 level-0 lattice whose
    union repeats edges across levels: with use_lattice true both
    packages run GraphLAM on the table path, and agree."""
    mg = np.stack(np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 8),
                              indexing="ij")).astype(np.float32)
    jm, pm = _models("GraphLAM", mg, hidden_dims=8, processor_layers=2, mesh_levels=2)
    assert not jm.graph.multi_lattice_ok and not jm._lattice_on(need_multi=True)
    assert pm.settings.use_lattice and pm.table_path
    x = np.random.default_rng(6).standard_normal((2, 64, F_IN)).astype(np.float32)
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x), seed=7)
    want = jax.jit(jm.apply)(variables, x)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    _close(got, want, BAR)


def test_table_path_bf16_matches_jax():
    """GraphLAM's table path in bf16 (edge features and in-degrees cast
    to bf16, as the JAX package's ``_garr``): forward and gradient
    vector within the bars of tests/test_torch_bf16.py."""
    settings = dict(SMALL, processor_layers=1, use_lattice=False)
    jm, pm = _models("GraphLAM", **settings)
    x = np.random.default_rng(8).standard_normal((2, H * W, F_IN)).astype(np.float32)
    check_against_jax("GraphLAM table", jm, pm, x)

