"""The port's lattice primitives and graph construction against the JAX
package's: exact equality (the same numpy arithmetic, and 0/1 selection
matmuls that each pick one value)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu.ops import lattice_ops as jax_lat
from py4cast_tpu_torch.models import graph as port_graph
from py4cast_tpu_torch.ops import lattice_ops as port_lat


@pytest.fixture(scope="module")
def lattice():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 8, 8, 16)).astype(np.float32)


def test_dirs8_order_matches():
    assert port_lat.DIRS8 == jax_lat.DIRS8


@pytest.mark.parametrize("di,dj", jax_lat.DIRS8)
def test_shift2d_exact(lattice, di, dj):
    want = np.asarray(jax_lat.shift2d(jnp.asarray(lattice), di, dj))
    got = port_lat.shift2d(torch.from_numpy(lattice), di, dj).numpy()
    np.testing.assert_array_equal(got, want)


#: lattices where the shifts fall off every side, down to a single cell
SHIFT_LATTICES = [(2, 8, 8, 16), (1, 1, 1, 4), (1, 1, 5, 3), (2, 2, 3, 5)]


@pytest.mark.parametrize("shape", SHIFT_LATTICES)
def test_stack_shifts_exact(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x)
    want = np.asarray(jnp.stack([jax_lat.shift2d(jx, di, dj) for di, dj in jax_lat.DIRS8], 1))
    got = port_lat.stack_shifts(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHIFT_LATTICES)
def test_unshift_sum_is_the_adjoint_of_stack_shifts(shape):
    """<stack_shifts(x), y> = <x, unshift_sum(y)> on random inputs (fp64,
    so that the two sums' orders agree to rounding)."""
    rng = np.random.default_rng(3)
    b, hr, w, h = shape
    x = torch.from_numpy(rng.standard_normal(shape))
    y = torch.from_numpy(rng.standard_normal((b, 8, hr, w, h)))
    lhs = float((port_lat.stack_shifts(x) * y).sum())
    rhs = float((x * port_lat.unshift_sum(y)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))
    assert port_lat.unshift_sum(y).shape == x.shape


@pytest.mark.parametrize("shape", SHIFT_LATTICES)
def test_unshift_sum_matches_jax_vjp_of_the_shift_stack(shape):
    import jax

    rng = np.random.default_rng(4)
    b, hr, w, h = shape
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal((b, 8, hr, w, h)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda v: jnp.stack([jax_lat.shift2d(v, di, dj) for di, dj in jax_lat.DIRS8], 1),
        jnp.asarray(x))
    (want,) = vjp(jnp.asarray(y))
    got = port_lat.unshift_sum(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def _maps():
    rows = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    cols = np.array([0, 1, 1, 2, 2, 3, 3, 3])
    return port_lat.sel_matrix(rows, 4), port_lat.sel_matrix(cols, 4)


def test_sel_matrix_exact():
    idx = np.array([0, 2, 2, 1])
    np.testing.assert_array_equal(port_lat.sel_matrix(idx, 3), jax_lat.sel_matrix(idx, 3))


def test_sep_take_mm_exact(lattice):
    a_r, a_c = _maps()
    coarse = lattice[:, :4, :4]
    want = np.asarray(jax_lat.sep_take_mm(jnp.asarray(coarse), a_r, a_c))
    got = port_lat.sep_take_mm(
        torch.from_numpy(coarse), torch.from_numpy(a_r), torch.from_numpy(a_c)
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_sep_aggregate_exact(lattice):
    a_r, a_c = _maps()
    # small integers: their sums are exact in fp32 whatever the order
    ints = np.round(lattice * 8)
    want = np.asarray(jax_lat.sep_aggregate(jnp.asarray(ints), a_r, a_c))
    got = port_lat.sep_aggregate(
        torch.from_numpy(ints), torch.from_numpy(a_r), torch.from_numpy(a_c)
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_stencil_and_pair_feats_exact():
    rng = np.random.default_rng(1)
    pos = rng.uniform(size=(6, 7, 2)).astype(np.float32)
    for a, b in zip(port_lat.stencil_feats(pos), jax_lat.stencil_feats(pos)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port_lat.stencil_feats(pos, 0.5), jax_lat.stencil_feats(pos, 0.5)):
        np.testing.assert_array_equal(a, b)
    dst = rng.uniform(size=(6, 7, 2)).astype(np.float32)
    for a, b in zip(port_lat.pair_feats(pos, dst), jax_lat.pair_feats(pos, dst)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw,levels", [((32, 32), 3), ((40, 24), 2)])
def test_build_graph_artifacts_exact(hw, levels):
    h, w = hw
    mg = np.stack(
        np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 2, w), indexing="ij")
    ).astype(np.float32)
    js = jax_graph.GraphModelSettings(mesh_levels=levels)
    ps = port_graph.GraphModelSettings(mesh_levels=levels)
    want = jax_graph.build_graph_artifacts(mg, js)
    got = port_graph.build_graph_artifacts(mg, ps)
    assert got.level_hw == want.level_hw
    assert got.multi_lattice_ok == want.multi_lattice_ok
    assert sorted(got.lattice_np) == sorted(want.lattice_np)
    assert got.n_grid == want.n_grid
    for a, b in zip(got.mesh_pos, want.mesh_pos):
        np.testing.assert_array_equal(a, b)
    for k in want.lattice_np:
        np.testing.assert_array_equal(got.lattice_np[k], want.lattice_np[k], err_msg=k)


def test_degenerate_multimesh_is_flagged():
    """A 2x2 level-0 lattice repeats edges across levels: both packages
    flag it, and the port's GraphLAM falls through to the table path, as
    the JAX package's does, and runs."""
    mg = np.stack(np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 8),
                              indexing="ij")).astype(np.float32)
    js = jax_graph.GraphModelSettings(mesh_levels=2)
    ps = port_graph.GraphModelSettings(mesh_levels=2)
    assert not jax_graph.build_graph_artifacts(mg, js).multi_lattice_ok
    graph = port_graph.build_graph_artifacts(mg, ps)
    assert not graph.multi_lattice_ok
    model = port_graph.GraphLAM(4, 1, (64,), ps, graph)
    assert model.table_path
    with torch.no_grad():
        y = model(torch.ones(2, 64, 4))
    assert y.shape == (2, 64, 1) and bool(torch.isfinite(y).all())
