"""The graph models at hidden widths above the CUDA kernels' row-tile
instances, in the port against the JAX package on the CPU: GraphLAM at
``hidden_dims`` 96 and 128 and HiLAM at 128 (32x32 grid, lattices 8²,
4², 2², one processor layer), forward and every gradient from the same
numpy-drawn variables (``convert.params_from_jax``), and three AdamW
steps on Dummy from the same converted parameters; and the plain
versions of kernels a and b, forward and backward, at width 130 against
the JAX package's Pallas kernels in interpret mode.

On the CPU the stencil and corner-hop stages run the plain versions of
kernels a and b (``ops/stencil_kernel.py``, ``ops/hop_kernel.py``), which
take any width; on the card their wide instances (``csrc/wide_rows.cuh``)
are held to the same plain versions (tests/test_torch_cuda.py).

Bars: 1e-4 of the largest JAX value (absolute below 1) for the models
and their gradients, and 1e-4 relative for the AdamW losses
(tests/test_torch_graphlam.py's and tests/test_torch_hilam.py's: the
port sums in another order than XLA across the levels and LayerNorms);
1e-5 for the kernels' forwards and 2e-4 for their gradients, the JAX
kernel tests' own bars (tests/test_stencil_kernel.py,
tests/test_hop_kernel.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu.ops import hop_kernel as jax_hop
from py4cast_tpu.ops import lattice_ops as jax_lat
from py4cast_tpu.ops import stencil_kernel as jax_stencil
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import graph as port_graph
from py4cast_tpu_torch.models.graph import _corners_rc
from py4cast_tpu_torch.ops import hop_kernel, stencil_kernel
from py4cast_tpu_torch.ops import lattice_ops as port_lat

BAR = 1e-4
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
F_IN, F_OUT = 5, 2
MESHGRID = np.stack(
    np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
).astype(np.float32)
#: (model, hidden_dims): past b-bwd's and a-bwd's row tiles (96), and
#: past b-fwd's (128)
MODELS = [("GraphLAM", 96), ("GraphLAM", 128), ("HiLAM", 128)]
#: kernels a and b at a width past every row-tile instance, not a
#: multiple of 4 or of 128
WIDE = 130


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


def _settings(hidden):
    return {"hidden_dims": hidden, "processor_layers": 1, "mesh_levels": 3}


def _numpy_variables(shapes, rng):
    """Variables of the given shapes drawn with numpy: kernels with
    lecun-normal spread over the input axis, LayerNorm scales about 1,
    biases about 0, so that every parameter moves the output."""

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=MODELS, ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """The JAX model's variables, an input, its output and the gradients
    of sum(y²) (one jit), and the port's model with the variables
    loaded."""
    model, hidden = request.param
    js = jax_graph.GraphModelSettings(**_settings(hidden))
    jm = getattr(jax_graph, model)(num_input_features=F_IN, num_output_features=F_OUT,
                                   input_shape=(1024,), settings=js,
                                   graph=jax_graph.build_graph_artifacts(MESHGRID, js))
    rng = np.random.default_rng(hidden)
    x = rng.standard_normal((2, 1024, F_IN)).astype(np.float32)
    variables = _numpy_variables(jax.eval_shape(jm.init, jax.random.key(0), x), rng)

    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    ps = port_graph.GraphModelSettings(**_settings(hidden))
    pm = getattr(port_graph, model)(F_IN, F_OUT, (1024,), ps,
                                    port_graph.build_graph_artifacts(MESHGRID, ps))
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return x, np.asarray(want), params_from_jax(jax.tree.map(np.asarray, grads)), pm


def test_wide_forward_matches_jax(case):
    x, want, _, pm = case
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1024, F_OUT)
    _close(got, want, BAR, "y")


def test_wide_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter, each moved."""
    x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    for name, p in pm.named_parameters():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name].numpy(), BAR, name)
        assert float(p.grad.abs().max()) > 0, name


@pytest.fixture(scope="module")
def dummy_train():
    return jax_get_datasets("dummy", 2, 1, 3)[0], port_get_datasets("dummy", 2, 1, 3)[0]


@pytest.mark.parametrize("model,hidden", MODELS, ids=[f"{m}-{h}" for m, h in MODELS])
def test_wide_adamw_step_losses_match_jax(dummy_train, model, hidden):
    """Three AdamW steps on Dummy (64x64, batch 8, 1 AR step) from the
    JAX module's parameters, converted: the losses track the JAX
    package's within 1e-4."""
    jax_train, port_train = dummy_train
    settings = dict(model_name=model, settings_init_args=_settings(hidden),
                    training_strategy="diff_ar", num_pred_steps_train=1,
                    num_pred_steps_val_test=1, num_warmup_steps=2)
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                           jax_train.dataset_info)
    state = jm.init_state(jax.random.key(0), 3)
    pm = port_training.AutoRegressiveModule(port_training.TrainingSettings(**settings),
                                            port_train.dataset_info, device="cpu")
    pstate = pm.init_state(None, 3, params_from_jax(jax.tree.map(np.asarray, state.params)))
    j_losses, p_losses = [], []
    batches = zip(jax_train.loader(batch_size=8, num_workers=1),
                  port_train.loader(batch_size=8, num_workers=1))
    for _, (jb, pb) in zip(range(3), batches):
        state, loss = jm.train_step(state, jb, jax.random.key(2))
        j_losses.append(float(loss))
        p_losses.append(float(pm.train_step(pstate, pb)))
    assert pstate.step == 3
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    assert len(set(p_losses)) == 3


# ------------------------------------------- kernels a and b at width 130
def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc + sh for s, sc, sh in shapes]


def _t(arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


#: a 4x5 lattice (the stencil); a ragged 9x7 grid over a 3x3 mesh level 0
#: whose last row and column clip (the corner hop)
B, H, W, FF = 2, 4, 5, 3
GH, GW, MH, MW = 9, 7, 3, 3


def _weights(h, seed):
    """(we, be, wo, bo, lns, lnb) at width h, products of unit spread."""
    return _arrays(seed, [((h, h), h ** -0.5, 0.0), ((h,), 0.1, 0.0),
                          ((h, h), h ** -0.5, 0.0), ((h,), 0.1, 0.0),
                          ((h,), 0.2, 1.0), ((h,), 0.1, 0.0)])


def _hop_rest(h, hr, w, seed):
    """vd, feats and the corner hop's weights at width h."""
    vd, feats = _arrays(seed, [((B, hr, w, h), 1.0, 0.0), ((4, hr, w, FF), 0.5, 0.0)])
    s = h ** -0.5
    params = _arrays(seed + 1, [
        ((FF, h), 0.5, 0.0), ((h,), 0.1, 0.0),                  # wf, bf
        ((h, h), s, 0.0), ((h, h), s, 0.0),                     # wd, wo
        ((h,), 0.1, 0.0), ((h,), 0.2, 1.0), ((h,), 0.1, 0.0),   # bo, lns, lnb
        ((h, h), s, 0.0), ((h, h), s, 0.0),                     # nd0a, nd0b
        ((h,), 0.1, 0.0), ((h, h), s, 0.0),                     # nb0, nd1
        ((h,), 0.1, 0.0), ((h,), 0.2, 1.0), ((h,), 0.1, 0.0),   # nb1, nlns, nlnb
    ])
    return [vd, feats] + params


@pytest.mark.parametrize("residual", [False, True])
def test_wide_stencil_plain_matches_pallas_interpret(residual):
    """a-fwd's plain version (ps shifted by the port) against the JAX
    kernel fed the JAX package's shift2d stack."""
    e, ps, pd = _arrays(40, [((B, 8, H, W, WIDE), 1.0, 0.0), ((B, H, W, WIDE), 1.0, 0.0),
                             ((B, H, W, WIDE), 1.0, 0.0)])
    mask = (np.random.default_rng(41).uniform(size=(8, H, W, 1)) > 0.2).astype(np.float32)
    args = [e, ps, pd, mask] + _weights(WIDE, 42)
    j = [jnp.asarray(a) for a in args]
    j[1] = jnp.stack([jax_lat.shift2d(j[1], di, dj) for di, dj in jax_lat.DIRS8], axis=1)
    want = jax_stencil.fused_stencil_message(*j, interpret=True, mode=1, residual=residual)
    got = stencil_kernel.fused_stencil_message(*_t(args), residual=residual)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)


@pytest.mark.parametrize("mean", [False, True])
def test_wide_hop_plain_matches_pallas_interpret(mean):
    """b-fwd's plain version (corners gathered by the port's maps)
    against the JAX kernel fed the JAX package's sep_take_mm corners."""
    (ps,) = _arrays(43, [((B, MH, MW, WIDE), 1.0, 0.0)])
    (r0, r1), (c0, c1) = _corners_rc((GH, GW), (MH, MW))
    rows, cols = (np.stack(m).astype(np.int32) for m in ((r0, r1), (c0, c1)))
    ar = np.stack([port_lat.sel_matrix(r, MH) for r in rows])
    ac = np.stack([port_lat.sel_matrix(c, MW) for c in cols])
    rest = _hop_rest(WIDE, GH, GW, 44)
    corners = [jax_lat.sep_take_mm(jnp.asarray(ps), jnp.asarray(ar[k // 2]),
                                   jnp.asarray(ac[k % 2])) for k in range(4)]
    want = jax_hop.fused_corner_hop(corners, *[jnp.asarray(a) for a in rest], mean=mean,
                                    interpret=True, mode=1)
    got = hop_kernel.fused_corner_hop(*_t([ps, rows, cols]), *_t(rest), mean=mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("residual", [False, True])
def test_wide_stencil_bwd_plain_matches_pallas_vjp(residual):
    """a-bwd's plain version against jax.vjp of the JAX kernel."""
    e, vs, pd, g_out, g_agg = _arrays(45, [((B, 8, H, W, WIDE), 1.0, 0.0)] * 2
                                      + [((B, H, W, WIDE), 1.0, 0.0),
                                         ((B, 8, H, W, WIDE), 1.0, 0.0),
                                         ((B, H, W, WIDE), 1.0, 0.0)])
    mask = (np.random.default_rng(46).uniform(size=(8, H, W, 1)) > 0.2).astype(np.float32)
    args = [e, vs, pd, mask] + _weights(WIDE, 47)
    jargs = [jnp.asarray(a) for a in args]

    def fwd(e, vs, pd, we, be, wo, bo, lns, lnb):
        return jax_stencil.fused_stencil_message(e, vs, pd, jargs[3], we, be, wo, bo, lns, lnb,
                                                 interpret=True, mode=1, residual=residual)

    _, vjp = jax.vjp(fwd, *jargs[:3], *jargs[4:])
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_agg)))
    got = stencil_kernel.fused_stencil_message_bwd(*_t(args), *_t([g_out, g_agg]),
                                                   residual=residual)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("mean", [False, True])
def test_wide_hop_bwd_plain_matches_pallas_vjp(mean):
    """b-bwd's plain version against jax.vjp of the JAX kernel."""
    psg = _arrays(48, [((B, H, W, WIDE), 1.0, 0.0)] * 4)
    rest = _hop_rest(WIDE, H, W, 49)
    (g,) = _arrays(50, [((B, H, W, WIDE), 1.0, 0.0)])
    jrest = [jnp.asarray(a) for a in rest]

    def fwd(p0, p1, p2, p3, vd, *weights):
        return jax_hop.fused_corner_hop([p0, p1, p2, p3], vd, jrest[1], *weights, mean=mean,
                                        interpret=True, mode=1)

    _, vjp = jax.vjp(fwd, *[jnp.asarray(p) for p in psg], jrest[0], *jrest[2:])
    want = vjp(jnp.asarray(g))
    got = hop_kernel.fused_corner_hop_bwd(_t(psg), *_t(rest), torch.from_numpy(g), mean=mean)
    assert len(got) == len(want) == 19
    for i, (gr, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gr.numpy(), np.asarray(w), **GRAD_TOL, err_msg=f"grad {i}")
