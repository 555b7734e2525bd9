"""HiLAM and HiLAMParallel in the port against the JAX package on the
CPU: the same variables (converted by ``convert.params_from_jax``) and
the same inputs through both, forward and every gradient, with sum and
mean aggregation on a 32x32 grid (lattices 8², 4², 2²): HiLAM with
mean, HiLAMParallel with sum, and the other way round in
``Trainer.predict`` on Dummy; three AdamW steps of HiLAM end to end.

On the CPU the stencil and corner-hop stages run the plain versions of
kernels a and b (``ops/stencil_kernel.py``, ``ops/hop_kernel.py``), the
same formulas the CUDA kernels are held to on the card.

Bar: 1e-4 of the largest JAX value (absolute below 1). The port sums in
another order than XLA across the sweep's levels, the processor layers
and their LayerNorms."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import graph as port_graph

BAR = 1e-4
F_IN, F_OUT = 5, 2
SMALL = {"hidden_dims": 8, "processor_layers": 2, "mesh_levels": 3}
MESHGRID = np.stack(
    np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
).astype(np.float32)


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


def _port_model(model, **settings):
    ps = port_graph.GraphModelSettings(**settings)
    return getattr(port_graph, model)(F_IN, F_OUT, (1024,), ps,
                                      port_graph.build_graph_artifacts(MESHGRID, ps))


def _numpy_variables(shapes, rng):
    """Variables of the given shapes drawn with numpy: kernels with
    lecun-normal spread (over the input axis; a scanned kernel has the
    layer axis first), LayerNorm scales about 1, biases about 0 — not
    Flax's zero biases and unit scales, so that every parameter moves
    the output."""

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=[("HiLAM", "mean"), ("HiLAMParallel", "sum")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """The JAX model's variables (numpy), an input, its output and the
    gradients of sum(y²), and the port's model with the variables
    loaded."""
    model, aggr = request.param
    settings = dict(SMALL, mesh_aggr=aggr)
    js = jax_graph.GraphModelSettings(**settings)
    jm = getattr(jax_graph, model)(num_input_features=F_IN, num_output_features=F_OUT,
                                   input_shape=(1024,), settings=js,
                                   graph=jax_graph.build_graph_artifacts(MESHGRID, js))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1024, F_IN)).astype(np.float32)
    variables = _numpy_variables(jax.eval_shape(jm.init, jax.random.key(0), x), rng)
    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    want = np.asarray(want)
    pm = _port_model(model, **settings)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return model, variables, x, want, params_from_jax(jax.tree.map(np.asarray, grads)), pm


def test_params_from_jax_fills_every_parameter(case):
    """Every parameter, by name and shape; the scanned processor axis is
    split at the deeper nesting of the hierarchy's steps."""
    model, variables, _, _, _, pm = case
    state = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    proc = variables["params"]["processor"]
    if model == "HiLAM":
        kernel, name = proc["intra_down_0"]["edge"]["w_e"]["kernel"], "intra_down_0.edge.w_e"
    else:
        kernel, name = proc["up_1"]["w_s"]["kernel"], "up_1.w_s"
    for layer in range(SMALL["processor_layers"]):
        np.testing.assert_array_equal(state[f"processor.{layer}.{name}.weight"].numpy(),
                                      kernel[layer].T)


def test_forward_matches_jax(case):
    *_, x, want, _, pm = case
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1024, F_OUT)
    _close(got, want, BAR)


def test_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter. HiLAMParallel's last
    layer cannot reach level 0 from levels 1 and 2 within one layer: its
    parameters there get no gradient in the port and zeros in JAX."""
    model, _, x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    unreached = []
    for name, p in pm.named_parameters():
        if p.grad is None:
            assert float(want[name].abs().max()) == 0.0, name
            unreached.append(name)
            continue
        _close(p.grad.numpy(), want[name].numpy(), BAR, name)
        assert float(p.grad.abs().max()) > 0, name
    if model == "HiLAM":
        assert unreached == []
    else:
        assert unreached and all(n.startswith(("processor.1.", "processor.0.",
                                               "intra_edge_embed_2", "up_edge_embed_1"))
                                 for n in unreached)


def test_gather_table_path_is_not_ported():
    """The name predates the gather-table path's port: ``use_lattice:
    false`` now builds HiLAM and HiLAMParallel on that path, which takes
    the lattice path's state dict and gives its output within 1e-5."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1024, F_IN))
                         .astype(np.float32))
    for model in ("HiLAM", "HiLAMParallel"):
        lattice = _port_model(model, **SMALL)
        port_training.init_weights(lattice, torch.Generator().manual_seed(0))
        table = _port_model(model, **SMALL, use_lattice=False)
        assert table.table_path and not lattice.table_path
        table.load_state_dict(lattice.state_dict(), strict=True)
        with torch.no_grad():
            got, want = table(x), lattice(x)
        assert got.shape == (2, 1024, F_OUT) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dummy_data():
    return jax_get_datasets("dummy", 2, 2, 3), port_get_datasets("dummy", 2, 2, 3)


@pytest.mark.parametrize("model,aggr", [("HiLAM", "sum"), ("HiLAMParallel", "mean")])
def test_predict_matches_jax_on_dummy(dummy_data, model, aggr):
    """JAX Trainer.predict (params from module.init_state) against the
    port's from the same converted params (lattices 16², 8², 4²), each
    model with the aggregation its parity case above does not take."""
    (_, _, jax_test), (_, _, port_test) = dummy_data
    settings = dict(model_name=model, settings_init_args=dict(SMALL, mesh_aggr=aggr),
                    training_strategy="diff_ar")
    jax_module = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**settings), jax_test.dataset_info)
    state = jax_module.init_state(jax.random.key(0), 1)
    with tempfile.TemporaryDirectory() as tmp:
        want = jax_training.Trainer(
            jax_training.TrainerConfig(batch_size=8, save_path=tmp)
        ).predict(jax_module, jax_test, state)
    port_module = port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**settings), port_test.dataset_info, device="cpu")
    got = port_training.Trainer(
        port_training.TrainerConfig(batch_size=8, device="cpu", num_workers=1)
    ).predict(port_module, port_test, params_from_jax(jax.tree.map(np.asarray, state.params)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.names == w.names and g.feature_names == w.feature_names
        assert g.shape == (8, 3, 64 * 64, 1)
        assert np.isfinite(g.array).all()
        _close(g.array, np.asarray(w.array), BAR)


def test_adamw_step_losses_match_jax(dummy_data):
    """Three AdamW steps of HiLAM from converted params (2 AR steps a
    batch): the losses track the JAX package's within 1e-4."""
    (jax_train, _, _), (port_train, _, _) = dummy_data
    settings = dict(model_name="HiLAM", settings_init_args=SMALL,
                    training_strategy="diff_ar", num_pred_steps_train=2,
                    num_pred_steps_val_test=2, num_warmup_steps=2)
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


def test_unreached_parameters_get_zero_gradients_and_weight_decay(dummy_data):
    """HiLAMParallel at 2 layers: loss_and_grads gives the parameters the
    loss cannot reach zeros (as jax.grad does), and an AdamW step still
    decays them, as optax.adamw does."""
    _, (port_train, _, _) = dummy_data
    settings = dict(model_name="HiLAMParallel", settings_init_args=SMALL,
                    training_strategy="diff_ar", num_pred_steps_train=1, num_warmup_steps=0,
                    learning_rate=1e-2)
    pm = port_training.AutoRegressiveModule(port_training.TrainingSettings(**settings),
                                            port_train.dataset_info, device="cpu")
    state = pm.init_state(torch.Generator().manual_seed(0), 10)
    batch = next(iter(port_train.loader(batch_size=2, num_workers=1)))
    _, grads = pm.loss_and_grads(state, batch)
    zero = {k for k, g in grads.items() if float(g.abs().max()) == 0.0}
    assert "processor.1.up_0.w_e.weight" in zero and "processor.1.intra_0.w_e.weight" not in zero
    before = {k: state.params[k].detach().clone() for k in zero}
    pm.train_step(state, batch)
    for k in zero:
        decay = 1 - state.optimizer.param_groups[0]["weight_decay"] * 1e-2
        torch.testing.assert_close(state.params[k].detach(), before[k] * decay)
