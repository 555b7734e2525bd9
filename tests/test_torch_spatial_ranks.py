"""The spatial axis across processes, on the CPU: gloo ranks (each a
process of its own, spawned by ``testing.run_ranks``) whose lat bands
join through halo exchanges and band all-reduces, against one process
of the port and against the JAX package's ``train_step`` on a spatial
mesh of the same layout.

Each run: a 32x32 grid, global batch 4, three AdamW steps, step k on
``synthetic_batch(info, 4, seed=k)``; HalfUNet (8 filters, depth 2),
HiLAM (h 8, 2 levels) and UNet at ``MeshConfig(1, 2)``, GraphLAM and
HiLAMParallel at ``MeshConfig(2, 2)``. One launch of the ranks a layout
runs every case of that layout in turn (``testing.train_reports``).

Bars:
- from the port's own initial parameters (seed 0): losses, parameters,
  the first step's gradients as AdamW receives them (summed over the
  bands, averaged over the data ranks by ``all_reduce_grads``) and
  ``predict_step`` (after ``gather_lat``) within 1e-5 of scale of one
  process, only the order of the sums over the bands changing; two runs
  of a layout bit for bit; every rank the same parameters. AdamW is
  blind to a constant scale on every gradient, so the gradients are
  held themselves;
- from the JAX package's initial parameters (``convert``): the losses
  within 1e-4 (relative) of the JAX package's ``train_step`` on
  ``make_mesh(MeshConfig(data_parallel, spatial))``, and the first
  step's reduced gradients within 1e-4 of the scale of ``jax.grad`` of
  its loss on that mesh, for HalfUNet and HiLAM at (1, 2) and GraphLAM
  at (2, 2);
- a 30-row grid padded to 32 (``lat_multiple`` 4) predicted back on 30
  rows, as one process does.

Why the 1e-5 bar starts from the port's draw: from the JAX-drawn
HalfUNet parameters one ReLU input of ``ConvBlock_2`` sits at 9.9e-7 in
one process and at -2.0e-8 on the bands (its GroupNorm statistics are
summed in another order), so its gradient passes on one side of the
kink and not on the other, and after three AdamW steps the parameters
stand 2.3e-5 of scale apart; the losses still agree within 1e-6. The
first step's gradients, which the JAX bar holds, then differ by 1.7e-3
of scale from one process's and from ``jax.grad``'s alike (one process
meets ``jax.grad`` within 7.4e-7; scaling every parameter by 1.001
moves that input off the kink and the bands back within 7.9e-7), so
HalfUNet meets the JAX package from its draw at key 1, whose smallest
ReLU input of the first step is 2.5e-5 from zero.
UNet's conv biases that feed a GroupNorm have a zero gradient but for
rounding, which AdamW's first steps turn into moves of the order of the
learning rate, on the data axis as on the spatial one: they are left
out of UNet's parameter bar."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from py4cast_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from py4cast_tpu.parallel.mesh import make_mesh as jax_make_mesh
from py4cast_tpu.testing import synthetic_batch as jax_synthetic_batch
from py4cast_tpu.testing import synthetic_dataset_info as jax_synthetic_dataset_info
from py4cast_tpu.training import AutoRegressiveModule as JaxModule
from py4cast_tpu.training import TrainingSettings as JaxSettings
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.testing import fit_test_report, run_ranks, train_report

GRAPH = {"hidden_dims": 8, "mesh_levels": 2, "processor_layers": 1}
#: model -> (data, spatial), settings, the key of the JAX package's draw
#: that it is held to the JAX package from (None: not held)
CASES = {
    "HalfUNet": ((1, 2), {"num_filters": 8, "depth": 2}, 1),
    "HiLAM": ((1, 2), GRAPH, 0),
    "UNet": ((1, 2), {"init_features": 4, "depth": 2}, None),
    "GraphLAM": ((2, 2), GRAPH, 0),
    "HiLAMParallel": ((2, 2), GRAPH, None),
}
#: the models held to the JAX package
TO_JAX = sorted(name for name, (_, _, key) in CASES.items() if key is not None)
STEPS = 3
BATCH = 4
#: the bar of a rank layout against one process, relative to scale
TOPOLOGY_BAR = 1e-5
#: the port against the JAX package
JAX_RTOL = 1e-4
#: the padded grid of HalfUNet's case: bands of 15 rows would not pool
PADDED = {"padded_grid": [30, 32], "lat_multiple": 4}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in every rank (``run_ranks``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_start(name, args, layout, key, params_path):
    """The JAX package's module on a (data, spatial) mesh and its initial
    state drawn from ``key``, whose parameters are saved for the port."""
    info = jax_synthetic_dataset_info(grid_shape=(32, 32), weather_features=3,
                                      forcing_features=6, border_size=2)
    module = JaxModule(
        JaxSettings(model_name=name, settings_init_args=dict(args),
                    training_strategy="scaled_ar", num_input_steps=2, num_warmup_steps=2),
        info, mesh=jax_make_mesh(JaxMeshConfig(data_parallel=layout[0], spatial=layout[1]),
                                 jax.devices()[:layout[0] * layout[1]]))
    state = module.init_state(jax.random.key(key), STEPS)
    torch.save(params_from_jax(jax.tree.map(np.asarray, state.params)), params_path)
    return module, info, state


def _jax_run(module, info, state):
    """Three steps of the JAX package's ``train_step`` as it jits it
    (``_batch_loss`` under ``value_and_grad``, then ``apply_gradients``,
    the kernels' gate set first), each also returning its gradients, in
    one compile: the steps' losses and the first step's gradients in the
    port's layout."""
    from py4cast_tpu.ops.attention import set_spatial_shards

    set_spatial_shards(module._spatial_shards)
    batches = [jax_synthetic_batch(info, BATCH, seed=k) for k in range(STEPS)]
    num_pred_steps = batches[0].num_pred_steps

    @jax.jit
    def step(state, inputs, forcing, outputs, rng, buffers):
        (loss, _), grads = jax.value_and_grad(module._batch_loss, has_aux=True)(
            state.params, inputs, forcing, outputs, num_pred_steps, rng, buffers, train=True)
        return state.apply_gradients(grads=grads), loss, grads

    losses, first_grads = [], None
    for batch in batches:
        state, loss, grads = step(state, *module._batch_arrays(batch), jax.random.key(1),
                                  module.step_buffers())
        losses.append(float(loss))
        first_grads = first_grads or params_from_jax(jax.tree.map(np.asarray, grads))
    return losses, first_grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per model: one port process, two runs of its ranks from the
    port's draw, and from the JAX package's draw its losses on the
    spatial mesh and one run of the port's ranks. The ranks run in their
    own processes while this one computes the references."""
    out = {name: {"name": name, "layout": layout} for name, (layout, _, _) in CASES.items()}
    cases, jax_runs = {}, {}
    for name, (layout, args, key) in CASES.items():
        base = {"model_name": name, "settings_init_args": args, "batch_size": BATCH,
                "steps": STEPS, **(PADDED if name == "HalfUNet" else {})}
        mine = [base, base]
        if key is not None:
            path = tmp_path_factory.mktemp(f"params_{name}") / "params.pt"
            jax_runs[name] = _jax_start(name, args, layout, key, path)
            mine.append({**base, "params_path": str(path)})
        cases.setdefault(tuple(layout), []).append((name, mine))
    with ThreadPoolExecutor(len(cases)) as pool:
        launched = {layout: pool.submit(
            run_ranks, "py4cast_tpu_torch.testing:train_reports", layout[0] * layout[1],
            {"cases": [case for _, mine in per_model for case in mine], "mesh": list(layout)},
            timeout=240) for layout, per_model in cases.items()}
        for name, run in jax_runs.items():
            out[name]["jax"], out[name]["jax_grads"] = _jax_run(*run)
        for per_model in cases.values():
            for name, mine in per_model:
                out[name]["one"] = train_report(**mine[0])
        reports_of = {layout: f.result() for layout, f in launched.items()}
    for layout, per_model in cases.items():
        reports = reports_of[layout]
        at = 0
        for name, mine in per_model:
            per_run = [[rank[at + i] for rank in reports] for i in range(len(mine))]
            out[name]["many"] = per_run[:2]
            if len(mine) == 3:
                out[name]["jax_ranks"] = per_run[2]
            at += len(mine)
    return out


@pytest.fixture(params=sorted(CASES))
def run(request, runs):
    return runs[request.param]


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _grads_err(got: dict, want: dict) -> float:
    """The largest gradient error over every parameter, relative to the
    largest gradient: a wrong scale on the reduced gradients shows here
    whatever its size."""
    assert got.keys() == want.keys()
    err = max(float((got[k] - torch.as_tensor(want[k])).abs().max()) for k in want)
    return err / max(float(torch.as_tensor(w).abs().max()) for w in want.values())


def _kept(name, key):
    """UNet's conv biases feed GroupNorms: out of the parameter bar."""
    return not (name == "UNet" and key.startswith("ConvBlock") and key.endswith("bias"))


def test_spatial_ranks_match_one_process(run):
    """Losses and parameters after three AdamW steps."""
    one = run["one"]
    for rank in run["many"][0]:
        assert rank["world_size"] == run["layout"][0] * run["layout"][1]
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=TOPOLOGY_BAR)
        for k, want in one["params"].items():
            if _kept(run["name"], k):
                err = _scaled_err(rank["params"][k], want)
                assert err <= TOPOLOGY_BAR, f"{run['name']} rank {rank['rank']} {k}: {err:.3e}"


def test_spatial_ranks_reduce_gradients_as_one_process(run):
    """The first step's gradients, summed over the bands and averaged
    over the data ranks, are one process's gradients of the global
    batch's loss."""
    want = run["one"]["grads"]
    for rank in run["many"][0]:
        err = _grads_err(rank["grads"], want)
        assert err <= TOPOLOGY_BAR, f"{run['name']} rank {rank['rank']}: {err:.3e}"


def test_spatial_ranks_hold_the_same_parameters(run):
    """Every rank steps AdamW on the same all-reduced gradient."""
    first, *others = run["many"][0]
    for other in others:
        assert other["losses"] == first["losses"]
        for k in first["params"]:
            assert torch.equal(other["params"][k], first["params"][k]), k


def test_two_runs_of_one_layout_agree_bit_for_bit(run):
    a, b = run["many"]
    for ra, rb in zip(a, b):
        assert ra["losses"] == rb["losses"]
        assert torch.equal(ra["predictions"], rb["predictions"])
        for k in ra["params"]:
            assert torch.equal(ra["params"][k], rb["params"][k]), k


@pytest.mark.parametrize("name", TO_JAX)
def test_spatial_ranks_match_the_jax_spatial_mesh(runs, name):
    """The logged loss is the global batch's: the JAX package's on a
    (data, spatial) mesh of the same layout, step for step."""
    run = runs[name]
    for rank in run["jax_ranks"]:
        np.testing.assert_allclose(rank["losses"], run["jax"], rtol=JAX_RTOL)
    assert len(set(run["jax"])) == STEPS  # the weights moved after the warmup's lr 0


@pytest.mark.parametrize("name", TO_JAX)
def test_spatial_ranks_reduce_gradients_as_the_jax_spatial_mesh(runs, name):
    """The gradients AdamW receives on the ranks are ``jax.grad`` of the
    JAX package's loss on the same (data, spatial) mesh."""
    run = runs[name]
    for rank in run["jax_ranks"]:
        err = _grads_err(rank["grads"], run["jax_grads"])
        assert err <= JAX_RTOL, f"{name} rank {rank['rank']}: {err:.3e}"


def test_spatial_predictions_match_one_process_on_the_whole_grid(run):
    want = run["one"]["predictions"]
    spatial = (32, 32) if run["name"] in ("HalfUNet", "UNet") else (1024,)
    assert tuple(want.shape) == (BATCH, 1, *spatial, 3)
    for rank in run["many"][0]:
        assert rank["predictions"].shape == want.shape
        assert _scaled_err(rank["predictions"], want) <= TOPOLOGY_BAR


def test_halo_rows_cross_only_where_convolutions_read(run):
    """The grid models' bands exchange halo rows each step (the same
    bytes every step); the graph models' bands none: their one
    collective is the g2m all-reduce."""
    for rank in run["many"][0]:
        halo = rank["halo_bytes"]
        assert len(set(halo)) == 1
        assert (halo[0] > 0) == (run["name"] in ("HalfUNet", "UNet"))


def test_padded_grid_comes_back_with_its_rows(runs):
    """HalfUNet on a 30x32 grid, padded to 32 rows (two bands of 16)."""
    run = runs["HalfUNet"]
    want = run["one"]["padded_predictions"]
    assert tuple(want.shape) == (BATCH, 1, 30, 32, 3)
    for rank in run["many"][0]:
        assert rank["padded_predictions"].shape == want.shape
        assert _scaled_err(rank["padded_predictions"], want) <= TOPOLOGY_BAR


def test_trainer_fits_tests_and_predicts_on_two_bands(tmp_path):
    """``Trainer.fit``, ``test`` with logging, ``eval_rows`` and
    ``predict`` of HalfUNet on two bands (7 test samples: a padded tail
    of 3 at batch 4) fit the same parameters, and score and predict every
    sample on the whole grid, as one process does; rank 0 alone writes.
    The ``TrainerConfig`` keeps its default layout (every rank on the
    data axis): the trainer loads by the module's mesh, so both bands
    load the same samples."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, "py4cast_tpu_torch.testing:fit_test_report", 2,
                            {"save_path": str(tmp_path / "two"), "mesh": [1, 2], "n_test": 7},
                            timeout=180)
        one = fit_test_report(str(tmp_path / "one"), n_test=7)
        two = ranks.result()
    assert [r["is_main"] for r in two] == [True, False]
    assert not (tmp_path / "two" / "rank1").exists()
    assert (tmp_path / "two" / "rank0" / "test_scores.json").is_file()
    for rank in two:
        assert rank["step"] == one["step"] == 2
        for k, want in one["params"].items():
            assert _scaled_err(rank["params"][k], want) <= TOPOLOGY_BAR, k
        assert rank["rows"].shape == one["rows"].shape == (7, 2)
        np.testing.assert_allclose(rank["rows"].numpy(), one["rows"].numpy(), rtol=1e-5)
        assert rank["predictions"].shape == one["predictions"].shape == (7, 2, 32, 32, 3)
        assert _scaled_err(rank["predictions"], one["predictions"]) <= TOPOLOGY_BAR
        for k, v in one["scores"].items():
            np.testing.assert_allclose(rank["scores"][k], v, rtol=1e-5, err_msg=k)
