"""The data axis across processes, on the CPU: two gloo ranks (each a
process of its own, spawned by ``testing.run_ranks``) against one
process of the port and against the JAX package's data-parallel
``train_step``.

Each case: global batch 4, three AdamW steps, step k on
``synthetic_batch(info, 4, seed=k)`` at a 32x32 grid; each rank loads
its two rows through ``DataLoader``. Bars: the two-rank losses and
parameters within 1e-5 of scale of one process (only the order of the
gradient sum changes); two runs of the same topology bit for bit; the
two-rank losses within 1e-4 (relative) of the JAX package's on a
two-device data mesh, from the same parameters (``convert``)."""

import time

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
from py4cast_tpu_torch.testing import run_ranks, train_report

MODELS = {
    "HalfUNet": {"num_filters": 8, "depth": 2},
    "HiLAM": {"hidden_dims": 8, "mesh_levels": 2, "processor_layers": 1},
}
STEPS = 3
BATCH = 4
#: the bar of a rank topology against one process, relative to scale
TOPOLOGY_BAR = 1e-5
#: the port against the JAX package
JAX_RTOL = 1e-4
TARGET = "py4cast_tpu_torch.testing:train_report"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in every rank (``run_ranks``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tmp_path_factory):
    """The JAX package's losses on a 2-device data mesh, and from its
    initial parameters: one port process, and two runs of two ranks."""
    name = request.param
    info = jax_synthetic_dataset_info(grid_shape=(32, 32), weather_features=3,
                                      forcing_features=6, border_size=2)
    module = JaxModule(
        JaxSettings(model_name=name, settings_init_args=dict(MODELS[name]),
                    training_strategy="scaled_ar", num_input_steps=2, num_warmup_steps=2),
        info, mesh=jax_make_mesh(JaxMeshConfig(data_parallel=2), jax.devices()[:2]))
    state = module.init_state(jax.random.key(0), STEPS)
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    path = tmp_path_factory.mktemp(f"params_{name}") / "params.pt"
    torch.save(params, path)
    jax_losses = []
    for k in range(STEPS):
        state, loss = module.train_step(state, jax_synthetic_batch(info, BATCH, seed=k),
                                        jax.random.key(1))
        jax_losses.append(float(loss))
    kwargs = {"model_name": name, "settings_init_args": MODELS[name], "batch_size": BATCH,
              "steps": STEPS, "params_path": str(path)}
    one = train_report(**kwargs)
    two = [run_ranks(TARGET, 2, kwargs, timeout=120) for _ in range(2)]
    return {"name": name, "jax": jax_losses, "one": one, "two": two}


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def test_two_ranks_report_their_place(runs):
    for run in runs["two"]:
        assert [r["rank"] for r in run] == [0, 1]
        assert {r["world_size"] for r in run} == {2}
    assert runs["one"]["world_size"] == 1


def test_two_ranks_match_one_process(runs):
    """Losses and parameters after three AdamW steps."""
    one = runs["one"]
    for rank in runs["two"][0]:
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=TOPOLOGY_BAR)
        for k, want in one["params"].items():
            err = _scaled_err(rank["params"][k], want)
            assert err <= TOPOLOGY_BAR, f"{runs['name']} {k}: {err:.3e}"


def test_two_ranks_hold_the_same_parameters(runs):
    """Every rank steps AdamW on the same all-reduced gradient."""
    first, second = runs["two"][0]
    assert first["losses"] == second["losses"]
    for k in first["params"]:
        assert torch.equal(first["params"][k], second["params"][k]), k


def test_two_runs_of_one_topology_agree_bit_for_bit(runs):
    a, b = runs["two"]
    for ra, rb in zip(a, b):
        assert ra["losses"] == rb["losses"]
        for k in ra["params"]:
            assert torch.equal(ra["params"][k], rb["params"][k]), k


def test_two_ranks_match_the_jax_data_parallel_step(runs):
    """The logged loss is the global batch's: the JAX package's loss on
    a 2-device data mesh, step for step."""
    np.testing.assert_allclose(runs["two"][0][0]["losses"], runs["jax"], rtol=JAX_RTOL)
    # the weights moved after the warmup's lr-0 update
    assert len(set(runs["jax"])) == STEPS


_STUCK = """
import time

import torch.distributed as dist


def fail_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    time.sleep(120)  # waits for a rank that never comes
    return {}


def sleep():
    time.sleep(120)
    return {}
"""


def test_a_failed_rank_ends_the_run(tmp_path):
    """A rank that raises ends the run at once, with its output; the
    other rank, left waiting, is killed."""
    (tmp_path / "stuck.py").write_text(_STUCK)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 exited.*rank 1 gives up"):
        run_ranks(f"{tmp_path}/stuck.py:fail_on_rank_one", 2, timeout=60)
    assert time.monotonic() - t0 < 30


def test_ranks_past_their_time_are_killed(tmp_path):
    (tmp_path / "stuck.py").write_text(_STUCK)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 4"):
        run_ranks(f"{tmp_path}/stuck.py:sleep", 2, timeout=4)
    assert time.monotonic() - t0 < 15
