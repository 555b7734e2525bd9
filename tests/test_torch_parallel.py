"""The scale-out layer's data axis and lat padding, on the CPU.

In this process: the mesh and its refusals (a layout the world size
does not hold, the models and paths that do not run on a spatial mesh
yet, spatial > 1 on one card), the process-group entry
(``maybe_init_distributed``) for torchrun and SLURM, a gloo group of one
rank bit for bit against no group, the loader's rank slices, the
dropout seed of each rank, ``Statics.pad_lat`` and a padded module
against the JAX package's (``lat_multiple=2`` at lat 9: losses within
1e-4, predictions and eval arrays on the 9x12 grid). Across two gloo
ranks (``testing.run_ranks``): fit, test with logging and predict over
an 11-sample padded tail at global batch 4, which score every sample as
one process does (rtol 2e-4), with one rank alone writing."""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from py4cast_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from py4cast_tpu.parallel.mesh import make_mesh as jax_make_mesh
from py4cast_tpu.testing import synthetic_batch as jax_synthetic_batch
from py4cast_tpu.testing import synthetic_dataset_info as jax_synthetic_dataset_info
from py4cast_tpu.testing import synthetic_statics as jax_synthetic_statics
from py4cast_tpu.training import AutoRegressiveModule as JaxModule
from py4cast_tpu.training import TrainingSettings as JaxSettings
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets.loader import DataLoader
from py4cast_tpu_torch.parallel import mesh as port_mesh
from py4cast_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from py4cast_tpu_torch.rollout import DROPOUT_STREAM, fold_seed
from py4cast_tpu_torch.testing import (
    SyntheticDataset,
    fit_test_report,
    run_ranks,
    synthetic_batch,
    synthetic_dataset_info,
    synthetic_statics,
)
from py4cast_tpu_torch.training import (
    AutoRegressiveModule,
    Trainer,
    TrainerConfig,
    TrainingSettings,
)

SMALL = {
    "HalfUNet": {"num_filters": 8, "depth": 2},
    "HiLAM": {"hidden_dims": 8, "mesh_levels": 2, "processor_layers": 1},
}
JAX_RTOL = 1e-4
#: per-sample test scores of two ranks against one process
TAIL_RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in every rank (``run_ranks``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def launcher_env(monkeypatch):
    """No launcher variable from the environment this test runs in."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.fixture
def one_rank(launcher_env):
    """A gloo process group of one rank, joined as torchrun's variables
    say, left at the end of the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        launcher_env.setenv(key, value)
    assert port_mesh.maybe_init_distributed("cpu", timeout=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _settings(model="HalfUNet", **kw):
    return TrainingSettings(model_name=model, settings_init_args=dict(SMALL[model]),
                            training_strategy="scaled_ar", num_input_steps=2,
                            num_warmup_steps=2, **kw)


def _info(grid=(32, 32)):
    return synthetic_dataset_info(grid_shape=grid, weather_features=3, forcing_features=6,
                                  border_size=2)


# ------------------------------------------------------------------- the mesh
def test_mesh_without_a_process_group_is_one_rank():
    assert not port_mesh.distributed()
    assert make_mesh() == Mesh(rank=0, local_rank=0, world_size=1, data=1, spatial=1,
                               distributed=False)
    assert make_mesh(MeshConfig(data_parallel=1)) == make_mesh(MeshConfig(-1, 1))
    assert port_mesh.is_main_process()


@pytest.mark.parametrize("config,match", [
    (MeshConfig(spatial=2), "mesh 1x2 does not match 1 processes"),
    (MeshConfig(data_parallel=2, spatial=2), "mesh 2x2 does not match 1 processes"),
    (MeshConfig(data_parallel=2), "mesh 2x1 does not match 1 processes"),
])
def test_make_mesh_refuses(config, match):
    """A layout whose data x spatial is not the world size."""
    with pytest.raises(ValueError, match=match):
        make_mesh(config)


@pytest.mark.parametrize("kw,match", [
    ({"mesh_spatial": 2}, "mesh_spatial=2: mesh 1x2 does not match 1 processes"),
    ({"mesh_data_parallel": 2}, "does not match 1 processes"),
])
def test_trainer_config_refuses_a_mesh_the_group_cannot_hold(kw, match):
    with pytest.raises(ValueError, match=match):
        TrainerConfig(device="cpu", **kw)


def test_trainer_config_takes_the_world_size():
    for dp in (-1, 1):
        assert TrainerConfig(device="cpu", mesh_data_parallel=dp).mesh_config() == \
            MeshConfig(dp, 1)


@pytest.mark.parametrize("model,args,match", [
    ("CustomUNet", {"encoder_depth": 2, "decoder_channels": (8, 4)}, None),
    ("DeepLabV3", {"encoder_depth": 2}, None),
    ("HiLAM", {"hidden_dims": 8, "mesh_levels": 2, "use_lattice": False},
     "HiLAM runs the gather-table path"),
])
def test_module_refuses_a_spatial_mesh(model, args, match):
    """The ResNet-encoder models build on a spatial mesh, with bands of
    whole multiples of their encoder's stride; the gather-table path
    raises, as the JAX package refuses it (``tests/test_parallel.py``)."""
    settings = TrainingSettings(model_name=model, settings_init_args=args,
                                training_strategy="scaled_ar", num_input_steps=2)
    mesh = Mesh(world_size=2, data=1, spatial=2)
    if match is None:
        module = AutoRegressiveModule(settings, _info(), device="cpu", mesh=mesh)
        assert module._buffers["grid_statics"].shape[0] == 16  # its band of 32 rows
        return
    with pytest.raises(ValueError, match=f"(?s)Spatial mesh sharding.*{match}.*spatial=1"):
        AutoRegressiveModule(settings, _info(), device="cpu", mesh=mesh)


def test_spatial_ranks_on_one_card_raise_and_nothing_falls_back(launcher_env, monkeypatch):
    """Two ranks (data 1 x spatial 2) on a host of one card: the second
    rank has no card of its own, and NCCL runs one rank a card; the
    group is not joined on gloo instead."""
    monkeypatch.setattr(port_mesh, "resolve_device", lambda device: torch.device(device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for key, value in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}.items():
        launcher_env.setenv(key, value)
    with pytest.raises(RuntimeError, match=r"local rank 1 has no card of its own.*1 card\(s\)"
                                           r".*spatial > 1 needs spatial cards a data group"):
        port_mesh.maybe_init_distributed("cuda")
    assert not port_mesh.distributed()


def test_shard_batch_refuses_a_batch_the_data_axis_does_not_divide():
    rows = np.zeros((2, 1, 4, 4, 1), np.float32)
    assert port_mesh.shard_batch(Mesh(world_size=2, data=2), rows) is rows
    with pytest.raises(ValueError, match=r"Global batch size 4 \(2 local rows x 2 processes\)"
                                          r" is not divisible by the data-parallel mesh axis"):
        port_mesh.shard_batch(Mesh(world_size=2, data=3), rows)


def test_cuda_without_a_card_raises_and_nothing_falls_back(launcher_env):
    """No card: the entry points raise for "cuda"; a launcher's group on
    "cuda" raises too, rather than joining on gloo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA"):
        AutoRegressiveModule(_settings(), _info(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Trainer(TrainerConfig())
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": "29500"}.items():
        launcher_env.setenv(key, value)
    with pytest.raises(RuntimeError, match="no CUDA"):
        port_mesh.maybe_init_distributed("cuda")
    assert not port_mesh.distributed()


def test_no_launcher_no_group(launcher_env):
    assert port_mesh.maybe_init_distributed("cpu") is False
    launcher_env.setenv("SLURM_NTASKS", "1")
    assert port_mesh.maybe_init_distributed("cpu") is False
    assert not port_mesh.distributed()


def test_slurm_without_master_addr_raises(launcher_env):
    for key, value in {"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "1"}.items():
        launcher_env.setenv(key, value)
    with pytest.raises(RuntimeError, match="MASTER_ADDR is unset"):
        port_mesh.maybe_init_distributed("cpu")
    assert not port_mesh.distributed()


# ----------------------------------------------------- a group of one rank
def test_one_rank_group_joins_on_gloo(one_rank):
    assert dist.get_backend() == "gloo" and port_mesh.is_main_process()
    assert make_mesh() == Mesh(rank=0, local_rank=0, world_size=1, data=1, spatial=1,
                               distributed=True)
    assert TrainerConfig(device="cpu", mesh_data_parallel=1).mesh_config() == MeshConfig(1, 1)
    loader = DataLoader(SyntheticDataset(_info((8, 8)), 4), batch_size=4)
    assert (loader.process_index, loader.process_count) == (0, 1)
    t = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(port_mesh.to_host(t), t.numpy())
    assert port_mesh.broadcast_object({"a": 1}) == {"a": 1}


def _steps(module, accumulate, steps=3):
    info = module.dataset_info
    state = module.init_state(torch.Generator().manual_seed(0), steps * accumulate)
    losses = []
    for k in range(steps * accumulate):
        losses.append(module.train_step(state, synthetic_batch(info, 2, seed=k)))
    return losses, state


@pytest.mark.parametrize("accumulate", [1, 2])
def test_one_rank_group_steps_bit_for_bit_as_no_group(one_rank, accumulate):
    """The all-reduce of one rank (a collective, and a division by 1 x
    accumulate) changes no bit of three AdamW steps."""
    info = _info()
    settings = _settings(accumulate_grad_batches=accumulate)
    grouped = AutoRegressiveModule(settings, info, device="cpu")
    alone = AutoRegressiveModule(settings, info, device="cpu", mesh=Mesh())
    assert grouped.mesh.distributed and not alone.mesh.distributed
    got, got_state = _steps(grouped, accumulate)
    want, want_state = _steps(alone, accumulate)
    assert [float(v) for v in got] == [float(v) for v in want]
    for k, p in want_state.params.items():
        assert torch.equal(got_state.params[k], p), k


def test_one_rank_group_fit_saves_what_no_group_saves(one_rank, tmp_path):
    """A fit whose epoch ends between two micro-batches (3 batches at
    accumulate 2): the group averages every rank's waiting gradient
    sums before rank 0 writes them, and with one rank the checkpoint is
    the one a fit without a group writes, bit for bit."""
    info = _info()
    data = SyntheticDataset(info, 6, num_pred_steps=1, seed=0)
    payloads = []
    for name, mesh in (("group", None), ("alone", Mesh())):
        module = AutoRegressiveModule(_settings(accumulate_grad_batches=2), info, device="cpu",
                                      mesh=mesh)
        trainer = Trainer(TrainerConfig(max_epochs=1, batch_size=2, num_workers=1,
                                        logging_enabled=False, save_path=str(tmp_path / name),
                                        device="cpu"))
        state = trainer.fit(module, data, data)
        assert (state.step, state.micro_step) == (1, 1)
        payloads.append(torch.load(tmp_path / name / "checkpoints" / "last" / "state.pt",
                                   weights_only=True))
    group, alone = payloads
    assert set(group["grad_accum"]) == set(alone["grad_accum"]) == set(alone["params"])
    for key in ("params", "grad_accum"):
        for k, v in alone[key].items():
            assert torch.equal(group[key][k], v), (key, k)


def test_all_reduce_grads_of_one_rank(one_rank):
    params = {"a": torch.randn(3, 2), "b": torch.randn(5)}
    for p in params.values():
        p.grad = torch.randn_like(p)
    want = {k: p.grad.clone() / 2 for k, p in params.items()}
    assert port_mesh.all_reduce_grads(params, world_size=1, accumulate=2) == 11 * 4
    for k, p in params.items():
        assert torch.equal(p.grad, want[k]), k


# ------------------------------------------------------------------ loader
def test_loader_slices_are_disjoint_and_cover_every_global_batch():
    data = SyntheticDataset(_info((4, 4)), 10)
    whole = DataLoader(data, batch_size=4, shuffle=True, seed=3, process_count=1)
    ranks = [DataLoader(data, batch_size=4, shuffle=True, seed=3, process_index=r,
                        process_count=2) for r in range(2)]
    want = whole._batch_indices()
    got = [r._batch_indices() for r in ranks]
    assert len(want) == len(got[0]) == len(got[1]) == 2
    for (w, nv), (a, _), (b, _) in zip(want, *got):
        assert len(a) == len(b) == 2 and not set(a) & set(b)
        np.testing.assert_array_equal(np.concatenate([a, b]), w)
    # the next epoch reshuffles, the same on every rank
    for loader in (whole, *ranks):
        loader._epoch = 1
    again = [r._batch_indices() for r in ranks]
    assert [list(a) for a, _ in again[0]] != [list(a) for a, _ in got[0]]
    for (w, _), (a, _), (b, _) in zip(whole._batch_indices(), *again):
        np.testing.assert_array_equal(np.concatenate([a, b]), w)


def test_loader_pads_the_tail_to_the_global_batch_before_slicing():
    data = SyntheticDataset(_info((4, 4)), 11)
    ranks = [DataLoader(data, batch_size=4, drop_last=False, pad_last=True, process_index=r,
                        process_count=2) for r in range(2)]
    tails = [r._batch_indices()[-1] for r in ranks]
    assert [list(i) for i, _ in tails] == [[8, 9], [10, 10]]
    assert {nv for _, nv in tails} == {3}
    batches = [list(r)[-1] for r in ranks]
    assert [b.num_valid for b in batches] == [3, 3]
    assert [b.batch_size for b in batches] == [2, 2]


def test_loader_skips_a_short_tail_wholly_on_earlier_ranks():
    data = SyntheticDataset(_info((4, 4)), 10)
    ranks = [DataLoader(data, batch_size=4, drop_last=False, process_index=r, process_count=2)
             for r in range(2)]
    assert [list(i) for i, _ in ranks[0]._batch_indices()] == [[0, 1], [4, 5], [8, 9]]
    assert [list(i) for i, _ in ranks[1]._batch_indices()] == [[2, 3], [6, 7]]


def test_loader_refuses_a_global_batch_the_ranks_do_not_divide():
    with pytest.raises(ValueError, match="not divisible by the process count"):
        DataLoader(SyntheticDataset(_info((4, 4)), 4), batch_size=3, process_count=2)


# ----------------------------------------------------------------- dropout
def test_ranks_fold_their_rank_into_the_dropout_seed():
    """Two ranks draw different masks for their rows: the rank is folded
    into the seed; one rank keeps the single-process seed."""
    info = _info()
    settings = TrainingSettings(
        model_name="UNetRPP", training_strategy="scaled_ar", num_input_steps=2,
        settings_init_args=dict(hidden_size=16, num_heads_encoder=2, num_heads_decoder=2,
                                depths=(2, 1), encoder_proj_sizes=(16, 8),
                                decoder_proj_size=8, linear_upsampling=False,
                                dropout_rate=0.3))
    modules = [AutoRegressiveModule(settings, info, device="cpu",
                                    mesh=Mesh(rank=r, local_rank=r, world_size=2, data=2))
               for r in range(2)]
    alone = AutoRegressiveModule(settings, info, device="cpu")
    params = alone.init_params(torch.Generator().manual_seed(0))
    seeds = [m._dropout_seed(params) for m in modules]
    assert alone._dropout_seed(params) == fold_seed(settings.seed, DROPOUT_STREAM, 0)
    assert seeds == [fold_seed(alone._dropout_seed(params), r) for r in range(2)]
    batch = synthetic_batch(info, 2, seed=0)
    losses = [float(m.loss_and_grads(params, batch)[0]) for m in (*modules, alone)]
    assert len(set(losses)) == 3, losses
    # each rank's masks repeat
    assert float(modules[1].loss_and_grads(params, batch)[0]) == losses[1]


# ----------------------------------------------------------- lat padding
def test_statics_pad_lat_semantics():
    st = synthetic_statics((9, 12), border_size=2)
    padded = st.pad_lat(3)
    assert padded.grid_shape == (12, 12)
    # pad rows are all border: the interior count is unchanged
    assert padded.interior_mask.sum() == st.interior_mask.sum()
    assert (padded.border_mask[9:] == 1.0).all()
    # the coordinate channels extrapolate monotonically (graph builders)
    y = padded.grid_statics["y"][..., 0]
    dy = np.diff(y[:, 0])
    assert (np.sign(dy) == np.sign(dy[0])).all()
    assert st.pad_lat(0) is st
    # the JAX package's padded statics, bit for bit
    want = jax_synthetic_statics((9, 12), border_size=2).pad_lat(3)
    np.testing.assert_array_equal(padded.grid_statics.array, np.asarray(want.grid_statics.array))
    np.testing.assert_array_equal(padded.border_mask, np.asarray(want.border_mask))


@pytest.fixture(scope="module", params=sorted(SMALL))
def padded(request):
    """lat 9 padded to 10 (lat_multiple=2): the JAX module's loss at its
    initial params on one device (its eval step's mean, which is the
    loss its first train step returns, for one compile without a
    backward), and the port's module from the same params."""
    name = request.param
    info = jax_synthetic_dataset_info(grid_shape=(9, 12), weather_features=3,
                                      forcing_features=6, border_size=2)
    jm = JaxModule(JaxSettings(model_name=name, settings_init_args=dict(SMALL[name]),
                               training_strategy="scaled_ar", num_input_steps=2,
                               num_warmup_steps=2),
                   info, mesh=jax_make_mesh(JaxMeshConfig(data_parallel=1), jax.devices()[:1]),
                   lat_multiple=2)
    state = jm.init_state(jax.random.key(0), num_training_steps=4)
    batch = jax_synthetic_batch(info, batch_size=2, num_pred_steps=2)
    params = params_from_jax(jax.tree.map(np.asarray, state.params))
    _, per_step = jm.eval_step(state, batch, jax.random.key(1))
    jax_loss = np.mean(np.asarray(per_step))
    pm = AutoRegressiveModule(_settings(name), _info((9, 12)), device="cpu", lat_multiple=2)
    return {"name": name, "jax": jm, "jax_loss": float(jax_loss), "port": pm,
            "params": params}


def test_padded_module_pads_one_row(padded):
    pm = padded["port"]
    assert pm._lat_pad == padded["jax"]._lat_pad == 1
    assert pm.dataset_info.statics.grid_shape == (9, 12)
    assert pm.manifest()["grid_shape"] == [9, 12]
    rows = 10 * 12 if pm.is_graph else 10
    assert pm._buffers["grid_statics"].shape[0] == rows
    assert pm._buffers["interior_mask"].sum() == pm.interior_mask_np.sum()


def test_padded_train_loss_matches_jax(padded):
    pm = padded["port"]
    state = pm.init_state(None, 4, padded["params"])
    loss = float(pm.train_step(state, synthetic_batch(pm.dataset_info, 2, num_pred_steps=2)))
    np.testing.assert_allclose(loss, padded["jax_loss"], rtol=JAX_RTOL)


def test_predictions_and_eval_arrays_come_back_unpadded(padded):
    pm, params = padded["port"], padded["params"]
    batch = synthetic_batch(pm.dataset_info, 2, num_pred_steps=2)
    spatial = (9 * 12,) if pm.is_graph else (9, 12)
    assert pm.predict_step(params, batch).array.shape == (2, 2, *spatial, 3)
    preds, per_step = pm.eval_step(params, batch)
    assert per_step.shape == (2, 2)
    pred, target, mask = pm.named_eval_arrays(preds, batch)
    assert pred.array.shape[2:-1] == target.array.shape[2:-1] == spatial
    assert mask.shape == target.array.shape


# ------------------------------------------------- two ranks, padded tail
@pytest.fixture(scope="module")
def tail(tmp_path_factory):
    root = tmp_path_factory.mktemp("tail")
    one = fit_test_report(str(root / "one"))
    two = run_ranks("py4cast_tpu_torch.testing:fit_test_report", 2,
                    {"save_path": str(root / "two")}, timeout=180)
    return root, one, two


def test_two_ranks_score_every_tail_sample_as_one_process(tail):
    _, one, two = tail
    assert one["rows"].shape == (11, 2)
    for rank in two:
        assert rank["step"] == one["step"] == 2
        np.testing.assert_allclose(rank["rows"].numpy(), one["rows"].numpy(), rtol=TAIL_RTOL)
        np.testing.assert_allclose(rank["predictions"].numpy(), one["predictions"].numpy(),
                                   rtol=TAIL_RTOL, atol=1e-5)
        assert set(rank["scores"]) == set(one["scores"])
        for k, v in one["scores"].items():
            np.testing.assert_allclose(rank["scores"][k], v, rtol=TAIL_RTOL, err_msg=k)


def test_two_ranks_return_the_same_scores(tail):
    _, _, (first, second) = tail
    assert first["scores"] == second["scores"]
    assert torch.equal(first["rows"], second["rows"])
    assert torch.equal(first["predictions"], second["predictions"])


def test_one_rank_writes(tail):
    root, _, two = tail
    assert [r["is_main"] for r in two] == [True, False]
    assert not (root / "two" / "rank1").exists()
    written = root / "two" / "rank0"
    for name in ("checkpoints/last/state.pt", "checkpoints/best/state.pt",
                 "checkpoints/manifest.json", "test_scores.json", "run_info.json",
                 "model/signature.json"):
        assert (written / name).is_file(), name
    figures = {p.relative_to(written) for p in written.rglob("*.png")}
    want = {p.relative_to(root / "one" / "rank0") for p in (root / "one" / "rank0").rglob("*.png")}
    assert figures == want and figures
