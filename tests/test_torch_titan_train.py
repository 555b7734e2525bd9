"""The slice as a whole, on the CPU: training on Titan and on Poesy's
ensemble members through the port's entry points.

- On a Titan tree (a 32 x 32 subdomain, two fields), a small HalfUNet
  carried over by ``convert.params_from_jax`` gives a first train
  step's loss and gradients within 1e-4 of the JAX package's.
- The port's ``dataset_cli prepare`` and then its CLI's ``fit``,
  ``test`` and ``predict`` (config/CLI/dataset/titan.yaml with a
  ``data.dataset_conf`` JSON, config/CLI/model/halfunet.yaml cut to 8
  filters), the trained checkpoint's contract checked against the
  dataset.
- A two-member Poesy fit → test → predict trains on, scores and exports
  both members, as tests/test_ensemble_e2e.py checks for the JAX
  package."""

import datetime as dt
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import py4cast_tpu.datasets.titan as jax_titan
import py4cast_tpu_torch.datasets.poesy as port_poesy
import py4cast_tpu_torch.datasets.titan as port_titan
from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.parallel.mesh import MeshConfig, make_mesh
from py4cast_tpu_torch import cli
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import base as port_base
from py4cast_tpu_torch.datasets import dataset_cli
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.datasets.synthetic_trees import write_poesy_tree, write_titan_tree

BAR = 1e-4
ROOT = Path(__file__).resolve().parents[1]
SUBDATASET = "titan_aro_arp_PAAROME_1S40_100-132-240-272"
TITAN_CONF = {
    "periods": {
        "train": {"start": 20230101, "end": 20230101, "obs_step": 3600},
        "valid": {"start": 20230102, "end": 20230102, "obs_step": 3600,
                  "obs_step_btw_t0": 10800},
        "test": {"start": 20230102, "end": 20230102, "obs_step": 3600,
                 "obs_step_btw_t0": 10800},
    },
    "grid": {"name": "PAAROME_1S40", "border_size": 2, "subdomain": [100, 132, 240, 272]},
    "settings": {"standardize": True, "file_format": "npy"},
    "params": {
        "aro_t2m": {"levels": [2], "kind": "input_output"},
        "arp_t": {"levels": [500], "kind": "input"},
    },
}
POESY_PERIOD = {"start": 20210601, "end": 20210601, "refcst_daily_runs": [0],
                "refcst_leadtime_start_in_sec": 3600, "refcst_leadtime_end_in_sec": 21600,
                "refcst_leadtime_step_in_sec": 3600}
POESY_CONF = {
    "periods": {"train": {**POESY_PERIOD, "refcst_daily_runs": [0, 43200]},
                "valid": POESY_PERIOD, "test": POESY_PERIOD},
    "grid": {"name": "EURW1S40", "border_size": 2},
    "settings": {"standardize": True, "file_format": "npy"},
    "members": [0, 3],
    "params": {"t2m": {"levels": [2], "kind": "input_output"},
               "u10": {"levels": [10], "kind": "input_output"}},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A Titan tree (two days of hours) and a Poesy tree (two runs) with
    their statistics, both packages pointed at them; the JSON confs."""
    root = tmp_path_factory.mktemp("trees")
    dates = [dt.datetime(2023, 1, 1) + dt.timedelta(hours=h) for h in range(48)]
    write_titan_tree(root / "titan", SUBDATASET,
                     {"aro_t2m_2m": (5.0, 285.0), "arp_t_500hpa": (5.0, 260.0)},
                     dates, (32, 32), seed=0)
    write_poesy_tree(root / "poesy", (24, 24, 45, 16),
                     [dt.datetime(2021, 6, 1), dt.datetime(2021, 6, 1, 12)],
                     variables=("t2m", "u10"), seed=1)
    confs = {"titan": root / "titan_aro_arp.json", "poesy": root / "poesy.json"}
    confs["titan"].write_text(json.dumps(TITAN_CONF))
    confs["poesy"].write_text(json.dumps(POESY_CONF))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_titan, port_titan):
            mp.setattr(mod, "TITAN_PATH", root / "titan")
        mp.setattr(port_poesy, "POESY_PATH", root / "poesy")
        mp.setattr(port_poesy, "CACHE_DIR", root / "cache")
        for name, conf in confs.items():
            assert dataset_cli.main([name if name != "titan" else "titan_aro_arp", "prepare",
                                     "--dataset-conf", str(conf), "--num-input-steps", "2",
                                     "--batch-size", "2"]) == 0
        yield root, confs


def test_first_train_step_matches_jax(trees):
    """JAX value_and_grad of _batch_loss (on one CPU device: the batch
    is 2) against the port's loss_and_grads on the first Titan train
    batch (2 AR steps), from the same converted HalfUNet params."""
    settings = dict(model_name="HalfUNet", settings_init_args=dict(num_filters=8, depth=3),
                    training_strategy="diff_ar", num_input_steps=2, num_pred_steps_train=2,
                    num_pred_steps_val_test=2, num_warmup_steps=2)
    jax_train = jax_get_datasets("titan_aro_arp", 2, 2, 2, dataset_conf=TITAN_CONF)[0]
    port_train = port_get_datasets("titan_aro_arp", 2, 2, 2, dataset_conf=TITAN_CONF)[0]
    one_device = make_mesh(MeshConfig(data_parallel=1), jax.devices()[:1])
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                           jax_train.dataset_info, mesh=one_device)
    state = jm.init_state(jax.random.key(0), 3)
    buffers = jm.step_buffers()
    fn = jax.jit(jax.value_and_grad(
        lambda p, i, f, o: jm._batch_loss(p, i, f, o, 2, jax.random.key(1), buffers,
                                          train=True)[0]))
    jb = next(iter(jax_train.loader(batch_size=2, num_workers=1)))
    pb = next(iter(port_train.loader(batch_size=2, num_workers=1)))
    for attr in ("inputs", "outputs", "forcing"):
        np.testing.assert_array_equal(getattr(pb, attr).array, np.asarray(getattr(jb, attr).array))
    j_loss, j_grads = fn(state.params, *jm._batch_arrays(jb))
    pm = port_training.AutoRegressiveModule(port_training.TrainingSettings(**settings),
                                            port_train.dataset_info, device="cpu")
    p_loss, p_grads = pm.loss_and_grads(params_from_jax(jax.tree.map(np.asarray, state.params)),
                                        pb)
    assert abs(float(p_loss) - float(j_loss)) <= BAR * abs(float(j_loss))
    want = params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(p_grads) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        err = float((p_grads[k] - w).abs().max())
        assert err <= BAR * scale, f"{k}: {err:.3e} > {BAR} x {scale:.3g}"


def _cli(sub, conf, save, *extra):
    return cli.main([sub, "--config", str(ROOT / "config/CLI/trainer.yaml"),
                     "--config", str(ROOT / "config/CLI/dataset/titan.yaml"),
                     "--config", str(ROOT / "config/CLI/model/halfunet.yaml"),
                     "--data.dataset_conf", str(conf), "--trainer.device", "cpu",
                     "--trainer.save_path", str(save),
                     "--model.settings_init_args.num_filters", "8", *extra])


def test_cli_fit_test_predict_on_titan(trees, tmp_path):
    """titan.yaml's data section (1 input step, batch 2, 10 workers) and
    halfunet.yaml through the port's CLI: a fit of two steps, then test
    and predict from its checkpoint, whose contract is checked against
    the Titan dataset's info."""
    _, confs = trees
    save = tmp_path / "run"
    assert _cli("fit", confs["titan"], save, "--trainer.max_epochs", "1",
                "--trainer.limit_train_batches", "2", "--trainer.limit_val_batches", "1") == 0
    manifest = json.loads((save / "checkpoints" / "manifest.json").read_text())
    assert manifest["dataset"] == f"{'titan_aro_arp'}_PAAROME_1S40"
    assert manifest["output_feature_names"] == ["aro_t2m_2m"]
    assert manifest["forcing_feature_names"][0] == "arp_t_500hpa"
    assert manifest["grid_shape"] == [32, 32]
    assert _cli("test", confs["titan"], save, "--trainer.ckpt_path", "last") == 0
    scores = json.loads((save / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])
    assert _cli("predict", confs["titan"], save, "--trainer.ckpt_path", "last") == 0
    preds = [np.load(p) for p in sorted((save / "predictions").glob("batch_*.npy"))]
    test_ds = port_get_datasets("titan_aro_arp", 1, 1, 1, dataset_conf=str(confs["titan"]))[2]
    assert sum(p.shape[0] for p in preds) == len(test_ds) == 8
    assert preds[0].shape[1:] == (1, 32, 32, 1) and all(np.isfinite(p).all() for p in preds)

    # a dataset that breaks the checkpoint's contract is refused
    broken = json.loads(confs["titan"].read_text())
    broken["grid"]["subdomain"] = [100, 116, 240, 272]
    other = tmp_path / "titan_aro_arp.json"
    other.write_text(json.dumps(broken))
    base = port_titan.TITAN_PATH / "subdatasets"
    (base / "titan_aro_arp_PAAROME_1S40_100-116-240-272").mkdir()
    for f in ("parameters_stats.json", "diff_stats.json"):
        (base / "titan_aro_arp_PAAROME_1S40_100-116-240-272" / f).write_bytes(
            (base / SUBDATASET / f).read_bytes())
    with pytest.raises(ValueError, match="grid shape differs"):
        _cli("predict", other, save, "--trainer.ckpt_path", "last")


def test_poesy_members_trained_scored_and_exported(trees, tmp_path, monkeypatch):
    """fit → test → predict on Poesy's two members: every member's
    samples are loaded by the fit (no validation in its one epoch),
    scored by the test and exported by the predict (one prediction row
    a sample, padded tails sliced)."""
    train_ds, val_ds, test_ds = port_get_datasets("poesy", 2, 1, 1, dataset_conf=POESY_CONF)
    assert {s.member for s in train_ds.sample_list} == {0, 3}
    assert {s.member for s in test_ds.sample_list} == {0, 3}
    loaded = []
    load = port_base.Sample.load

    def counting_load(self, *args, **kwargs):
        loaded.append((self.timestamps.datetime, tuple(self.timestamps.timedeltas), self.member))
        return load(self, *args, **kwargs)

    monkeypatch.setattr(port_base.Sample, "load", counting_load)
    settings = port_training.TrainingSettings(
        model_name="HalfUNet", settings_init_args={"num_filters": 4, "depth": 2},
        training_strategy="scaled_ar", num_input_steps=2, num_warmup_steps=2)
    module = port_training.AutoRegressiveModule(settings, train_ds.dataset_info, device="cpu")
    trainer = port_training.Trainer(port_training.TrainerConfig(
        max_epochs=1, check_val_every_n_epoch=2, batch_size=2, save_path=str(tmp_path / "run"),
        logging_enabled=False, num_workers=1, device="cpu"))

    def keys(ds):
        return {(s.timestamps.datetime, tuple(s.timestamps.timedeltas), s.member)
                for s in ds.sample_list}

    state = trainer.fit(module, train_ds, val_ds)
    steps = len(train_ds) // 2
    assert state.step == steps
    assert set(loaded) == keys(train_ds)  # every training sample, both members
    loaded.clear()
    scores = trainer.test(module, test_ds, state)
    assert np.isfinite(scores["test_mean_loss"])
    assert keys(test_ds) == set(loaded)
    loaded.clear()
    preds = trainer.predict(module, test_ds, state)
    assert keys(test_ds) == set(loaded)
    assert sum(p.array.shape[0] for p in preds) == len(test_ds)
    assert all(np.isfinite(p.array).all() for p in preds)
