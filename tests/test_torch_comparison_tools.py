"""The port's run-comparison tools (py4cast_tpu_torch.tools), the cases
of tests/test_comparison_tools.py on runs the port's Trainer trained on
the CPU on Dummy, and CheckpointManager.read_manifest against the JAX
package's on one manifest file."""

import json

import pytest
import torch

from py4cast_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from py4cast_tpu_torch.checkpoint import CheckpointManager, _jsonable
from py4cast_tpu_torch.datasets import get_datasets
from py4cast_tpu_torch.tools import gif_comparison, scores_comparison
from py4cast_tpu_torch.training import (
    AutoRegressiveModule,
    Trainer,
    TrainerConfig,
    TrainingSettings,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as every port test file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One tiny HalfUNet fit on Dummy (a train and a val batch): its save
    path and module."""
    train_ds, val_ds, _ = get_datasets("dummy", 2, 1, 2)
    module = AutoRegressiveModule(
        TrainingSettings(model_name="HalfUNet", settings_init_args={"num_filters": 4, "depth": 2},
                         num_warmup_steps=2),
        train_ds.dataset_info, device="cpu")
    save = tmp_path_factory.mktemp("run")
    Trainer(TrainerConfig(max_epochs=1, batch_size=8, limit_train_batches=1,
                          limit_val_batches=1, save_path=str(save), logging_enabled=False,
                          num_workers=1, device="cpu")).fit(module, train_ds, val_ds)
    return save, module


def test_scores_comparison_plots_multiple_runs(tmp_path):
    runs = []
    for name, vals in [("runA", (1.0, 0.9, 0.8)), ("runB", (1.2, 1.0, 0.7))]:
        d = tmp_path / name
        d.mkdir()
        scores = {"dummy_parameter_500": list(vals),
                  "dummy_parameter_850": [v * 2 for v in vals]}
        (d / "Test_rmse_scores.json").write_text(json.dumps(scores))
        runs.append(str(d / "Test_rmse_scores.json"))
    out = tmp_path / "cmp.png"
    rc = scores_comparison.main(["--runs", *runs, "--labels", "A", "B", "--output", str(out)])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0


def test_scores_comparison_label_mismatch_errors(tmp_path):
    f = tmp_path / "Test_rmse_scores.json"
    f.write_text(json.dumps({"v": [1.0]}))
    with pytest.raises(SystemExit, match="labels"):
        scores_comparison.main(["--runs", str(f), "--labels", "A", "B"])


def test_gif_comparison_from_trained_checkpoints(run, tmp_path):
    """Render the side-by-side case-study GIFs from the run's manifest
    and its restored checkpoint: the whole tool path."""
    save, _ = run
    ckpt = save / "checkpoints" / "last"
    assert ckpt.exists()
    out_dir = tmp_path / "gifs"
    rc = gif_comparison.main(["--ckpts", str(ckpt), "--labels", "tiny", "--num-pred-steps", "2",
                              "--output-dir", str(out_dir), "--device", "cpu"])
    assert rc == 0
    gifs = list(out_dir.glob("comparison_*.gif"))
    assert gifs, "no comparison GIFs written"
    assert all(g.stat().st_size > 0 for g in gifs)


def test_read_manifest_matches_the_jax_package(run):
    """Both packages' read_manifest give the same dict from the manifest
    the port's fit wrote, which is the module's manifest as JSON."""
    save, module = run
    directory = save / "checkpoints"
    got = CheckpointManager(directory, write=False).read_manifest()
    assert got == JaxCheckpointManager(directory).read_manifest()
    assert got["framework"] == "py4cast_tpu_torch"
    assert got["model_name"] == "HalfUNet"
    assert got == json.loads(json.dumps(_jsonable(module.manifest()), default=str))
