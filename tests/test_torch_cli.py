"""The port's command line on the Dummy dataset, on the CPU
(``--trainer.device cpu``): fit, then test and predict from the
checkpoint it wrote, with the configs of ``config/CLI``."""

import json
from pathlib import Path

import numpy as np
import pytest

from py4cast_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
           "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
           "--config", str(ROOT / "config/CLI/model/graphlam.yaml")]
#: the graphlam.yaml model, cut in width and depth for the CPU
SMALL = ["--model.settings_init_args.hidden_dims", "16",
         "--model.settings_init_args.processor_layers", "2",
         "--trainer.device", "cpu", "--data.num_workers", "1"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    save = tmp_path_factory.mktemp("cli_run")
    assert cli.main(["fit", *CONFIGS, *SMALL, "--trainer.save_path", str(save),
                     "--trainer.max_epochs", "1", "--trainer.limit_train_batches", "2",
                     "--trainer.limit_val_batches", "1"]) == 0
    return save


def test_fit_writes_checkpoints_manifest_and_metrics(run_dir):
    assert (run_dir / "checkpoints" / "last" / "state.pt").is_file()
    assert (run_dir / "checkpoints" / "best" / "state.pt").is_file()
    manifest = json.loads((run_dir / "checkpoints" / "manifest.json").read_text())
    assert manifest["model_settings"]["hidden_dims"] == 16
    assert "val_mean_loss" in (run_dir / "metrics.csv").read_text()


def test_test_from_the_checkpoint(run_dir):
    assert cli.main(["test", *CONFIGS, "--trainer.device", "cpu", "--trainer.save_path",
                     str(run_dir), "--trainer.ckpt_path", "last",
                     "--trainer.limit_val_batches", "1"]) == 0
    scores = json.loads((run_dir / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])


def test_predict_rebuilds_the_model_from_the_manifest(run_dir):
    """The current config asks for the full graphlam.yaml width; the
    checkpoint's manifest (width 16) wins."""
    assert cli.main(["predict", *CONFIGS, "--trainer.device", "cpu", "--trainer.save_path",
                     str(run_dir), "--trainer.ckpt_path", "best"]) == 0
    files = sorted((run_dir / "predictions").glob("batch_*.npy"))
    assert files
    arr = np.load(files[0])
    assert arr.shape == (8, 3, 64 * 64, 1) and np.isfinite(arr).all()


def test_predict_filters_run_hours_and_injects_old_weights(run_dir, tmp_path):
    """--data.list_run_hour keeps the samples of one run hour only;
    --data.use_old_weights copies another checkpoint's parameters into
    the restored state: with `last`'s own weights, `last`'s predictions
    of those samples come back; with other weights, other predictions."""
    import torch

    from py4cast_tpu_torch.datasets import get_datasets

    samples = get_datasets("dummy", 2, 1, 3)[2].sample_list
    keep = sorted({s.timestamps.datetime.hour for s in samples})[0]
    rows = [i for i, s in enumerate(samples) if s.timestamps.datetime.hour == keep]
    last = run_dir / "checkpoints" / "last"
    other = tmp_path / "other"
    other.mkdir()
    payload = torch.load(last / "state.pt", weights_only=True)
    payload["params"] = {k: v + 0.1 for k, v in payload["params"].items()}
    torch.save(payload, other / "state.pt")

    def predict(name, *extra):
        save = tmp_path / name
        assert cli.main(["predict", *CONFIGS, "--trainer.device", "cpu",
                         "--trainer.save_path", str(save), "--trainer.ckpt_path",
                         str(last), *extra]) == 0
        return np.concatenate(
            [np.load(p) for p in sorted((save / "predictions").glob("batch_*.npy"))])

    full = predict("full")
    hour = ["--data.list_run_hour", f"[{keep}]"]
    same = predict("same", *hour, "--data.use_old_weights", str(last))
    moved = predict("moved", *hour, "--data.use_old_weights", str(other))
    assert 0 < len(rows) < len(full)
    np.testing.assert_allclose(same, full[rows], rtol=1e-6, atol=1e-6)
    assert np.isfinite(moved).all() and not np.allclose(moved, same)
    with pytest.raises(SystemExit, match="run hour"):
        cli.main(["predict", *CONFIGS, "--trainer.device", "cpu", "--trainer.save_path",
                  str(run_dir), "--trainer.ckpt_path", "last", "--data.list_run_hour", "[25]"])


def test_predict_refuses_a_dataset_outside_the_contract(run_dir):
    """A grid cut to 32x32 is not the grid the checkpoint was trained on."""
    with pytest.raises(ValueError, match="contract mismatch"):
        cli.main(["predict", *CONFIGS, "--trainer.device", "cpu", "--trainer.save_path",
                  str(run_dir), "--trainer.ckpt_path", "last", "--data.config_override",
                  '{"grid": {"subdomain": [0, 32, 0, 32]}}'])


def test_fast_dev_run_trains_one_batch_and_saves_nothing(tmp_path):
    assert cli.main(["fit", *CONFIGS, *SMALL, "--trainer.save_path", str(tmp_path),
                     "--trainer.fast_dev_run", "true"]) == 0
    assert not (tmp_path / "checkpoints" / "last").exists()
    assert (tmp_path / "checkpoints" / "manifest.json").is_file()


@pytest.mark.parametrize("subcommand,extra", [
    ("fit", ["--trainer.bogus_key", "1"]),
    ("fit", ["--model.not_a_setting", "1"]),
    ("train", []),
    ("test", []),  # test needs --trainer.ckpt_path
])
def test_bad_command_lines_exit(subcommand, extra, tmp_path):
    with pytest.raises(SystemExit):
        cli.main([subcommand, *CONFIGS, *SMALL, "--trainer.save_path", str(tmp_path), *extra])


def test_gif_export_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        cli.DataConfig(save_gifs=True)


def test_parse_cli_composes_configs_and_overrides():
    sub, conf = cli.parse_cli(["fit", *CONFIGS, "--data.batch_size=4",
                               "--model.learning_rate", "1e-4"])
    assert sub == "fit"
    assert conf["data"]["batch_size"] == 4
    assert float(conf["model"]["learning_rate"]) == 1e-4
    assert conf["model"]["model_name"] == "GraphLAM"
    assert conf["trainer"]["max_epochs"] == 10
