"""config/CLI/model/customunet.yaml, deeplabv3.yaml and deeplabv3plus.yaml
through the port's command line on the Dummy dataset, on the CPU, at
their own width (resnet18, depth 5, decoder 256): fit, then test and
predict from the checkpoint it wrote. The observers (plots, metrics)
are off here: tests/test_torch_cli.py and test_torch_observers.py
drive them."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from py4cast_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: it keeps this file from contending with the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model_yaml, name", [("customunet", "CustomUNet"),
                                              ("deeplabv3", "DeepLabV3"),
                                              ("deeplabv3plus", "DeepLabV3Plus")])
def test_model_yaml_fits_tests_and_predicts_as_shipped(model_yaml, name, tmp_path):
    """config/CLI/model/{customunet,deeplabv3,deeplabv3plus}.yaml at their
    own width (resnet18, depth 5, decoder 256) through fit, then test and
    predict from the checkpoint it wrote."""
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--config", str(ROOT / f"config/CLI/model/{model_yaml}.yaml"),
               "--trainer.device", "cpu", "--trainer.save_path", str(tmp_path),
               "--data.num_workers", "1", "--trainer.logging_enabled", "false"]
    assert cli.main(["fit", *configs, "--trainer.max_epochs", "1",
                     "--trainer.limit_train_batches", "2",
                     "--trainer.limit_val_batches", "1"]) == 0
    manifest = json.loads((tmp_path / "checkpoints" / "manifest.json").read_text())
    assert manifest["model_name"] == name
    assert manifest["model_settings"]["encoder_depth"] == 5
    assert cli.main(["test", *configs, "--trainer.ckpt_path", "last",
                     "--trainer.limit_val_batches", "1"]) == 0
    scores = json.loads((tmp_path / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])
    assert cli.main(["predict", *configs, "--trainer.ckpt_path", "last"]) == 0
    arr = np.load(sorted((tmp_path / "predictions").glob("batch_*.npy"))[0])
    assert arr.shape == (8, 3, 64, 64, 1) and np.isfinite(arr).all()
