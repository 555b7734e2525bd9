"""SwinUNetR through the port's trainer and command line on Dummy, on the
CPU: three AdamW steps from the JAX package's initial state against the
JAX package's three, and config/CLI/model/swinunetr.yaml through fit,
test and predict at a small width.

Bar: the losses within 1e-4 (relative), as the other models' AdamW
tests."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu_torch import cli
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from tests.test_torch_swin import SMALL, _draw

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(jax_module, steps):
    """The JAX module's init_state, its variables drawn with numpy from
    jax.eval_shape instead of its jitted init."""
    x = jnp.zeros((1, *jax_module.model.input_shape, jax_module.num_input_features))
    shapes = jax.eval_shape(jax_module.model.init, jax.random.key(0), x)

    def init_params(rng):
        jax_module._graph_buffers = {}  # as the JAX init_params leaves it for a grid model
        return _draw(shapes)

    jax_module.init_params = init_params
    return jax_module.init_state(jax.random.key(0), steps)


def test_adamw_step_losses_match_jax():
    """Three AdamW steps of SwinUNetR (2 AR steps a batch) from the same
    converted params: the losses track the JAX package's within 1e-4."""
    jax_train = jax_get_datasets("dummy", 2, 2, 3)[0]
    port_train = port_get_datasets("dummy", 2, 2, 3)[0]
    settings = dict(model_name="SwinUNetR", settings_init_args=SMALL,
                    training_strategy="diff_ar", num_pred_steps_train=2,
                    num_pred_steps_val_test=2, num_warmup_steps=2)
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                           jax_train.dataset_info)
    state = _jax_state(jm, 3)
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


def test_swinunetr_yaml_fits_tests_and_predicts(tmp_path):
    """config/CLI/model/swinunetr.yaml (depths 2/2/2/2, heads 3/6/12/24,
    instance norm) at feature size 12: fit with stochastic depth on,
    then test and predict from the checkpoint it wrote."""
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--config", str(ROOT / "config/CLI/model/swinunetr.yaml"),
               "--model.settings_init_args.feature_size", "12",
               "--model.settings_init_args.dropout_path_rate", "0.1",
               "--trainer.device", "cpu", "--trainer.save_path", str(tmp_path),
               "--data.num_workers", "1", "--trainer.logging_enabled", "false"]
    assert cli.main(["fit", *configs, "--trainer.max_epochs", "1",
                     "--trainer.limit_train_batches", "2",
                     "--trainer.limit_val_batches", "1"]) == 0
    manifest = json.loads((tmp_path / "checkpoints" / "manifest.json").read_text())
    assert manifest["model_name"] == "SwinUNetR"
    assert manifest["model_settings"]["num_heads"] == [3, 6, 12, 24]
    assert manifest["model_settings"]["feature_size"] == 12
    assert cli.main(["test", *configs, "--trainer.ckpt_path", "last",
                     "--trainer.limit_val_batches", "1"]) == 0
    scores = json.loads((tmp_path / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])
    assert cli.main(["predict", *configs, "--trainer.ckpt_path", "last"]) == 0
    arr = np.load(sorted((tmp_path / "predictions").glob("batch_*.npy"))[0])
    assert arr.shape == (8, 3, 64, 64, 1) and np.isfinite(arr).all()
