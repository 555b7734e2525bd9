"""The port's command line on the Dummy dataset, on the CPU
(``--trainer.device cpu``): fit, then test and predict from the
checkpoint it wrote, with the configs of ``config/CLI``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from py4cast_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
           "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
           "--config", str(ROOT / "config/CLI/model/graphlam.yaml")]
#: the graphlam.yaml model, cut in width and depth for the CPU
SMALL = ["--model.settings_init_args.hidden_dims", "16",
         "--model.settings_init_args.processor_layers", "2",
         "--trainer.device", "cpu", "--data.num_workers", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def test_parse_cli_composes_configs_and_overrides():
    sub, conf = cli.parse_cli(["fit", *CONFIGS, "--data.batch_size=4",
                               "--model.learning_rate", "1e-4"])
    assert sub == "fit"
    assert conf["data"]["batch_size"] == 4
    assert float(conf["model"]["learning_rate"]) == 1e-4
    assert conf["model"]["model_name"] == "GraphLAM"
    assert conf["trainer"]["max_epochs"] == 10


def test_segformer_yaml_fits_and_tests(tmp_path):
    """config/CLI/model/segformer.yaml through fit and test, cut to two
    narrow stages for the CPU."""
    configs = [*CONFIGS[:4], "--config", str(ROOT / "config/CLI/model/segformer.yaml")]
    small = ["--model.settings_init_args.dims", "[16, 32]",
             "--model.settings_init_args.heads", "[1, 2]",
             "--model.settings_init_args.ff_expansion", "[2, 2]",
             "--model.settings_init_args.reduction_ratio", "[4, 1]",
             "--model.settings_init_args.num_layers", "1",
             "--model.settings_init_args.decoder_dim", "16",
             "--model.settings_init_args.num_downsampling_chans", "8",
             "--trainer.device", "cpu", "--data.num_workers", "1",
             "--trainer.save_path", str(tmp_path)]
    assert cli.main(["fit", *configs, *small, "--trainer.max_epochs", "1",
                     "--trainer.limit_train_batches", "2", "--trainer.limit_val_batches",
                     "1"]) == 0
    manifest = json.loads((tmp_path / "checkpoints" / "manifest.json").read_text())
    assert manifest["model_name"] == "Segformer"
    assert list(manifest["model_settings"]["dims"]) == [16, 32]
    assert cli.main(["test", *configs, "--trainer.device", "cpu", "--trainer.save_path",
                     str(tmp_path), "--trainer.ckpt_path", "last",
                     "--trainer.limit_val_batches", "1"]) == 0
    scores = json.loads((tmp_path / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])


#: halfunet.yaml, hilam.yaml, hilamparallel.yaml, unet.yaml and
#: unetrpp.yaml, cut in width and depth for the CPU
MODEL_YAMLS = {
    "halfunet": (["--model.settings_init_args.num_filters", "8"], "HalfUNet", "num_filters", 8),
    "unet": (["--model.settings_init_args.init_features", "8",
              "--model.settings_init_args.depth", "2"], "UNet", "init_features", 8),
    "unetrpp": (["--model.settings_init_args.hidden_size", "16",
                 "--model.settings_init_args.num_heads_encoder", "2",
                 "--model.settings_init_args.num_heads_decoder", "2",
                 "--model.settings_init_args.depths", "[2, 1]",
                 "--model.settings_init_args.encoder_proj_sizes", "[16, 8]",
                 "--model.settings_init_args.decoder_proj_size", "8"], "UNetRPP", "hidden_size",
                16),
    "hilam": (["--model.settings_init_args.hidden_dims", "8",
               "--model.settings_init_args.processor_layers", "1"], "HiLAM", "hidden_dims", 8),
    "hilamparallel": (["--model.settings_init_args.hidden_dims", "8",
                       "--model.settings_init_args.processor_layers", "2"], "HiLAMParallel",
                      "hidden_dims", 8),
}


@pytest.mark.parametrize("model_yaml", sorted(MODEL_YAMLS))
def test_model_yaml_fits_tests_and_predicts(model_yaml, tmp_path):
    """config/CLI/model/{halfunet,hilam,hilamparallel,unet,unetrpp}.yaml
    through fit, then test and predict from the checkpoint it wrote."""
    cut, name, key, value = MODEL_YAMLS[model_yaml]
    configs = [*CONFIGS[:4], "--config", str(ROOT / f"config/CLI/model/{model_yaml}.yaml"),
               "--trainer.device", "cpu", "--trainer.save_path", str(tmp_path)]
    assert cli.main(["fit", *configs, *cut, "--data.num_workers", "1",
                     "--trainer.max_epochs", "1", "--trainer.limit_train_batches", "2",
                     "--trainer.limit_val_batches", "1"]) == 0
    manifest = json.loads((tmp_path / "checkpoints" / "manifest.json").read_text())
    assert manifest["model_name"] == name
    assert manifest["model_settings"][key] == value
    assert cli.main(["test", *configs, "--trainer.ckpt_path", "last",
                     "--trainer.limit_val_batches", "1"]) == 0
    scores = json.loads((tmp_path / "test_scores.json").read_text())
    assert np.isfinite(scores["test_mean_loss"])
    assert cli.main(["predict", *configs, "--trainer.ckpt_path", "last"]) == 0
    arr = np.load(sorted((tmp_path / "predictions").glob("batch_*.npy"))[0])
    spatial = (64 * 64,) if name.startswith("HiLAM") else (64, 64)
    assert arr.shape == (8, 3, *spatial, 1) and np.isfinite(arr).all()


def test_unetrpp_yaml_runs_the_kernel_code_and_dropout(tmp_path):
    """unetrpp.yaml with attention_code flash_attn (the kernels on the
    card, their plain versions here) and a nonzero dropout_rate, cut for
    the CPU: fit trains with dropout and records both settings, and
    predict runs from its checkpoint (tests/test_torch_unetrpp.py holds
    predict with dropout to the JAX package's deterministic output)."""
    cut = MODEL_YAMLS["unetrpp"][0]
    configs = [*CONFIGS[:4], "--config", str(ROOT / "config/CLI/model/unetrpp.yaml"),
               "--trainer.device", "cpu", *cut,
               "--model.settings_init_args.attention_code", "flash_attn",
               "--model.settings_init_args.dropout_rate", "0.1"]
    assert cli.main(["fit", *configs, "--trainer.save_path", str(tmp_path),
                     "--data.num_workers", "1", "--trainer.max_epochs", "1",
                     "--trainer.limit_train_batches", "2", "--trainer.limit_val_batches",
                     "1"]) == 0
    manifest = json.loads((tmp_path / "checkpoints" / "manifest.json").read_text())
    assert manifest["model_settings"]["attention_code"] == "flash_attn"
    assert manifest["model_settings"]["dropout_rate"] == 0.1
    assert cli.main(["predict", *configs, "--trainer.save_path", str(tmp_path),
                     "--trainer.ckpt_path", "last"]) == 0
    arr = np.load(sorted((tmp_path / "predictions").glob("batch_*.npy"))[0])
    assert arr.shape == (8, 3, 64, 64, 1) and np.isfinite(arr).all()
