"""Plugin discovery in the port: ``py4cast_tpu_torch_plugin_example``'s
Identity joins the port's registry and computes what the JAX package's
Identity computes; neither registry picks up the other's plugin; a
plugin module that fails to import warns, a name already registered
raises; the CLI trains and predicts with the plugin's model by name."""

import importlib
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import py4cast_tpu.models as jax_models
import py4cast_tpu_plugin_example
import py4cast_tpu_torch.models as port_models
import py4cast_tpu_torch_plugin_example
from py4cast_tpu_torch import cli
from py4cast_tpu_torch.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: it keeps this file from contending with the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_identity_is_discovered_and_matches_jax():
    """Identity is in the port's registry from its plugin module, with
    its settings and model type; from converted JAX variables and
    ``scale`` 2.5 it gives the JAX Identity's output."""
    kls, settings = port_models.get_model_kls_and_settings("identity", {"scale": 2.5})
    assert kls is py4cast_tpu_torch_plugin_example.Identity
    assert "Identity" in port_models.all_nn_architectures
    assert kls.model_type == port_models.ModelType.CONVOLUTIONAL and settings.scale == 2.5
    jm = py4cast_tpu_plugin_example.Identity(
        num_input_features=5, num_output_features=3, input_shape=(6, 7),
        settings=py4cast_tpu_plugin_example.IdentitySettings(scale=2.5))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    variables = {"params": {"Dense_0": {
        "kernel": rng.standard_normal((5, 3)).astype(np.float32),
        "bias": rng.standard_normal(3).astype(np.float32)}}}
    pm = port_models.build_model_from_settings("Identity", 5, 3, settings, (6, 7))
    pm.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), rtol=1e-6, atol=1e-6)


def test_neither_registry_picks_up_the_other_plugin():
    """Each package's prefix matches its own plugin module only: the two
    Identity classes come from their own modules."""
    port_prefix, jax_prefix = port_models.PLUGIN_PREFIX, jax_models.PLUGIN_PREFIX
    assert not "py4cast_tpu_plugin_example".startswith(port_prefix)
    assert not "py4cast_tpu_torch_plugin_example".startswith(jax_prefix)
    assert port_models.registry["Identity"].__module__ == "py4cast_tpu_torch_plugin_example"
    assert jax_models.registry["Identity"].__module__ == "py4cast_tpu_plugin_example"
    assert all(issubclass(k, torch.nn.Module) for k in port_models.registry.values())


def _plugin_dir(tmp_path, monkeypatch, name, source):
    """A plugin module ``name`` on sys.path, a copy of the registry to
    discover into, and the module forgotten afterwards."""
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(source))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(port_models, "registry", dict(port_models.registry))
    monkeypatch.delitem(sys.modules, name, raising=False)
    importlib.invalidate_caches()


def test_a_broken_plugin_warns_and_registers_nothing(tmp_path, monkeypatch):
    _plugin_dir(tmp_path, monkeypatch, "py4cast_tpu_torch_plugin_broken",
                "import a_module_that_does_not_exist\n")
    before = dict(port_models.registry)
    with pytest.warns(UserWarning, match="py4cast_tpu_torch_plugin_broken"):
        port_models._discover_plugins()
    assert port_models.registry == before
    sys.modules.pop("py4cast_tpu_torch_plugin_broken", None)


def test_a_plugin_name_collision_raises(tmp_path, monkeypatch):
    """A plugin class named like a built-in model raises; one that does
    not set ``register`` is skipped."""
    _plugin_dir(tmp_path, monkeypatch, "py4cast_tpu_torch_plugin_clash", """
        from py4cast_tpu_torch.models.base import ModelBase

        class Quiet(ModelBase):
            pass

        class HalfUNet(ModelBase):
            register = True
        """)
    with pytest.raises(ValueError, match="HalfUNet from py4cast_tpu_torch_plugin_clash"):
        port_models._discover_plugins()
    assert "Quiet" not in port_models.registry
    sys.modules.pop("py4cast_tpu_torch_plugin_clash", None)


def test_cli_fits_and_predicts_the_plugin_model(tmp_path):
    """``--model.model_name Identity``, found by discovery: fit on Dummy,
    then predict from the checkpoint."""
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--model.model_name", "Identity", "--model.settings_init_args.scale", "0.5",
               "--trainer.device", "cpu", "--trainer.save_path", str(tmp_path),
               "--data.num_workers", "1", "--trainer.logging_enabled", "false"]
    assert cli.main(["fit", *configs, "--trainer.max_epochs", "1",
                     "--trainer.limit_train_batches", "2",
                     "--trainer.limit_val_batches", "1"]) == 0
    assert cli.main(["predict", *configs, "--trainer.ckpt_path", "last"]) == 0
    arr = np.load(sorted((tmp_path / "predictions").glob("batch_*.npy"))[0])
    assert arr.shape == (8, 3, 64, 64, 1) and np.isfinite(arr).all()


def test_jax_variables_convert_for_identity():
    """The JAX Identity's own init tree converts onto the port's Identity."""
    jm = py4cast_tpu_plugin_example.Identity(num_input_features=4, num_output_features=2,
                                             input_shape=(3, 3))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), np.zeros((1, 3, 3, 4), np.float32))
    pm = py4cast_tpu_torch_plugin_example.Identity(4, 2, (3, 3))
    state = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
