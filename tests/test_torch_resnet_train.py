"""The ResNet-encoder models (CustomUNet, DeepLabV3, DeepLabV3Plus) through
the port's trainer and CLI on the CPU: bf16 forward and gradients
against the JAX package's bf16 (the bars of tests/test_torch_bf16.py),
three AdamW steps of CustomUNet against the JAX package's, the
pretrained encoder (the bundled npz and one written by
``save_encoder_npz``) loaded bit for bit as the JAX package loads it,
with the stem adapted to 5 input channels, its four errors, and a
resume that keeps the checkpoint's weights."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.models import deeplab as jax_deeplab
from py4cast_tpu.models import pretrained as jax_pretrained
from py4cast_tpu.models import unet as jax_unet
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.checkpoint import CheckpointManager
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import deeplab as port_deeplab
from py4cast_tpu_torch.models import pretrained as port_pretrained
from py4cast_tpu_torch.models import unet as port_unet
from tests.test_torch_bf16 import check_against_jax
from tests.test_torch_resnet import F_IN, F_OUT, MODELS, build, draw_variables

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(encoder_depth=3, decoder_channels=(32, 16, 8))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- bf16
@pytest.mark.parametrize("model, norm", [("CustomUNet", "group"), ("DeepLabV3", "affine"),
                                         ("DeepLabV3Plus", "group")])
def test_bf16_matches_jax(model, norm):
    """Forward within max(2·d, 2⁻⁷) of scale of the JAX package's bf16
    (d: its own bf16-vs-fp32 gap), and the master gradients within twice
    its own bf16 error."""
    jm, pm = build(model, norm, {}, (30, 27))
    x = np.random.default_rng(1).standard_normal((2, 30, 27, F_IN)).astype(np.float32)
    check_against_jax(f"{model} {norm}", jm, pm, x)


# ---------------------------------------------------------- trainer, Dummy
@pytest.fixture(scope="module")
def dummy_data():
    return jax_get_datasets("dummy", 2, 2, 3), port_get_datasets("dummy", 2, 2, 3)


def test_adamw_step_losses_match_jax(dummy_data):
    """Three AdamW steps of CustomUNet from converted params (2 AR steps
    a batch): the losses track the JAX package's within 1e-4."""
    (jax_train, _, _), (port_train, _, _) = dummy_data
    settings = dict(model_name="CustomUNet", settings_init_args=SMALL,
                    training_strategy="diff_ar", num_pred_steps_train=2,
                    num_pred_steps_val_test=2, num_warmup_steps=2)
    jm = jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                           jax_train.dataset_info)
    state = jm.init_state(jax.random.key(0), 3)
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


# ------------------------------------------------------- pretrained encoder
def _variables(model, norm, grid=(32, 32)):
    jm, _ = build(model, norm, {}, grid)
    x = np.zeros((1, *grid, F_IN), np.float32)
    return draw_variables(jax.eval_shape(jm.init, jax.random.key(0), x))


def test_bundled_encoder_loads_as_jax_does(dummy_data):
    """encoder_weights: true reads data/pretrained/resnet18.npz (fp16,
    3 input channels, every encoder parameter): through Trainer's
    init_params the port's encoder equals the JAX package's loaded and
    converted one bit for bit, the stem adapted to the Dummy module's
    input channels (not a multiple of 3); the other parameters keep
    their drawn values."""
    _, (port_train, _, _) = dummy_data
    assert port_pretrained.default_weights_path("resnet18") == (
        ROOT / "data" / "pretrained" / "resnet18.npz")
    st = port_training.TrainingSettings(model_name="CustomUNet", settings_init_args={
        **SMALL, "encoder_weights": True})
    module = port_training.AutoRegressiveModule(st, port_train.dataset_info, device="cpu")
    n_in = module.num_input_features
    assert n_in % 3 != 0
    params = module.init_params(torch.Generator().manual_seed(0))
    drawn = module.model.state_dict()
    jm = jax_unet.CustomUNet(num_input_features=n_in, num_output_features=F_OUT,
                             input_shape=(64, 64),
                             settings=jax_unet.CustomUNetSettings(**SMALL, encoder_weights=True))
    variables = draw_variables(jax.eval_shape(jm.init, jax.random.key(0),
                                              np.zeros((1, 64, 64, n_in), np.float32)))
    want = params_from_jax(jax.tree.map(np.asarray, jax_pretrained.maybe_load_encoder(
        variables, jm.settings, n_in)))
    assert params.keys() == want.keys()
    assert params["encoder.stem_conv.weight"].shape[1] == n_in
    for k, v in params.items():
        if k.startswith("encoder."):
            assert torch.equal(v, want[k]), k
            assert not torch.equal(v, drawn[k]), k
        else:
            assert torch.equal(v, drawn[k]), k


def test_explicit_npz_from_save_encoder_npz_loads_as_jax_does(tmp_path):
    """An affine-norm npz of stage 0 only, written by the port's
    save_encoder_npz with a 3-channel stem: DeepLabV3 (5 inputs) loads
    it as the JAX package does, bit for bit; stage 1 keeps its draw."""
    from flax import traverse_util

    variables = _variables("DeepLabV3", "affine")
    enc = traverse_util.flatten_dict(variables["params"]["encoder"], sep="/")
    rng = np.random.default_rng(7)
    flat = {k: rng.standard_normal((7, 7, 3, 64) if k == "stem_conv/kernel" else a.shape)
            .astype(np.float32) for k, a in enc.items() if not k.startswith("stage1")}
    path = port_pretrained.save_encoder_npz(
        tmp_path / "enc.npz", flat, {"encoder_name": "resnet18", "norm": "affine",
                                     "in_channels": 3})
    settings = port_deeplab.DeepLabSettings(**MODELS["DeepLabV3"][4], encoder_norm="affine",
                                            encoder_weights=str(path))
    state = params_from_jax(variables)
    got = port_deeplab.DeepLabV3(F_IN, F_OUT, (32, 32), settings).load_pretrained(state)
    jset = jax_deeplab.DeepLabSettings(**MODELS["DeepLabV3"][4], encoder_norm="affine",
                                       encoder_weights=str(path))
    want = params_from_jax(jax.tree.map(np.asarray, jax_pretrained.maybe_load_encoder(
        variables, jset, F_IN)))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["encoder.stage1_block0.conv1.weight"],
                       state["encoder.stage1_block0.conv1.weight"])
    assert not torch.equal(got["encoder.stem_conv.weight"], state["encoder.stem_conv.weight"])


def test_encoder_loading_raises_as_jax_does(tmp_path):
    """A missing file, a norm kind or encoder name the model was not
    built with, and a shape mismatch raise what the JAX package raises."""
    variables = _variables("CustomUNet", "group")
    state = params_from_jax(variables)
    good = {"stem_norm/scale": np.ones(64, np.float32)}
    bad_shape = {"stem_norm/scale": np.ones(32, np.float32)}
    files = {}
    for name, flat, meta in (("norm", good, {"encoder_name": "resnet18", "norm": "affine"}),
                             ("name", good, {"encoder_name": "resnet34", "norm": "group"}),
                             ("shape", bad_shape, {"encoder_name": "resnet18", "norm": "group"})):
        files[name] = port_pretrained.save_encoder_npz(tmp_path / f"{name}.npz", flat, meta)
    files["missing"] = tmp_path / "absent.npz"
    for case, match in (("missing", "does not exist"), ("norm", "norm weights"),
                        ("name", "is for 'resnet34'"), ("shape", "Shape mismatch")):
        kw = dict(SMALL, encoder_weights=str(files[case]))
        jm = jax_unet.CustomUNetSettings(**kw)
        pset = port_unet.CustomUNetSettings(**kw)
        error = FileNotFoundError if case == "missing" else ValueError
        with pytest.raises(error, match=match):
            jax_pretrained.maybe_load_encoder(variables, jm, F_IN)
        with pytest.raises(error, match=match):
            port_pretrained.maybe_load_encoder(state, pset, F_IN)
    assert port_pretrained.maybe_load_encoder(state, port_unet.CustomUNetSettings(), F_IN) is state


def test_resume_keeps_the_checkpoints_encoder(dummy_data, tmp_path):
    """With encoder_weights: true, a fit's checkpoint restores its own
    trained encoder: init_state loads the npz first, the restore
    overwrites it (as fit and the CLI do)."""
    _, (port_train, port_val, _) = dummy_data
    st = port_training.TrainingSettings(model_name="CustomUNet", settings_init_args={
        **SMALL, "encoder_weights": True}, num_warmup_steps=1)
    module = port_training.AutoRegressiveModule(st, port_train.dataset_info, device="cpu")
    trainer = port_training.Trainer(port_training.TrainerConfig(
        max_epochs=1, batch_size=8, limit_train_batches=2, limit_val_batches=1,
        save_path=str(tmp_path), device="cpu", num_workers=1, logging_enabled=False))
    fitted = trainer.fit(module, port_train, port_val)
    fresh = module.init_state(torch.Generator().manual_seed(0), 1)
    restored = CheckpointManager(tmp_path / "checkpoints").restore("last", fresh)
    loaded = module.init_params(torch.Generator().manual_seed(0))
    for k, v in restored.params.items():
        assert torch.equal(v.detach(), fitted.params[k].detach()), k
    assert not torch.equal(restored.params["encoder.stem_conv.weight"].detach(),
                           loaded["encoder.stem_conv.weight"])
