"""UNetRPP in the port against the JAX package on the CPU: the same
variables (converted by ``convert.params_from_jax``) and the same inputs
through both, forward and every gradient, with encoder stages scanned
(depth 2) and plain (depth 1), both upsampling modes (bilinear and 1x1
conv, or transposed convs at k = s = 2 and k = s = dr) and both
attention codes (``xla``, and ``pallas``, where the JAX package on the
CPU takes its einsum path and the port ``short_kv_attention``'s plain
version); EPA's initializers; ``Trainer.predict`` on Dummy and three
AdamW steps; and the dropout the trainer threads through train steps.

Bars: a whole model 1e-4 of the largest JAX value (absolute below 1),
as for HalfUNet (tests/test_torch_halfunet.py says why)."""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import training as jax_training
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.models import unetrpp as jax_unetrpp
from py4cast_tpu_torch import training as port_training
from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.models import base as port_base
from py4cast_tpu_torch.models import unetrpp as port_unetrpp

BAR = 1e-4
F_IN, F_OUT = 5, 3
#: (settings, grid): hidden 32, 2 heads; odd grids padded to a multiple
#: of dr·2^(stages−1)
CASES = {
    "scanned_plain_bilinear_xla": (dict(depths=(2, 1), encoder_proj_sizes=(8, 4),
                                        linear_upsampling=True, attention_code="xla"),
                                   (30, 27)),
    "plain_scanned_transposed_pallas": (dict(depths=(1, 2), encoder_proj_sizes=(16, 8),
                                             linear_upsampling=False, attention_code="pallas"),
                                        (29, 31)),
    "three_stages_group_norm_dr2": (dict(depths=(2, 1, 1), encoder_proj_sizes=(8, 8, 4),
                                         downsampling_rate=2, norm_name="group",
                                         pos_embed="none", add_skip_connections=False,
                                         attention_code="pallas"), (16, 13)),
}
COMMON = dict(hidden_size=32, num_heads_encoder=2, num_heads_decoder=2, decoder_proj_size=8)


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar * scale, f"{name}: {err:.3e} > {bar} x {scale:.3g}"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread runs them as fast
    and keeps this file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed=0):
    """Variables for ``shapes`` (jax.eval_shape of init) drawn with numpy:
    kernels of std 1/sqrt(fan in), biases and norms near their init,
    EPA's temperature near 1 and projections of std 1/sqrt(tokens), so
    that the attention is far from uniform."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        a = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[-4 if len(s.shape) >= 4 else -2:-1]))
        if name in ("proj_k", "proj_v"):
            return a / np.sqrt(s.shape[-2])
        if name in ("scale", "temperature"):
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(lambda p, s: draw(p, s).astype(np.float32), shapes)


def _models(args, grid):
    settings = {**COMMON, **args}
    jm = jax_unetrpp.UNetRPP(num_input_features=F_IN, num_output_features=F_OUT,
                             input_shape=grid, settings=jax_unetrpp.UNetRPPSettings(**settings))
    pm = port_unetrpp.UNetRPP(F_IN, F_OUT, grid, port_unetrpp.UNetRPPSettings(**settings))
    return jm, pm


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX UNetRPP, its variables (numpy), an input, the JAX output and
    gradients of sum(y²), and the port's UNetRPP with the converted
    variables loaded."""
    args, grid = CASES[request.param]
    jm, pm = _models(args, grid)
    x = np.random.default_rng(1).standard_normal((2, *grid, F_IN)).astype(np.float32)
    variables = _draw(jax.eval_shape(jm.init, jax.random.key(0), x))

    def loss(v):
        y = jm.apply(v, x)
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return variables, x, np.asarray(want), params_from_jax(jax.tree.map(np.asarray, grads)), pm


def test_params_from_jax_fills_every_parameter(case):
    """Scanned stages split into ModuleLists, EPA's leaves kept, the
    transposed convs' kernels flipped: every leaf lands on a parameter
    of the same shape."""
    variables, _, _, _, pm = case
    state = params_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}
    stacked = variables["params"]["enc_stage0"]
    if "block" in stacked:
        np.testing.assert_array_equal(state["enc_stage0.1.EPA_0.proj_k"].numpy(),
                                      stacked["block"]["EPA_0"]["proj_k"][1])
    for name, kernel in variables["params"].items():
        if name.startswith("ConvTranspose"):
            np.testing.assert_array_equal(state[f"{name}.weight"].numpy(),
                                          kernel["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))


def test_forward_matches_jax(case):
    _, x, want, _, pm = case
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *x.shape[1:3], F_OUT)
    _close(got, want, BAR)


def test_gradients_match_jax(case):
    """d/dparams of sum(y²) for every parameter. The biases of the two
    convs before an ``instance`` norm (one channel a group, no affine)
    have a zero gradient in exact arithmetic, and both packages return
    rounding noise for it: those are held below BAR of the largest
    gradient on both sides instead of against each other."""
    _, x, _, want, pm = case
    pm.zero_grad()
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    exact_zero = ({f"{pm.stem_conv}.bias", f"{pm.head_conv}.bias"}
                  if pm.settings.norm_name == "instance" else set())
    largest = max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        if name in exact_zero:
            assert max(float(g.abs().max()), float(want[name].abs().max())) <= BAR * largest
        else:
            _close(g.numpy(), want[name].numpy(), BAR, name)
            assert float(g.abs().max()) > 0, name


def test_attention_codes_agree_and_kernel_code_runs_the_function(monkeypatch):
    """``pallas`` goes through ``short_kv_attention`` once a block (the
    kernels on the card), ``xla`` never; on the CPU both agree."""
    args, grid = CASES["scanned_plain_bilinear_xla"]
    calls = []
    real = port_unetrpp.short_kv_attention
    monkeypatch.setattr(port_unetrpp, "short_kv_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, *grid, F_IN))
                         .astype(np.float32))
    _, plain = _models(args, grid)
    _, kernel = _models({**args, "attention_code": "pallas"}, grid)
    port_training.init_weights(plain, torch.Generator().manual_seed(0))
    kernel.load_state_dict(plain.state_dict())
    with torch.no_grad():
        want = plain(x)
        assert not calls
        got = kernel(x)
    # encoder 2 + 1 blocks, one decoder block; (B·heads, N, hd)
    assert calls == [(4, 64, 8), (4, 64, 8), (4, 16, 16), (4, 64, 8)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_settings_validate_as_the_jax_package():
    for bad in (dict(dropout_rate=1.0), dict(conv_op="Conv3d"), dict(attention_code="cudnn"),
                dict(pos_embed="sincos"), dict(norm_name="batch")):
        with pytest.raises(ValueError) as want:
            jax_unetrpp.UNetRPPSettings(**bad)
        with pytest.raises(ValueError) as got:
            port_unetrpp.UNetRPPSettings(**bad)
        assert type(got.value) is type(want.value), bad
    assert port_unetrpp.UNetRPPSettings.DROPOUT_FIELDS == ("dropout_rate",)
    assert {f.name for f in dataclasses.fields(port_unetrpp.UNetRPPSettings)} == {
        f.name for f in dataclasses.fields(jax_unetrpp.UNetRPPSettings)}


def test_init_params_draw_as_flax():
    """init_weights: EPA's temperature ones, proj_k and proj_v flax's
    truncated_normal(0.02) (cut at ±2 std, so std 0.02 x 0.8796), the
    transposed convs lecun-normal over in · kh · kw."""
    pm = port_unetrpp.UNetRPP(F_IN, F_OUT, (64, 64), port_unetrpp.UNetRPPSettings(
        **{**COMMON, "depths": (2, 1), "encoder_proj_sizes": (64, 32)}))
    port_training.init_weights(pm, torch.Generator().manual_seed(0))
    epas = [m for m in pm.modules() if isinstance(m, port_unetrpp.EPA)]
    assert len(epas) == 4
    for epa in epas:
        assert torch.equal(epa.temperature, torch.ones(2, 1, 1))
        for proj in (epa.proj_k.detach(), epa.proj_v.detach()):
            assert float(proj.abs().max()) <= 0.04
            assert abs(float(proj.std()) / (0.02 * 0.8796) - 1) < 6 / proj.numel() ** 0.5 + 0.02
    for name in ("ConvTranspose_0", "ConvTranspose_1"):
        conv = getattr(pm, name)
        cin, _, kh, kw = conv.weight.shape
        want = (cin * kh * kw) ** -0.5
        assert abs(float(conv.weight.std()) / want - 1) < 6 / conv.weight.numel() ** 0.5 + 0.02
        assert float(conv.bias.abs().max()) == 0.0


# ----------------------------------------------------------- end to end, Dummy
SMALL = dict(hidden_size=16, num_heads_encoder=2, num_heads_decoder=2, depths=(2, 1),
             encoder_proj_sizes=(16, 8), decoder_proj_size=8, linear_upsampling=False,
             attention_code="pallas")


@pytest.fixture(scope="module")
def dummy_data():
    return jax_get_datasets("dummy", 2, 2, 3), port_get_datasets("dummy", 2, 2, 3)


def _jax_state(jax_module, steps):
    """The JAX module's init_state, its variables drawn with numpy from
    jax.eval_shape (``_draw``) instead of its jitted init, whose compile
    takes about 10 s on the CPU."""
    x = jnp.zeros((1, *jax_module.model.input_shape, jax_module.num_input_features))
    shapes = jax.eval_shape(jax_module.model.init, jax.random.key(0), x)

    def init_params(rng):
        jax_module._graph_buffers = {}  # as the JAX init_params leaves it for a grid model
        return _draw(shapes)

    jax_module.init_params = init_params
    return jax_module.init_state(jax.random.key(0), steps)


def test_predict_matches_jax_on_dummy(dummy_data):
    """JAX Trainer.predict (params from module.init_state) against the
    port's from the same converted params; with a nonzero dropout rate,
    both stay deterministic."""
    (_, _, jax_test), (_, _, port_test) = dummy_data
    settings = dict(model_name="UNetRPP", settings_init_args={**SMALL, "dropout_rate": 0.3},
                    training_strategy="diff_ar")
    jax_module = jax_training.AutoRegressiveModule(
        jax_training.TrainingSettings(**settings), jax_test.dataset_info)
    state = _jax_state(jax_module, 1)
    with tempfile.TemporaryDirectory() as tmp:
        want = jax_training.Trainer(
            jax_training.TrainerConfig(batch_size=8, save_path=tmp)
        ).predict(jax_module, jax_test, state)
    port_module = port_training.AutoRegressiveModule(
        port_training.TrainingSettings(**settings), port_test.dataset_info, device="cpu")
    assert port_module._dropout_active
    got = port_training.Trainer(
        port_training.TrainerConfig(batch_size=8, device="cpu", num_workers=1)
    ).predict(port_module, port_test, params_from_jax(jax.tree.map(np.asarray, state.params)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.names == w.names and g.feature_names == w.feature_names
        assert g.shape == (8, 3, 64, 64, 1)
        assert np.isfinite(g.array).all()
        _close(g.array, np.asarray(w.array), BAR)


def _train_settings(**args):
    return dict(model_name="UNetRPP", settings_init_args={**SMALL, **args},
                training_strategy="diff_ar", num_pred_steps_train=2,
                num_pred_steps_val_test=2, num_warmup_steps=2)


def test_adamw_step_losses_match_jax(dummy_data):
    """Three AdamW steps of UNetRPP from converted params (2 AR steps a
    batch): the losses track the JAX package's within 1e-4."""
    (jax_train, _, _), (port_train, _, _) = dummy_data
    settings = _train_settings()
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


# -------------------------------------------------------------------- dropout
def test_dropout_keeps_the_stated_fraction_and_scales():
    """Inverted dropout from an explicit generator: the kept share within
    5 sigma of 1 − rate, kept values scaled by 1 / (1 − rate), the same
    mask for the same seed, and no draw from the global RNG."""
    x = torch.ones(200_000)
    before = torch.random.get_rng_state()
    y = port_base.dropout(x, 0.3, torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), before)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.7) < 5 * (0.3 * 0.7 / x.numel()) ** 0.5
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / 0.7]))
    assert torch.equal(y, port_base.dropout(x, 0.3, torch.Generator().manual_seed(5)))
    assert port_base.dropout(x, 0.3, None) is x
    assert port_base.dropout(x, 0.0, torch.Generator()) is x


def _train_losses(data, steps=2, seed=42, **args):
    """Losses of ``steps`` train steps of a port module from fixed
    parameters (drawn with seed 0), and the global RNG state before and
    after."""
    (_, _, _), (port_train, _, _) = data
    settings = port_training.TrainingSettings(**_train_settings(**args), seed=seed)
    module = port_training.AutoRegressiveModule(settings, port_train.dataset_info,
                                                device="cpu")
    params = module.init_params(torch.Generator().manual_seed(0))
    state = module.init_state(None, 10, params)
    before = torch.random.get_rng_state()
    losses = [float(module.train_step(state, b))
              for _, b in zip(range(steps), port_train.loader(batch_size=8, num_workers=1))]
    return losses, before, torch.random.get_rng_state(), module, params


def test_dropout_zero_train_path_is_the_deterministic_path(dummy_data):
    """dropout_rate 0: no dropout seed, and the model with a generator
    equals the model without one bit for bit."""
    losses, _, _, module, params = _train_losses(dummy_data, steps=1)
    assert not module._dropout_active and module._dropout_seed(params) is None
    x = torch.randn(2, 64, 64, module.num_input_features,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = torch.func.functional_call(module.model, params, (x,))
        b = torch.func.functional_call(module.model, params, (x,),
                                       {"generator": torch.Generator().manual_seed(4)})
    assert torch.equal(a, b)


def test_dropout_losses_repeat_for_a_seed_and_differ_for_another(dummy_data):
    """Nonzero rate: two runs with one seed give the same losses bit for
    bit, another seed other losses, and neither the deterministic ones;
    the global RNG is never drawn from."""
    one, before, after, module, _ = _train_losses(dummy_data, dropout_rate=0.2)
    assert module._dropout_active and torch.equal(before, after)
    again = _train_losses(dummy_data, dropout_rate=0.2)[0]
    other = _train_losses(dummy_data, seed=7, dropout_rate=0.2)[0]
    plain = _train_losses(dummy_data)[0]
    assert one == again
    assert other[0] != one[0] and other[1] != one[1]
    assert plain[0] != one[0]


def test_dropout_masks_survive_checkpointing(dummy_data):
    """use_checkpointing recomputes the forward in the backward: its
    dropout generator is made inside the recomputed function from the
    step's seed, so loss and gradients equal the run without it."""
    (_, _, _), (port_train, _, _) = dummy_data
    batch = next(iter(port_train.loader(batch_size=8, num_workers=1)))
    out = []
    for ckpt in (False, True):
        settings = port_training.TrainingSettings(**_train_settings(dropout_rate=0.2),
                                                  use_checkpointing=ckpt)
        module = port_training.AutoRegressiveModule(settings, port_train.dataset_info,
                                                    device="cpu")
        params = module.init_params(torch.Generator().manual_seed(0))
        out.append(module.loss_and_grads(params, batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


def test_undeclared_drop_field_raises_as_the_jax_package(dummy_data, monkeypatch):
    """A nonzero "drop" field missing from DROPOUT_FIELDS raises the JAX
    package's ValueError, word for word."""
    (_, _, jax_test), (_, _, port_test) = dummy_data
    settings = dict(model_name="UNetRPP", settings_init_args={**SMALL, "dropout_rate": 0.1})
    monkeypatch.setattr(jax_unetrpp.UNetRPPSettings, "DROPOUT_FIELDS", ())
    monkeypatch.setattr(port_unetrpp.UNetRPPSettings, "DROPOUT_FIELDS", ())
    with pytest.raises(ValueError, match="DROPOUT_FIELDS") as want:
        jax_training.AutoRegressiveModule(jax_training.TrainingSettings(**settings),
                                          jax_test.dataset_info)
    with pytest.raises(ValueError, match="DROPOUT_FIELDS") as got:
        port_training.AutoRegressiveModule(port_training.TrainingSettings(**settings),
                                           port_test.dataset_info, device="cpu")
    assert str(got.value) == str(want.value)
