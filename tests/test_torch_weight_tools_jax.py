"""The port's encoder pretraining (``tools/pretrain_encoder.py``) against
the JAX package's on the CPU: its ``DenoiseAE`` against a restatement of
the module that ``bin/pretrain_encoder.py`` defines inside ``main()``
(ResNet18 at 32x32, batch 2, on the same converted variables): the
forward and every gradient within 1e-4 of scale, three Adam steps'
losses within 1e-4; the encoder's inverse conversion
(``convert.encoder_to_flax``) bit for bit and in the JAX encoder's
names; the tool's npz loaded by a ResNet34 CustomUNet."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from py4cast_tpu.models.unet import ResNetEncoder as JaxResNetEncoder
from py4cast_tpu_torch.convert import encoder_to_flax, params_from_jax
from py4cast_tpu_torch.models import unet as port_unet
from py4cast_tpu_torch.models.pretrained import load_encoder_npz
from py4cast_tpu_torch.tools import pretrain_encoder
from py4cast_tpu_torch.training import init_weights

BAR = 1e-4
SIZE, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are small, and it keeps this
    file from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxDenoiseAE(nn.Module):
    """bin/pretrain_encoder.py's module, as its ``main()`` defines it."""

    encoder_name: str

    @nn.compact
    def __call__(self, x):
        feats = JaxResNetEncoder(self.encoder_name, 5, name="encoder")(x)
        y = feats[-1]
        for skip in reversed(feats[:-1]):
            b, h, w, _ = skip.shape
            y = jax.image.resize(y, (b, h, w, y.shape[-1]), "nearest")
            y = jnp.concatenate([y, skip], axis=-1)
            y = nn.GroupNorm(num_groups=8)(nn.Conv(64, (3, 3))(y))
            y = nn.gelu(y)
        b, h, w, _ = y.shape
        y = jax.image.resize(y, (b, x.shape[1], x.shape[2], y.shape[-1]), "nearest")
        y = nn.gelu(nn.GroupNorm(num_groups=8)(nn.Conv(32, (3, 3))(y)))
        return nn.Conv(x.shape[-1], (1, 1))(y)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX module's variables (its own init), the first batch's
    output and gradients of the denoising MSE, and three optax.adam(1e-3)
    steps' losses, on the tool's draws from seed 0 (one jit)."""
    model = JaxDenoiseAE("resnet18")
    variables = model.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    rng = np.random.default_rng(0)
    batches = list(pretrain_encoder.noisy_batches(rng, 3, BATCH, SIZE))
    tx = optax.adam(1e-3)

    def loss_fn(p, noisy, clean):
        y = model.apply(p, noisy)
        return jnp.mean((y - clean) ** 2), y

    @jax.jit
    def step(p, s, noisy, clean):
        (loss, y), g = jax.value_and_grad(loss_fn, has_aux=True)(p, noisy, clean)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss, y, g

    p, s, losses = variables, tx.init(variables), []
    for noisy, clean in batches:
        p, s, loss, y, g = step(p, s, noisy, clean)
        if not losses:
            out, grads = np.asarray(y), g
        losses.append(float(loss))
    return (jax.tree.map(np.asarray, variables), batches, out,
            params_from_jax(jax.tree.map(np.asarray, grads)), losses)


def port_model(variables):
    model = pretrain_encoder.DenoiseAE("resnet18")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def test_denoise_ae_forward_matches_jax(jax_run):
    variables, batches, want, _, _ = jax_run
    with torch.no_grad():
        got = port_model(variables)(torch.from_numpy(batches[0][0])).numpy()
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, 3)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= BAR * scale


def test_denoise_ae_gradients_match_jax(jax_run):
    """Every parameter's gradient of the MSE, within 1e-4 of the largest
    gradient of its module."""
    variables, batches, _, want, _ = jax_run
    model = port_model(variables)
    noisy, clean = (torch.from_numpy(a) for a in batches[0])
    torch.mean((model(noisy) - clean) ** 2).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    scale = {}
    for k, w in want.items():
        mod = k.rsplit(".", 1)[0]
        scale[mod] = max(scale.get(mod, 1e-3), float(w.abs().max()))
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        assert err <= BAR * scale[k.rsplit(".", 1)[0]], f"{k}: {err:.3e}"


def test_three_adam_steps_match_optax(jax_run):
    """The tool's step (torch Adam at optax.adam's defaults, inside
    exact_reductions) on the JAX variables: three losses within 1e-4."""
    variables, batches, _, _, want = jax_run
    model = port_model(variables)
    opt = pretrain_encoder.adam(model)
    got = [float(pretrain_encoder.train_step(model, opt, torch.from_numpy(noisy),
                                             torch.from_numpy(clean)))
           for noisy, clean in batches]
    np.testing.assert_allclose(got, want, rtol=BAR, atol=0)
    assert got[2] < got[0]


@pytest.mark.parametrize("encoder", ["resnet18", "resnet34"])
def test_encoder_to_flax_inverts_params_from_jax(encoder):
    """The port's encoder state through ``encoder_to_flax`` and back
    through ``params_from_jax`` bit for bit, in the JAX encoder's own
    flat names and shapes."""
    enc = port_unet.ResNetEncoder(3, encoder)
    init_weights(enc, torch.Generator().manual_seed(1))
    state = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    flat = encoder_to_flax(state)
    back = params_from_jax({"encoder": flat})
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    shapes = jax.eval_shape(JaxResNetEncoder(encoder, 5).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = traverse_util.flatten_dict(shapes["params"], sep="/")
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in want.items()}


def test_pretrain_main_writes_a_resnet34_npz_customunet_loads(tmp_path):
    """``main`` on the CPU: a ResNet34 npz with the JAX tool's meta, which
    CustomUNet's ``encoder_weights`` loads; each loaded tensor is the
    npz's through the inverse conversion (the stem adapted to 4 inputs);
    the default device is the card, which raises here."""
    out = tmp_path / "resnet34.npz"
    assert pretrain_encoder.main(["--encoder", "resnet34", "--steps", "2", "--batch", "2",
                                  "--size", "32", "--device", "cpu", "--out", str(out)]) == 0
    flat, meta = load_encoder_npz(out)
    assert meta == {"encoder_name": "resnet34", "norm": "group", "in_channels": 3,
                    "source": "selfsupervised-grf"}
    model = port_unet.CustomUNet(4, 2, (32, 32), port_unet.CustomUNetSettings(
        encoder_name="resnet34", encoder_weights=str(out)))
    params = model.load_pretrained({k: v.detach() for k, v in model.named_parameters()})
    got = encoder_to_flax(params)
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        if k == "stem_conv/kernel":
            np.testing.assert_array_equal(got[k], np.tile(v, (1, 1, 2, 1))[:, :, :4] * 0.75)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_encoder.main(["--steps", "1", "--out", str(tmp_path / "x.npz")])


@pytest.mark.parametrize("src,dst", [((2, 2), (3, 3)), ((3, 5), (7, 10)), ((6, 4), (12, 3)),
                                     ((5, 7), (3, 7))])
def test_resize_nearest_matches_jax(src, dst):
    """The decoder's nearest growth against ``jax.image.resize``: whole
    factors, fractional ones (a ResNet's maps at sides that are not a
    power of two) and a shrink, bit for bit."""
    x = np.random.default_rng(4).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), "nearest"))
    got = pretrain_encoder.resize_nearest(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_array_equal(got, want)
