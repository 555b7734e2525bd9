"""The port's data layer, rollout and entry points against the JAX
package's, on the CPU."""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import rollout as jax_rollout
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.named_tensor import NamedArray as JaxNamedArray
from py4cast_tpu_torch import rollout as port_rollout
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.datasets.forcing import generate_forcings
from py4cast_tpu_torch.named_tensor import NamedArray
from py4cast_tpu_torch.training import (
    AutoRegressiveModule,
    Trainer,
    TrainerConfig,
    TrainingSettings,
)


@pytest.fixture(scope="module")
def both_test_sets():
    return jax_get_datasets("dummy", 2, 1, 3)[2], port_get_datasets("dummy", 2, 1, 3)[2]


def test_dummy_items_identical(both_test_sets):
    jax_ds, port_ds = both_test_sets
    assert len(port_ds) == len(jax_ds) == 24
    for i in (0, 23):
        want, got = jax_ds[i], port_ds[i]
        for attr in ("inputs", "outputs", "forcing"):
            w, g = getattr(want, attr), getattr(got, attr)
            assert g.names == w.names and g.feature_names == w.feature_names
            np.testing.assert_array_equal(g.array, w.array)
        assert got.validity_times == want.validity_times


def test_dataset_info_and_statics_identical(both_test_sets):
    jax_info, port_info = both_test_sets[0].dataset_info, both_test_sets[1].dataset_info
    for attr in ("weather_dim", "forcing_dim", "pred_step", "output_feature_names",
                 "forcing_feature_names", "state_weights", "shortnames"):
        assert getattr(port_info, attr) == getattr(jax_info, attr), attr
    np.testing.assert_array_equal(
        port_info.statics.grid_statics.array, jax_info.statics.grid_statics.array
    )
    np.testing.assert_array_equal(port_info.statics.meshgrid, jax_info.statics.meshgrid)
    flat = port_info.statics.flatten_spatial()
    assert flat.grid_statics.names == ("ngrid", "features")
    assert flat.border_mask.shape == (64 * 64, 1)


def test_loader_pads_last_batch(both_test_sets):
    port_ds = both_test_sets[1]
    batches = list(port_ds.loader(batch_size=5, num_workers=2, drop_last=False, pad_last=True))
    assert [b.valid_count for b in batches] == [5, 5, 5, 5, 4]
    last = batches[-1]
    np.testing.assert_array_equal(last.outputs.array[4], last.outputs.array[3])
    assert last.inputs.names == ("batch", "timestep", "lat", "lon", "features")


def test_filter_samples_matches_jax(both_test_sets):
    """The CLI's list_run_hour filter keeps the same samples as the JAX
    package's, leaves the original dataset alone, and raises when nothing
    is left."""
    jax_ds, port_ds = both_test_sets
    hours = sorted({s.timestamps.datetime.hour for s in port_ds.sample_list})
    assert len(hours) > 1
    keep = hours[0]

    def pick(s):
        return s.timestamps.datetime.hour == keep

    got, want = port_ds.filter_samples(pick), jax_ds.filter_samples(pick)
    assert 0 < len(got) == len(want) < len(port_ds) == 24
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i].outputs.array, want[i].outputs.array)
        assert got[i].validity_times == want[i].validity_times
    with pytest.raises(ValueError, match="no samples"):
        port_ds.filter_samples(lambda s: False)


def test_named_array_ops_match_jax():
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((2, 3, 4, 5, 3)).astype(np.float32)
    names = ("batch", "timestep", "lat", "lon", "features")
    feats = ("a", "b", "c")
    j, p = JaxNamedArray(arr, names, feats), NamedArray(arr, names, feats)
    pt = NamedArray(torch.from_numpy(arr), names, feats)
    cases = [
        (lambda x: x.select("timestep", 1)),
        (lambda x: x.flatten("ngrid", 2, 3)),
        (lambda x: x.flatten("ngrid", 2, 3).unflatten("ngrid", (4, 5), ("lat", "lon"))),
    ]
    for fn in cases:
        want, got, got_t = fn(j), fn(p), fn(pt)
        assert got.names == want.names == got_t.names
        assert got.feature_names == want.feature_names == got_t.feature_names
        np.testing.assert_array_equal(got.array, np.asarray(want.array))
        np.testing.assert_array_equal(got_t.array.numpy(), np.asarray(want.array))
    np.testing.assert_array_equal(p["b"], np.asarray(j["b"]))
    other = NamedArray(arr[..., :1], names, ("d",))
    assert (p | other).feature_names == ("a", "b", "c", "d")
    assert (pt | NamedArray(torch.from_numpy(arr[..., :1]), names, ("d",))).shape[-1] == 4
    with pytest.raises(ValueError, match="duplicate"):
        NamedArray.concat([p, p])
    with pytest.raises(ValueError, match="features dim"):
        NamedArray(arr, names, ("a",))


def test_forcings_broadcast_like_jax(both_test_sets):
    port_ds = both_test_sets[1]
    t0 = dt.datetime(2023, 1, 5, 6)
    terms = [dt.timedelta(hours=h) for h in (1, 2, 3)]
    forcings = generate_forcings(t0, terms, port_ds.grid)
    like = NamedArray(np.zeros((3, 64, 64, 1), np.float32),
                      ("timestep", "lat", "lon", "features"), ("x",))
    cal = forcings[0].broadcast_like(like)
    assert cal.names == ("timestep", "lat", "lon", "features") and cal.shape == (3, 64, 64, 2)
    j = JaxNamedArray(np.asarray(forcings[0].array), forcings[0].names,
                      forcings[0].feature_names).broadcast_like(
        JaxNamedArray(like.array, like.names, like.feature_names))
    np.testing.assert_array_equal(cal.array, np.asarray(j.array))


def _rollout_case(strategy, inter):
    rng = np.random.default_rng(3)
    b, n_in, n, f, ff, s, t = 2, 2, 12, 3, 4, 2, 3
    arrs = dict(
        inputs=rng.standard_normal((b, n_in, n, f)).astype(np.float32),
        forcing=rng.standard_normal((b, t, n, ff)).astype(np.float32),
        outputs=rng.standard_normal((b, t, n, f)).astype(np.float32),
        statics=rng.standard_normal((n, s)).astype(np.float32),
        border=(rng.uniform(size=(n, 1)) > 0.7).astype(np.float32),
        mean=rng.standard_normal(f).astype(np.float32) * 0.1,
        std=rng.uniform(0.5, 1.5, f).astype(np.float32),
    )
    w = rng.standard_normal((n_in * f + s + ff, f)).astype(np.float32) * 0.2
    kw = dict(strategy=strategy, num_inter_steps=inter, num_input_steps=n_in,
              common_features_idx=(0, 1, 2) if strategy == "downscaling_only" else ())
    if strategy == "downscaling_only":
        w = w[n_in * f:]
    return arrs, w, kw, t


@pytest.mark.parametrize("strategy,with_outputs,inter", [
    ("scaled_ar", True, 2), ("scaled_ar", False, 1), ("diff_ar", True, 1),
    ("downscaling_only", False, 1),
])
def test_rollout_matches_jax(strategy, with_outputs, inter):
    """Both rollouts with the same fixed linear model."""
    a, w, kw, t = _rollout_case(strategy, inter)
    outputs = a["outputs"] if with_outputs else None
    want = jax_rollout.rollout(
        lambda x: jnp.tanh(x @ w), *(jnp.asarray(a[k]) for k in ("inputs", "forcing")),
        None if outputs is None else jnp.asarray(outputs), jnp.asarray(a["statics"]),
        jnp.asarray(a["border"]), jnp.asarray(a["mean"]), jnp.asarray(a["std"]),
        jax_rollout.RolloutConfig(**kw), t,
    )
    wt = torch.from_numpy(w)
    got = port_rollout.rollout(
        lambda x: torch.tanh(x @ wt), *(torch.from_numpy(a[k]) for k in ("inputs", "forcing")),
        None if outputs is None else torch.from_numpy(outputs),
        torch.from_numpy(a["statics"]), torch.from_numpy(a["border"]),
        torch.from_numpy(a["mean"]), torch.from_numpy(a["std"]),
        port_rollout.RolloutConfig(**kw), t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_common_features_index_matches_jax():
    outs = ("t2m_2_heightAboveGround", "u_500_isobaricInhPa")
    forc = ("x_500_isobaricInhPa", "y_2_heightAboveGround", "cos_hour")
    assert port_rollout.common_features_index(outs, forc) == \
        jax_rollout.common_features_index(outs, forc)
    with pytest.raises(ValueError, match="exactly ONE"):
        port_rollout.common_features_index(("a_7_x",), forc, strict=True)


def test_mask_blocks_uses_the_generator():
    x = torch.ones(2, 16, 16, 3)
    a = port_rollout.mask_blocks(x, torch.Generator().manual_seed(0), 0.5)
    b = port_rollout.mask_blocks(x, torch.Generator().manual_seed(0), 0.5)
    assert torch.equal(a, b)
    assert 0 < float(a.mean()) < 1
    assert torch.equal(port_rollout.mask_blocks(x, torch.Generator(), 0.0), x)


def test_entry_points_default_to_cuda_and_raise_without_it(both_test_sets):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is usable")
    settings = TrainingSettings(model_name="GraphLAM",
                                settings_init_args={"hidden_dims": 8, "processor_layers": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoRegressiveModule(settings, both_test_sets[1].dataset_info)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig())


def test_unported_names_raise(both_test_sets):
    with pytest.raises(ValueError, match="not yet ported"):
        AutoRegressiveModule(TrainingSettings(model_name="HalfUNet"),
                             both_test_sets[1].dataset_info, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1"):
        port_get_datasets("titan", 2, 1, 1)
    with pytest.raises(NotImplementedError, match="fp32"):
        AutoRegressiveModule(
            TrainingSettings(model_name="GraphLAM", precision="bf16"),
            both_test_sets[1].dataset_info, device="cpu",
        )


def test_predict_rejects_a_foreign_state(both_test_sets):
    port_ds = both_test_sets[1]
    settings = TrainingSettings(model_name="GraphLAM",
                                settings_init_args={"hidden_dims": 8, "processor_layers": 1})
    module = AutoRegressiveModule(settings, port_ds.dataset_info, device="cpu")
    state = module.init_params(torch.Generator().manual_seed(0))
    state.pop("decoder.Dense_1.bias")
    with pytest.raises(ValueError, match="missing"):
        Trainer(TrainerConfig(batch_size=8, device="cpu")).predict(module, port_ds, state)


def test_init_params_is_seeded_and_lecun_scaled(both_test_sets):
    info = both_test_sets[1].dataset_info
    settings = TrainingSettings(model_name="GraphLAM",
                                settings_init_args={"hidden_dims": 32, "processor_layers": 1})
    module = AutoRegressiveModule(settings, info, device="cpu")
    a = module.init_params(torch.Generator().manual_seed(7))
    a = {k: v.clone() for k, v in a.items()}
    b = module.init_params(torch.Generator().manual_seed(7))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a["processor.0.block.edge.out.weight"]  # fan_in 32
    assert abs(float(w.std()) - 32 ** -0.5) < 0.03
    assert float(w.abs().max()) <= 2 * 32 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(a["processor.0.block.edge.ln.weight"], torch.ones(32))
    assert torch.equal(a["processor.0.block.edge.w_e.bias"], torch.zeros(32))
