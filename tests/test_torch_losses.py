"""The port's losses against the JAX package's on the same NamedArrays
(grid and graph layouts, every elementwise loss, NaN-masked targets for
the mask-union denominator), on the CPU.

Bar: rtol/atol 1e-6 — the same fp32 formula, summed in another order."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py4cast_tpu import losses as jax_losses
from py4cast_tpu.named_tensor import NamedArray as JaxNamedArray
from py4cast_tpu_torch import losses
from py4cast_tpu_torch.named_tensor import NamedArray

TOL = dict(rtol=1e-6, atol=1e-6)
FEATURES = ("t2m_2_heightAboveGround", "u10_10_heightAboveGround", "z_500_isobaricInhPa")


@pytest.fixture(scope="module")
def info():
    """The DatasetInfo fields the losses read."""
    return SimpleNamespace(
        state_weights=dict(zip(FEATURES, (1.0, 0.5, 2.0))),
        diff_stats={n: {"std": s} for n, s in zip(FEATURES, (0.7, 1.3, 2.1))},
        stats={n: {"std": s} for n, s in zip(FEATURES, (3.0, 0.4, 9.0))},
    )


def _case(layout, nan):
    """(pred, target, mask, interior_mask) as numpy, (B, T, *spatial, F)."""
    rng = np.random.default_rng(0 if layout == "grid" else 1)
    spatial = (6, 5) if layout == "grid" else (30,)
    shape = (2, 3) + spatial + (len(FEATURES),)
    pred = rng.standard_normal(shape).astype(np.float32)
    target = rng.standard_normal(shape).astype(np.float32)
    interior = (rng.uniform(size=spatial + (1,)) > 0.2).astype(np.float32)
    mask = np.ones(shape, np.float32)
    if nan:
        target[..., 1] = np.where(rng.uniform(size=shape[:-1]) > 0.7, np.nan, target[..., 1])
        # three spatial points with no valid value in any row, step or feature
        flat = mask.reshape(2, 3, -1, len(FEATURES))
        flat[:, :, :3] = 0.0
        mask = (~np.isnan(target)).astype(np.float32) * flat.reshape(shape)
        target = np.nan_to_num(target, nan=0.0)
    return pred, target, mask, interior


def _named(arr, layout, jax_side):
    names = ("batch", "timestep") + (("lat", "lon") if layout == "grid" else ("ngrid",)) + (
        "features",)
    if jax_side:
        return JaxNamedArray(jnp.asarray(arr), names, FEATURES)
    return NamedArray(torch.from_numpy(arr), names, FEATURES)


def _both(conf, info, layout, nan, **call):
    pred, target, mask, interior = _case(layout, nan)
    jl = jax_losses.CombinedLoss(conf)
    jl.prepare(interior, info, FEATURES)
    pl = losses.CombinedLoss(conf)
    pl.prepare(interior, info, FEATURES)
    want = jl(_named(pred, layout, True), _named(target, layout, True), jnp.asarray(mask),
              **call)
    got = pl(_named(pred, layout, False), _named(target, layout, False),
             torch.from_numpy(mask), **call)
    return got, want


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("layout", ["grid", "graph"])
@pytest.mark.parametrize("name", ["MSELoss", "L1Loss", "HuberLoss", "SmoothL1Loss"])
def test_weighted_loss_matches_jax(info, name, layout, nan):
    conf = [{"class": "WeightedLoss", "weight": 1.0, "params": {"loss": name}}]
    got, want = _both(conf, info, layout, nan)
    assert tuple(got.shape) == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("name", ["MSELoss", "L1Loss"])
def test_scaled_loss_matches_jax(info, name, nan):
    conf = [{"class": "ScaledLoss", "params": {"loss": name}}]
    got, want = _both(conf, info, "grid", nan)
    assert tuple(got.shape) == (2, 3, len(FEATURES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_combined_loss_sums_weighted_members_like_jax(info):
    conf = [
        {"class": "WeightedLoss", "weight": 0.7, "params": {"loss": "MSELoss"}},
        {"class": "WeightedLoss", "weight": 0.3, "params": {"loss": "L1Loss"}},
    ]
    got, want = _both(conf, info, "graph", True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_interior_mask_argument_matches_jax(info):
    """The trainer passes its device copy of the interior mask."""
    conf = [{"class": "WeightedLoss", "params": {"loss": "MSELoss"}}]
    interior = (np.random.default_rng(5).uniform(size=(30, 1)) > 0.5).astype(np.float32)
    pred, target, mask, _ = _case("graph", False)
    jl, pl = jax_losses.CombinedLoss(conf), losses.CombinedLoss(conf)
    jl.prepare(interior, info, FEATURES)
    pl.prepare(interior, info, FEATURES)
    want = jl(_named(pred, "graph", True), _named(target, "graph", True), jnp.asarray(mask),
              interior_mask=jnp.asarray(interior))
    got = pl(_named(pred, "graph", False), _named(target, "graph", False),
             torch.from_numpy(mask), interior_mask=torch.from_numpy(interior))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_union_denominator_counts_all_invalid_points(info):
    loss = losses.WeightedLoss("MSELoss")
    interior = np.ones((30, 1), np.float32)
    loss.prepare(interior, info, FEATURES)
    mask = torch.ones(2, 3, 30, len(FEATURES))
    mask[:, :, :4] = 0.0
    mask[0, 1, 7, 2] = 0.0  # one feature of one step: still a valid point
    assert float(loss._union_denominator(mask)) == 30 - 4


def test_combined_loss_rejects_mixed_output_shapes():
    conf = [
        {"class": "WeightedLoss", "params": {"loss": "MSELoss"}},
        {"class": "ScaledLoss", "params": {"loss": "MSELoss"}},
    ]
    with pytest.raises(ValueError, match="incompatible shapes"):
        losses.CombinedLoss(conf)


def test_perceptual_loss_is_not_ported_yet():
    """The perceptual loss is ported: CombinedLoss builds it as a (B, T)
    member beside WeightedLoss (tests/test_torch_perceptual.py holds its
    values and gradients against the JAX package's)."""
    combined = losses.CombinedLoss([{"class": "WeightedLoss", "params": {"loss": "MSELoss"}},
                                    {"class": "PerceptualLossPy4Cast", "params": {}}])
    member = combined.losses[1][0]
    assert isinstance(member, losses.PerceptualLossPy4Cast)
    assert member.output_shape == "bt" and member.trained and member.num_scales == 3


def test_unknown_elementwise_loss_raises():
    with pytest.raises(NameError, match="not defined"):
        losses.WeightedLoss("CrossEntropy")
