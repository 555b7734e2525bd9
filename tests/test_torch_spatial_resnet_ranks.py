"""The spatial axis of the ResNet-encoder models, the perceptual loss and
``mask_ratio`` across processes, on the CPU: gloo ranks (each a process
of its own, spawned by ``testing.run_ranks``) whose lat bands join
through halo exchanges (several bands deep for ASPP's dilations),
band all-reduces (GroupNorm, ASPP's image-level mean, the losses) and
the block masks cut from the whole grid's draw, against one process of
the port and against the JAX package's ``train_step`` on a spatial mesh
of the same layout.

Each run: a 32x32 grid, global batch 4, three AdamW steps, step k on
``synthetic_batch(info, 4, seed=k)``. At ``MeshConfig(1, 2)``:
CustomUNet (encoder depth 3: bands of 8-row multiples), DeepLabV3Plus
with ``encoder_norm: affine``, DeepLabV3 (ASPP's rates 12/24/36 on the
2-row bands of the 4x4 deepest map), HalfUNet with
``PerceptualLossPy4Cast`` (weight 0.1) alone and with ``mask_ratio``
0.25, and CustomUNet in bf16; at ``MeshConfig(2, 2)``: CustomUNet with
the perceptual loss and ``mask_ratio``. One launch of the ranks a
layout runs every case of that layout in turn
(``testing.train_reports``). DeepLabV3Plus with the perceptual loss
also goes through the trainer on two bands: fit, test with logging,
eval rows and predict (``testing.fit_test_report``).

Bars (those of ``test_torch_spatial_attention_ranks.py``):
- from the port's own initial parameters (seed 0): losses, parameters
  (``testing.held_params``), the first step's gradients as AdamW
  receives them and ``predict_step`` within 1e-5 of scale of one
  process; two runs of a layout bit for bit; every rank the same
  parameters. With ``mask_ratio`` the bands and the data ranks draw one
  process's masks from one generator;
- bf16 (CustomUNet): each step's |bands − one process| within
  max(2·d, 2⁻⁷) of the fp32 loss, d the largest |bf16 − fp32| of one
  process relative to it;
- from the JAX package's initial parameters (``convert``): the losses
  within 1e-4 (relative) of the JAX package's ``train_step`` on
  ``make_mesh(MeshConfig(1, 2))``, and the first step's reduced
  gradients within 1e-4 of the scale of ``jax.grad`` on that mesh, for
  CustomUNet, DeepLabV3Plus and HalfUNet with the perceptual loss (the
  32-row lat is padded by neither package)."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from py4cast_tpu_torch.testing import fit_test_report, held_params, run_ranks, train_report

CUSTOM = {"encoder_depth": 3, "decoder_channels": [8, 4, 4]}
DEEPLAB = {"encoder_depth": 3, "decoder_channels": 8}
HALFUNET = {"num_filters": 8, "depth": 2}
PERCEPTUAL = [{"class": "WeightedLoss", "weight": 1.0, "params": {"loss": "MSELoss"}},
              {"class": "PerceptualLossPy4Cast", "weight": 0.1, "params": {}}]
#: case -> (model, (data, spatial), settings, the key of the JAX
#: package's draw that it is held to the JAX package from (None: not
#: held), losses (None: the default), mask_ratio). HalfUNet draws at key
#: 1, as in ``test_torch_spatial_ranks.py``: at key 0 a ReLU input within
#: rounding of zero flips its side when GroupNorm sums in band order
#: (1.65e-3 of the largest gradient with or without the perceptual loss,
#: while one process meets ``jax.grad`` within 1.6e-6)
CASES = {
    "CustomUNet": ("CustomUNet", (1, 2), CUSTOM, 0, None, 0.0),
    "DeepLabV3Plus_affine": ("DeepLabV3Plus", (1, 2), {**DEEPLAB, "encoder_norm": "affine"}, 0,
                             None, 0.0),
    "DeepLabV3": ("DeepLabV3", (1, 2), DEEPLAB, None, None, 0.0),
    "HalfUNet_perceptual": ("HalfUNet", (1, 2), HALFUNET, 1, PERCEPTUAL, 0.0),
    "HalfUNet_perceptual_mask": ("HalfUNet", (1, 2), HALFUNET, None, PERCEPTUAL, 0.25),
    "CustomUNet_perceptual_mask_2x2": ("CustomUNet", (2, 2), CUSTOM, None, PERCEPTUAL, 0.25),
}
#: ``fit_test_report``'s model: DeepLabV3Plus with the perceptual loss
FIT = {"model_name": "DeepLabV3Plus", "settings_init_args": DEEPLAB, "losses": PERCEPTUAL,
       "n_test": 7}
#: the bf16 case and the fp32 case whose one-process losses it is held by
BF16 = ("CustomUNet_bf16", "CustomUNet")
TO_JAX = sorted(name for name, case in CASES.items() if case[3] is not None)
STEPS = 3
BATCH = 4
TOPOLOGY_BAR = 1e-5
JAX_RTOL = 1e-4
ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in every rank (``run_ranks``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_reference(model, args, layout, key, losses, params_path):
    """The JAX package's module on a (data, spatial) mesh from its draw at
    ``key`` (saved to ``params_path`` for the port), then three steps of
    its ``train_step`` as it jits it, each also returning its gradients:
    the losses and the first step's gradients in the port's layout. Runs
    in a process of its own."""
    import jax

    from py4cast_tpu.parallel.mesh import MeshConfig, make_mesh
    from py4cast_tpu.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu.training import AutoRegressiveModule, TrainingSettings
    from py4cast_tpu_torch.convert import params_from_jax

    jax.config.update("jax_platforms", "cpu")
    info = synthetic_dataset_info(grid_shape=(32, 32), weather_features=3, forcing_features=6,
                                  border_size=2)
    extra = {} if losses is None else {"losses": [dict(conf) for conf in losses]}
    module = AutoRegressiveModule(
        TrainingSettings(model_name=model, settings_init_args=dict(args),
                         training_strategy="scaled_ar", num_input_steps=2, num_warmup_steps=2,
                         **extra),
        info, mesh=make_mesh(MeshConfig(data_parallel=layout[0], spatial=layout[1]),
                             jax.devices()[:layout[0] * layout[1]]))
    state = module.init_state(jax.random.key(key), STEPS)
    torch.save(params_from_jax(jax.tree.map(np.asarray, state.params)), params_path)
    batches = [synthetic_batch(info, BATCH, seed=k) for k in range(STEPS)]
    num_pred_steps = batches[0].num_pred_steps

    @jax.jit
    def step(state, inputs, forcing, outputs, rng, buffers):
        (loss, _), grads = jax.value_and_grad(module._batch_loss, has_aux=True)(
            state.params, inputs, forcing, outputs, num_pred_steps, rng, buffers, train=True)
        return state.apply_gradients(grads=grads), loss, grads

    losses_out, first_grads = [], None
    for batch in batches:
        state, loss, grads = step(state, *module._batch_arrays(batch), jax.random.key(1),
                                  module.step_buffers())
        losses_out.append(float(loss))
        first_grads = first_grads or params_from_jax(jax.tree.map(np.asarray, grads))
    return losses_out, first_grads


def _case(name):
    if name == BF16[0]:
        model, layout, args, _, losses, mask = CASES[BF16[1]]
        precision = "bf16"
    else:
        model, layout, args, _, losses, mask = CASES[name]
        precision = "32"
    return {"model_name": model, "settings_init_args": args, "batch_size": BATCH,
            "steps": STEPS, "precision": precision, "losses": losses,
            "mask_ratio": mask}, layout


def _launch(pool, layout, cases):
    return pool.submit(run_ranks, "py4cast_tpu_torch.testing:train_reports",
                       layout[0] * layout[1], {"cases": cases, "mesh": list(layout)},
                       timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: one port process and two runs of its ranks from the
    port's draw (one run for bf16), and for the cases held to the JAX
    package its losses and gradients on the spatial mesh (each computed
    in a process of its own, all at once) and one run of the port's
    ranks from its draw, launched once the JAX package has drawn. The
    ranks run in their own processes while this one computes the
    references."""
    out, mine, jax_cases = {}, {}, {}
    for name in [*CASES, BF16[0]]:
        base, layout = _case(name)
        out[name] = {"name": name, "layout": layout, "case": base}
        mine.setdefault(layout, []).append((name, [base] if name == BF16[0] else [base, base]))
        key = CASES.get(name, (None,) * 4)[3]
        if key is not None:
            path = str(tmp_path_factory.mktemp(f"params_{name}") / "params.pt")
            jax_cases[name] = ({**base, "params_path": path},
                               (base["model_name"], base["settings_init_args"], layout, key,
                                base["losses"], path))
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(len(mine) + 1) as threads, \
            ProcessPoolExecutor(len(jax_cases), mp_context=spawn) as procs:
        jax_runs = {name: procs.submit(_jax_reference, *args)
                    for name, (_, args) in jax_cases.items()}
        launched = {layout: _launch(threads, layout, [c for _, runs in cases for c in runs])
                    for layout, cases in mine.items()}
        fit_dir = tmp_path_factory.mktemp("fit")
        fitted = threads.submit(run_ranks, "py4cast_tpu_torch.testing:fit_test_report", 2,
                                {**FIT, "save_path": str(fit_dir / "two"), "mesh": [1, 2]},
                                timeout=300)
        fit = {"one": fit_test_report(str(fit_dir / "one"), **FIT), "dir": fit_dir}
        one = {}
        for name in out:
            base = out[name]["case"]
            key = repr(sorted(base.items()))
            if key not in one:
                one[key] = train_report(**base)
            out[name]["one"] = one[key]
        for name, future in jax_runs.items():
            out[name]["jax"], out[name]["jax_grads"] = future.result()
        from_jax = _launch(threads, (1, 2), [case for case, _ in jax_cases.values()])
        reports_of = {layout: f.result() for layout, f in launched.items()}
        fit["two"] = fitted.result()
        for i, name in enumerate(jax_cases):
            out[name]["jax_ranks"] = [rank[i] for rank in from_jax.result()]
    for layout, cases in mine.items():
        at = 0
        for name, runs in cases:
            out[name]["many"] = [[rank[at + i] for rank in reports_of[layout]]
                                 for i in range(len(runs))]
            at += len(runs)
    out["fit"] = fit
    return out


FP32_CASES = sorted(CASES)


@pytest.fixture(params=FP32_CASES)
def run(request, runs):
    return runs[request.param]


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _grads_err(got: dict, want: dict) -> float:
    """The largest gradient error over every parameter, relative to the
    largest gradient."""
    assert got.keys() == want.keys()
    err = max(float((got[k] - torch.as_tensor(want[k])).abs().max()) for k in want)
    return err / max(float(torch.as_tensor(w).abs().max()) for w in want.values())


def test_spatial_ranks_match_one_process(run):
    """Losses and parameters after three AdamW steps."""
    one = run["one"]
    for rank in run["many"][0]:
        assert rank["world_size"] == run["layout"][0] * run["layout"][1]
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=TOPOLOGY_BAR)
        got = held_params(one["grads"], rank["params"], TOPOLOGY_BAR)
        for k, want in held_params(one["grads"], one["params"], TOPOLOGY_BAR).items():
            if want.numel():
                err = _scaled_err(got[k], want)
                assert err <= TOPOLOGY_BAR, f"{run['name']} rank {rank['rank']} {k}: {err:.3e}"


def test_spatial_ranks_reduce_gradients_as_one_process(run):
    """The first step's gradients, summed over the bands (and averaged
    over the data ranks), are one process's."""
    for rank in run["many"][0]:
        err = _grads_err(rank["grads"], run["one"]["grads"])
        assert err <= TOPOLOGY_BAR, f"{run['name']} rank {rank['rank']}: {err:.3e}"


def test_spatial_ranks_hold_the_same_parameters_and_repeat_bit_for_bit(run):
    first, *others = run["many"][0]
    for other in others:
        assert other["losses"] == first["losses"]
        for k in first["params"]:
            assert torch.equal(other["params"][k], first["params"][k]), k
    for ra, rb in zip(*run["many"]):
        assert ra["losses"] == rb["losses"]
        assert torch.equal(ra["predictions"], rb["predictions"])


def test_spatial_predictions_match_one_process_on_the_whole_grid(run):
    want = run["one"]["predictions"]
    assert tuple(want.shape) == (BATCH, 1, 32, 32, 3)
    for rank in run["many"][0]:
        assert rank["predictions"].shape == want.shape
        assert _scaled_err(rank["predictions"], want) <= TOPOLOGY_BAR


def test_each_case_exchanges_halo_rows_and_nothing_else(run):
    """Every case takes halo rows for its convs and pools, the same bytes
    every step; none gathers K/V or rolls."""
    for rank in run["many"][0]:
        assert len(set(rank["halo_bytes"])) == 1 and rank["halo_bytes"][0] > 0
        assert rank["gather_bytes"] == rank["roll_bytes"] == [0] * STEPS


def test_masks_differ_from_no_masks():
    """``mask_ratio`` 0.25 moves the loss: the masks are drawn at all."""
    plain = train_report("HalfUNet", HALFUNET, batch_size=BATCH, steps=1, losses=PERCEPTUAL)
    masked = train_report("HalfUNet", HALFUNET, batch_size=BATCH, steps=1, losses=PERCEPTUAL,
                          mask_ratio=0.25)
    assert plain["losses"][0] != masked["losses"][0]


@pytest.mark.parametrize("name", TO_JAX)
def test_spatial_ranks_match_the_jax_spatial_mesh(runs, name):
    """The logged loss is the global batch's: the JAX package's on a
    (1, 2) mesh, step for step, and the gradients AdamW receives are
    ``jax.grad``'s on that mesh."""
    run = runs[name]
    for rank in run["jax_ranks"]:
        np.testing.assert_allclose(rank["losses"], run["jax"], rtol=JAX_RTOL)
        err = _grads_err(rank["grads"], run["jax_grads"])
        assert err <= JAX_RTOL, f"{name} rank {rank['rank']}: {err:.3e}"
    assert len(set(run["jax"])) == STEPS  # the weights moved after the warmup's lr 0


def test_bf16_bands_within_the_bf16_bar_of_one_process(runs):
    bf16, fp32 = runs[BF16[0]], runs[BF16[1]]
    want32 = np.asarray(fp32["one"]["losses"])
    one16 = np.asarray(bf16["one"]["losses"])
    d = float(np.max(np.abs(one16 - want32) / np.abs(want32)))
    bar = max(2 * d, ULP) * np.abs(want32)
    for rank in bf16["many"][0]:
        got = np.asarray(rank["losses"])
        assert np.all(np.abs(got - one16) <= bar), (got, one16, bar)
        assert np.all(np.isfinite(rank["predictions"].numpy()))


def test_trainer_fits_tests_and_predicts_deeplabv3plus_with_the_perceptual_loss(runs):
    """``Trainer.fit``, ``test`` with logging, ``eval_rows`` and
    ``predict`` of DeepLabV3Plus under the perceptual loss on two bands
    (7 test samples: a padded tail of 3 at batch 4) fit the same
    parameters (``held_params``), and score and predict every sample on
    the whole grid, as one process does; rank 0 alone writes."""
    one, two, root = runs["fit"]["one"], runs["fit"]["two"], runs["fit"]["dir"]
    assert [r["is_main"] for r in two] == [True, False]
    assert not (root / "two" / "rank1").exists()
    assert (root / "two" / "rank0" / "test_scores.json").is_file()
    for rank in two:
        assert rank["step"] == one["step"] == 2
        got = held_params(one["grads"], rank["params"], TOPOLOGY_BAR)
        for k, want in held_params(one["grads"], one["params"], TOPOLOGY_BAR).items():
            if want.numel():
                assert _scaled_err(got[k], want) <= TOPOLOGY_BAR, k
        assert rank["rows"].shape == one["rows"].shape == (7, 2)
        np.testing.assert_allclose(rank["rows"].numpy(), one["rows"].numpy(), rtol=1e-5)
        assert rank["predictions"].shape == one["predictions"].shape == (7, 2, 32, 32, 3)
        assert _scaled_err(rank["predictions"], one["predictions"]) <= TOPOLOGY_BAR
        for k, v in one["scores"].items():
            np.testing.assert_allclose(rank["scores"][k], v, rtol=1e-5, err_msg=k)
