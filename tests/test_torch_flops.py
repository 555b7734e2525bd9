"""``py4cast_tpu_torch.ops.flops`` against the JAX package's jaxpr walker
(``py4cast_tpu/ops/flops.py``), on the CPU.

- Each of the six kernels' FLOP formulas against ``FlopCounterMode``'s
  count of the matrix products in its plain version, at two shapes:
  equal for a-fwd, a-bwd and c-fwd; b-fwd and b-bwd take ``feats @ Wf``
  once a batch element where the plain version takes it once, and b-bwd
  and c-bwd recompute more than the plain backward does (stated below).
- The count of one forward and one train step (the gradient of
  ``sum(y²)`` with respect to every parameter) against the JAX
  package's ``step_flops`` of ``model.apply`` and ``jax.grad``:
  **equal** for HalfUNet; for UNet, GraphLAM, Segformer and UNetRPP the
  difference is a stated term worked out from the shapes each model
  runs (recorded as it runs), never a tolerance:
  * the JAX walker counts a convolution as its ``conv_general_dilated``:
    a transposed convolution (Flax's ``ConvTranspose``, k = s) over its
    input dilated by s, zeros included, forward and in its kernel's
    gradient (s² times the port's count), and the input gradient of a
    strided convolution over the output gradient dilated by s (the
    input's pixels, not the output's);
  * JAX's bilinear resizes are products (``jax.image.resize``), the
    port's forward ``F.interpolate`` is not; a growth's backward is two
    products in the port (``_GrowBilinear``), the forward's count;
  * GraphLAM: JAX gathers m2g's four corners by 0/1 selection products
    (and transposes them in its backward), the port's b-fwd loads them
    and its backward folds them back by ``sep_aggregate``; b-bwd
    recomputes the forward twice (13 h×h and 8 feature products a cell
    more than jax.vjp); JAX's processor recomputes each layer's forward
    in its backward (``nn.remat``), a-bwd only its two stencil products;
  * c-bwd recomputes P and dP (3 of its 7 products) where jax.vjp
    keeps them.
  Segformer's depthwise convolutions hold ``ops/flops.py``'s own
  formula for a convolution's backward to the JAX count: torch's counts
  a grouped convolution's weight gradient once a group too many times.
- A count under fake tensors equals a real CPU call's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._python_dispatch import TorchDispatchMode

from py4cast_tpu import models as jax_models
from py4cast_tpu.models import graph as jax_graph
from py4cast_tpu.ops.flops import step_flops as jax_step_flops
from py4cast_tpu_torch import models as port_models
from py4cast_tpu_torch.models import graph as port_graph
from py4cast_tpu_torch.models import segformer as port_segformer
from py4cast_tpu_torch.models import unetrpp as port_unetrpp
from py4cast_tpu_torch.ops import attention, flops, hop_kernel, stencil_kernel
from py4cast_tpu_torch.ops.lattice_ops import stack_shifts
from py4cast_tpu_torch.testing import _small_module

aten = torch.ops.aten


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as every port test file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def _counted(fn) -> int:
    """FlopCounterMode's count of one real call."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


# ------------------------------------------------------------------ formulas
#: the last two past the CUDA kernels' row-tile instances (on the card
#: the wide instances, whose products the same formulas count)
@pytest.mark.parametrize("b,hr,w,f_in,h", [(1, 5, 6, 8, 8), (2, 3, 4, 3, 16),
                                           (1, 3, 4, 130, 130), (1, 2, 3, 100, 300)])
def test_stencil_formulas_equal_the_plain_products(b, hr, w, f_in, h):
    e, ps, pd, we, be, wo, bo, lns, lnb, g_out, g_agg = _rand(
        (b, 8, hr, w, f_in), (b, hr, w, h), (b, hr, w, h), (f_in, h), (h,), (h, h), (h,), (h,),
        (h,), (b, 8, hr, w, h), (b, hr, w, h))
    mask = torch.ones(8, hr, w, 1)
    args = (e, ps, pd, mask, we, be, wo, bo, lns, lnb)
    bwd = (e, stack_shifts(ps), pd, mask, we, be, wo, bo, lns, lnb, g_out, g_agg)
    assert _counted(lambda: stencil_kernel.stencil_message_fwd(*args, False)) == \
        _counted(lambda: stencil_kernel.stencil_message_plain(*args)) > 0
    assert _counted(lambda: stencil_kernel.stencil_message_bwd(*bwd, False)) == \
        _counted(lambda: stencil_kernel.stencil_message_bwd_plain(*bwd)) > 0


@pytest.mark.parametrize("b,gh,gw,mh,mw,h,ff", [(1, 7, 9, 3, 4, 8, 3), (2, 5, 6, 2, 3, 16, 2),
                                                (2, 5, 6, 2, 3, 130, 3)])
def test_corner_hop_formulas_against_the_plain_products(b, gh, gw, mh, mw, h, ff):
    """The kernels take feats_k @ Wf for every batch element (the plain
    version once), and b-bwd's corner pass recomputes pd and the four
    corners a second time."""
    rows = torch.from_numpy(np.stack([(np.arange(gh) * mh) // gh] * 2).astype(np.int32))
    cols = torch.from_numpy(np.stack([(np.arange(gw) * mw) // gw] * 2).astype(np.int32))
    ps, vd, feats, g, *weights = _rand(
        (b, mh, mw, h), (b, gh, gw, h), (4, gh, gw, ff), (b, gh, gw, h), (ff, h), (h,), (h, h),
        (h, h), (h,), (h,), (h,), (h, h), (h, h), (h,), (h, h), (h,), (h,), (h,))
    rest = (vd, feats, *weights)
    psg = hop_kernel.gather_corners(ps, rows, cols)
    cells = b * gh * gw
    batch_feats = 8 * (b - 1) * gh * gw * ff * h
    fwd = _counted(lambda: hop_kernel.corner_hop_fwd(ps, rows, cols, *rest, False))
    assert fwd == _counted(lambda: hop_kernel.corner_hop_plain(ps, rows, cols, *rest)) \
        + batch_feats
    bwd = _counted(lambda: hop_kernel.corner_hop_bwd(*psg, *rest, g, False))
    assert bwd == _counted(lambda: hop_kernel.corner_hop_bwd_plain(psg, *rest, g)) \
        + batch_feats + 2 * cells * (5 * h * h + 4 * ff * h)


@pytest.mark.parametrize("bh,lq,lk,d", [(3, 37, 5, 16), (2, 64, 9, 32)])
def test_attention_formulas_against_the_plain_products(bh, lq, lk, d):
    """c-fwd: the plain version's two products; c-bwd: its five and the
    second pass's recompute of P and dP."""
    q, k, v, do = _rand((bh, lq, d), (bh, lk, d), (bh, lk, d), (bh, lq, d))
    assert _counted(lambda: attention.short_kv_attention_fwd(q, k, v, 0.5)) == \
        _counted(lambda: attention.short_kv_attention_plain(q, k, v, 0.5))
    o, lse = attention.short_kv_attention_fwd(q, k, v, 0.5)
    assert _counted(lambda: attention.short_kv_attention_bwd(q, k, v, o, lse, do, 0.5)) == \
        _counted(lambda: attention.short_kv_attention_bwd_plain(q, k, v, do, 0.5)) \
        + 4 * bh * lq * lk * d


# ---------------------------------------------------------- against the JAX
class _Convolutions(TorchDispatchMode):
    """Records every convolution and its backward, each with the spatial
    shape of its input before an explicit pad (Flax's SAME padding, which
    the port's convolutions take with ``F.pad``)."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self._padded = []  # (pad output, its input's spatial shape)

    def _unpadded(self, x):
        return next((hw for t, hw in self._padded if t is x), tuple(x.shape[2:]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is aten.constant_pad_nd:
            self._padded.append((out, self._unpadded(args[0])))
        elif func.overloadpacket is aten.convolution:
            self.calls.append((func.overloadpacket, args, self._unpadded(args[0])))
        elif func.overloadpacket is aten.convolution_backward:
            self.calls.append((func.overloadpacket, args, self._unpadded(args[1])))
        return out


def _jax_conv_term(calls) -> int:
    """What the JAX walker counts beyond FlopCounterMode for these
    convolutions: a transposed convolution's dilated zeros (its forward
    and its kernel's gradient, s² times the port's count), and a strided
    convolution's input gradient over the (unpadded) input's pixels where
    FlopCounterMode counts the output's."""
    term = 0
    for op, args, (hu, wu) in calls:
        if op is aten.convolution:
            x, w, _, stride, _, _, transposed = args[:7]
            if transposed:
                term += (stride[0] * stride[1] - 1) * 2 * x.shape[0] * w.numel() \
                    * x.shape[2] * x.shape[3]
            continue
        g, x, w = args[:3]
        stride, transposed, mask = args[4], args[7], args[10]
        if transposed and mask[1]:
            term += (stride[0] * stride[1] - 1) * 2 * x.shape[0] * w.numel() \
                * x.shape[2] * x.shape[3]
        if not transposed and mask[0] and stride != [1, 1]:
            term += 2 * x.shape[0] * w.numel() * (hu * wu - g.shape[2] * g.shape[3])
    return term


def _jax_resize_flops(calls) -> tuple:
    """The JAX walker's count of ``jax.image.resize`` at each recorded
    bilinear resize's shapes: (growths, shrinks)."""
    grow = shrink = 0
    for shape, (h, w) in calls:
        n = int(jax_step_flops(lambda a: jax.image.resize(a, (shape[0], h, w, shape[3]),
                                                          "bilinear"),
                               jax.ShapeDtypeStruct(shape, jnp.float32)))
        if h < shape[1] or w < shape[2]:
            shrink += n
        else:
            grow += n
    return grow, shrink


def _models(name, args, grid, f_in=5, f_out=3):
    """The JAX and the port model of ``name``, and the input shape."""
    jk, js = jax_models.get_model_kls_and_settings(name, args)
    _, ps = port_models.get_model_kls_and_settings(name, args)
    extra_j, extra_p, shape = {}, {}, tuple(grid)
    if jk.model_type.name == "GRAPH":
        mg = np.stack(np.meshgrid(np.linspace(0, 1, grid[0]), np.linspace(0, 1, grid[1]),
                                  indexing="ij")).astype(np.float32)
        extra_j["graph"] = jax_graph.build_graph_artifacts(mg, js)
        extra_p["graph"] = port_graph.build_graph_artifacts(mg, ps)
        shape = (grid[0] * grid[1],)
    jm = jax_models.build_model_from_settings(name, f_in, f_out, js, shape, **extra_j)
    pm = port_models.build_model_from_settings(name, f_in, f_out, ps, shape, **extra_p)
    return jm, pm, (1, *shape, f_in)


def _jax_counts(jm, x_shape):
    """JAX's step_flops of the forward and of jax.grad of sum(y²), traced
    at abstract variables (jax.eval_shape): nothing runs."""
    x = jax.ShapeDtypeStruct(x_shape, jnp.float32)
    v = jax.eval_shape(jm.init, jax.random.key(0), x)
    fwd = jax_step_flops(lambda v, x: jm.apply(v, x), v, x)
    train = jax_step_flops(jax.grad(lambda v, x: jnp.sum(jm.apply(v, x) ** 2)), v, x)
    return int(fwd), int(train)


def _port_counts(pm, x_shape, monkeypatch=None):
    """The port's forward and train-step counts by op, the convolutions
    each ran and the bilinear resizes each took (as the JAX counts are
    taken, under fake tensors)."""
    resizes = []
    if monkeypatch is not None:
        for mod in (port_segformer, port_unetrpp):
            real = mod._bilinear_resize

            def record(x, h, w, real=real):
                if (h, w) != tuple(x.shape[1:3]):
                    resizes.append((tuple(x.shape), (h, w)))
                return real(x, h, w)
            monkeypatch.setattr(mod, "_bilinear_resize", record)
    params = list(pm.parameters())
    x = torch.zeros(x_shape)
    out = {}
    for kind, fn in (("fwd", lambda: pm(x)),
                     ("train", lambda: torch.autograd.grad((pm(x) ** 2).sum(), params,
                                                           allow_unused=True))):
        resizes.clear()
        with _Convolutions() as convs:
            by_op = flops.count(fn)
        out[kind] = (by_op, list(convs.calls), list(resizes))
    return out


def test_halfunet_counts_equal_the_jax_walker():
    jm, pm, x_shape = _models("HalfUNet", {"num_filters": 8, "depth": 2}, (16, 16))
    jax_fwd, jax_train = _jax_counts(jm, x_shape)
    port = _port_counts(pm, x_shape)
    assert (sum(port["fwd"][0].values()), sum(port["train"][0].values())) == \
        (jax_fwd, jax_train)
    assert flops.step_flops(pm, torch.zeros(x_shape)) == jax_fwd


def test_unet_counts_differ_by_the_transposed_convolutions_zeros():
    jm, pm, x_shape = _models("UNet", {"init_features": 8, "depth": 2}, (16, 16))
    jax_fwd, jax_train = _jax_counts(jm, x_shape)
    port = _port_counts(pm, x_shape)
    for kind, want in (("fwd", jax_fwd), ("train", jax_train)):
        by_op, convs, _ = port[kind]
        term = _jax_conv_term(convs)
        assert term > 0
        assert sum(by_op.values()) + term == want, kind


def _graph_terms(pm, b=1):
    """GraphLAM's terms (B = 1): (forward, train step)."""
    g, s = pm.graph, pm.settings
    h = s.hidden_dims
    (hr, w), (hc, wc) = g.grid_hw, g.level_hw[0]
    ff = g.lattice_np["lat_m2g_feats"].shape[-1]
    cells = b * hr * w
    # m2g's four corners: JAX's selection products (rows, then columns)
    select = 4 * (2 * b * hr * hc * wc * h + 2 * b * hr * w * wc * h)
    # the port's backward folds them back: rows, then columns
    fold = 4 * (2 * b * hc * hr * w * h + 2 * b * hc * wc * w * h)
    # the JAX processor's remat recomputes every layer's forward but the
    # two stencil products a-bwd recomputes too: each level's ps and pd,
    # a sub-lattice's selection products both ways, the node MLP
    per_layer = 3 * 2 * b * hc * wc * h * h
    for lev, (hl, wl) in enumerate(g.level_hw):
        sub = (hl, wl) != (hc, wc)
        per_layer += 2 * 2 * b * hl * wl * h * h
        if sub:
            per_layer += 2 * b * h * (hl * wc * hc + hl * wl * wc + hc * wl * hl + hc * wc * wl)
    remat = s.processor_layers * per_layer
    recompute = 2 * cells * (13 * h * h + 8 * ff * h)
    return select, remat - recompute + 2 * select - fold


def test_graphlam_counts_differ_by_the_stated_terms():
    jm, pm, x_shape = _models("GraphLAM", {"hidden_dims": 8, "processor_layers": 2,
                                           "mesh_levels": 3}, (32, 32))
    assert pm.graph.level_hw == [(8, 8), (4, 4), (2, 2)]
    jax_fwd, jax_train = _jax_counts(jm, x_shape)
    port = _port_counts(pm, x_shape)
    assert "p4t.corner_hop_bwd" in port["train"][0]
    fwd_term, train_term = _graph_terms(pm)
    assert sum(port["fwd"][0].values()) + fwd_term == jax_fwd
    assert sum(port["train"][0].values()) + train_term == jax_train


ATTENTION = {
    "Segformer": ({"dims": [16, 32], "heads": [1, 2], "ff_expansion": [2, 2],
                   "reduction_ratio": [4, 1], "num_layers": 1, "decoder_dim": 16}, (32, 32)),
    # 64x64: the deepest stage keeps 4 tokens (torch's einsum multiplies
    # a contraction over one token elementwise, which is no product)
    "UNetRPP": ({"hidden_size": 32, "depths": [1, 1, 1, 1], "num_heads_encoder": 2,
                 "num_heads_decoder": 2, "encoder_proj_sizes": [8, 8, 8, 8],
                 "decoder_proj_size": 8, "attention_code": "pallas"}, (64, 64)),
}


@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_attention_model_counts_differ_by_the_stated_terms(name, monkeypatch):
    jm, pm, x_shape = _models(name, *ATTENTION[name])
    jax_fwd, jax_train = _jax_counts(jm, x_shape)
    port = _port_counts(pm, x_shape, monkeypatch)
    fwd_ops, fwd_convs, fwd_resizes = port["fwd"]
    assert "p4t.short_kv_attention_fwd" in fwd_ops
    grow, shrink = _jax_resize_flops(fwd_resizes)
    assert sum(fwd_ops.values()) + _jax_conv_term(fwd_convs) + grow + shrink == jax_fwd

    ops, convs, resizes = port["train"]
    grow, shrink = _jax_resize_flops(resizes)
    recompute = 3 * ops["p4t.short_kv_attention_bwd"] // 7
    assert sum(ops.values()) + _jax_conv_term(convs) + grow + 2 * shrink - recompute \
        == jax_train


# ---------------------------------------------------------- fake and real
@pytest.mark.parametrize("name,args,grid", [
    ("HiLAM", {"hidden_dims": 8, "processor_layers": 1}, (16, 16)),
    ("HiLAM", {"hidden_dims": 130, "processor_layers": 1}, (16, 16)),  # past the row tiles
    ("UNetRPP", ATTENTION["UNetRPP"][0], (32, 32)),
])
def test_fake_count_equals_a_real_call(name, args, grid):
    """The module helpers under fake tensors and by a real CPU call: a
    predict call of two AR steps and a train step, the kernels' ops
    among them."""
    module, _ = _small_module(name, args, grid, "cpu")
    params = module.init_params(torch.Generator().manual_seed(0))
    predict = flops.predict_flops(module, params, num_pred_steps=2)
    train = flops.train_step_flops(module, params)
    assert predict == flops.predict_flops(module, params, num_pred_steps=2, fake=False)
    assert train == flops.train_step_flops(module, params, fake=False)
    kernels = {"HiLAM": ("a-fwd", "a-bwd", "b-fwd", "b-bwd"), "UNetRPP": ("c-fwd", "c-bwd")}
    assert set(flops.kernel_shares(train)) == set(kernels[name])
    assert sum(flops.kernel_shares(predict).values()) < 1
