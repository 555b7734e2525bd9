"""FLOPs of one call: the counterpart of ``py4cast_tpu/ops/flops.py``.

The JAX package walks a jaxpr and counts its ``dot_general`` and
``conv_general_dilated`` equations (a ``scan`` body times its length, a
``pallas_call`` body once a grid block): hardware FLOPs, what the chip
performs, so recomputed work counts each time it runs. Here the count
is ``torch.utils.flop_counter.FlopCounterMode`` over one call, kept to
the same families: matrix products (``mm``, ``addmm``, ``bmm``,
``baddbmm``), convolutions and their backward (``convolution_backward_flop``,
which counts a grouped convolution's weight gradient right), and the six hand
kernels' custom ops (``p4t::*``), whose formulas below count the
products each kernel performs, from its shapes, recompute included
(a-bwd recomputes the forward's two products, b-bwd's two passes each
recompute pd and the four corners, c-bwd's two passes each recompute P
and dP). FlopCounterMode sees an op once, whatever runs it, so a count
is the same on the card (the kernels) as on the CPU (the plain
versions).

A count runs under ``FakeTensorMode`` unless ``fake=False``: every
tensor is a shape, nothing is computed or allocated, so a 512x640
train step costs a trace, as the JAX walker only traces. Real tensors
an op meets (a module's parameters and buffers) become fake ones.

MFU is ``step_flops`` of a step over its time over the card's peak for
the step's dtype (67 TFLOP/s fp32 outside the tensor cores on an H100
SXM at 700 W).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# the kernels' modules register the p4t ops
from py4cast_tpu_torch.ops import attention, hop_kernel, stencil_kernel  # noqa: F401

aten = torch.ops.aten

#: the six hand kernels' custom ops, by kernel
KERNEL_OPS = {
    "a-fwd": torch.ops.p4t.stencil_message_fwd,
    "a-bwd": torch.ops.p4t.stencil_message_bwd,
    "b-fwd": torch.ops.p4t.corner_hop_fwd,
    "b-bwd": torch.ops.p4t.corner_hop_bwd,
    "c-fwd": torch.ops.p4t.short_kv_attention_fwd,
    "c-bwd": torch.ops.p4t.short_kv_attention_bwd,
}

#: what a count keeps: the JAX walker's families (matrix products,
#: convolutions and their backward) and the kernels
COUNTED = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
           aten._convolution, aten.cudnn_convolution, aten.convolution_overrideable,
           aten._slow_conv2d_forward, aten.convolution_backward, *KERNEL_OPS.values())


# ---------------------------------------------------------------- formulas
# Each receives the op's arguments with every tensor replaced by its
# shape, and counts 2 FLOPs a multiply-add of the kernel's products.

@register_flop_formula(torch.ops.p4t.stencil_message_fwd)
def stencil_message_fwd_flop(e, ps, pd, mask, we, *_, out_shape=None, **__) -> int:
    """a-fwd: e @ We and silu(pre) @ Wo for each cell and direction."""
    b, _, hr, w, f_in = e
    h = we[-1]
    return 2 * b * 8 * hr * w * (f_in * h + h * h)


@register_flop_formula(torch.ops.p4t.stencil_message_bwd)
def stencil_message_bwd_flop(e, vs, pd, mask, we, *_, out_shape=None, **__) -> int:
    """a-bwd: the forward's two products recomputed, dt @ Wo^T, z^T dt,
    dpre @ We^T and e^T dpre for each cell and direction."""
    b, _, hr, w, f_in = e
    h = we[-1]
    return 2 * b * 8 * hr * w * (3 * f_in * h + 3 * h * h)


@register_flop_formula(torch.ops.p4t.corner_hop_fwd)
def corner_hop_fwd_flop(ps, rows, cols, vd, feats, *_, out_shape=None, **__) -> int:
    """b-fwd, for each grid cell: vd @ Wd, for each of the 4 corners
    feats_k @ Wf and z_k @ Wo, then vd @ Nd0a, agg @ Nd0b and u @ Nd1
    (the corner gathers are loads, no products)."""
    b, hr, w, h = vd
    ff = feats[-1]
    return 2 * b * hr * w * (8 * h * h + 4 * ff * h)


@register_flop_formula(torch.ops.p4t.corner_hop_bwd)
def corner_hop_bwd_flop(psg0, psg1, psg2, psg3, vd, feats, *_, out_shape=None, **__) -> int:
    """b-bwd, for each grid cell: the node pass recomputes the forward's
    8 h x h and 4 feature products and runs the node backward (6 h x h);
    the corner pass recomputes pd and the 4 corners (5 h x h, 4 feature
    products), runs each corner's backward (2 h x h and feats^T dpre) and
    dpd's (2 h x h): 29 h x h and 12 ff x h products."""
    b, hr, w, h = vd
    ff = feats[-1]
    return 2 * b * hr * w * (29 * h * h + 12 * ff * h)


@register_flop_formula(torch.ops.p4t.short_kv_attention_fwd)
def short_kv_attention_fwd_flop(q, k, v, *_, out_shape=None, **__) -> int:
    """c-fwd: q . k^T and P . v."""
    bh, lq, d = q
    return 4 * bh * lq * k[1] * d


@register_flop_formula(torch.ops.p4t.short_kv_attention_bwd)
def short_kv_attention_bwd_flop(q, k, v, *_, out_shape=None, **__) -> int:
    """c-bwd: the dq pass recomputes q . k^T and dO . v^T and takes
    dS . k; the dK/dV pass recomputes both again and takes dS^T . q and
    P^T . dO: 7 products of BH x Lq x Lk x D."""
    bh, lq, d = q
    return 14 * bh * lq * k[1] * d


def convolution_backward_flop(grad_out, x, w, bias_sizes, stride, padding, dilation,
                              transposed, output_padding, groups, output_mask,
                              out_shape=None, **__) -> int:
    """A convolution's backward: each gradient asked for (input, weight)
    takes the forward's products, 2 x batch x the weight's size (its
    input channels a group) x the pixels the kernel visits (the output's;
    a transposed convolution's input's). torch's own formula counts a
    grouped convolution's weight gradient once a group too many times
    (32 times a depthwise 3x3 of 32 channels)."""
    spatial = x[2:] if transposed else grad_out[2:]
    forward = 2 * grad_out[0] * math.prod(w) * math.prod(spatial)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


# ------------------------------------------------------------------ counts
def count(fn: Callable, *args, fake: bool = True) -> Dict[str, int]:
    """FLOPs of one call of ``fn(*args)`` by op (``"aten.mm"``,
    ``"p4t.stencil_message_fwd"``, ...), the ``COUNTED`` families only,
    under ``FakeTensorMode`` unless ``fake`` is False."""
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    counter = FlopCounterMode(display=False, custom_mapping={
        aten.convolution_backward: convolution_backward_flop})
    with mode, counter:
        fn(*args)
    return {str(op): int(n) for op, n in counter.get_flop_counts()["Global"].items()
            if op in COUNTED and n}


def step_flops(fn: Callable, *args, fake: bool = True) -> int:
    """FLOPs of one call of ``fn(*args)``: the sum of ``count``."""
    return sum(count(fn, *args, fake=fake).values())


def kernel_shares(counts: Dict[str, int]) -> Dict[str, float]:
    """Each hand kernel's share of a count (those it holds)."""
    total = sum(counts.values())
    return {kernel: counts[str(op)] / total for kernel, op in KERNEL_OPS.items()
            if str(op) in counts}


def _zero_batch(module, batch_size: int, num_pred_steps: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero (inputs, forcing, outputs) of a batch as ``module`` takes it
    on its device: (B, T, *input_shape, F), in ``batch_arg_dtypes``."""
    spatial = tuple(module.model.input_shape)
    in_dtype, forcing_dtype, out_dtype = module.batch_arg_dtypes()
    b, f = batch_size, module.num_output_features

    def zeros(steps, feats, dtype):
        return torch.zeros((b, steps, *spatial, feats), device=module.device, dtype=dtype)

    return (zeros(module.settings.num_input_steps, f, in_dtype),
            zeros(num_pred_steps, module.dataset_info.forcing_dim, forcing_dtype),
            zeros(num_pred_steps, f, out_dtype))


def predict_flops(module, state, batch_size: int = 1, num_pred_steps: int = 1,
                  fake: bool = True) -> Dict[str, int]:
    """FLOPs by op of one predict call of an ``AutoRegressiveModule`` at
    its grid: ``num_pred_steps`` AR steps of the model without gradient,
    at the parameters of ``state`` (a ``TrainState`` or a params dict)."""
    from py4cast_tpu_torch.training import _params_of

    params = module._place(_params_of(state))

    def call():
        inputs, forcing, _ = _zero_batch(module, batch_size, num_pred_steps)
        with torch.no_grad():
            module._rollout(params, inputs, forcing, None, num_pred_steps)

    return count(call, fake=fake)


def train_step_flops(module, state, batch_size: int = 1, num_pred_steps: int = 1,
                     fake: bool = True) -> Dict[str, int]:
    """FLOPs by op of one train step of an ``AutoRegressiveModule`` at
    its grid: the loss of ``num_pred_steps`` AR steps and its gradient
    with respect to every parameter (AdamW's update has no products)."""
    from py4cast_tpu_torch.training import _params_of

    params = module._place(_params_of(state))

    def call():
        inputs, forcing, outputs = _zero_batch(module, batch_size, num_pred_steps)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, _ = module._batch_loss(leaves, inputs, forcing, outputs, num_pred_steps)
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)

    return count(call, fake=fake)
