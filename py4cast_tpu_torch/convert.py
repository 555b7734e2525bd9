"""Load the JAX package's model variables into the port.

The port's modules carry the JAX param tree's names, so the conversion
is a walk over that tree with three rules:

- a ``kernel`` is converted by its rank: a Flax ``Dense`` kernel (in,
  out) is transposed to the torch ``Linear`` weight (out, in); a Flax
  ``Conv`` kernel HWIO (kh, kw, in / groups, out) becomes the torch
  ``Conv2d`` weight OIHW with ``permute(3, 2, 0, 1)`` (a depthwise
  (3, 3, 1, C) kernel becomes (C, 1, 3, 3)); any other rank raises;
- a ``LayerNorm`` or ``GroupNorm`` ``scale`` is the torch norm's
  ``weight``;
- a top-level ``pos_embed`` (HalfUNet's ``absolute_pos_embed``) keeps
  its name and its (1, H, W, 1) layout;
- the processor's params carry a leading ``processor_layers`` axis
  (``nn.scan`` stacks them); each slice goes to one layer of the
  port's ``processor`` ModuleList.

The fused-kernel param modules of the JAX package (``_DenseParams``,
``_LNParams``, ``_NodeMLPParams``) register the same names (``w_e``,
``out``, ``ln``, ``node/Dense_0``, ...) as the modules they stand for,
so one walk covers both.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

#: top-level param collections whose leaves are stacked over layers
SCANNED = ("processor",)


def _kernel_to_torch(arr: np.ndarray, path) -> torch.Tensor:
    if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return torch.tensor(arr.T)
    if arr.ndim == 4:  # Conv HWIO -> Conv2d OIHW
        return torch.tensor(np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
    raise ValueError(
        f"kernel {'/'.join(path)} has rank {arr.ndim} (shape {arr.shape}); only "
        "Dense (2-D) and 2-D Conv (4-D HWIO) kernels convert"
    )


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's parameter state from the JAX package's variables.

    ``tree`` is a nested dict of numpy arrays — ``{"params": {...}}`` as
    ``model.init`` returns it, or the inner dict — e.g. made with
    ``jax.tree.map(np.asarray, variables)``. Returns ``{name: tensor}``
    keyed like ``model.named_parameters()``.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def leaf(path, arr):
        arr = np.asarray(arr, np.float32)
        *mods, name = path
        if name == "kernel":
            out[".".join(mods + ["weight"])] = _kernel_to_torch(arr, path)
        elif name == "scale":
            out[".".join(mods + ["weight"])] = torch.tensor(arr)
        elif name == "bias":
            out[".".join(mods + ["bias"])] = torch.tensor(arr)
        elif name == "pos_embed" and not mods:
            out[name] = torch.tensor(arr)
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")

    def walk(node, path, layer_axis):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)], layer_axis or (not path and k in SCANNED))
        elif layer_axis:
            for i in range(node.shape[0]):
                leaf([path[0], str(i)] + path[1:], node[i])
        else:
            leaf(path, node)

    walk(tree, [], False)
    return out
