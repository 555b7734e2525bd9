"""Load the JAX package's model variables into the port.

The port's modules carry the JAX param tree's names, so the conversion
is a walk over that tree with these rules:

- the ``kernel`` of a Flax ``ConvTranspose_*`` module, HWIO (kh, kw,
  in, out) with ``transpose_kernel=False``, becomes the torch
  ``ConvTranspose2d`` weight (in, out, kh, kw) flipped in both spatial
  axes (``models.base.FlaxConvTranspose2d`` says why); it is recognised
  by its module's name, since its rank is a Conv kernel's;
- any other ``kernel`` is converted by its rank: a Flax ``Dense``
  kernel (in, out) is transposed to the torch ``Linear`` weight (out,
  in); a Flax ``Conv`` kernel HWIO (kh, kw, in / groups, out) becomes
  the torch ``Conv2d`` weight OIHW with ``permute(3, 2, 0, 1)`` (a
  depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3)); any other rank
  raises;
- a ``LayerNorm`` or ``GroupNorm`` ``scale`` is the torch norm's
  ``weight``;
- a top-level ``pos_embed`` (HalfUNet's ``absolute_pos_embed``) keeps
  its name and its (1, H, W, 1) layout, and so do an ``EPA_*``
  module's ``temperature`` (heads, 1, 1), ``proj_k`` and ``proj_v``
  (tokens, proj), and a ``WindowAttention_*`` module's
  ``rel_pos_bias`` (heads, (2·ws − 1)²) (SwinUNetR);
- params stacked by ``nn.scan`` carry a leading layer axis; each slice
  goes to one entry of the port's ModuleList of the same name.
  GraphLAM's ``processor`` keeps its scanned step's name
  (``processor.0.block...``); a UNetRPP encoder stage of depth > 1
  (``enc_stage{i}/block/...``) is a ModuleList of EPABlocks, so the
  step's ``block`` goes (``enc_stage0.0.EPA_0...``). A stage of depth 1
  is a plain EPABlock, with no axis and no ``block``.

The fused-kernel param modules of the JAX package (``_DenseParams``,
``_LNParams``, ``_NodeMLPParams``) register the same names (``w_e``,
``out``, ``ln``, ``node/Dense_0``, ...) as the modules they stand for,
so one walk covers both. A key may also hold a whole path joined by
``/`` (``stage0_block0/conv1/kernel``, Flax's ``flatten_dict(sep="/")``
and the encoder npz's keys).

``encoder_to_flax`` goes the other way for a ResNet encoder's leaves
(conv kernels, norm scales, biases), to the encoder npz's flat keys.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

#: top-level param collections whose leaves are stacked over layers
SCANNED = ("processor",)
#: top-level scanned stages whose step (``block``) the port does not keep
SCANNED_STAGE = re.compile(r"enc_stage\d+")
#: leaves kept as they are, by the prefix of their module's name
OWN_LEAVES = {"EPA_": ("temperature", "proj_k", "proj_v"),
              "WindowAttention_": ("rel_pos_bias",)}


def _kernel_to_torch(arr: np.ndarray, path) -> torch.Tensor:
    if arr.ndim == 4 and len(path) > 1 and path[-2].startswith("ConvTranspose"):
        # HWIO -> (in, out, kh, kw), flipped in both spatial axes
        return torch.tensor(np.ascontiguousarray(arr[::-1, ::-1].transpose(2, 3, 0, 1)))
    if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return torch.tensor(arr.T)
    if arr.ndim == 4:  # Conv HWIO -> Conv2d OIHW
        return torch.tensor(np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
    raise ValueError(
        f"kernel {'/'.join(path)} has rank {arr.ndim} (shape {arr.shape}); only "
        "Dense (2-D) and 2-D Conv (4-D HWIO) kernels convert"
    )


def _nested(tree: Mapping) -> dict:
    """``tree`` with every key that joins a path by ``/`` split into
    nested dicts."""
    out: dict = {}
    for key, value in tree.items():
        *mods, leaf = str(key).split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = _nested(value) if isinstance(value, Mapping) else value
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's parameter state from the JAX package's variables.

    ``tree`` is a nested dict of numpy arrays — ``{"params": {...}}`` as
    ``model.init`` returns it, or the inner dict — e.g. made with
    ``jax.tree.map(np.asarray, variables)``. Returns ``{name: tensor}``
    keyed like ``model.named_parameters()``.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    tree = _nested(tree)
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
        elif (name == "pos_embed" and not mods) or (mods and any(
                mods[-1].startswith(prefix) and name in leaves
                for prefix, leaves in OWN_LEAVES.items())):
            out[".".join(mods + [name])] = torch.tensor(arr)
        else:
            raise ValueError(
                f"unexpected parameter {name!r} of module {'/'.join(mods) or '(top level)'}: "
                "convert.py knows kernel, scale, bias, a top-level pos_embed, an EPA "
                "module's temperature, proj_k, proj_v and a WindowAttention module's "
                "rel_pos_bias")

    def walk(node, path, scan):
        """``scan``: how many names after the first a scanned leaf drops
        (0 keeps the step's name, 1 drops ``block``), None if not scanned."""
        if isinstance(node, Mapping):
            for k, v in node.items():
                if not path and k in SCANNED:
                    scan = 0
                elif not path:
                    is_stage = (SCANNED_STAGE.fullmatch(str(k)) and isinstance(v, Mapping)
                                and set(v) == {"block"})
                    scan = 1 if is_stage else None
                walk(v, path + [str(k)], scan)
        elif scan is not None:
            for i in range(node.shape[0]):
                leaf([path[0], str(i)] + path[1 + scan:], node[i])
        else:
            leaf(path, node)

    walk(tree, [], None)
    return out


def encoder_to_flax(state: Mapping[str, torch.Tensor],
                    prefix: str = "encoder.") -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax`` for a ResNet encoder: the
    entries of ``state`` under ``prefix`` as the encoder npz's flat Flax
    keys (``stage0_block0/conv1/kernel``), fp32 numpy. A conv weight
    OIHW becomes the HWIO ``kernel``, a norm's ``weight`` its ``scale``,
    a ``bias`` stays; ``params_from_jax({"encoder": flat})`` gives
    ``state`` back bit for bit."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in state.items():
        if not name.startswith(prefix):
            continue
        *mods, leaf = name[len(prefix):].split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf != "bias":
            raise ValueError(f"encoder parameter {name} of shape {arr.shape} has no Flax "
                             "counterpart: only conv weights, norm weights and biases convert")
        flat["/".join(mods + [leaf])] = np.ascontiguousarray(arr)
    if not flat:
        raise ValueError(f"no parameter of the state starts with {prefix!r}")
    return flat
