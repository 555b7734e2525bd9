"""Trained-model export: a ``torch.export`` program of a model's forward.

The counterpart of ``py4cast_tpu/export.py``, which serializes the
jitted forward to StableHLO. Here ``torch.export`` traces the forward
at fixed parameters for one fp32 input shape into an ``ExportedProgram``
saved as a ``.pt2`` file, which ``load_and_infer`` reloads and runs. The
hand kernels are ``torch.library`` custom ops (``p4t::*``), so a
program keeps them as ops: on the card the reloaded program launches
them, on the CPU it runs their plain versions.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch


def export_forward(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                   input_shape: Tuple[int, ...], dest: Path, batch_size: int = 1) -> Path:
    """Export ``model``'s forward at ``params`` (a state dict of its
    parameters, on the model's device) for a fixed fp32 input
    ``(batch_size, *input_shape, model.num_input_features)`` to ``dest``
    (``torch.export.export`` under ``no_grad``, then
    ``torch.export.save``). The model itself is left as it was."""
    held = next(model.parameters(), None)
    device = held.device if held is not None else torch.device("cpu")
    frozen = copy.deepcopy(model).eval()
    unexpected = frozen.load_state_dict(params, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"params the model does not have: {unexpected}")
    x = torch.zeros((batch_size, *input_shape, model.num_input_features), device=device)
    with torch.no_grad():
        program = torch.export.export(frozen, (x,))
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, dest)
    return dest


def load_and_infer(path: Path, x) -> torch.Tensor:
    """Reload a program ``export_forward`` wrote and run it on ``x`` (a
    numpy array or a tensor), on the device the program was exported
    on. The port's kernel ops are registered first, so that a program
    holding them loads."""
    from py4cast_tpu_torch.ops import attention, hop_kernel, stencil_kernel  # noqa: F401

    program = torch.export.load(Path(path))
    held = [*program.state_dict.values(), *program.constants.values()]
    device = held[0].device if held else torch.device("cpu")
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                        dtype=torch.float32, device=device)
    with torch.no_grad():
        return program.module()(x)
