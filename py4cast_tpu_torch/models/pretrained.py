"""Pretrained ResNet-encoder checkpoints: the npz format, loading, and the
adaptation of the stem to the model's input channels.

CustomUNet, DeepLabV3 and DeepLabV3Plus take ``encoder_weights``: False
(drawn weights), True (the default npz of ``default_weights_path``) or
an npz path. The npz is the JAX package's format, so one file serves
both packages: flat keys ``<module path>/<param>`` in the encoder's
stable names and Flax's layout (``stage0_block1/conv2/kernel``, HWIO;
``norm1/scale``), plus ``__meta__`` (json: encoder_name, norm kind,
in_channels). The repo ships ``data/pretrained/resnet18.npz`` (fp16,
GroupNorm, 3 input channels); a file under ``ROOTDIR/pretrained/`` wins
over it. The stem kernel is adapted to the model's input channels by
cyclic tiling and a C0/C rescale (the segmentation-models strategy).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from py4cast_tpu_torch.convert import params_from_jax
from py4cast_tpu_torch.settings import ROOTDIR

#: the weights committed with the repo
_REPO_PRETRAINED = Path(__file__).resolve().parents[2] / "data" / "pretrained"


def default_weights_path(encoder_name: str) -> Path:
    """User-produced weights (ROOTDIR) win over the committed ones."""
    user = ROOTDIR / "pretrained" / f"{encoder_name}.npz"
    if user.exists():
        return user
    bundled = _REPO_PRETRAINED / f"{encoder_name}.npz"
    return bundled if bundled.exists() else user


def adapt_in_channels(kernel: np.ndarray, in_channels: int) -> np.ndarray:
    """(H, W, C0, O) → (H, W, in_channels, O) by cyclic tiling, rescaled
    by C0/in_channels so activation magnitudes are preserved. The product
    keeps the kernel's dtype (fp16 for the bundled file), as the JAX
    package's does."""
    c0 = kernel.shape[2]
    if c0 == in_channels:
        return kernel
    reps = -(-in_channels // c0)
    tiled = np.tile(kernel, (1, 1, reps, 1))[:, :, :in_channels]
    return tiled * (c0 / float(in_channels))


def save_encoder_npz(path: Path, flat_params: dict, meta: dict) -> Path:
    """Write ``flat_params`` ({"stem_conv/kernel": array, ...}, Flax
    layout) and ``meta`` as an encoder npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in flat_params.items()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_encoder_npz(path: Path):
    """(flat params, meta) of an encoder npz."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return flat, meta


def maybe_load_encoder(params: Dict[str, torch.Tensor], settings,
                       num_input_features: int) -> Dict[str, torch.Tensor]:
    """``params`` (the port's parameter state) with the pretrained encoder
    of ``settings.encoder_weights`` (False | True | path) loaded: each
    npz entry converted as ``convert.params_from_jax`` converts it (HWIO
    → OIHW, ``scale`` → ``weight``) under ``encoder.``, cast to the
    parameter's dtype and put on its device. Entries the model does not
    have (deeper stages) are skipped; none matching raises."""
    spec = settings.encoder_weights
    if not spec:
        return params
    path = Path(spec) if isinstance(spec, str) else default_weights_path(settings.encoder_name)
    if not path.exists():
        raise FileNotFoundError(
            f"encoder_weights requested but {path} does not exist. Produce it with "
            "python -m py4cast_tpu_torch.tools.convert_torchvision_encoder (torchvision "
            "ImageNet checkpoint) or python -m py4cast_tpu_torch.tools.pretrain_encoder "
            "(offline self-supervised).")
    flat, meta = load_encoder_npz(path)
    if meta.get("norm") != settings.encoder_norm:
        raise ValueError(
            f"{path} carries {meta.get('norm')!r}-norm weights but the model is "
            f"configured with encoder_norm={settings.encoder_norm!r}")
    if meta.get("encoder_name") != settings.encoder_name:
        raise ValueError(
            f"{path} is for {meta.get('encoder_name')!r}, model wants "
            f"{settings.encoder_name!r}")
    if "stem_conv/kernel" in flat:
        flat["stem_conv/kernel"] = adapt_in_channels(flat["stem_conv/kernel"],
                                                     num_input_features)
    out = dict(params)
    loaded, missing = 0, []
    for name, value in params_from_jax({"encoder": flat}).items():
        if name not in params:
            missing.append(name)
            continue
        if params[name].shape != value.shape:
            raise ValueError(
                f"Shape mismatch for {name}: model {tuple(params[name].shape)} vs "
                f"checkpoint {tuple(value.shape)}")
        out[name] = value.to(device=params[name].device, dtype=params[name].dtype)
        loaded += 1
    if loaded == 0:
        raise ValueError(
            f"No parameter of {path} matched the encoder (first missing: {missing[:3]})")
    return out
