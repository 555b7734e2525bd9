"""Pieces of the JAX package's ``models/unet.py`` that the port's models
share. Only the bilinear resize so far (Segformer's decoder); UNet and
HalfUNet are not ported yet (ROADMAP.md, queue 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to (h, w), as
    ``jax.image.resize(method="bilinear")`` upsamples (half-pixel
    centres, edges clamped). Shrinking raises: jax antialiases when it
    downsizes and ``F.interpolate`` does not, and no ported model
    shrinks."""
    if h < x.shape[1] or w < x.shape[2]:
        raise ValueError(
            f"_bilinear_resize only upsamples: {tuple(x.shape[1:3])} -> {(h, w)} would "
            "need jax's antialiased downsizing, which is not ported"
        )
    if (h, w) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)
