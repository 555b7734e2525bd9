"""2x2 / stride-2 max pooling on NHWC tensors.

The JAX package writes this pool with a custom VJP (its ``ops/pool.py``)
because XLA's ``select_and_scatter`` is slow on the TPU; it is not a
Pallas kernel. Here it is ``F.max_pool2d``, whose backward routes each
window's cotangent to its FIRST maximum in row-major window order, as
the JAX VJP does, and which crops odd tails (VALID padding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from py4cast_tpu_torch.parallel.spatial import current_band


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Max over non-overlapping 2x2 windows of NHWC ``x``, stride 2,
    VALID padding: (B, H, W, C) -> (B, H // 2, W // 2, C). On a lat band
    the pool is the band's own when the band starts on an even row,
    which every band of an even row count does; an odd band raises (the
    module sizes bands so that none is: ``ModelBase.spatial_lat_multiple``)."""
    if current_band() is not None and x.shape[1] % 2:
        raise ValueError(f"a lat band of {x.shape[1]} rows cannot pool 2x2 on its own")
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=2, stride=2).permute(0, 2, 3, 1)
