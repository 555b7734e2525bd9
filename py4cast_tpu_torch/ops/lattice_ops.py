"""Dense lattice primitives for graph message passing.

Every graph ``models/graph.py::build_graph_artifacts`` makes is a regular
lattice coarsening, so all of its edge sets have separable structure:

- intra-level 8-neighbor edges  → a 2-D stencil (shift + add),
- grid↔mesh nearest / surrounding-4 edges → separable 0/1 selection
  matmuls for takes and for aggregation,
- multimesh levels → dilated stencils on sub-lattices.

Torch functions on (..., H, W, h) tensors, and the numpy helpers that
build the static lattice data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: fixed direction order for 8-neighbor stencils — MUST match the edge
#: enumeration order of ``models/graph.py::_neighbors8``
DIRS8: Tuple[Tuple[int, int], ...] = tuple(
    (di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)
)


def shift2d(v: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Shift a (..., H, W, h) lattice so out[a, b] = v[a - di, b - dj],
    zero-filled outside — i.e. align each cell's (di, dj)-neighbor
    (the edge SOURCE) with the cell itself (the edge DESTINATION)."""
    H, W = v.shape[-3], v.shape[-2]
    # F.pad lists (left, right) pairs from the LAST dim backwards
    out = F.pad(v, (0, 0, max(dj, 0), max(-dj, 0), max(di, 0), max(-di, 0)))
    r0, c0 = max(-di, 0), max(-dj, 0)
    return out[..., r0 : r0 + H, c0 : c0 + W, :]


def stack_shifts(ps: torch.Tensor) -> torch.Tensor:
    """The eight neighbour shifts of a (B, H, W, h) lattice, stacked in
    DIRS8 order: (B, 8, H, W, h) with out[:, k] = shift2d(ps, *DIRS8[k]),
    each cell's k-th edge source aligned with the cell."""
    return torch.stack([shift2d(ps, di, dj) for di, dj in DIRS8], dim=1)


def unshift_sum(dvs: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``stack_shifts``: (B, 8, H, W, h) -> (B, H, W, h),
    sum_k shift2d(dvs[:, k], -di, -dj), each direction's cotangent moved
    back onto its source cell (what fell off the lattice is dropped).
    fp32 sums in DIRS8 order; bf16 in reverse, each add rounded, as
    ``jax.vjp`` of the JAX package's shift stack sums its cotangents."""
    order = range(8) if dvs.dtype == torch.float32 else range(7, -1, -1)
    out = None
    for k in order:
        di, dj = DIRS8[k]
        moved = shift2d(dvs[:, k], -di, -dj)
        out = moved if out is None else out + moved
    return out


def sep_take_mm(v: torch.Tensor, a_rows: torch.Tensor, a_cols: torch.Tensor) -> torch.Tensor:
    """Separable lattice take as transposed 0/1 selection matmuls:
    out = a_rows^T · v · a_cols, with a_rows (ch, fh) the aggregation
    matrix of ``sel_matrix`` (a_rows[rows[i], i] = 1; a_cols likewise).
    Exact — each output cell selects exactly one source cell."""
    x = torch.einsum("Ri,...Rjh->...ijh", a_rows, v)
    return torch.einsum("Cj,...iCh->...ijh", a_cols, x)


def sep_take_mm_vjp(g: torch.Tensor, a_rows: torch.Tensor, a_cols: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``sep_take_mm`` as ``jax.vjp`` takes it: the
    columns contracted first, then the rows (``sep_aggregate`` takes the
    rows first). In exact arithmetic both are the same sum; in bf16 each
    contraction rounds, and this order rounds where JAX does."""
    x = torch.einsum("Cj,...ijh->...iCh", a_cols, g)
    return torch.einsum("Ri,...iCh->...RCh", a_rows, x)


def sep_aggregate(x: torch.Tensor, a_rows: torch.Tensor, a_cols: torch.Tensor) -> torch.Tensor:
    """Separable sum-aggregation (fine → coarse) via 0/1 selection
    matmuls: out[R, C] = Σ_{i: row_map[i]=R} Σ_{j: col_map[j]=C} x[i, j].

    x: (..., fh, fw, h); a_rows: (ch, fh); a_cols: (cw, fw)."""
    x = torch.einsum("Ri,...ijh->...Rjh", a_rows, x)
    return torch.einsum("Cj,...Rjh->...RCh", a_cols, x)


# ------------------------------------------------------------- build helpers
def sel_matrix(idx: np.ndarray, n_rows: int) -> np.ndarray:
    """0/1 selection matrix M (n_rows, len(idx)) with M[idx[i], i] = 1.
    ``M @ x`` sums x's rows into their mapped destinations (aggregation);
    for unique idx it is a pure scatter placement."""
    m = np.zeros((n_rows, len(idx)), dtype=np.float32)
    m[idx, np.arange(len(idx))] = 1.0
    return m


def stencil_feats(
    pos: np.ndarray, scale: float | None = None
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Static 8-direction edge features + existence mask for a lattice.

    pos: (lh, lw, 2) node positions. Returns (feats (8, lh, lw, 3),
    mask (8, lh, lw, 1), scale). feats[d, a, b] = [dx, dy, len] / scale
    of the edge from the (di, dj)-neighbor INTO cell (a, b), with scale
    the max length over the edge set (pass ``scale`` to share the
    normalization across sets, e.g. the multimesh union)."""
    lh, lw, _ = pos.shape
    feats = np.zeros((8, lh, lw, 3), dtype=np.float32)
    mask = np.zeros((8, lh, lw, 1), dtype=np.float32)
    for d, (di, dj) in enumerate(DIRS8):
        src_r = slice(max(-di, 0), lh - max(di, 0))
        src_c = slice(max(-dj, 0), lw - max(dj, 0))
        dst_r = slice(max(di, 0), lh - max(-di, 0))
        dst_c = slice(max(dj, 0), lw - max(-dj, 0))
        d_vec = pos[src_r, src_c] - pos[dst_r, dst_c]
        length = np.linalg.norm(d_vec, axis=-1, keepdims=True)
        feats[d, dst_r, dst_c, :2] = d_vec
        feats[d, dst_r, dst_c, 2:] = length
        mask[d, dst_r, dst_c] = 1.0
    if scale is None:
        scale = max(float(feats[..., 2].max()), 1e-12)
    feats /= scale
    feats *= mask  # keep non-edges exactly zero
    return feats, mask, scale


def pair_feats(
    pos_src: np.ndarray, pos_dst: np.ndarray, scale: float | None = None
) -> Tuple[np.ndarray, float]:
    """Edge features for a one-edge-per-cell bipartite lattice map
    (up/down/g2m/m2g corners), kept in lattice shape (..., 3)."""
    d = pos_src - pos_dst
    length = np.linalg.norm(d, axis=-1, keepdims=True)
    if scale is None:
        scale = max(float(length.max()), 1e-12)
    return np.concatenate([d / scale, length / scale], axis=-1).astype(np.float32), scale
