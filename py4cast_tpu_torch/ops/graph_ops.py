"""Message-passing primitives of the gather-table GNN path, as gathers
both ways: the JAX package's ``ops/graph_ops.py`` in PyTorch.

Message aggregation is a plain sum and the graphs have bounded degree
by construction (m2g: 4, down: 1, intra: ≤ 8, g2m and up: the
coarsening ratio), so both directions of both primitives are gathers
through padded inverse-index tables:

- aggregate forward:  agg[n] = Σ_k e[table[n, k]]  (padded index table)
- aggregate backward: de[j] = dagg[dst[j]]
- gather forward:     vs[j] = v[src[j]]
- gather backward:    dv[n] = Σ_k dvs[src_table[n, k]]

Each sum runs over the table's K axis in one fixed order, so a second
call repeats bit for bit on the card. ``index_add_``, ``scatter_add_``
and autograd through ``index_select`` would accumulate with atomics
there, in no fixed order; none is used.
"""

from __future__ import annotations

import numpy as np
import torch


def build_table(idx: np.ndarray, n_rows: int) -> np.ndarray:
    """Padded inverse-index table: table[n] lists the positions j with
    idx[j] == n, in increasing order, padded with len(idx) (a virtual
    zero row). int32, (n_rows, max(1, largest count))."""
    idx = np.asarray(idx)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    counts = np.bincount(idx, minlength=n_rows)
    k_max = int(counts.max()) if len(idx) else 1
    table = np.full((n_rows, max(k_max, 1)), len(idx), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(idx)) - starts[sorted_idx]
    table[sorted_idx, within] = order
    return table


def _table_sum(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[:, n] = Σ_k x[:, table[n, k]], x padded with a zero row at
    index len(x): (B, R, h) → (B, N, h), summed over K in one order."""
    b, _, h = x.shape
    x_pad = torch.cat([x, x.new_zeros(b, 1, h)], dim=1)
    n, k = table.shape
    return x_pad.index_select(1, table.reshape(-1)).reshape(b, n, k, h).sum(dim=2)


class EdgeAggregateFn(torch.autograd.Function):
    """Σ over incoming edges per destination node.

    e: (B, E, h); dst_table: (Nd, K) indices into E (pad = E); dst:
    (E,) the destination of each edge, for the backward. Returns
    (B, Nd, h)."""

    @staticmethod
    def forward(ctx, e, dst_table, dst):
        ctx.save_for_backward(dst)
        return _table_sum(e, dst_table)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g.index_select(1, dst), None, None


class GatherNodesFn(torch.autograd.Function):
    """Per-edge gather of node states: vs[j] = v[idx[j]].

    v: (B, N, h); idx: (E,); table: (N, K) the inverse table of idx,
    for the backward. Returns (B, E, h)."""

    @staticmethod
    def forward(ctx, v, idx, table):
        ctx.save_for_backward(table)
        return v.index_select(1, idx)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return _table_sum(g, table), None, None


def edge_aggregate(e: torch.Tensor, dst_table: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return EdgeAggregateFn.apply(e, dst_table, dst)


def gather_nodes(v: torch.Tensor, idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return GatherNodesFn.apply(v, idx, table)
