"""The graph models in PyTorch: GraphLAM (the multiscale mesh GNN),
HiLAM and HiLAMParallel (the hierarchical ones).

The multiscale mesh is built once on the host in numpy
(``build_graph_artifacts``): regular coarsenings of the grid,
8-neighbor intra-level edges, nearest-neighbor g2m and surrounding-4
m2g edges. Message passing has two paths with one state dict, chosen
as the JAX package's ``_lattice_on`` chooses:

- the lattice path (``use_lattice: true``, the default): stencil shifts
  and separable 0/1 selection matmuls (``ops/lattice_ops.py``), no
  per-edge gathers. On a CUDA device the two hot stages run as
  hand-written kernels, forward and backward: the processor's stencil
  edge message (``ops/stencil_kernel.py::StencilMessageFn``) and the
  m2g corner hop (``ops/hop_kernel.py::CornerHopFn``), whose forward
  gathers each grid cell's four mesh corners itself through the int32
  corner maps;
- the gather-table path (``use_lattice: false``, and GraphLAM on a graph
  whose multimesh union repeats edges across levels, as small grids
  do): per-edge gathers and sums over padded inverse-index tables
  (``ops/graph_ops.py``), in a fixed order both ways, and no hand
  kernel.

Module and parameter names mirror the JAX package's param tree
(``grid_embed/Dense_0``, ``processor/block/edge/w_e``, ...), which is
one tree for both paths, so ``convert.params_from_jax`` is a plain walk
over it and a checkpoint of one path loads into the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.models.base import LayerNorm, ModelBase, ModelType
from py4cast_tpu_torch.ops.graph_ops import build_table, edge_aggregate, gather_nodes
from py4cast_tpu_torch.ops.hop_kernel import CornerHopFn
from py4cast_tpu_torch.ops.lattice_ops import (
    pair_feats,
    sel_matrix,
    sep_aggregate,
    sep_take_mm,
    stack_shifts,
    stencil_feats,
)
from py4cast_tpu_torch.ops.stencil_kernel import StencilMessageFn
from py4cast_tpu_torch.parallel.spatial import Band, band_all_reduce

#: the grid-side lattice metadata, by its lat axis: what a lat band cuts
#: (a band's columns of a separable selection matrix, ``ar[:, band]``,
#: aggregate the band's edges alone, so the bands' sums add up to the
#: whole grid's; the mesh-side metadata stays whole)
GRID_LAT_AXES = {"lat_g2m_feats": 0, "lat_g2m_rows": 0, "lat_g2m_ar": 1,
                 "lat_m2g_feats": 1, "lat_m2g_rows": 1, "lat_m2g_ar": 2}


@dataclass(frozen=True)
class GraphModelSettings:
    tmp_dir: str = "/tmp"  # accepted for config parity; graphs stay in RAM
    hidden_dims: int = 64
    hidden_layers: int = 1
    use_checkpointing: bool = False  # training recomputes the forward in the backward
    offload_to_cpu: bool = False  # accepted for config parity; no effect
    mesh_aggr: str = "sum"
    processor_layers: int = 4
    mesh_levels: int = 3
    coarsen_factor: int = 4
    #: lattice-form message passing; false takes the gather-table path
    #: (same parameters, so checkpoints interchange)
    use_lattice: bool = True


# -------------------------------------------------------- graph construction
class EdgeSet:
    """A static edge set: src/dst indices and edge features, sorted by
    destination (stable)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, feats: np.ndarray):
        order = np.argsort(dst, kind="stable")
        self.src = src[order].astype(np.int32)
        self.dst = dst[order].astype(np.int32)
        self.feats = feats[order].astype(np.float32)

    def __len__(self):
        return len(self.src)


@dataclass
class GraphArtifacts:
    """The static graph data: the edge sets of the gather-table path and
    the lattice metadata of the lattice path."""

    n_grid: int
    mesh_pos: List[np.ndarray]  # per-level (Nl, 2) normalized positions
    grid_hw: Tuple[int, int]
    level_hw: List[Tuple[int, int]]
    lattice_np: dict
    #: the lattice multimesh equals the union of the levels' edge sets
    #: only when that union is dedup-free (fails on degenerate tiny
    #: lattices)
    multi_lattice_ok: bool
    intra: List[EdgeSet]  # per-level 8-neighbor edges
    up: List[EdgeSet]  # level l -> l+1, each fine node to its nearest coarse node
    down: List[EdgeSet]  # level l+1 -> l, reversed
    g2m: EdgeSet  # grid -> mesh level 0, nearest
    m2g: EdgeSet  # mesh level 0 -> grid, surrounding 4
    multi: EdgeSet  # every level's edges on the level-0 node set, deduplicated
    #: ``graph_arrays``'s result, made once
    arrays: Optional[Tuple[dict, dict]] = field(default=None, repr=False)

    @property
    def level_sizes(self) -> List[int]:
        return [p.shape[0] for p in self.mesh_pos]


def _edge_feats(pos_src: np.ndarray, pos_dst: np.ndarray) -> np.ndarray:
    """Static per-edge features: displacement + length, max-normalized."""
    d = pos_src - pos_dst
    length = np.linalg.norm(d, axis=-1, keepdims=True)
    scale = max(length.max(), 1e-12)
    return np.concatenate([d / scale, length / scale], axis=-1)


def _neighbors8(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """8-neighborhood edges on an h×w lattice (both directions)."""
    idx = np.arange(h * w).reshape(h, w)
    src, dst = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            si = slice(max(0, -di), h - max(0, di))
            sj = slice(max(0, -dj), w - max(0, dj))
            ti = slice(max(0, di), h + min(0, di))
            tj = slice(max(0, dj), w + min(0, dj))
            src.append(idx[si, sj].ravel())
            dst.append(idx[ti, tj].ravel())
    return np.concatenate(src), np.concatenate(dst)


def _nearest_rc(
    fine_hw: Tuple[int, int], coarse_hw: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis nearest-coarse-index maps on regular linspace lattices."""
    fh, fw = fine_hw
    ch, cw = coarse_hw
    ri = np.rint(np.arange(fh) * (ch - 1) / max(fh - 1, 1)).astype(int)
    ci = np.rint(np.arange(fw) * (cw - 1) / max(fw - 1, 1)).astype(int)
    return ri, ci


def _nearest_on_lattice(fine_hw: Tuple[int, int], coarse_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest coarse-lattice node per fine node, by index arithmetic."""
    ri, ci = _nearest_rc(fine_hw, coarse_hw)
    return (ri[:, None] * coarse_hw[1] + ci[None, :]).ravel()


def _corners_rc(
    fine_hw: Tuple[int, int], coarse_hw: Tuple[int, int]
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Per-axis floor/ceil coarse-index maps for the surrounding-4 mapping."""
    fh, fw = fine_hw
    ch, cw = coarse_hw
    r = np.arange(fh) * (ch - 1) / max(fh - 1, 1)
    c = np.arange(fw) * (cw - 1) / max(fw - 1, 1)
    r0 = np.clip(np.floor(r).astype(int), 0, ch - 1)
    r1 = np.clip(r0 + 1, 0, ch - 1)
    c0 = np.clip(np.floor(c).astype(int), 0, cw - 1)
    c1 = np.clip(c0 + 1, 0, cw - 1)
    return (r0, r1), (c0, c1)


def _surrounding4_on_lattice(fine_hw: Tuple[int, int], coarse_hw: Tuple[int, int]) -> np.ndarray:
    """The 4 surrounding coarse-lattice nodes per fine node: (Nf, 4), in
    corner order r0c0, r0c1, r1c0, r1c1."""
    cw = coarse_hw[1]
    (r0, r1), (c0, c1) = _corners_rc(fine_hw, coarse_hw)
    out = np.stack([r0[:, None] * cw + c0[None, :], r0[:, None] * cw + c1[None, :],
                    r1[:, None] * cw + c0[None, :], r1[:, None] * cw + c1[None, :]], axis=-1)
    return out.reshape(-1, 4)


def build_graph_artifacts(meshgrid: np.ndarray, settings: GraphModelSettings) -> GraphArtifacts:
    """Build the multiscale mesh from the grid coordinates.

    meshgrid: (2, H, W) coordinates (``Statics.meshgrid``).
    """
    _, h, w = meshgrid.shape
    pos = np.stack([meshgrid[0], meshgrid[1]], axis=-1).reshape(-1, 2)
    pmin, pmax = pos.min(0), pos.max(0)
    pos = (pos - pmin) / np.where(pmax > pmin, pmax - pmin, 1.0)

    # ---- mesh levels: NESTED regular coarsenings. Level l is a stride-2
    # subsample of level l-1's lattice, so every coarse node coincides
    # with a level-0 node
    f = settings.coarsen_factor
    lh0, lw0 = max(2, h // f), max(2, w // f)
    row_sel = [np.linspace(0, h - 1, lh0).astype(int)]  # grid-row indices
    col_sel = [np.linspace(0, w - 1, lw0).astype(int)]
    row_in0 = [np.arange(lh0)]  # position of each level's rows in level 0
    col_in0 = [np.arange(lw0)]
    for _ in range(1, settings.mesh_levels):
        r0 = row_in0[-1][::2] if len(row_in0[-1]) > 3 else row_in0[-1][[0, -1]]
        c0 = col_in0[-1][::2] if len(col_in0[-1]) > 3 else col_in0[-1][[0, -1]]
        row_in0.append(r0)
        col_in0.append(c0)
        row_sel.append(row_sel[0][r0])
        col_sel.append(col_sel[0][c0])

    mesh_pos: List[np.ndarray] = []
    level_hw: List[Tuple[int, int]] = []
    for ii, jj in zip(row_sel, col_sel):
        sel = (ii[:, None] * w + jj[None, :]).ravel()
        mesh_pos.append(pos[sel])
        level_hw.append((len(ii), len(jj)))

    # ---- intra-level 8-neighbor edges
    intra = []
    for (lh, lw), p in zip(level_hw, mesh_pos):
        src, dst = _neighbors8(lh, lw)
        intra.append(EdgeSet(src, dst, _edge_feats(p[src], p[dst])))

    # ---- up (l → l+1: each fine node sends to its nearest coarse node)
    #      and down (l+1 → l: reversed)
    up, down = [], []
    for level in range(settings.mesh_levels - 1):
        fine, coarse = mesh_pos[level], mesh_pos[level + 1]
        near_c = _nearest_on_lattice(level_hw[level], level_hw[level + 1])
        src_u = np.arange(len(fine))
        up.append(EdgeSet(src_u, near_c, _edge_feats(fine[src_u], coarse[near_c])))
        down.append(EdgeSet(near_c, src_u, _edge_feats(coarse[near_c], fine[src_u])))

    # ---- grid ↔ mesh level 0
    m0 = mesh_pos[0]
    g2m_dst = _nearest_on_lattice((h, w), level_hw[0])
    g2m = EdgeSet(np.arange(len(pos)), g2m_dst, _edge_feats(pos, m0[g2m_dst]))
    m2g_src = _surrounding4_on_lattice((h, w), level_hw[0]).ravel()
    m2g_dst = np.repeat(np.arange(len(pos)), 4)
    m2g = EdgeSet(m2g_src, m2g_dst, _edge_feats(m0[m2g_src], pos[m2g_dst]))

    # ---- nested multimesh: each level's 8-neighbor edges mapped onto
    # the level-0 node set via the nesting indices, deduplicated; the
    # lattice form needs their union to have no duplicate edge
    msrc, mdst = [], []
    lw0_ = level_hw[0][1]
    for level, (lh, lw) in enumerate(level_hw):
        s, t = _neighbors8(lh, lw)
        r0, c0 = row_in0[level], col_in0[level]
        to0 = (r0[:, None] * lw0_ + c0[None, :]).ravel()
        msrc.append(to0[s])
        mdst.append(to0[t])
    msrc, mdst = np.concatenate(msrc), np.concatenate(mdst)
    key = msrc.astype(np.int64) * len(m0) + mdst
    uniq_keys, uniq = np.unique(key, return_index=True)
    multi_lattice_ok = len(uniq_keys) == len(key)
    msrc, mdst = msrc[uniq], mdst[uniq]
    multi = EdgeSet(msrc, mdst, _edge_feats(m0[msrc], m0[mdst]))

    lat = _build_lattice_meta(pos, (h, w), mesh_pos, level_hw, row_in0, col_in0, settings)
    return GraphArtifacts(len(pos), mesh_pos, (h, w), level_hw, lat, multi_lattice_ok,
                          intra, up, down, g2m, m2g, multi)


def graph_arrays(g: GraphArtifacts) -> Tuple[dict, dict]:
    """The static graph data as a flat name → numpy dict, the JAX
    package's ``_GraphModelBase.graph_arrays``: ``mesh_pos_{l}``, for
    each edge set ``{prefix}_src``, ``_dst``, ``_feats``, ``_src_table``,
    ``_dst_table`` (``build_table``, padded with the edge count) and
    ``_dst_count``, and the lattice metadata; with the regular-K map
    (prefix → K where the edge set has exactly K contiguous edges a
    destination, in order). Made once a graph."""
    if g.arrays is not None:
        return g.arrays
    d: dict = {f"mesh_pos_{l}": p for l, p in enumerate(g.mesh_pos)}
    regular: dict = {}

    def add(prefix, es, n_src, n_dst):
        d[f"{prefix}_src"] = es.src
        d[f"{prefix}_dst"] = es.dst
        d[f"{prefix}_feats"] = es.feats
        d[f"{prefix}_src_table"] = build_table(es.src, n_src)
        dst_table = build_table(es.dst, n_dst)
        d[f"{prefix}_dst_table"] = dst_table
        counts = np.bincount(es.dst, minlength=n_dst)
        d[f"{prefix}_dst_count"] = counts.astype(np.float32)
        k = int(counts[0]) if len(counts) else 0
        if k > 0 and (counts == k).all() and np.array_equal(
                dst_table, np.arange(n_dst * k).reshape(n_dst, k)):
            regular[prefix] = k

    sizes = g.level_sizes
    add("g2m", g.g2m, g.n_grid, sizes[0])
    add("m2g", g.m2g, sizes[0], g.n_grid)
    for l, es in enumerate(g.intra):
        add(f"intra_{l}", es, sizes[l], sizes[l])
    for l, es in enumerate(g.up):
        add(f"up_{l}", es, sizes[l], sizes[l + 1])
    for l, es in enumerate(g.down):
        add(f"down_{l}", es, sizes[l + 1], sizes[l])
    add("multi", g.multi, sizes[0], sizes[0])
    d.update(g.lattice_np)
    g.arrays = (d, regular)
    return g.arrays


def _build_lattice_meta(
    pos: np.ndarray,
    grid_hw: Tuple[int, int],
    mesh_pos: List[np.ndarray],
    level_hw: List[Tuple[int, int]],
    row_in0: List[np.ndarray],
    col_in0: List[np.ndarray],
    settings: GraphModelSettings,
) -> dict:
    """Dense lattice metadata: the edge data of the graph in separable
    lattice form — per-direction stencil features + masks
    (intra/multimesh), per-axis index maps + 0/1 selection matrices
    (g2m/m2g/up/down)."""
    h, w = grid_hw
    lat: dict = {}

    for lev, ((lh, lw), p) in enumerate(zip(level_hw, mesh_pos)):
        feats, mask, _ = stencil_feats(p.reshape(lh, lw, 2))
        lat[f"lat_intra_{lev}_feats"] = feats
        lat[f"lat_intra_{lev}_mask"] = mask
        lat[f"lat_intra_{lev}_count"] = mask.sum(axis=0)

    for lev in range(settings.mesh_levels - 1):
        fhw, chw = level_hw[lev], level_hw[lev + 1]
        ri, ci = _nearest_rc(fhw, chw)
        fine = mesh_pos[lev].reshape(*fhw, 2)
        coarse = mesh_pos[lev + 1].reshape(*chw, 2)
        cg = coarse[ri][:, ci]  # coarse partner per fine cell
        up_f, scale = pair_feats(fine, cg)
        down_f, _ = pair_feats(cg, fine, scale)  # same lengths → same scale
        a_r, a_c = sel_matrix(ri, chw[0]), sel_matrix(ci, chw[1])
        count = (a_r.sum(1)[:, None] * a_c.sum(1)[None, :])[..., None]
        lat[f"lat_up_{lev}_feats"] = up_f
        lat[f"lat_up_{lev}_rows"] = ri.astype(np.int32)
        lat[f"lat_up_{lev}_cols"] = ci.astype(np.int32)
        lat[f"lat_up_{lev}_ar"] = a_r
        lat[f"lat_up_{lev}_ac"] = a_c
        lat[f"lat_up_{lev}_count"] = count.astype(np.float32)
        lat[f"lat_down_{lev}_feats"] = down_f
        lat[f"lat_down_{lev}_rows"] = ri.astype(np.int32)
        lat[f"lat_down_{lev}_cols"] = ci.astype(np.int32)
        lat[f"lat_down_{lev}_ar"] = a_r
        lat[f"lat_down_{lev}_ac"] = a_c

    # --- g2m: grid (fine) → mesh level 0 (coarse), nearest
    hw0 = level_hw[0]
    grid_lat = pos.reshape(h, w, 2)
    m0_lat = mesh_pos[0].reshape(*hw0, 2)
    ri, ci = _nearest_rc((h, w), hw0)
    g2m_f, _ = pair_feats(grid_lat, m0_lat[ri][:, ci])
    a_r, a_c = sel_matrix(ri, hw0[0]), sel_matrix(ci, hw0[1])
    lat["lat_g2m_feats"] = g2m_f
    lat["lat_g2m_rows"] = ri.astype(np.int32)
    lat["lat_g2m_cols"] = ci.astype(np.int32)
    lat["lat_g2m_ar"] = a_r
    lat["lat_g2m_ac"] = a_c
    lat["lat_g2m_count"] = (a_r.sum(1)[:, None] * a_c.sum(1)[None, :])[..., None].astype(
        np.float32
    )

    # --- m2g: mesh level 0 → grid, surrounding-4 corners
    (r0, r1), (c0, c1) = _corners_rc((h, w), hw0)
    # the corner-hop kernel reads ps at these cells unchecked
    if min(r0.min(), c0.min()) < 0 or r1.max() >= hw0[0] or c1.max() >= hw0[1]:
        raise ValueError(f"m2g corner maps leave the {hw0} level-0 lattice")
    src_pos = np.stack(
        [m0_lat[rk][:, ck] for rk in (r0, r1) for ck in (c0, c1)]
    )  # (4, h, w, 2) in corner order r0c0, r0c1, r1c0, r1c1
    m2g_f, _ = pair_feats(src_pos, grid_lat[None])
    lat["lat_m2g_feats"] = m2g_f
    lat["lat_m2g_rows"] = np.stack([r0, r1]).astype(np.int32)
    lat["lat_m2g_cols"] = np.stack([c0, c1]).astype(np.int32)
    lat["lat_m2g_ar"] = np.stack([sel_matrix(r0, hw0[0]), sel_matrix(r1, hw0[0])])
    lat["lat_m2g_ac"] = np.stack([sel_matrix(c0, hw0[1]), sel_matrix(c1, hw0[1])])

    # --- multimesh: per-level dilated stencils on level-0 sub-lattices,
    # sharing the union's feature normalization scale
    union_scale = 0.0
    for lev, ((lh, lw), p) in enumerate(zip(level_hw, mesh_pos)):
        _, _, s = stencil_feats(p.reshape(lh, lw, 2))
        union_scale = max(union_scale, s)
    count0 = np.zeros(hw0 + (1,), dtype=np.float32)
    for lev, ((lh, lw), p) in enumerate(zip(level_hw, mesh_pos)):
        feats, mask, _ = stencil_feats(p.reshape(lh, lw, 2), union_scale)
        lat[f"lat_multi_{lev}_feats"] = feats
        lat[f"lat_multi_{lev}_mask"] = mask
        rows, cols = row_in0[lev], col_in0[lev]
        lat[f"lat_multi_{lev}_rows"] = rows.astype(np.int32)
        lat[f"lat_multi_{lev}_cols"] = cols.astype(np.int32)
        s_r, s_c = sel_matrix(rows, hw0[0]), sel_matrix(cols, hw0[1])
        lat[f"lat_multi_{lev}_sr"] = s_r
        lat[f"lat_multi_{lev}_sc"] = s_c
        count0 += ((s_r @ mask.sum(axis=0)[..., 0]) @ s_c.T)[..., None]
    lat["lat_multi_count"] = count0
    return lat


# ------------------------------------------------------------------ modules
def _kernel(lin: nn.Linear) -> torch.Tensor:
    """A Linear's weight in the (in, out) layout the CUDA kernels take."""
    return lin.weight.t().contiguous()


class MLP(nn.Module):
    """Dense → silu, ``hidden_layers`` times, then Dense → LayerNorm.
    Submodules carry flax's auto names (Dense_0, ..., LayerNorm_0)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 hidden_layers: int = 1, layer_norm: bool = True):
        super().__init__()
        self.hidden_layers = hidden_layers
        dims = [in_dim] + [hidden_dim] * hidden_layers + [out_dim]
        for i in range(hidden_layers + 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.LayerNorm_0 = LayerNorm(out_dim) if layer_norm else None

    def forward(self, x):
        for i in range(self.hidden_layers):
            x = F.silu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.hidden_layers}")(x)
        return self.LayerNorm_0(x) if self.LayerNorm_0 is not None else x


class _EdgeMessage(nn.Module):
    """An edge message's layers (``w_e``, ``w_s``, ``w_d``, ``hidden_{i}``,
    ``out``, ``ln``; the subclass registers them) and its gather-table
    form, the JAX package's ``EdgeMessage``."""

    def _tail(self, z):
        z = F.silu(z)
        for i in range(self.hidden_layers - 1):
            z = F.silu(getattr(self, f"hidden_{i}")(z))
        return self.ln(self.out(z))

    def table(self, v_src, v_dst, e, edges: Dict[str, torch.Tensor], regular_k=None,
              aggr=None):
        """(e_new (B, E, h), agg (B, Nd, h)) over a static edge set: the
        first dense split over [e ‖ v_s ‖ v_d], node states projected
        before they are gathered; with ``regular_k`` (exactly K
        contiguous edges a destination) v_d broadcasts over K and the
        aggregate is a reshape-sum. ``aggr`` (default the message's
        own) "mean" divides by max(in-degree, 1)."""
        pe = self.w_e(e)
        ps = gather_nodes(self.w_s(v_src), edges["src"], edges["src_table"])
        pd = self.w_d(v_dst)
        if regular_k:
            b, n_e, h = pe.shape
            nd = n_e // regular_k
            e_new = self._tail(pe.reshape(b, nd, regular_k, h) + ps.reshape(b, nd, regular_k, h)
                               + pd[:, :, None])
            agg = e_new.sum(dim=2)
            e_new = e_new.reshape(b, n_e, h)
        else:
            e_new = self._tail(pe + ps + gather_nodes(pd, edges["dst"], edges["dst_table"]))
            agg = edge_aggregate(e_new, edges["dst_table"], edges["dst"])
        if (aggr or self.aggr) == "mean":
            agg = agg / torch.clamp(edges["dst_count"], min=1.0)[None, :, None]
        return e_new, agg


class _StencilMessage(_EdgeMessage):
    """Edge message on an 8-neighbor lattice stencil. Edge states live as
    (B, 8, H, W, h) arrays in DIRS8 order; each edge's source state
    arrives by a shift instead of a gather. With ``residual`` the first
    output is ``e + e_new``; agg always aggregates the raw e_new, and
    with ``aggr="mean"`` it is divided by ``max(count, 1)`` after the
    fused stage."""

    def __init__(self, v_dim: int, e_dim: int, hidden_dim: int,
                 hidden_layers: int = 1, residual: bool = False, aggr: str = "sum"):
        super().__init__()
        h = hidden_dim
        self.hidden_layers = hidden_layers
        self.residual = residual
        self.aggr = aggr
        self.w_s = nn.Linear(v_dim, h, bias=False)
        self.w_d = nn.Linear(v_dim, h, bias=False)
        self.w_e = nn.Linear(e_dim, h)
        for i in range(hidden_layers - 1):
            self.add_module(f"hidden_{i}", nn.Linear(h, h))
        self.out = nn.Linear(h, h)
        self.ln = LayerNorm(h)

    def forward(self, v, e, mask, count=None):
        ps = self.w_s(v)
        pd = self.w_d(v)
        if self.hidden_layers == 1:
            # the fused stage: CUDA kernels (forward and backward) on the
            # card, their plain versions on the CPU (ops/stencil_kernel.py);
            # the forward kernel shifts ps onto each cell itself and, with
            # residual, already returns e + e_new
            e_out, agg = StencilMessageFn.apply(
                e.contiguous(), ps.contiguous(), pd.contiguous(), mask,
                _kernel(self.w_e), self.w_e.bias, _kernel(self.out), self.out.bias,
                self.ln.weight, self.ln.bias, self.residual,
            )
        else:
            e_new = self._tail(self.w_e(e) + stack_shifts(ps) + pd[:, None])
            agg = (e_new * mask[None]).sum(dim=1)
            e_out = e + e_new if self.residual else e_new
        if self.aggr == "mean":
            agg = agg / torch.clamp(count[None], min=1.0)
        return e_out, agg


class _NearestMessage(_EdgeMessage):
    """Edge message for a one-edge-per-fine-cell map (up_l): the fine
    cell is the source, its nearest coarse cell the destination, whose
    state arrives by a separable take; the aggregate is two selection
    matmuls. Plain PyTorch: no TPU kernel sits on it."""

    def __init__(self, hidden_dim: int, hidden_layers: int = 1, aggr: str = "sum"):
        super().__init__()
        h = hidden_dim
        self.hidden_layers = hidden_layers
        self.aggr = aggr
        self.w_e = nn.Linear(h, h)
        self.w_s = nn.Linear(h, h, bias=False)
        self.w_d = nn.Linear(h, h, bias=False)
        for i in range(hidden_layers - 1):
            self.add_module(f"hidden_{i}", nn.Linear(h, h))
        self.out = nn.Linear(h, h)
        self.ln = LayerNorm(h)

    def forward(self, v_fine, v_coarse, e, lat: Dict[str, torch.Tensor]):
        pd = sep_take_mm(self.w_d(v_coarse), lat["ar"], lat["ac"])
        e_new = self._tail(self.w_e(e) + self.w_s(v_fine) + pd)
        agg = sep_aggregate(e_new, lat["ar"], lat["ac"])
        if self.aggr == "mean":
            agg = agg / torch.clamp(lat["count"][None], min=1.0)
        return e_new, agg


class _ReverseNearestMessage(_NearestMessage):
    """Edge message for down_l: coarse → fine along the same nearest map
    (one edge a fine cell, so sum and mean agree): the coarse source
    arrives by a separable take, and the aggregate is the message."""

    def forward(self, v_coarse, v_fine, e, lat: Dict[str, torch.Tensor]):
        ps = sep_take_mm(self.w_s(v_coarse), lat["ar"], lat["ac"])
        e_new = self._tail(self.w_e(e) + ps + self.w_d(v_fine))
        return e_new, e_new


class LatticeInteractionNetwork(nn.Module):
    """An interaction network: an ``edge`` message of kind ``stencil``
    (intra-level, kernels a-fwd and a-bwd on the card), ``nearest`` (up)
    or ``down``, then a residual ``node`` MLP update of the destination,
    and with ``update_edges`` a residual edge update (inside the kernel
    for ``stencil``). ``forward`` takes lattice-form edges, ``table`` a
    static edge set (the JAX package's ``InteractionNetwork``)."""

    def __init__(self, hidden_dim: int, hidden_layers: int = 1, aggr: str = "sum",
                 kind: str = "stencil", update_edges: bool = True):
        super().__init__()
        h = hidden_dim
        self.kind = kind
        self.update_edges = update_edges
        if kind == "stencil":
            self.edge = _StencilMessage(h, h, h, hidden_layers, residual=update_edges,
                                        aggr=aggr)
        elif kind == "nearest":
            self.edge = _NearestMessage(h, hidden_layers, aggr)
        elif kind == "down":
            self.edge = _ReverseNearestMessage(h, hidden_layers, aggr)
        else:
            raise ValueError(f"kind must be 'stencil', 'nearest' or 'down', got {kind!r}")
        self.node = MLP(2 * h, h, h, hidden_layers)

    def forward(self, v_src, v_dst, e, lat: Dict[str, torch.Tensor]):
        if self.kind == "stencil":
            e_out, agg = self.edge(v_dst, e, lat["mask"], lat.get("count"))
            if not self.update_edges:
                e_out = e
        else:
            e_new, agg = self.edge(v_src, v_dst, e, lat)
            e_out = e + e_new if self.update_edges else e
        return v_dst + self.node(torch.cat([v_dst, agg], dim=-1)), e_out

    def table(self, v_src, v_dst, e, edges: Dict[str, torch.Tensor], regular_k=None):
        e_new, agg = self.edge.table(v_src, v_dst, e, edges, regular_k)
        v_out = v_dst + self.node(torch.cat([v_dst, agg], dim=-1))
        return v_out, (e + e_new if self.update_edges else e)


class LatticeEncodeDecode(nn.Module):
    """The encode/decode hop: 'nearest' is the g2m hop (grid → mesh0),
    'corners' the m2g hop (mesh0 → grid through the 4 surrounding coarse
    cells). ``forward`` on the lattice, ``table`` on a static edge set
    (the JAX package's ``EncodeDecodeInteraction``)."""

    def __init__(self, hidden_dim: int, feat_dim: int, hidden_layers: int = 1,
                 aggr: str = "sum", kind: str = "nearest"):
        super().__init__()
        if kind not in ("nearest", "corners"):
            raise ValueError(f"kind must be 'nearest' or 'corners', got {kind!r}")
        h = hidden_dim
        self.hidden_layers = hidden_layers
        self.aggr = aggr
        self.kind = kind
        self.w_s = nn.Linear(h, h, bias=False)
        self.w_f = nn.Linear(feat_dim, h)
        self.w_d = nn.Linear(h, h, bias=False)
        self.out = nn.Linear(h, h)
        self.ln = LayerNorm(h)
        self.node = MLP(2 * h, h, h, hidden_layers)

    def _tail(self, z):
        return self.ln(self.out(F.silu(z)))

    def aggregate(self, v_src, v_dst, lat: Dict[str, torch.Tensor]):
        """The g2m hop's sum of its edges' messages onto mesh level 0; on
        a lat band, of the band's edges alone (its rows of ``feats`` and
        ``ar``): a partial sum."""
        pd = self.w_d(v_dst)
        pre = self.w_f(lat["feats"])[None] + self.w_s(v_src) + sep_take_mm(pd, lat["ar"],
                                                                            lat["ac"])
        return sep_aggregate(self._tail(pre), lat["ar"], lat["ac"])

    def update(self, v_dst, agg, lat: Dict[str, torch.Tensor]):
        """The g2m hop's node update from the whole aggregate (divided by
        the in-degree ``count`` for mean aggregation)."""
        if self.aggr == "mean":
            agg = agg / torch.clamp(lat["count"][None], min=1.0)
        return v_dst + self.node(torch.cat([v_dst, agg], dim=-1))

    def forward(self, v_src, v_dst, lat: Dict[str, torch.Tensor]):
        if self.kind == "nearest":
            # on a lat band the bands' partial sums are all-reduced before
            # the count division and the node update: the one collective
            # of a graph model's forward
            return self.update(v_dst, band_all_reduce(self.aggregate(v_src, v_dst, lat)), lat)

        ps = self.w_s(v_src)
        ar, ac = lat["ar"], lat["ac"]
        if self.hidden_layers == 1:
            # the fused m2g hop: CUDA kernels (forward and backward) on
            # the card, their plain versions on the CPU (ops/hop_kernel.py);
            # the forward kernel gathers each corner's row of ps itself
            h = self.w_d.weight.shape[0]
            nd0 = _kernel(self.node.Dense_0)
            return CornerHopFn.apply(
                ps.contiguous(), lat["rows"], lat["cols"], ar, ac, v_dst.contiguous(),
                lat["feats"],
                _kernel(self.w_f), self.w_f.bias, _kernel(self.w_d),
                _kernel(self.out), self.out.bias, self.ln.weight, self.ln.bias,
                nd0[:h].contiguous(), nd0[h:].contiguous(), self.node.Dense_0.bias,
                _kernel(self.node.Dense_1), self.node.Dense_1.bias,
                self.node.LayerNorm_0.weight, self.node.LayerNorm_0.bias,
                self.aggr == "mean",
            )
        ps_g = [sep_take_mm(ps, ar[k // 2], ac[k % 2]).contiguous() for k in range(4)]
        pd = self.w_d(v_dst)
        pf = self.w_f(lat["feats"])  # (4, H, W, h)
        agg = sum(self._tail(pf[k] + ps_g[k] + pd) for k in range(4))
        if self.aggr == "mean":
            agg = agg / 4.0
        return v_dst + self.node(torch.cat([v_dst, agg], dim=-1))

    def table(self, v_src, v_dst, feats, edges: Dict[str, torch.Tensor], regular_k=None):
        """The hop over a static edge set: the edge features enter through
        one linear, silu → dense → LN a edge, aggregated (a reshape-sum
        with ``regular_k``), then the node update."""
        pf = self.w_f(feats)[None]
        ps = gather_nodes(self.w_s(v_src), edges["src"], edges["src_table"])
        pd = self.w_d(v_dst)
        if regular_k:
            b, nd, h = pd.shape
            pre = (pf.reshape(1, nd, regular_k, h) + ps.reshape(b, nd, regular_k, h)
                   + pd[:, :, None])
            agg = self._tail(pre).sum(dim=2)
        else:
            pre = pf + ps + gather_nodes(pd, edges["dst"], edges["dst_table"])
            agg = edge_aggregate(self._tail(pre), edges["dst_table"], edges["dst"])
        if self.aggr == "mean":
            agg = agg / torch.clamp(edges["dst_count"], min=1.0)[None, :, None]
        return v_dst + self.node(torch.cat([v_dst, agg], dim=-1))


class _LatticeUnionBlock(nn.Module):
    """The multimesh union interaction (one shared edge message + one
    node update). ``forward`` on the lattice: each mesh level is a
    dilated stencil on a level-0 sub-lattice; per-level aggregates are
    scattered back into the level-0 lattice with selection matmuls.
    ``table`` on the deduplicated union edge set."""

    def __init__(self, hidden_dim: int, hidden_layers: int = 1, aggr: str = "sum"):
        super().__init__()
        h = hidden_dim
        self.aggr = aggr
        self.edge = _StencilMessage(h, h, h, hidden_layers, residual=True)
        self.node = MLP(2 * h, h, h, hidden_layers)

    def forward(self, v0, e_levels, lat: Dict[str, torch.Tensor]):
        agg_total = torch.zeros_like(v0)
        new_e = []
        for lev, e in enumerate(e_levels):
            full = e.shape[2:4] == v0.shape[1:3]
            sr, sc = lat[f"lat_multi_{lev}_sr"], lat[f"lat_multi_{lev}_sc"]
            v_l = v0 if full else sep_take_mm(v0, sr, sc)
            e_new, agg = self.edge(v_l, e, lat[f"lat_multi_{lev}_mask"])
            new_e.append(e_new)
            if not full:
                agg = sep_aggregate(agg, sr, sc)
            agg_total = agg_total + agg
        if self.aggr == "mean":
            agg_total = agg_total / torch.clamp(lat["lat_multi_count"][None], min=1.0)
        v_new = self.node(torch.cat([v0, agg_total], dim=-1))
        return v0 + v_new, tuple(new_e)

    def table(self, v0, e, edges: Dict[str, torch.Tensor]):
        e_new, agg = self.edge.table(v0, v0, e, edges, aggr=self.aggr)
        return v0 + self.node(torch.cat([v0, agg], dim=-1)), e + e_new


class _LatticeFlatStep(nn.Module):
    """One multimesh processor layer (GraphLAM)."""

    def __init__(self, hidden_dim: int, hidden_layers: int, aggr: str):
        super().__init__()
        self.block = _LatticeUnionBlock(hidden_dim, hidden_layers, aggr)

    def forward(self, v0, e_levels, lat):
        return self.block(v0, e_levels, lat)

    def table(self, v0, e, edges):
        return self.block.table(v0, e, edges)


class _LatticeHiLAMSweepStep(nn.Module):
    """One HiLAM processor layer: sweep up the hierarchy, then back down,
    updating the inter-level and intra-level edges at each stop, in the
    JAX package's order and names (``up_{l}``, ``intra_up_{l+1}``, then
    ``down_{l}``, ``intra_down_{l}``)."""

    def __init__(self, hidden_dim: int, hidden_layers: int, aggr: str, num_levels: int):
        super().__init__()
        self.num_levels = num_levels

        def lin(kind):
            return LatticeInteractionNetwork(hidden_dim, hidden_layers, aggr, kind=kind)

        for l in range(num_levels - 1):
            self.add_module(f"up_{l}", lin("nearest"))
            self.add_module(f"intra_up_{l + 1}", lin("stencil"))
        for l in reversed(range(num_levels - 1)):
            self.add_module(f"down_{l}", lin("down"))
            self.add_module(f"intra_down_{l}", lin("stencil"))

    def forward(self, mesh_v, intra_e, up_e, down_e, lat, down_ks=None):
        """On lattice-form edges (``lat``), or with ``down_ks`` (the
        regular K of each down edge set, or None) on static edge sets
        (``lat`` then maps each prefix to its ``_GraphModelBase._edges``)."""
        table = down_ks is not None
        mesh_v, intra_e, up_e, down_e = list(mesh_v), list(intra_e), list(up_e), list(down_e)

        def run(name, *args, **kw):
            mod = getattr(self, name)
            return mod.table(*args, **kw) if table else mod(*args)

        for l in range(self.num_levels - 1):  # sweep up
            mesh_v[l + 1], up_e[l] = run(f"up_{l}", mesh_v[l], mesh_v[l + 1], up_e[l],
                                         lat[f"up_{l}"])
            mesh_v[l + 1], intra_e[l + 1] = run(f"intra_up_{l + 1}", mesh_v[l + 1], mesh_v[l + 1],
                                                intra_e[l + 1], lat[f"intra_{l + 1}"])
        for l in reversed(range(self.num_levels - 1)):  # sweep down
            kw = {"regular_k": down_ks[l]} if table else {}
            mesh_v[l], down_e[l] = run(f"down_{l}", mesh_v[l + 1], mesh_v[l], down_e[l],
                                       lat[f"down_{l}"], **kw)
            mesh_v[l], intra_e[l] = run(f"intra_down_{l}", mesh_v[l], mesh_v[l], intra_e[l],
                                        lat[f"intra_{l}"])
        return mesh_v, intra_e, up_e, down_e


class _LatticeHiLAMParallelStep(nn.Module):
    """One HiLAMParallel processor layer: every edge set (intra at each
    level, up, down) messages at once from the current node states, then
    each level's nodes are updated once with the sum of their incoming
    aggregates (modules ``intra_{l}``, ``up_{l}``, ``down_{l}``,
    ``node_{l}``)."""

    def __init__(self, hidden_dim: int, hidden_layers: int, aggr: str, num_levels: int):
        super().__init__()
        h = hidden_dim
        self.num_levels = num_levels
        for l in range(num_levels):
            self.add_module(f"intra_{l}", _StencilMessage(h, h, h, hidden_layers,
                                                          residual=True, aggr=aggr))
        for l in range(num_levels - 1):
            self.add_module(f"up_{l}", _NearestMessage(h, hidden_layers, aggr))
            self.add_module(f"down_{l}", _ReverseNearestMessage(h, hidden_layers, aggr))
        for l in range(num_levels):
            self.add_module(f"node_{l}", MLP(2 * h, h, h, hidden_layers))

    def forward(self, mesh_v, intra_e, up_e, down_e, lat, down_ks=None):
        """On lattice-form edges, or on static edge sets with ``down_ks``,
        as ``_LatticeHiLAMSweepStep.forward``."""
        L = self.num_levels
        table = down_ks is not None
        new_intra, new_up, new_down, aggs = [], [], [], []
        for l in range(L):
            mod = getattr(self, f"intra_{l}")
            if table:
                e_new, agg = mod.table(mesh_v[l], mesh_v[l], intra_e[l], lat[f"intra_{l}"])
                new_intra.append(intra_e[l] + e_new)
            else:
                d = lat[f"intra_{l}"]
                e_out, agg = mod(mesh_v[l], intra_e[l], d["mask"], d.get("count"))
                new_intra.append(e_out)  # the residual is inside the stage
            aggs.append(agg)
        for l in range(L - 1):
            up, down = getattr(self, f"up_{l}"), getattr(self, f"down_{l}")
            if table:
                e_up, agg_up = up.table(mesh_v[l], mesh_v[l + 1], up_e[l], lat[f"up_{l}"])
                e_down, agg_down = down.table(mesh_v[l + 1], mesh_v[l], down_e[l],
                                              lat[f"down_{l}"], down_ks[l])
            else:
                e_up, agg_up = up(mesh_v[l], mesh_v[l + 1], up_e[l], lat[f"up_{l}"])
                e_down, agg_down = down(mesh_v[l + 1], mesh_v[l], down_e[l], lat[f"down_{l}"])
            new_up.append(up_e[l] + e_up)
            aggs[l + 1] = aggs[l + 1] + agg_up
            new_down.append(down_e[l] + e_down)
            aggs[l] = aggs[l] + agg_down
        new_v = [mesh_v[l] + getattr(self, f"node_{l}")(torch.cat([mesh_v[l], aggs[l]], dim=-1))
                 for l in range(L)]
        return new_v, new_intra, new_up, new_down


#: the arrays of an edge set the gather-table path keeps as buffers
TABLE_KEYS = ("src", "dst", "src_table", "dst_table", "feats", "dst_count")


class _GraphModelBase(ModelBase):
    """The skeleton the graph models share: grid and mesh embeds
    (``grid_embed``, ``mesh_embed_{l}``), the g2m hop, the processor the
    subclass builds (``_build_processor``), the m2g hop (kernel b on the
    lattice path) and the decoder. Static graph arrays are non-persistent
    buffers: they follow the module to its device and stay out of the
    state dict, which is one for both paths.

    The path is the JAX package's ``_lattice_on``: the gather-table path
    (``table_path``) for ``use_lattice: false``, and for a graph whose
    multimesh union is not dedup-free where the model needs it
    (``_lattice_need_multi``, GraphLAM); the lattice path otherwise.

    With ``band`` (index, count) the model runs on that lat band of the
    grid (``parallel.spatial``): the graph is built on the whole grid and
    its grid-side lattice metadata cut to the band's rows once, here
    (``GRID_LAT_AXES``); the grid embed,
    the m2g hop (kernel b on the band's rows, against the whole mesh
    projection) and the decoder run on the band; the g2m hop all-reduces
    its partial aggregate; the mesh levels and their processor (kernel a)
    run replicated on every band. The gather-table path refuses a band,
    as the JAX package's does."""

    settings_kls = GraphModelSettings
    model_type = ModelType.GRAPH
    supported_num_spatial_dims = (1,)
    spatial_shardable = True
    #: the model's lattice path needs a dedup-free multimesh union
    _lattice_need_multi = False
    #: mesh levels with an embed (None: every level)
    _embedded_levels = None

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: GraphModelSettings,
                 graph: GraphArtifacts, band: Optional[Tuple[int, int]] = None):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        self.graph = graph
        self.table_path = not settings.use_lattice or (
            self._lattice_need_multi and not graph.multi_lattice_ok)
        count = band[1] if band is not None else 1
        if count > 1 and self.table_path:
            raise ValueError(
                f"Spatial mesh sharding (spatial={count}) requires a model whose forward "
                f"tolerates a sharded lat dim; {type(self).__name__} runs the gather-table "
                f"path (use_lattice: false, or a multimesh union that repeats edges): use "
                f"use_lattice: true or spatial=1")
        #: the (band's) grid the model reads and writes
        self.grid_hw = (graph.grid_hw[0] // count, graph.grid_hw[1])
        h, hl, aggr = settings.hidden_dims, settings.hidden_layers, settings.mesh_aggr
        self.num_levels = len(graph.level_hw)
        self.num_embedded = self._embedded_levels or self.num_levels
        self.grid_embed = MLP(num_input_features, h, h, hl)
        for l in range(self.num_embedded):
            self.add_module(f"mesh_embed_{l}", MLP(2, h, h, hl))
        self.g2m = LatticeEncodeDecode(h, 3, hl, aggr, kind="nearest")
        self._build_processor(h, hl, aggr)
        self.m2g = LatticeEncodeDecode(h, 3, hl, aggr, kind="corners")
        self.decoder = MLP(h, num_output_features, h, hl, layer_norm=False)

        if self.table_path:
            arrays, regular = graph_arrays(graph)
            #: prefix → K of the regular edge sets (m2g: 4, down_{l}: 1)
            self.regular = dict(regular)
            names = [f"mesh_pos_{l}" for l in range(self.num_embedded)] + [
                f"{prefix}_{k}" for prefix in self._table_prefixes() for k in TABLE_KEYS]
            for name in names:
                arr = arrays[name]
                dtype = np.float32 if np.issubdtype(arr.dtype, np.floating) else np.int64
                self.register_buffer(name, torch.as_tensor(np.asarray(arr, dtype)),
                                     persistent=False)
            return
        arrays = dict(graph.lattice_np)
        if count > 1:
            arrays.update({name: np.ascontiguousarray(Band(*band).cut(arrays[name], axis))
                           for name, axis in GRID_LAT_AXES.items()})
        for l in range(self.num_embedded):
            arrays[f"mesh_pos_{l}"] = graph.mesh_pos[l].reshape(*graph.level_hw[l], 2)
        for name, arr in arrays.items():
            if np.issubdtype(arr.dtype, np.floating):
                self.register_buffer(
                    name, torch.as_tensor(np.asarray(arr, np.float32)), persistent=False
                )
        # the m2g corner maps (int32), which the corner-hop kernel gathers by
        for name in ("lat_m2g_rows", "lat_m2g_cols"):
            self.register_buffer(name, torch.as_tensor(arrays[name]), persistent=False)

    def _build_processor(self, h: int, hl: int, aggr: str) -> None:
        raise NotImplementedError

    def _table_prefixes(self) -> List[str]:
        """The edge sets the model's gather-table path reads."""
        return ["g2m", "m2g"]

    @classmethod
    def build_graph(cls, settings: GraphModelSettings, meshgrid) -> GraphArtifacts:
        return build_graph_artifacts(np.asarray(meshgrid), settings)

    def _garr(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """A static graph buffer, cast to the activation dtype when it is
        a float one (the JAX package's ``_garr``): under bf16 the edge
        features, masks, counts and selection matrices are bf16 too."""
        t = getattr(self, name)
        return t.to(dtype) if t.is_floating_point() else t

    def _lat(self, prefix: str, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        out = {}
        for k in ("feats", "mask", "count", "ar", "ac", "sr", "sc", "rows", "cols"):
            name = f"lat_{prefix}_{k}"
            if hasattr(self, name):
                out[k] = self._garr(name, dtype)
        return out

    def _edges(self, prefix: str, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """An edge set's index tables and in-degrees (the JAX package's
        ``_edge_dict``), the counts in the activation dtype."""
        return {k: self._garr(f"{prefix}_{k}", dtype)
                for k in ("src", "dst", "src_table", "dst_table", "dst_count")}

    def _edge_embed(self, mlp: nn.Module, feats: torch.Tensor, b: int) -> torch.Tensor:
        """A static edge set's embedding broadcast over the batch, made
        contiguous: the kernel wrappers refuse a stride-0 batch."""
        e = mlp(feats)
        return e[None].expand((b,) + e.shape).contiguous()

    def _embed(self, x):
        """(grid_v, [mesh_v_l for each embedded level]): on the lattice
        path (B, H, W, h) and (B, lh, lw, h), on the table path
        (B, n_grid, h) and (B, N_l, h)."""
        b = x.shape[0]
        if not self.table_path:
            x = x.reshape(b, *self.grid_hw, x.shape[-1])
        grid_v = self.grid_embed(x)
        mesh_v = []
        for l in range(self.num_embedded):
            emb = getattr(self, f"mesh_embed_{l}")(self._garr(f"mesh_pos_{l}", x.dtype))
            mesh_v.append(emb[None].expand((b,) + emb.shape))
        return grid_v, mesh_v

    def _encode(self, grid_v, mesh_v0):
        """The g2m hop onto mesh level 0."""
        dt = grid_v.dtype
        if self.table_path:
            return self.g2m.table(grid_v, mesh_v0, self._garr("g2m_feats", dt),
                                  self._edges("g2m", dt))
        return self.g2m(grid_v, mesh_v0, self._lat("g2m", dt))

    def _decode(self, mesh_v0, grid_v):
        """m2g, decode, and flatten back to the (B, n_grid, F) GRAPH contract."""
        dt = grid_v.dtype
        if self.table_path:
            hop = self.m2g.table(mesh_v0, grid_v, self._garr("m2g_feats", dt),
                                 self._edges("m2g", dt), regular_k=self.regular.get("m2g"))
        else:
            hop = self.m2g(mesh_v0, grid_v, self._lat("m2g", dt))
        out = self.decoder(hop)
        return out.reshape(grid_v.shape[0], -1, out.shape[-1])


class GraphLAM(_GraphModelBase):
    """Multiscale GNN on a GraphCast-style nested multi-mesh: a single
    mesh node set (level 0) whose edge set is the union of 8-neighbor
    edges at every coarsening scale; per level on the lattice path, the
    deduplicated union on the table path."""

    _lattice_need_multi = True
    _embedded_levels = 1

    def _build_processor(self, h, hl, aggr):
        self.mesh_edge_embed = MLP(3, h, h, hl)
        self.processor = nn.ModuleList(
            _LatticeFlatStep(h, hl, aggr) for _ in range(self.settings.processor_layers)
        )

    def _table_prefixes(self):
        return super()._table_prefixes() + ["multi"]

    def forward(self, x):
        b, dt = x.shape[0], x.dtype
        grid_v, (mesh_v0,) = self._embed(x)
        v0 = self._encode(grid_v, mesh_v0)
        if self.table_path:
            e = self._edge_embed(self.mesh_edge_embed, self._garr("multi_feats", dt), b)
            edges = self._edges("multi", dt)
            for step in self.processor:
                v0, e = step.table(v0, e, edges)
            return self._decode(v0, grid_v)
        e_levels = tuple(
            self._edge_embed(self.mesh_edge_embed, self._garr(f"lat_multi_{lev}_feats", dt), b)
            for lev in range(self.num_levels)
        )
        multi = {
            f"lat_multi_{lev}_{k}": self._garr(f"lat_multi_{lev}_{k}", dt)
            for lev in range(self.num_levels) for k in ("mask", "sr", "sc")
        }
        multi["lat_multi_count"] = self._garr("lat_multi_count", dt)
        for step in self.processor:
            v0, e_levels = step(v0, e_levels, multi)
        return self._decode(v0, grid_v)


class _HierarchicalBase(_GraphModelBase):
    """HiLAM's and HiLAMParallel's shared forward: every level embedded,
    edge embeds ``intra_edge_embed_{l}``, ``up_edge_embed_{l}`` and
    ``down_edge_embed_{l}``, a processor of ``_step_kls`` layers over
    the hierarchy (lattices 125², 63², 32² at a 500×500 grid)."""

    _step_kls = None
    _KINDS = ("intra", "up", "down")

    def _build_processor(self, h, hl, aggr):
        L = self.num_levels
        for kind, n in zip(self._KINDS, (L, L - 1, L - 1)):
            for l in range(n):
                self.add_module(f"{kind}_edge_embed_{l}", MLP(3, h, h, hl))
        self.processor = nn.ModuleList(
            self._step_kls(h, hl, aggr, L) for _ in range(self.settings.processor_layers)
        )

    def _table_prefixes(self):
        L = self.num_levels
        return super()._table_prefixes() + [
            f"{kind}_{l}" for kind, n in zip(self._KINDS, (L, L - 1, L - 1)) for l in range(n)]

    def forward(self, x):
        L, b, dt = self.num_levels, x.shape[0], x.dtype
        grid_v, mesh_v = self._embed(x)
        mesh_v[0] = self._encode(grid_v, mesh_v[0])
        sets = [(kind, l) for kind, n in zip(self._KINDS, (L, L - 1, L - 1)) for l in range(n)]
        feats = "{}_{}_feats" if self.table_path else "lat_{}_{}_feats"
        edges = {kind: [] for kind in self._KINDS}
        for kind, l in sets:
            edges[kind].append(self._edge_embed(getattr(self, f"{kind}_edge_embed_{l}"),
                                                self._garr(feats.format(kind, l), dt), b))
        if self.table_path:
            static = {f"{kind}_{l}": self._edges(f"{kind}_{l}", dt) for kind, l in sets}
            down_ks = [self.regular.get(f"down_{l}") for l in range(L - 1)]
        else:
            static = {f"{kind}_{l}": self._lat(f"{kind}_{l}", dt) for kind, l in sets}
            down_ks = None
        intra_e, up_e, down_e = edges["intra"], edges["up"], edges["down"]
        for step in self.processor:
            mesh_v, intra_e, up_e, down_e = step(mesh_v, intra_e, up_e, down_e, static, down_ks)
        return self._decode(mesh_v[0], grid_v)


class HiLAM(_HierarchicalBase):
    """Hierarchical GNN: each processor layer sweeps up the mesh
    hierarchy, processing intra-level at each stop, then back down
    (Oskarsson et al. 2023). 2·(L−1) stencil stages a layer on the
    lattice path."""

    _step_kls = _LatticeHiLAMSweepStep


class HiLAMParallel(_HierarchicalBase):
    """HiLAM whose processor layers run every hierarchy edge set at once
    with separate messages and one node update a level. L stencil
    stages a layer on the lattice path."""

    _step_kls = _LatticeHiLAMParallelStep
