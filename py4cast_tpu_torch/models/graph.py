"""GraphLAM on the lattice: the multiscale mesh GNN in PyTorch.

The multiscale mesh is built once on the host in numpy
(``build_graph_artifacts``): regular coarsenings of the grid,
8-neighbor intra-level edges, nearest-neighbor g2m and surrounding-4
m2g edges. Message passing runs in lattice form (``ops/lattice_ops.py``)
— stencil shifts and separable 0/1 selection matmuls, no per-edge
gathers. On a CUDA device the two hot stages run as hand-written
kernels, forward and backward: the processor's stencil edge message
(``ops/stencil_kernel.py::StencilMessageFn``) and the m2g corner hop
(``ops/hop_kernel.py::CornerHopFn``).

Module and parameter names mirror the JAX package's param tree
(``grid_embed/Dense_0``, ``processor/block/edge/w_e``, ...), so
``convert.params_from_jax`` is a plain walk over that tree. Only the
lattice path is ported: the gather-table path (``use_lattice: false``,
or graphs whose multimesh union is not dedup-free) raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from py4cast_tpu_torch.models.base import ModelBase, ModelType
from py4cast_tpu_torch.ops.hop_kernel import CornerHopFn
from py4cast_tpu_torch.ops.lattice_ops import (
    DIRS8,
    pair_feats,
    sel_matrix,
    sep_aggregate,
    sep_take_mm,
    shift2d,
    stencil_feats,
)
from py4cast_tpu_torch.ops.stencil_kernel import StencilMessageFn

LN_EPS = 1e-6  # flax nn.LayerNorm default; torch's is 1e-5


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
    #: lattice-form message passing; the only path the port has
    use_lattice: bool = True


# -------------------------------------------------------- graph construction
@dataclass
class GraphArtifacts:
    """The static graph data of the lattice path. (The JAX package's
    artifacts also carry per-edge tables for the gather-table path,
    which is not ported.)"""

    n_grid: int
    mesh_pos: List[np.ndarray]  # per-level (Nl, 2) normalized positions
    grid_hw: Tuple[int, int]
    level_hw: List[Tuple[int, int]]
    lattice_np: dict
    #: the lattice multimesh equals the union of the levels' edge sets
    #: only when that union is dedup-free (fails on degenerate tiny
    #: lattices)
    multi_lattice_ok: bool


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

    # ---- nested multimesh: each level's 8-neighbor edges mapped onto
    # the level-0 node set via the nesting indices; the lattice form
    # needs their union to have no duplicate edge
    msrc, mdst = [], []
    lw0_ = level_hw[0][1]
    for level, (lh, lw) in enumerate(level_hw):
        s, t = _neighbors8(lh, lw)
        r0, c0 = row_in0[level], col_in0[level]
        to0 = (r0[:, None] * lw0_ + c0[None, :]).ravel()
        msrc.append(to0[s])
        mdst.append(to0[t])
    key = np.concatenate(msrc).astype(np.int64) * (lw0_ * level_hw[0][0]) + np.concatenate(mdst)
    multi_lattice_ok = len(np.unique(key)) == len(key)

    lat = _build_lattice_meta(pos, (h, w), mesh_pos, level_hw, row_in0, col_in0, settings)
    return GraphArtifacts(len(pos), mesh_pos, (h, w), level_hw, lat, multi_lattice_ok)


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
        self.LayerNorm_0 = nn.LayerNorm(out_dim, eps=LN_EPS) if layer_norm else None

    def forward(self, x):
        for i in range(self.hidden_layers):
            x = F.silu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.hidden_layers}")(x)
        return self.LayerNorm_0(x) if self.LayerNorm_0 is not None else x


class _StencilMessage(nn.Module):
    """Edge message on an 8-neighbor lattice stencil. Edge states live as
    (B, 8, H, W, h) arrays in DIRS8 order; each edge's source state
    arrives by a shift instead of a gather. With ``residual`` the first
    output is ``e + e_new``; agg always aggregates the raw e_new."""

    def __init__(self, v_dim: int, e_dim: int, hidden_dim: int,
                 hidden_layers: int = 1, residual: bool = False):
        super().__init__()
        h = hidden_dim
        self.hidden_layers = hidden_layers
        self.residual = residual
        self.w_s = nn.Linear(v_dim, h, bias=False)
        self.w_d = nn.Linear(v_dim, h, bias=False)
        self.w_e = nn.Linear(e_dim, h)
        for i in range(hidden_layers - 1):
            self.add_module(f"hidden_{i}", nn.Linear(h, h))
        self.out = nn.Linear(h, h)
        self.ln = nn.LayerNorm(h, eps=LN_EPS)

    def forward(self, v, e, mask):
        ps = self.w_s(v)
        pd = self.w_d(v)
        vs = torch.stack([shift2d(ps, di, dj) for di, dj in DIRS8], dim=1)
        if self.hidden_layers == 1:
            # the fused stage: CUDA kernels (forward and backward) on the
            # card, their plain versions on the CPU (ops/stencil_kernel.py)
            return StencilMessageFn.apply(
                e.contiguous(), vs, pd.contiguous(), mask,
                _kernel(self.w_e), self.w_e.bias, _kernel(self.out), self.out.bias,
                self.ln.weight, self.ln.bias, self.residual,
            )
        z = F.silu(self.w_e(e) + vs + pd[:, None])
        for i in range(self.hidden_layers - 1):
            z = F.silu(getattr(self, f"hidden_{i}")(z))
        e_new = self.ln(self.out(z))
        agg = (e_new * mask[None]).sum(dim=1)
        return (e + e_new if self.residual else e_new), agg


class LatticeEncodeDecode(nn.Module):
    """The encode/decode hop on the lattice: 'nearest' is the g2m hop
    (grid → mesh0), 'corners' the m2g hop (mesh0 → grid through the 4
    surrounding coarse cells)."""

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
        self.ln = nn.LayerNorm(h, eps=LN_EPS)
        self.node = MLP(2 * h, h, h, hidden_layers)

    def _tail(self, z):
        return self.ln(self.out(F.silu(z)))

    def forward(self, v_src, v_dst, lat: Dict[str, torch.Tensor]):
        ps = self.w_s(v_src)
        if self.kind == "nearest":
            pd = self.w_d(v_dst)
            pre = self.w_f(lat["feats"])[None] + ps + sep_take_mm(pd, lat["ar"], lat["ac"])
            agg = sep_aggregate(self._tail(pre), lat["ar"], lat["ac"])
            if self.aggr == "mean":
                agg = agg / torch.clamp(lat["count"][None], min=1.0)
            return v_dst + self.node(torch.cat([v_dst, agg], dim=-1))

        ar, ac = lat["ar"], lat["ac"]
        ps_g = [sep_take_mm(ps, ar[k // 2], ac[k % 2]).contiguous() for k in range(4)]
        if self.hidden_layers == 1:
            # the fused m2g hop: CUDA kernels (forward and backward) on
            # the card, their plain versions on the CPU (ops/hop_kernel.py)
            h = self.w_d.weight.shape[0]
            nd0 = _kernel(self.node.Dense_0)
            return CornerHopFn.apply(
                *ps_g, v_dst.contiguous(), lat["feats"],
                _kernel(self.w_f), self.w_f.bias, _kernel(self.w_d),
                _kernel(self.out), self.out.bias, self.ln.weight, self.ln.bias,
                nd0[:h].contiguous(), nd0[h:].contiguous(), self.node.Dense_0.bias,
                _kernel(self.node.Dense_1), self.node.Dense_1.bias,
                self.node.LayerNorm_0.weight, self.node.LayerNorm_0.bias,
                self.aggr == "mean",
            )
        pd = self.w_d(v_dst)
        pf = self.w_f(lat["feats"])  # (4, H, W, h)
        agg = sum(self._tail(pf[k] + ps_g[k] + pd) for k in range(4))
        if self.aggr == "mean":
            agg = agg / 4.0
        return v_dst + self.node(torch.cat([v_dst, agg], dim=-1))


class _LatticeUnionBlock(nn.Module):
    """The multimesh union interaction (one shared edge message + one
    node update) on the lattice: each mesh level is a dilated stencil on
    a level-0 sub-lattice; per-level aggregates are scattered back into
    the level-0 lattice with selection matmuls."""

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


class _LatticeFlatStep(nn.Module):
    """One multimesh processor layer on the lattice (GraphLAM)."""

    def __init__(self, hidden_dim: int, hidden_layers: int, aggr: str):
        super().__init__()
        self.block = _LatticeUnionBlock(hidden_dim, hidden_layers, aggr)

    def forward(self, v0, e_levels, lat):
        return self.block(v0, e_levels, lat)


class GraphLAM(ModelBase):
    """Multiscale GNN on a GraphCast-style nested multi-mesh: a single
    mesh node set (level 0) whose edge set is the union of 8-neighbor
    edges at every coarsening scale, in lattice form.

    Static graph arrays are non-persistent buffers: they follow the
    module to its device and stay out of the state dict."""

    settings_kls = GraphModelSettings
    model_type = ModelType.GRAPH
    supported_num_spatial_dims = (1,)

    def __init__(self, num_input_features: int, num_output_features: int,
                 input_shape: Tuple[int, ...], settings: GraphModelSettings,
                 graph: GraphArtifacts):
        super().__init__(num_input_features, num_output_features, input_shape, settings)
        if not (settings.use_lattice and graph.multi_lattice_ok):
            raise NotImplementedError(
                "py4cast_tpu_torch runs GraphLAM only on the lattice path; the "
                "gather-table path (use_lattice: false, or a graph whose "
                "multimesh union is not dedup-free) is not ported yet "
                "(ROADMAP.md, queue 1 item 11)"
            )
        self.graph = graph
        h, hl, aggr = settings.hidden_dims, settings.hidden_layers, settings.mesh_aggr
        self.grid_embed = MLP(num_input_features, h, h, hl)
        self.mesh_embed_0 = MLP(2, h, h, hl)
        self.g2m = LatticeEncodeDecode(h, 3, hl, aggr, kind="nearest")
        self.mesh_edge_embed = MLP(3, h, h, hl)
        self.processor = nn.ModuleList(
            _LatticeFlatStep(h, hl, aggr) for _ in range(settings.processor_layers)
        )
        self.m2g = LatticeEncodeDecode(h, 3, hl, aggr, kind="corners")
        self.decoder = MLP(h, num_output_features, h, hl, layer_norm=False)

        arrays = dict(graph.lattice_np)
        arrays["mesh_pos_0"] = graph.mesh_pos[0].reshape(*graph.level_hw[0], 2)
        for name, arr in arrays.items():
            if np.issubdtype(arr.dtype, np.floating):
                self.register_buffer(
                    name, torch.as_tensor(np.asarray(arr, np.float32)), persistent=False
                )

    @classmethod
    def build_graph(cls, settings: GraphModelSettings, meshgrid) -> GraphArtifacts:
        return build_graph_artifacts(np.asarray(meshgrid), settings)

    def _lat(self, prefix: str) -> Dict[str, torch.Tensor]:
        out = {}
        for k in ("feats", "mask", "count", "ar", "ac", "sr", "sc"):
            name = f"lat_{prefix}_{k}"
            if hasattr(self, name):
                out[k] = getattr(self, name)
        return out

    def forward(self, x):
        g, s = self.graph, self.settings
        b = x.shape[0]
        gh, gw = g.grid_hw
        lh, lw = g.level_hw[0]
        grid_v = self.grid_embed(x.reshape(b, gh, gw, x.shape[-1]))
        mesh_v0 = self.mesh_embed_0(self.mesh_pos_0)[None].expand(b, lh, lw, s.hidden_dims)
        v0 = self.g2m(grid_v, mesh_v0, self._lat("g2m"))
        e_levels = tuple(
            self.mesh_edge_embed(feats)[None].expand((b,) + feats.shape[:-1] + (s.hidden_dims,))
            .contiguous()
            for feats in (getattr(self, f"lat_multi_{lev}_feats") for lev in range(len(g.level_hw)))
        )
        multi = {
            f"lat_multi_{lev}_{k}": getattr(self, f"lat_multi_{lev}_{k}")
            for lev in range(len(g.level_hw)) for k in ("mask", "sr", "sc")
        }
        multi["lat_multi_count"] = self.lat_multi_count
        for step in self.processor:
            v0, e_levels = step(v0, e_levels, multi)
        grid_out = self.m2g(v0, grid_v, self._lat("m2g"))
        out = self.decoder(grid_out)
        return out.reshape(b, g.n_grid, out.shape[-1])
