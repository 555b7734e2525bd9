"""The spatial axis: lat bands and the collectives that join them.

A grid of H (padded) lat rows is cut into S contiguous bands of H / S
rows; spatial rank s holds rows ``[s·H/S, (s+1)·H/S)`` of every grid
tensor. Graph models flatten the grid row-major, so a band of the flat
``ngrid`` axis is a band of lat rows. A ``Band`` names this rank's band
and the process group of the S ranks that share one data index.

Five collectives join the bands, each an autograd ``Function``
(``gather_lat`` takes no gradient):

- ``halo_rows(x, top, bottom)``: ``x`` (B, H/S, W, C) with the
  ``top`` lat rows above it and the ``bottom`` rows below it around it,
  from the band above and the band below (or from every band a halo
  deeper than a band spans: ASPP's dilations on the deepest map), a
  ``fill`` (zeros; ``-inf`` for a max pool) beyond the global top and
  bottom (or, with ``clamp``, the global edge row repeated: a bilinear
  growth's edges). Its backward sends each halo row's gradient back to
  its owner, which adds it to its rows in a fixed order;
- ``band_all_reduce(x)``: the sum of every band's partial ``x`` (a
  GroupNorm's band statistics, the g2m hop's partial aggregate, EPA's
  token sums). Its backward all-reduces the cotangent: every band's
  partial reaches the sum that every rank goes on from;
- ``gather_rows(x, dim)``: the bands concatenated on ``dim``, with a
  gradient: its backward sums every band's cotangent of the whole in
  band order and keeps this band's rows (Segformer's reduced K/V);
- ``roll_rows(x, shift)``: ``torch.roll`` of the whole lat dim by
  ``shift``, each band trading ``|shift|`` edge rows with its neighbour
  across the wrap (Swin's shifted windows); its backward is the
  opposite roll;
- ``gather_lat(x, dim)``: the bands concatenated on ``dim``, for eval,
  predict, the observers and the writers.

Model code and the losses read this rank's band from ``current_band()``,
which ``on_band`` sets around a step; the module passes its mesh's band
where it calls a primitive itself, outside a step's forward (the logged
loss, the eval rows, ``gather_lat``), and a graph model is handed its
band at build only to cut its grid-side metadata. With no band (S = 1)
every primitive is the identity and the code path is the unsharded
one. The collectives run on the band's group (gloo on the CPU, NCCL on
cards); every rank of a group must call them in the same order, which
the same model on the same shapes does. Every exchange goes through
``_gather`` and ``_all_reduce``, which ``testing.run_on_bands`` stands
in for to run every band of a grid in one process.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


@dataclass(frozen=True)
class Band:
    """This rank's lat band: ``index`` s of ``count`` S, and ``group``,
    the process group of the S spatial ranks of its data index, in
    spatial order."""

    index: int
    count: int
    group: Optional[object] = field(default=None, compare=False, repr=False)

    def rows(self, n: int) -> slice:
        """This band's rows of an axis of ``n`` (global, padded) rows."""
        if n % self.count:
            raise ValueError(f"{n} lat rows do not split into {self.count} bands")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def cut(self, a, axis: int):
        """This band's rows of ``a`` (numpy or torch) along ``axis``."""
        index = [slice(None)] * a.ndim
        index[axis] = self.rows(a.shape[axis])
        return a[tuple(index)]


_CURRENT: Optional[Band] = None


def current_band() -> Optional[Band]:
    """The band model code runs on, None off the spatial axis."""
    return _CURRENT


@contextlib.contextmanager
def on_band(band: Optional[Band]):
    """Run the body on ``band`` (None or a band of one: unsharded)."""
    global _CURRENT
    saved = _CURRENT
    _CURRENT = band if band is not None and band.count > 1 else None
    try:
        yield
    finally:
        _CURRENT = saved


def _gather(t: torch.Tensor, band: Band):
    """Every band's ``t`` (the same shape on each), in band order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(band.count)]
    dist.all_gather(parts, t, group=band.group)
    return parts


def _all_reduce(t: torch.Tensor, band: Band) -> torch.Tensor:
    """The sum of every band's ``t`` (the same shape on each), on every
    band."""
    out = t.clone(memory_format=torch.contiguous_format)  # NCCL reduces dense rows
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=band.group)
    return out


def _edge_rows(x: torch.Tensor, row: int, n: int) -> torch.Tensor:
    """``n`` copies of ``x``'s lat row ``row`` (0 or -1)."""
    edge = x[:, row:row + 1] if row >= 0 else x[:, row:]
    return edge.expand((x.shape[0], n) + tuple(x.shape[2:]))


class _HaloRows(torch.autograd.Function):
    """``halo_rows``: each band sends its last ``top`` and first
    ``bottom`` rows (the whole band where those cover it) in one
    all-gather of the band group and keeps what its halo spans: the
    nearest band's edge rows, or whole bands and the edge rows of the
    farthest where the halo is deeper than a band; ``fill`` beyond the
    global edges. The backward gathers the halo rows' gradients the same
    way (a halo row beyond every band left out) and adds them to the rows
    they came from, in band order (with ``clamp``, the repeated global
    edge rows' gradients to the edge row itself)."""

    @staticmethod
    def forward(ctx, x, top: int, bottom: int, band: Band, clamp: bool, fill: float):
        ctx.top, ctx.bottom, ctx.band, ctx.clamp = top, bottom, band, clamp
        h = x.shape[1]
        if clamp and h < max(top, bottom):
            raise ValueError(f"a lat band of {h} rows cannot send a clamped halo of "
                             f"{max(top, bottom)}")
        t, b = min(top, h), min(bottom, h)
        whole = t + b >= h
        sent = x if whole else torch.cat([x[:, h - t:], x[:, :b]], dim=1)
        parts = _gather(sent, band)
        s, n = band.index, band.count
        halo_rows.bytes += (n - 1) * sent.numel() * sent.element_size()

        def beyond(rows, edge):
            if clamp:
                return _edge_rows(x, edge, rows)
            return x.new_full((x.shape[0], rows) + x.shape[2:], fill)

        # the bands above, farthest first, each as its last t rows; then
        # the bands below, nearest first, each as its first b rows
        above = [(parts[s - j][:, h - t:] if whole else parts[s - j][:, :t])
                 if s - j >= 0 else beyond(t, 0) for j in range(-(-top // h), 0, -1)]
        below = [(parts[s + j][:, :b] if whole else parts[s + j][:, t:])
                 if s + j < n else beyond(b, -1) for j in range(1, -(-bottom // h) + 1)]
        grown = [x]
        if top:
            above = torch.cat(above, dim=1)
            grown.insert(0, above[:, above.shape[1] - top:])
        if bottom:
            grown.append(torch.cat(below, dim=1)[:, :bottom])
        return torch.cat(grown, dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        top, bottom, band = ctx.top, ctx.bottom, ctx.band
        s, n = band.index, band.count
        h = g.shape[1] - top - bottom
        # a halo row farther than (S - 1) bands from its band lies beyond
        # the grid for every band: its gradient goes nowhere
        kt, kb = min(top, (n - 1) * h), min(bottom, (n - 1) * h)
        edges = torch.cat([g[:, top - kt:top], g[:, top + h:top + h + kb]], dim=1)
        parts = _gather(edges, band)
        halo_rows.bytes += (n - 1) * edges.numel() * edges.element_size()
        dx = g[:, top:top + h].clone()
        if ctx.clamp and s == 0 and top:
            dx[:, :1] += g[:, :top].sum(dim=1, keepdim=True)
        lo = s * h
        for other in range(n):
            # the rows of this band that band ``other``'s halo holds, in
            # global rows: its bottom halo for a band above, its top halo
            # for a band below; added in band order
            if other < s:
                first = (other + 1) * h
                start, end = lo, min(lo + h, first + kb)
                halo = parts[other][:, kt:]
            elif other > s:
                first = other * h - kt
                start, end = max(lo, first), lo + h
                halo = parts[other][:, :kt]
            else:
                continue
            if end > start:
                dx[:, start - lo:end - lo] += halo[:, start - first:end - first]
        if ctx.clamp and s == n - 1 and bottom:
            dx[:, h - 1:] += g[:, top + h:].sum(dim=1, keepdim=True)
        return dx, None, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, band: Optional[Band] = None,
              clamp: bool = False, fill: float = 0.0) -> torch.Tensor:
    """NHWC ``x`` (a band's rows) grown by the ``top`` lat rows above the
    band and the ``bottom`` rows below it, from the bands that hold them
    (several, where a halo is deeper than a band), ``fill`` beyond the
    global edges (the edge row repeated with ``clamp``, which takes a
    halo of at most a band); off a band, ``x`` padded with ``fill`` rows
    (with the edge rows repeated under ``clamp``)."""
    band = band or current_band()
    if band is None or band.count == 1:
        if clamp:
            return torch.cat([_edge_rows(x, 0, top), x, _edge_rows(x, -1, bottom)], dim=1)
        return F.pad(x, (0, 0, 0, 0, top, bottom), value=fill)
    if top == bottom == 0:
        return x
    return _HaloRows.apply(x, top, bottom, band, clamp, fill)


#: bytes this process received from the other bands in halo exchanges,
#: forward and backward, since the last reset: each exchange is an
#: all-gather of every band's edge rows, (S − 1)·min(top + bottom, H/S)
#: rows a call forward and (S − 1)·(top + bottom) rows (each side at
#: most (S − 1)·H/S) backward, of which a band keeps what its halo spans
halo_rows.bytes = 0


class _BandAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, band: Band):
        ctx.band = band
        return _all_reduce(x, band)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_reduce(g, ctx.band), None


def band_all_reduce(x: torch.Tensor, band: Optional[Band] = None) -> torch.Tensor:
    """The sum over the band group of every band's partial ``x``, on
    every band; its cotangent is all-reduced the same way. ``x`` itself
    off a band."""
    band = band or current_band()
    if band is None or band.count == 1:
        return x
    return _BandAllReduce.apply(x, band)


class _GatherRows(torch.autograd.Function):
    """``gather_rows``: an all-gather of the bands' ``x``; the backward
    all-gathers every band's cotangent of the whole and sums the slices
    of this band's rows in band order (a reduce-scatter whose sums
    repeat bit for bit)."""

    @staticmethod
    def forward(ctx, x, dim: int, band: Band):
        ctx.dim, ctx.band, ctx.size = dim, band, x.shape[dim]
        parts = _gather(x, band)
        gather_rows.bytes += (band.count - 1) * x.numel() * x.element_size()
        return torch.cat(parts, dim=dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        band, dim, size = ctx.band, ctx.dim, ctx.size
        parts = _gather(g, band)
        gather_rows.bytes += (band.count - 1) * g.numel() * g.element_size()
        dx = parts[0].narrow(dim, band.index * size, size).clone()
        for part in parts[1:]:
            dx += part.narrow(dim, band.index * size, size)
        return dx, None, None


def gather_rows(x: torch.Tensor, dim: int, band: Optional[Band] = None) -> torch.Tensor:
    """Every band's ``x`` concatenated on ``dim`` in band order, on every
    band, with a gradient: each band's rows get the sum over the bands of
    their cotangents. ``x`` itself off a band."""
    band = band or current_band()
    if band is None or band.count == 1:
        return x
    return _GatherRows.apply(x, dim, band)


#: bytes this process received from the other bands in ``gather_rows``,
#: forward and backward, since the last reset
gather_rows.bytes = 0


def _roll(x: torch.Tensor, shift: int, band: Band) -> torch.Tensor:
    """This band's rows of the whole lat dim rolled by ``shift``: the
    |shift| rows that leave one end of a band enter the next band's other
    end (band S − 1's wrap to band 0 and back)."""
    k, h = abs(shift), x.shape[1]
    if k > h:
        raise ValueError(f"a lat band of {h} rows cannot roll {k} rows across bands")
    s, n = band.index, band.count
    sent = x[:, h - k:] if shift > 0 else x[:, :k]
    parts = _gather(sent, band)
    roll_rows.bytes += (n - 1) * sent.numel() * sent.element_size()
    if shift > 0:
        return torch.cat([parts[(s - 1) % n], x[:, :h - k]], dim=1)
    return torch.cat([x[:, k:], parts[(s + 1) % n]], dim=1)


class _RollRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift: int, band: Band):
        ctx.shift, ctx.band = shift, band
        return _roll(x, shift, band)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _roll(g, -ctx.shift, ctx.band), None, None


def roll_rows(x: torch.Tensor, shift: int, band: Optional[Band] = None) -> torch.Tensor:
    """``torch.roll(x, shift, dims=1)`` of the whole lat dim, on a band's
    rows: at ``shift`` < 0 each band sends its first |shift| rows to the
    band before it (band 0 to band S − 1), at ``shift`` > 0 its last ones
    to the band after it. The backward is the opposite roll. Off a band,
    ``torch.roll``."""
    band = band or current_band()
    if band is None or band.count == 1:
        return torch.roll(x, shift, dims=1)
    if shift == 0:
        return x
    return _RollRows.apply(x, shift, band)


#: bytes this process received from the other bands in ``roll_rows``,
#: forward and backward, since the last reset
roll_rows.bytes = 0


def gather_lat(x: torch.Tensor, dim: int, band: Optional[Band] = None) -> torch.Tensor:
    """Every band's ``x`` concatenated on ``dim`` in band order: the
    whole grid on every rank of the band group (``x`` itself off a band).
    Takes no gradient."""
    band = band or current_band()
    if band is None or band.count == 1:
        return x
    return torch.cat(_gather(x.detach(), band), dim=dim)
