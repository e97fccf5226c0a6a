"""The paper's expand/fold communication pattern as distributed SpMM, the
port of `repro/core/spmm2d.py`.

y = A @ x with A 2D-partitioned exactly as in the BFS (paper sec. 2.2) and x
row-sharded by vertex-block owner:

  expand:  `row_gather` of the x-blocks within each processor-column ->
           every processor holds the x slice matching its local CSC
           columns (property (i));
  local:   y_partial[row] += w_e * x[col_e]  (a segment-sum over the
           block's edges);
  fold:    `col_all_to_all` of the C row segments of y_partial, then a sum
           over the senders -> each owner receives the summed y for its
           vertex block (property (ii)) -- JAX's `psum_scatter(...,
           tiled=True)` over the columns.

It runs on the port's topologies (`dist.topology`): a `StackedMesh` holds
the grid on one device, a `multihost.ProcessMesh` gives each rank its
block and the collectives cross the group (floats as bytes on its uint8
wire).

The local step accumulates a bounded chunk of edges at a time with
`index_add_`, so no (E, d) message tensor exists.  Masked edges (row
index -1) go to a sink row past the block's rows, which is dropped.  The
local step is a `torch.autograd.Function` whose backward is the transposed
chunked product (y's gradient gathered by row, added into x's by column),
so autograd keeps only the block's index arrays and weights.  Gradients
flow through the stacked grid's collectives (a broadcast view and a
transpose); a process group's wire carries bytes, so there the product is
forward-only and refuses a tensor that requires grad.  Only float
summation order differs from JAX (`index_add_` on CUDA is unordered).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import Grid2D, LocalGraph2D
from repro_torch.dist.topology import Topology

# messages one chunk of the local step may hold (bytes): bounds its memory
CHUNK_BYTES = 1 << 28


def _edge_chunk(d: int, itemsize: int) -> int:
    return max(1, CHUNK_BYTES // max(1, d * itemsize))


def _edge_ends(col_off, row_idx, lo: int, hi: int, nrl: int):
    """(local column clipped to the block, local row or the sink nrl) of
    edge slots lo .. hi - 1, int32.  JAX's `repeat(arange(ncl), deg,
    total_repeat_length=e_cap)` gives every slot past the last column the
    last column; those slots are masked by row_idx < 0 as in JAX."""
    ncl = col_off.shape[0] - 1
    pos = torch.arange(lo, hi, dtype=col_off.dtype, device=col_off.device)
    col = torch.searchsorted(col_off[1:], pos, right=True, out_int32=True)
    col = col.clamp_(max=ncl - 1)
    rows = row_idx[lo:hi]
    return col, torch.where(rows >= 0, rows, nrl)


def _product(src, n_out: int, weight, col_off, row_idx, nrl: int,
             chunk: int, transpose: bool):
    """out[row_e] += w_e * src[col_e] over every edge slot, a chunk at a
    time, masked slots at the sink row nrl (out has nrl + 1 rows); with
    `transpose` out[col_e] += w_e * src[row_e] (src then has the sink row,
    zero, and out ncl rows)."""
    out = src.new_zeros((n_out,) + tuple(src.shape[1:]))
    for lo in range(0, row_idx.shape[0], chunk):
        hi = min(lo + chunk, row_idx.shape[0])
        col, row = _edge_ends(col_off, row_idx, lo, hi, nrl)
        if transpose:
            col, row = row, col
        msg = src[col]
        if weight is not None:
            msg = msg * weight[lo:hi, None].to(src.dtype)
        out.index_add_(0, row, msg)
    return out


class _LocalSpMM(torch.autograd.Function):
    """One block's y_part (nrl, d) = sum over its edges of w_e *
    xcols[col_e] at row_e (masked edges dropped)."""

    @staticmethod
    def forward(ctx, xcols, col_off, row_idx, weight, nrl, chunk):
        ctx.save_for_backward(col_off, row_idx, weight)
        ctx.nrl, ctx.chunk, ctx.ncl = nrl, chunk, xcols.shape[0]
        return _product(xcols, nrl + 1, weight, col_off, row_idx, nrl, chunk,
                        transpose=False)[:nrl]

    @staticmethod
    def backward(ctx, gy):
        col_off, row_idx, weight = ctx.saved_tensors
        gy = torch.cat([gy, gy.new_zeros((1,) + tuple(gy.shape[1:]))])
        gx = _product(gy, ctx.ncl, weight, col_off, row_idx, ctx.nrl,
                      ctx.chunk, transpose=True)
        return gx, None, None, None, None, None


def _forward_only(topo, x) -> None:
    if topo.distributed and x.requires_grad:
        raise ValueError("spmm2d across a process group is forward-only: "
                         "its wire carries bytes, not gradients")


def spmm2d_device(topo, graph: LocalGraph2D, x_own, edge_weight=None):
    """The per-processor body on a topology's block.

    graph: the block's (Rl, Cl, ...) CSC arrays; x_own: (Rl, Cl, S, d)
    features of the vertices each processor owns; edge_weight: (Rl, Cl,
    e_max) per-edge weights (any numeric dtype, cast to x's) or None.
    Returns (Rl, Cl, S, d) aggregated features of the owned blocks."""
    grid = topo.grid
    _forward_only(topo, x_own)
    S, C, R, nrl = grid.S, grid.C, grid.R, grid.n_rows_local
    Rl, Cl = x_own.shape[:2]
    tail = tuple(x_own.shape[3:])
    chunk = _edge_chunk(math.prod(tail), x_own.element_size())
    xg = topo.row_gather(x_own)                          # (Rl, Cl, R, S, d)
    parts = []
    for li in range(Rl):
        for lj in range(Cl):
            xcols = xg[li, lj].reshape((R * S,) + tail)  # local-col order
            w = None if edge_weight is None else edge_weight[li, lj]
            parts.append(_LocalSpMM.apply(xcols, graph.col_off[li, lj],
                                          graph.row_idx[li, lj], w, nrl,
                                          chunk))
    y_part = torch.stack(parts).reshape((Rl, Cl, C, S) + tail)
    del parts
    # fold: row segment m of every processor goes to column m, summed there
    return topo.col_all_to_all(y_part).sum(dim=2)


def _blocks(a, topo, shape2):
    """A graph array with whole-grid (R, C, ...) or block (Rl, Cl, ...)
    leading dims -> the block's, on the topology's device."""
    loc = topo.local
    if tuple(a.shape[:2]) == shape2 and (loc.Rl, loc.Cl) != shape2:
        a = a[loc.i0:loc.i0 + loc.Rl, loc.j0:loc.j0 + loc.Cl]
    if tuple(a.shape[:2]) != (loc.Rl, loc.Cl):
        raise ValueError(f"graph array with leading dims "
                         f"{tuple(a.shape[:2])} fits neither the grid "
                         f"{shape2} nor the block ({loc.Rl}, {loc.Cl})")
    return a.to(topo.device)


def make_spmm2d(grid: Grid2D, mesh, row_axes=("r",), col_axes=("c",)):
    """The global SpMM over `mesh` (a `dist.compat.StackedMesh` or a
    `multihost.ProcessMesh`): (col_off, row_idx, nnz, x (n, d)) -> (n, d),
    x in vertex-block order (block b = j*R + i holds vertices [b*S,
    (b+1)*S)).  The graph arrays carry the whole grid's (R, C, ...) or,
    in a group, the rank's (Rl, Cl, ...) leading dims; `nnz` is unused,
    as in JAX.  The callable also takes `edge_weight=` (.., e_max) in the
    graph's layout.  In a group every rank passes the whole x and
    receives the whole y."""
    topo = Topology(grid, mesh, row_axes, col_axes)
    loc = topo.local
    R, C, S = grid.R, grid.C, grid.S

    def fn(col_off, row_idx, nnz, x, edge_weight=None):
        del nnz
        _forward_only(topo, x)
        x = x.to(topo.device)
        tail = tuple(x.shape[1:])
        if x.shape[0] != grid.n:
            raise ValueError(f"x has {x.shape[0]} rows, the grid {grid.n}")
        # vertex block j*R + i is processor (i, j)'s
        x_own = x.reshape((C, R, S) + tail).transpose(0, 1)
        x_own = x_own[loc.i0:loc.i0 + loc.Rl, loc.j0:loc.j0 + loc.Cl]
        g = LocalGraph2D(col_off=_blocks(col_off, topo, (R, C)),
                         row_idx=_blocks(row_idx, topo, (R, C)),
                         nnz=None)
        w = None if edge_weight is None else _blocks(edge_weight, topo,
                                                     (R, C))
        y = topo.fetch(spmm2d_device(topo, g, x_own, w))
        return y.transpose(0, 1).reshape((grid.n,) + tail)

    return fn


def spmm_reference(edges, x, n: int, edge_weight=None, *, dtype=None):
    """y[v] = sum over edges (u -> v) of w_e * x[u] straight from a (2, E)
    edge list (no partition), on x's device, CHUNK_BYTES of messages at a
    time: the plain reference a card check holds `make_spmm2d` to.  dtype:
    y's accumulation dtype (default x's), e.g. float64.  Returns (y, the
    sum of |w_e * x[u]| of each row in x's dtype: a scale for the error
    bound)."""
    dtype = dtype or x.dtype
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=dtype, device=x.device)
    mag = torch.zeros(y.shape, dtype=x.dtype, device=x.device)
    chunk = _edge_chunk(math.prod(y.shape[1:]), y.element_size())
    for lo in range(0, edges.shape[1], chunk):
        hi = min(lo + chunk, edges.shape[1])
        u = edges[0, lo:hi].to(x.device).long()
        v = edges[1, lo:hi].to(x.device).long()
        msg = x[u].to(dtype)
        if edge_weight is not None:
            msg = msg * edge_weight[lo:hi].to(x.device).to(dtype)[:, None]
        y.index_add_(0, v, msg)
        mag.index_add_(0, v, msg.abs_().to(x.dtype))
    return y, mag
