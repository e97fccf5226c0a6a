"""2D graph partitioning (paper sec. 2.2 + 3.1), in torch on the target device.

The JAX package partitions on the host with one global `np.lexsort` over
int64 keys.  At Graph500 scale 26 that is 2^31 keys; here the edge list is
walked twice in pieces of EDGE_PIECE edges instead, a stable counting sort
by (block, local column) -- by (block, local row) for the CSR twin: the
first walk counts every block's edges and every (block, key) pair, whose
exclusive cumsum is the offsets; the second places each piece's edges,
stably sorted within the piece, after the ones earlier pieces placed under
the same pair.  So the temporaries are a piece's worth whatever a block
holds, and the result equals the JAX `partition_2d` / `partition_2d_csr`
exactly: the same stable (block, column) or (block, row) order, so the
same offsets, indices and `nnz`.  `partition_edge_vals(_csr)` run the same
walk with per-edge values (SSSP's weights) as the payload, so they line up
with the indices by construction.

Every function also builds only a rectangle of the blocks (`local=`, one
rank's blocks in a process group) from an edge list that stays on the host
(a numpy array, memory-mapped or not), streamed to `device=` a piece at a
time: a rank never holds the whole edge list on its card.  The padded width
`e_max` is still the maximum over every block, which every rank counts the
same way, so the widths equal the whole grid's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Grid2D, LocalGraph2D

# edges handled per piece of a walk: bounds a piece's temporaries (its
# keys, their int64 stable sort and placement) to a few GiB whatever the
# edge count
EDGE_PIECE = 1 << 26


# ----------------------------------------------------------------------------
# Index maps (Python ints or tensors)
# ----------------------------------------------------------------------------

def owner_of(g, grid: Grid2D):
    """Vertex g -> (i, j) owner coordinates.  Block b = j*R + i."""
    b = g // grid.S
    return b % grid.R, b // grid.R


def local_row(g, grid: Grid2D):
    """Global row -> local row (valid on every processor in the owner's
    processor-row)."""
    return (g // grid.S // grid.R) * grid.S + g % grid.S


def local_col(g, grid: Grid2D):
    """Global col -> local col (valid on every processor in the owner's
    processor-column)."""
    return g % grid.n_cols_local


def row2col(lr, i, j, grid: Grid2D):
    """Owner-local row index -> owner-local col index (paper ROW2COL)."""
    return i * grid.S + (lr - j * grid.S)


def global_from_row(lr, i, grid: Grid2D):
    """Local row index -> global vertex id, for a processor in grid-row i."""
    m = lr // grid.S
    return (m * grid.R + i) * grid.S + lr % grid.S


def global_from_col(lc, j, grid: Grid2D):
    """Local col index -> global vertex id for processor-column j."""
    return j * grid.n_cols_local + lc


# ----------------------------------------------------------------------------
# 2D partition
# ----------------------------------------------------------------------------

def _pieces(edges, device, vals=None):
    """(u, v, values) int32 pieces of consecutive edges of a (2, E) edge
    list on `device`: views of a tensor already there, else copies of one
    piece at a time of a host array (numpy, memory-mapped ones included),
    so a host edge list is never on the device whole.  values: the
    piece's slice of `vals` (E,), or None."""
    for a in range(0, edges.shape[1], EDGE_PIECE):
        b = a + EDGE_PIECE
        u, v = (_on(edges[k, a:b], device, torch.int32) for k in range(2))
        yield u, v, None if vals is None else _on(vals[a:b], device)


def _on(x, device, dtype=None):
    """A tensor or host array (slice) as a tensor on device (a read-only
    array, a memory map's, is copied: torch takes writable memory only)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device, dtype=dtype)


def _block_of(u, v, grid: Grid2D):
    """Owning processor p = i*C + j of each edge (u, v)."""
    pi = (v // grid.S) % grid.R
    pj = u // grid.n_cols_local
    return pi * grid.C + pj


def _local_block(b, local, grid: Grid2D):
    """Processor p = i*C + j -> its index in the rectangle `local`
    (i0, j0, Rl, Cl), row-major; -1 outside it."""
    i0, j0, Rl, Cl = local
    bi, bj = b // grid.C - i0, b % grid.C - j0
    inside = (bi >= 0) & (bi < Rl) & (bj >= 0) & (bj < Cl)
    return torch.where(inside, bi * Cl + bj, -1)


def _pair_slots(u, v, grid: Grid2D, local, by_row: bool, n_keys: int):
    """Every edge's (block, key) slot lb * n_keys + key (int64) among the
    rectangle's blocks, the edge's block b = i*C + j, and the mask of the
    edges the rectangle holds."""
    b = _block_of(u, v, grid)
    lb = _local_block(b, local, grid)
    key = local_row(v, grid) if by_row else local_col(u, grid)
    mine = lb >= 0
    return lb.long() * n_keys + key, b, mine


def _partition(edges, grid: Grid2D, pad_to, *, by_row: bool, vals=None,
               ids: bool = True, local=None, device=None):
    """The two walks shared by the CSC and CSR layouts and their edge
    values: every block's edges stably sorted by local column (by local
    row when `by_row`), as a counting sort (see the module docstring).

    edges: (2, E) tensor, or host array streamed to `device` a piece at a
    time (`_pieces`); vals: (E,) aligned values, the same kinds.  local: a
    `dist.topology.LocalBlock` -- only its (Rl, Cl) blocks are built (None
    = every block).  device: where the blocks are built (None = the edge
    tensor's device).  Returns (every block's edge count, offsets
    (Rl, Cl, n_keys + 1) int32, the other endpoint's local index
    (Rl, Cl, e_max) padded -1 or None without `ids`, and `vals` laid out
    alike padded 0 or None); raises if `pad_to` is below a block's
    count."""
    if device is None:
        device = edges.device
    if vals is not None and tuple(vals.shape) != (edges.shape[1],):
        raise ValueError(f"{vals.shape[0]} edge values for {edges.shape[1]} "
                         f"edges")
    n_keys = grid.n_rows_local if by_row else grid.n_cols_local
    rect = (0, 0, grid.R, grid.C) if local is None \
        else (local.i0, local.j0, local.Rl, local.Cl)
    Rl, Cl = rect[2:]
    L = Rl * Cl
    # walk 1: every block's count (the padded width is the maximum over
    # the whole grid, whichever blocks are built) and every pair's
    counts = torch.zeros(grid.P, dtype=torch.int64, device=device)
    pairs = torch.zeros(L * n_keys, dtype=torch.int64, device=device)
    for u, v, _ in _pieces(edges, device):
        slot, b, mine = _pair_slots(u, v, grid, rect, by_row, n_keys)
        counts += torch.bincount(b, minlength=grid.P)
        slot = slot[mine]
        pairs.index_add_(0, slot, torch.ones_like(slot))
        del slot, b, mine
    counts = counts.tolist()
    e_max = pad_to if pad_to is not None else max(counts)
    for p, cnt in enumerate(counts):
        if cnt > e_max:
            raise ValueError(
                f"pad_to={e_max} < local nnz {cnt} at "
                f"P({p // grid.C},{p % grid.C})")
    off = torch.zeros((L, n_keys + 1), dtype=torch.int32, device=device)
    off[:, 1:] = torch.cumsum(pairs.view(L, n_keys), dim=1)
    # each pair's next free position in its block's row
    cursor = off[:, :-1].reshape(-1).to(torch.int64)
    del pairs
    idx = torch.full((L, e_max), -1, dtype=torch.int32, device=device) \
        if ids else None
    vout = None
    if vals is not None:
        vdt = vals.dtype if isinstance(vals, torch.Tensor) \
            else torch.from_numpy(np.zeros(0, vals.dtype)).dtype
        vout = torch.zeros((L, e_max), dtype=vdt, device=device)
    # walk 2: place each piece's edges, in input order within a pair
    for u, v, w in _pieces(edges, device, vals):
        slot, _, mine = _pair_slots(u, v, grid, rect, by_row, n_keys)
        slot = slot[mine]
        sv, order = torch.sort(slot, stable=True)
        rank = torch.arange(sv.shape[0], dtype=torch.int64, device=device) \
            - torch.searchsorted(sv, sv)
        dest = (sv // n_keys) * e_max + cursor[sv] + rank
        cursor.index_add_(0, slot, torch.ones_like(slot))
        del slot, sv, rank
        if ids:
            other = local_col(u, grid) if by_row else local_row(v, grid)
            idx.view(-1)[dest] = other[mine][order]
        if w is not None:
            vout.view(-1)[dest] = w[mine][order]
        del dest, order, mine
    return (counts, off.view(Rl, Cl, n_keys + 1),
            None if idx is None else idx.view(Rl, Cl, e_max),
            None if vout is None else vout.view(Rl, Cl, e_max))


def _nnz(counts, grid: Grid2D, local, device):
    """The built blocks' (Rl, Cl) int32 edge counts."""
    nnz = torch.tensor(counts, dtype=torch.int32).reshape(grid.R, grid.C)
    if local is not None:
        nnz = nnz[local.i0:local.i0 + local.Rl, local.j0:local.j0 + local.Cl]
    return nnz.contiguous().to(device)


def partition_2d(edges, grid: Grid2D, pad_to: int | None = None, *,
                 local=None, device=None) -> LocalGraph2D:
    """Split a directed (2, E) int32 edge list [src u, dst v] among the grid.

    Edge (u, v) belongs to P_ij with i = (v // S) % R and j = u // (N/C).
    The blocks are built on `edges.device` (or `device`, see `_partition`
    for `local=` and host edge lists).  Returns stacked col_off
    (R, C, N/C + 1), row_idx (R, C, e_max) padded -1, nnz (R, C) -- the
    (Rl, Cl) blocks of `local` only, when given.
    """
    return partition_2d_with_vals(edges, None, grid, pad_to, local=local,
                                  device=device)[0]


def partition_2d_with_vals(edges, vals, grid: Grid2D,
                           pad_to: int | None = None, *, local=None,
                           device=None):
    """`partition_2d` and `partition_edge_vals` in one walk over the
    edges: (LocalGraph2D, the values (.., e_max) in its CSC order, or None
    without `vals`)."""
    counts, col_off, row_idx, w = _partition(
        edges, grid, pad_to, by_row=False, vals=vals, local=local,
        device=device)
    return LocalGraph2D(col_off=col_off, row_idx=row_idx,
                        nnz=_nnz(counts, grid, local, col_off.device)), w


def partition_2d_csr(edges, grid: Grid2D, pad_to: int | None = None, *,
                     local=None, device=None) -> dict:
    """Row-major (CSR) twin of `partition_2d` for the bottom-up direction.

    Built block by block like the CSC: the block's edges in input order,
    stable-sorted by local row, so within a row `col_idx` keeps the input
    order -- the JAX `np.lexsort((lr, dev))` order exactly.  Returns
    dict(row_off=(R, C, N/R + 1), col_idx=(R, C, e_max) LOCAL columns
    padded -1, nnz=(R, C)), int32 (`local=`, `device=`: as `partition_2d`).
    """
    return partition_2d_csr_with_vals(edges, None, grid, pad_to, local=local,
                                      device=device)[0]


def partition_2d_csr_with_vals(edges, vals, grid: Grid2D,
                               pad_to: int | None = None, *, local=None,
                               device=None):
    """`partition_2d_csr` and `partition_edge_vals_csr` in one walk: (the
    CSR dict, the values in its order or None)."""
    counts, row_off, col_idx, w = _partition(
        edges, grid, pad_to, by_row=True, vals=vals, local=local,
        device=device)
    return dict(row_off=row_off, col_idx=col_idx,
                nnz=_nnz(counts, grid, local, row_off.device)), w


def partition_edge_vals(edges, vals, grid: Grid2D, pad_to: int | None = None,
                        *, local=None, device=None):
    """Per-edge values laid out in `partition_2d`'s CSC order.

    vals: (E,) tensor aligned with the `edges` columns, on their device
    (uint8 weights for SSSP).  Returns (R, C, e_max) of vals' dtype, padded
    0: entry [i, j, k] is the value of the edge `partition_2d` put at
    row_idx[i, j, k] -- the same walk with the values as the payload, so
    the order equals the JAX `np.lexsort((lc, dev))` by construction.
    `local=`, `device=`: as `partition_2d`."""
    return _partition(edges, grid, pad_to, by_row=False, vals=vals,
                      ids=False, local=local, device=device)[3]


def partition_edge_vals_csr(edges, vals, grid: Grid2D,
                            pad_to: int | None = None, *, local=None,
                            device=None):
    """Per-edge values laid out in `partition_2d_csr`'s CSR order (the
    direction-optimised SSSP pulls over this copy)."""
    return _partition(edges, grid, pad_to, by_row=True, vals=vals,
                      ids=False, local=local, device=device)[3]


# ----------------------------------------------------------------------------
# 1D baseline partition (the paper's ORIGINAL code [1]: modulo rule)
# ----------------------------------------------------------------------------

def partition_1d(edges, n: int, P: int, pad_to: int | None = None):
    """Vertices assigned by modulo rule; each processor stores the full
    adjacency lists (CSC columns) of its own vertices.

    edges: (2, E) integer tensor.  Returns the JAX package's dict, on the
    edges' device: per-processor CSC over local columns (n/P columns,
    column k on processor p is vertex k*P + p) -- col_off (P, n/P + 1)
    int32, row_idx (P, e_max) int32 GLOBAL dst ids padded -1, nnz (P,)
    int32 -- and the ints n and P.  Within a column the rows keep the
    input order (JAX's `np.lexsort((lc, dev))`): one counting sort of the
    edges by (processor, local column)."""
    from repro_torch.graphgen.build import group_by_key

    if n % P:
        raise ValueError("n must be divisible by P (pad first)")
    u = edges[0].long()
    ncl = n // P
    off, rows = group_by_key((u % P) * ncl + u // P, edges[1], n)
    bounds = off[::ncl]                     # (P + 1,) each processor's span
    nnz = (bounds[1:] - bounds[:-1]).to(torch.int32)
    counts = nnz.tolist()
    e_max = pad_to if pad_to is not None else max(counts)
    for p, cnt in enumerate(counts):
        if cnt > e_max:
            raise ValueError(f"pad_to={e_max} < local nnz {cnt} at P({p})")
    col_off = off[:-1].view(P, ncl)
    col_off = torch.cat([col_off, bounds[1:, None]], dim=1) \
        - bounds[:-1, None]
    row_idx = torch.full((P, e_max), -1, dtype=torch.int32,
                         device=rows.device)
    for p, cnt in enumerate(counts):
        a = int(bounds[p])
        row_idx[p, :cnt] = rows[a:a + cnt]
    return dict(col_off=col_off.to(torch.int32), row_idx=row_idx, nnz=nnz,
                n=n, P=P)
