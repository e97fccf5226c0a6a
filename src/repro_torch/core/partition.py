"""2D graph partitioning (paper sec. 2.2 + 3.1), in torch on the target device.

The JAX package partitions on the host with one global `np.lexsort` over
int64 keys.  At Graph500 scale 26 that is 2^31 keys; here every processor
block is built on its own instead -- mask the edges it owns, in input order,
then stable-sort them by local column (by local row for the CSR twin), in
column ranges of at most SORT_PIECE edges -- so the temporaries are a
fraction of one block's worth.  The result equals the JAX `partition_2d` /
`partition_2d_csr` exactly: the same stable (block, column) or (block, row)
order, so the same offsets, indices and `nnz`.  `partition_edge_vals(_csr)`
run the same walk with per-edge values (SSSP's weights) as the payload, so
they line up with the indices by construction.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Grid2D, LocalGraph2D

# edges handled per elementwise pass: bounds the int32/bool temporaries of a
# pass to a few hundred MB whatever the edge count
EDGE_PIECE = 1 << 26
# entries per stable sort: a sort of n int32 keys holds about 22 n bytes of
# outputs and scratch, so a block of 2^29 edges is sorted in key ranges
SORT_PIECE = 1 << 27


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

def _pieces(edges: torch.Tensor):
    """(u, v) int32 views of consecutive pieces of a (2, E) edge list."""
    for a in range(0, edges.shape[1], EDGE_PIECE):
        yield edges[0, a:a + EDGE_PIECE], edges[1, a:a + EDGE_PIECE]


def _block_of(u, v, grid: Grid2D):
    """Owning processor p = i*C + j of each edge (u, v)."""
    pi = (v // grid.S) % grid.R
    pj = u // grid.n_cols_local
    return pi * grid.C + pj


def _block_counts(edges: torch.Tensor, grid: Grid2D,
                  pad_to: int | None):
    """Every block's edge count (row-major p = i*C + j) and the padded
    width e_max; raises if `pad_to` is below a block's count."""
    counts = torch.zeros(grid.P, dtype=torch.int64, device=edges.device)
    for u, v in _pieces(edges):
        counts += torch.bincount(_block_of(u, v, grid), minlength=grid.P)
    counts = counts.tolist()
    e_max = pad_to if pad_to is not None else max(counts)
    for p, cnt in enumerate(counts):
        if cnt > e_max:
            raise ValueError(
                f"pad_to={e_max} < local nnz {cnt} at "
                f"P({p // grid.C},{p % grid.C})")
    return counts, e_max


def _block_edges(edges: torch.Tensor, grid: Grid2D, p: int, vals=None):
    """Block p's edges in input order as (local col, local row) int32, and
    their values when `vals` (E,) is given (else None)."""
    lc_parts, lr_parts, val_parts = [], [], []
    for a, (u, v) in zip(range(0, edges.shape[1], EDGE_PIECE),
                         _pieces(edges)):
        mine = _block_of(u, v, grid) == p
        lc_parts.append(local_col(u[mine], grid))
        lr_parts.append(local_row(v[mine], grid))
        if vals is not None:
            val_parts.append(vals[a:a + EDGE_PIECE][mine])
    return (torch.cat(lc_parts), torch.cat(lr_parts),
            torch.cat(val_parts) if vals is not None else None)


def _fill_sorted(out, key, vals, off):
    """out[:n] = vals stably sorted by key, in key ranges of at most about
    SORT_PIECE entries (a range holds whole keys, so the order equals one
    stable sort of everything).  off: (n_keys + 1,) int32 exclusive cumsum
    of the key counts."""
    n_keys = off.shape[0] - 1
    count = key.shape[0]
    n_pieces = max(1, -(-count // SORT_PIECE))
    targets = torch.arange(1, n_pieces, dtype=torch.int32,
                           device=key.device) * (count // n_pieces)
    cuts = torch.searchsorted(off[1:], targets, right=True)
    bounds = [0] + cuts.tolist() + [n_keys]
    starts = off[bounds].tolist()
    for a, b, ea, eb in zip(bounds, bounds[1:], starts, starts[1:]):
        if eb == ea:
            continue
        if n_pieces == 1:
            ks, vs = key, vals
        else:
            sel = (key >= a) & (key < b)
            ks, vs = key[sel], vals[sel]
            del sel
        out[ea:eb] = vs[torch.sort(ks, stable=True).indices]


def _partition(edges: torch.Tensor, grid: Grid2D, pad_to, *, by_row: bool,
               vals=None):
    """The block-by-block walk shared by the CSC and CSR layouts and their
    edge values: every block's edges stably sorted by local column
    (by local row when `by_row`).  Returns (per-block edge counts, offsets
    (R, C, n_keys + 1) int32, and the sorted payload (R, C, e_max): the
    other endpoint's local index padded -1, or `vals` (E,) padded 0)."""
    R, C = grid.R, grid.C
    n_keys = grid.n_rows_local if by_row else grid.n_cols_local
    dev = edges.device
    edges = edges.to(torch.int32)
    if vals is not None and vals.shape != (edges.shape[1],):
        raise ValueError(f"{vals.shape[0]} edge values for {edges.shape[1]} "
                         f"edges")
    counts, e_max = _block_counts(edges, grid, pad_to)
    off = torch.zeros((R, C, n_keys + 1), dtype=torch.int32, device=dev)
    out = torch.full((R, C, e_max), -1, dtype=torch.int32, device=dev) \
        if vals is None else torch.zeros((R, C, e_max), dtype=vals.dtype,
                                         device=dev)
    for i in range(R):
        for j in range(C):
            lc, lr, w = _block_edges(edges, grid, i * C + j, vals)
            key, payload = (lr, lc) if by_row else (lc, lr)
            off[i, j, 1:] = torch.cumsum(
                torch.bincount(key, minlength=n_keys), 0)
            _fill_sorted(out[i, j], key, payload if w is None else w,
                         off[i, j])
            del lc, lr, w, key, payload
    return counts, off, out


def partition_2d(edges: torch.Tensor, grid: Grid2D,
                 pad_to: int | None = None) -> LocalGraph2D:
    """Split a directed (2, E) int32 edge list [src u, dst v] among the grid.

    Edge (u, v) belongs to P_ij with i = (v // S) % R and j = u // (N/C).
    The blocks are built on `edges.device`.  Returns stacked
    col_off (R, C, N/C + 1), row_idx (R, C, e_max) padded -1, nnz (R, C).
    """
    counts, col_off, row_idx = _partition(edges, grid, pad_to, by_row=False)
    nnz = torch.tensor(counts, dtype=torch.int32,
                       device=edges.device).reshape(grid.R, grid.C)
    return LocalGraph2D(col_off=col_off, row_idx=row_idx, nnz=nnz)


def partition_2d_csr(edges: torch.Tensor, grid: Grid2D,
                     pad_to: int | None = None) -> dict:
    """Row-major (CSR) twin of `partition_2d` for the bottom-up direction.

    Built block by block like the CSC: the block's edges in input order,
    stable-sorted by local row, so within a row `col_idx` keeps the input
    order -- the JAX `np.lexsort((lr, dev))` order exactly.  Returns
    dict(row_off=(R, C, N/R + 1), col_idx=(R, C, e_max) LOCAL columns
    padded -1, nnz=(R, C)), int32.
    """
    counts, row_off, col_idx = _partition(edges, grid, pad_to, by_row=True)
    nnz = torch.tensor(counts, dtype=torch.int32,
                       device=edges.device).reshape(grid.R, grid.C)
    return dict(row_off=row_off, col_idx=col_idx, nnz=nnz)


def partition_edge_vals(edges: torch.Tensor, vals: torch.Tensor,
                        grid: Grid2D, pad_to: int | None = None):
    """Per-edge values laid out in `partition_2d`'s CSC order.

    vals: (E,) tensor aligned with the `edges` columns, on their device
    (uint8 weights for SSSP).  Returns (R, C, e_max) of vals' dtype, padded
    0: entry [i, j, k] is the value of the edge `partition_2d` put at
    row_idx[i, j, k] -- the same walk with the values as the payload, so
    the order equals the JAX `np.lexsort((lc, dev))` by construction."""
    return _partition(edges, grid, pad_to, by_row=False, vals=vals)[2]


def partition_edge_vals_csr(edges: torch.Tensor, vals: torch.Tensor,
                            grid: Grid2D, pad_to: int | None = None):
    """Per-edge values laid out in `partition_2d_csr`'s CSR order (the
    direction-optimised SSSP pulls over this copy)."""
    return _partition(edges, grid, pad_to, by_row=True, vals=vals)[2]
