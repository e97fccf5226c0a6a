"""2D graph partitioning (paper sec. 2.2 + 3.1), in torch on the target device.

The JAX package partitions on the host with one global `np.lexsort` over
int64 keys.  At Graph500 scale 26 that is 2^31 keys; here every processor
block is built on its own instead -- mask the edges it owns, in input order,
then stable-sort them by local column -- so the temporaries are one block's
worth.  The result equals the JAX `partition_2d` exactly: the same stable
(block, column) order, so the same `col_off`, `row_idx` order and `nnz`.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Grid2D, LocalGraph2D

# edges handled per elementwise pass: bounds the int32/bool temporaries of a
# pass to a few hundred MB whatever the edge count
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

def _pieces(edges: torch.Tensor):
    """(u, v) int32 views of consecutive pieces of a (2, E) edge list."""
    for a in range(0, edges.shape[1], EDGE_PIECE):
        yield edges[0, a:a + EDGE_PIECE], edges[1, a:a + EDGE_PIECE]


def _block_of(u, v, grid: Grid2D):
    """Owning processor p = i*C + j of each edge (u, v)."""
    pi = (v // grid.S) % grid.R
    pj = u // grid.n_cols_local
    return pi * grid.C + pj


def partition_2d(edges: torch.Tensor, grid: Grid2D,
                 pad_to: int | None = None) -> LocalGraph2D:
    """Split a directed (2, E) int32 edge list [src u, dst v] among the grid.

    Edge (u, v) belongs to P_ij with i = (v // S) % R and j = u // (N/C).
    The blocks are built on `edges.device`.  Returns stacked
    col_off (R, C, N/C + 1), row_idx (R, C, e_max) padded -1, nnz (R, C).
    """
    R, C = grid.R, grid.C
    ncl = grid.n_cols_local
    dev = edges.device
    edges = edges.to(torch.int32)

    counts = torch.zeros(R * C, dtype=torch.int64, device=dev)
    for u, v in _pieces(edges):
        counts += torch.bincount(_block_of(u, v, grid), minlength=R * C)
    counts = counts.tolist()
    e_max = pad_to if pad_to is not None else max(counts)
    for p, cnt in enumerate(counts):
        if cnt > e_max:
            raise ValueError(
                f"pad_to={e_max} < local nnz {cnt} at P({p // C},{p % C})")

    col_off = torch.zeros((R, C, ncl + 1), dtype=torch.int32, device=dev)
    row_idx = torch.full((R, C, e_max), -1, dtype=torch.int32, device=dev)
    for i in range(R):
        for j in range(C):
            p = i * C + j
            lc_parts, lr_parts = [], []
            for u, v in _pieces(edges):
                mine = _block_of(u, v, grid) == p
                lc_parts.append(local_col(u[mine], grid))
                lr_parts.append(local_row(v[mine], grid))
            lc = torch.cat(lc_parts)
            lr = torch.cat(lr_parts)
            del lc_parts, lr_parts
            deg = torch.bincount(lc, minlength=ncl)
            col_off[i, j, 1:] = torch.cumsum(deg, 0)
            lc_sorted, order = torch.sort(lc, stable=True)
            del lc, lc_sorted
            row_idx[i, j, :counts[p]] = lr[order]
            del lr, order
    nnz = torch.tensor(counts, dtype=torch.int32, device=dev).reshape(R, C)
    return LocalGraph2D(col_off=col_off, row_idx=row_idx, nnz=nnz)
