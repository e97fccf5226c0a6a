"""CSR / CSC builders, the port of `repro/graphgen/build.py`.

The paper (sec. 3.1) stores each local adjacency block in Compressed Sparse
Column form -- two arrays only (column offsets and row indices), since all
non-zeroes equal 1.  The construction is a counting sort (degree histogram,
exclusive scan, stable placement), the scan-based construction the paper
runs through Thrust.  The placement walks the edge list in pieces of
EDGE_PIECE edges, as `core.partition` does: each piece's edges are stably
sorted by column and placed after the ones earlier pieces put in the same
column, so the temporaries are a piece's worth whatever the edge count and
the rows of a column keep the input order -- the JAX `argsort(stable=True)`
order exactly.

Offsets are int32, as in the JAX package.  JAX's `cumsum(dtype=int32)`
wraps once the edge count reaches 2^31 (R-MAT SCALE 26, edgefactor 16,
symmetrised, has exactly 2^31 edges), and its output is then no CSC; here
`build_csc` raises a ValueError naming the int32 limit instead
(`check_int32_offsets`).
"""
from __future__ import annotations

import numpy as np
import torch

# edges placed per piece: bounds the placement's temporaries (a piece's
# int64 keys, their stable sort and destinations)
EDGE_PIECE = 1 << 26
INT32_MAX = 2**31 - 1


def check_int32_offsets(n_edges: int) -> None:
    """Raise ValueError unless `n_edges` edges fit int32 offsets."""
    if n_edges > INT32_MAX:
        raise ValueError(
            f"{n_edges} edges do not fit int32 offsets (at most 2^31 - 1 = "
            f"{INT32_MAX}); the JAX package's int32 cumsum wraps there and "
            f"gives no CSC -- partition the graph over a grid "
            f"(core.partition_2d) instead")


def degrees(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Histogram of vertex ids in [0, n) as (n,) int32 (the degree when fed
    edge endpoints); ids >= n are dropped, as JAX's scatter drops them."""
    ids = ids.reshape(-1)
    ids = ids[ids < n] if ids.numel() and int(ids.max()) >= n else ids
    return torch.bincount(ids, minlength=n).to(torch.int32)


def build_csc(edges, n_cols: int, n_rows: int | None = None):
    """CSC of the directed edge set: column u holds the rows v of edges
    u -> v.

    edges: (2, E) integer tensor [src (= col), dst (= row)], src in
    [0, n_cols).  Returns (col_off (n_cols + 1,) int32, row_idx (E,)
    int32) on the edges' device; rows within a column are in input order
    (stable).  Raises ValueError past 2^31 - 1 edges."""
    return group_by_key(edges[0], edges[1], n_cols)


def build_csr(edges, n_rows: int, n_cols: int | None = None):
    """CSR: row v holds the cols u of edges u -> v (transpose access
    order)."""
    return group_by_key(edges[1], edges[0], n_rows)


def group_by_key(keys, values, n_keys: int):
    """The counting sort: `values` grouped by `keys` in [0, n_keys),
    stably, as (offsets (n_keys + 1,) int32, grouped values (E,) int32).
    Raises ValueError past 2^31 - 1 entries or for a key outside the
    range."""
    E = int(keys.shape[0])
    check_int32_offsets(E)
    dev = keys.device
    off = torch.zeros(n_keys + 1, dtype=torch.int32, device=dev)
    off[1:] = torch.cumsum(degrees(keys, n_keys), 0)
    if E and int(off[-1]) != E:
        raise ValueError(f"keys must lie in [0, {n_keys})")
    # each key's next free position
    cursor = off[:-1].to(torch.int64)
    out = torch.empty(E, dtype=torch.int32, device=dev)
    for a in range(0, E, EDGE_PIECE):
        k = keys[a:a + EDGE_PIECE].long()
        ks, order = torch.sort(k, stable=True)
        rank = torch.arange(ks.shape[0], dtype=torch.int64, device=dev) \
            - torch.searchsorted(ks, ks)
        out[cursor[ks] + rank] = values[a:a + EDGE_PIECE][order].to(
            torch.int32)
        cursor.index_add_(0, k, torch.ones_like(k))
        del k, ks, order, rank
    return off, out


def build_csc_np(edges: np.ndarray, n_cols: int):
    """numpy twin of build_csc for host-side partitioning of big graphs."""
    src = np.asarray(edges[0])
    dst = np.asarray(edges[1])
    deg = np.bincount(src, minlength=n_cols).astype(np.int64)
    col_off = np.zeros(n_cols + 1, np.int64)
    np.cumsum(deg, out=col_off[1:])
    order = np.argsort(src, kind="stable")
    return col_off.astype(np.int32), dst[order].astype(np.int32)
