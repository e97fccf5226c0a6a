"""Single-device BFS, the port of `repro/core/bfs_single.py`.

`bfs_reference_py` is the ground truth (a Python deque) the tests use; it
is the JAX package's numpy function, copied.  `bfs_single` is the paper's
local algorithm on one device: level-synchronous frontier expansion over a
CSC, with a deterministic scatter-min in place of atomics, so every newly
reached vertex's pred is its smallest frontier in-neighbour -- the JAX
function's levels and preds exactly.

The JAX function scans all E edges every level, masked to the frontier's
columns.  Only frontier edges can win the minimum, so here each level
scans just the frontier's columns, mapped from edge slots to frontier
vertices by a `searchsorted` over their degree scan, CHUNK edge slots at a
time (the minimum does not depend on the order, so the result is
bit-identical): a SCALE 26 graph's 2^31 edges would otherwise need int64
temporaries of 16 GiB a pass.  Padded row slots (`row_idx` < 0) are
inactive, as in JAX.  Plain torch, as the JAX function is plain JAX.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

I32_MAX = 2**31 - 1
# edge slots of the frontier's columns handled per pass
CHUNK = 1 << 26


def bfs_reference_py(col_off, row_idx, root: int, n: int):
    """Plain python BFS; returns (level, pred) int32 numpy arrays."""
    col_off = np.asarray(col_off)
    row_idx = np.asarray(row_idx)
    level = np.full(n, -1, np.int32)
    pred = np.full(n, -1, np.int32)
    level[root] = 0
    pred[root] = root
    q = deque([root])
    while q:
        u = q.popleft()
        for e in range(col_off[u], col_off[u + 1]):
            v = row_idx[e]
            if level[v] < 0:
                level[v] = level[u] + 1
                pred[v] = u
                q.append(v)
    return level, pred


def _expand_level(col_off, row_idx, front, cand) -> None:
    """One level: cand[v] = min(cand[v], u) over the edges u -> v of the
    frontier vertices `front` (int64, ascending), in place, CHUNK edge
    slots a pass."""
    start = col_off[front].long()
    deg = col_off[front + 1].long() - start
    ends = torch.cumsum(deg, 0)
    total = int(ends[-1])
    for a in range(0, total, CHUNK):
        k = torch.arange(a, min(a + CHUNK, total), dtype=torch.int64,
                         device=cand.device)
        f = torch.searchsorted(ends, k, right=True)
        v = row_idx[start[f] + k - (ends[f] - deg[f])].long()
        active = v >= 0
        cand.scatter_reduce_(0, v[active], front[f[active]].to(torch.int32),
                             "amin")


def bfs_single(col_off, row_idx, root: int):
    """Level-synchronous BFS on one device.  Returns (level, pred), (n,)
    int32 on the CSC's device.

    col_off: (n + 1,) int32 offsets; row_idx: int32 rows, padded with -1
    (within a column or past col_off[n])."""
    n = col_off.shape[0] - 1
    root = int(root)
    dev = col_off.device
    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pred = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[root] = 0
    pred[root] = root
    visited = torch.zeros((n,), dtype=torch.bool, device=dev)
    visited[root] = True
    front = torch.tensor([root], dtype=torch.int64, device=dev)
    cand = torch.empty((n,), dtype=torch.int32, device=dev)
    lvl = 1
    while front.numel():
        cand.fill_(I32_MAX)
        _expand_level(col_off, row_idx, front, cand)
        new = (cand < I32_MAX) & ~visited
        level[new] = lvl
        pred[new] = cand[new]
        visited |= new
        front = torch.nonzero(new).flatten()
        lvl += 1
    return level, pred
