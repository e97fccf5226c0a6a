"""NumPy host references for the frontier programs (ground truth in tests),
a copy of `repro/algos/reference.py` (plain numpy, so copied unchanged).

Each matches the distributed program's semantics exactly:

  * `cc_reference`       -- fixpoint of min-label propagation along directed
                            edges (= component-min labels on a symmetrised
                            edge list);
  * `sssp_reference`     -- Dijkstra over non-negative integer weights;
  * `multi_bfs_reference`-- simultaneous wave from K sources, first wave
                            wins, min source INDEX breaks same-wave ties;
  * `k_hop_neighborhood` -- the union k-hop vertex set of a source set (the
                            GNN sampling primitive).

Inputs are numpy arrays (move tensors to the host first).
"""
from __future__ import annotations

import heapq

import numpy as np

_BIG = np.iinfo(np.int32).max


def cc_reference(edges, n: int) -> np.ndarray:
    """(n,) int32 labels: min vertex id with a directed path to each vertex
    (on a symmetrised edge list: the component's minimum id)."""
    u = np.asarray(edges[0], dtype=np.int64)
    v = np.asarray(edges[1], dtype=np.int64)
    labels = np.arange(n, dtype=np.int32)
    while True:
        new = labels.copy()
        np.minimum.at(new, v, labels[u])
        if (new == labels).all():
            return labels
        labels = new


def sssp_reference(edges, weights, n: int, root: int) -> np.ndarray:
    """(n,) int32 shortest distances from root, -1 = unreachable."""
    u = np.asarray(edges[0], dtype=np.int64)
    v = np.asarray(edges[1], dtype=np.int64)
    w = np.asarray(weights, dtype=np.int64)
    order = np.argsort(u, kind="stable")
    us, vs, ws = u[order], v[order], w[order]
    starts = np.searchsorted(us, np.arange(n + 1))
    dist = np.full(n, -1, np.int64)
    heap = [(0, int(root))]
    while heap:
        d, x = heapq.heappop(heap)
        if dist[x] >= 0:
            continue
        dist[x] = d
        for e in range(starts[x], starts[x + 1]):
            y = int(vs[e])
            if dist[y] < 0:
                heapq.heappush(heap, (d + int(ws[e]), y))
    return dist.astype(np.int32)


def multi_bfs_reference(edges, n: int, sources, max_levels: int | None = None):
    """Simultaneous BFS from `sources`; returns ((n,) level, (n,) src).

    level[v] = hops to the nearest source (-1 beyond `max_levels` or
    unreachable); src[v] = index into `sources` of the claiming source,
    same-wave ties broken by the minimum index.
    """
    u = np.asarray(edges[0], dtype=np.int64)
    v = np.asarray(edges[1], dtype=np.int64)
    order = np.argsort(u, kind="stable")
    us, vs = u[order], v[order]
    starts = np.searchsorted(us, np.arange(n + 1))
    level = np.full(n, -1, np.int32)
    src = np.full(n, -1, np.int32)
    for idx, s in enumerate(np.asarray(sources, dtype=np.int64)):
        if level[s] < 0:
            level[s], src[s] = 0, idx
    frontier = np.flatnonzero(level == 0)
    lvl = 1
    while frontier.size and (max_levels is None or lvl <= max_levels):
        cand: dict[int, int] = {}
        for x in frontier:
            for e in range(starts[x], starts[x + 1]):
                y = int(vs[e])
                if level[y] < 0:
                    c = cand.get(y, _BIG)
                    if src[x] < c:
                        cand[y] = int(src[x])
        for y, s in cand.items():
            level[y], src[y] = lvl, s
        frontier = np.fromiter(cand.keys(), dtype=np.int64,
                               count=len(cand))
        lvl += 1
    return level, src


def k_hop_neighborhood(edges, n: int, sources, k: int) -> np.ndarray:
    """Sorted vertex ids within k hops of any source (GNN sampling)."""
    level, _ = multi_bfs_reference(edges, n, sources, max_levels=k)
    return np.flatnonzero(level >= 0)
