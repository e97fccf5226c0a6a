"""Graph500 BFS output validation + TEPS accounting (paper sec. 4), the
port of `repro/core/validate.py` on torch tensors, so the rules run where
the graph lives; and the checks of connected components and SSSP outputs
(`validate_cc`, `validate_sssp`), tensor passes over the same edge list.

Checks (on the global (level, pred) result and the input edge list):
  1. root: level[root] == 0 and pred[root] == root;
  2. reachability consistency: level[v] >= 0  <=>  pred[v] >= 0;
  3. tree: for every visited v != root, pred[v] is visited and
     level[v] == level[pred[v]] + 1;
  4. tree edges exist in the graph;
  5. every input edge (u, v) with both endpoints visited satisfies
     |level[u] - level[v]| <= 1, and no edge joins visited to unvisited.

At Graph500 scale 26 the symmetrised edge list has 2^31 entries, so every
pass over it runs in pieces, and rule 4's sorted edge keys are built once
per graph (`EdgeIndex`), in pieces that fit beside the graph.

Across a process group (`validate_bfs_group`) every rank holds the fetched
(level, pred) and checks rules 4 and 5 over its own share of the edges
only: rule 4 by marking the tree edges its share holds (an all_reduce
merges the marks), and the first failing rule is agreed as a code (an
all_reduce of the minimum) before every rank raises the same message, the
JAX package's, in its order.
"""
from __future__ import annotations

import torch

from repro_torch.dist import multihost as MH

# edges per elementwise pass: bounds the temporaries of one pass
EDGE_PIECE = 1 << 27
# edge keys per sorted piece of an EdgeIndex
KEY_PIECE = 1 << 28


def _check(ok, msg: str) -> None:
    if not bool(ok):
        raise AssertionError(msg)


def _pieces(edges):
    for a in range(0, edges.shape[1], EDGE_PIECE):
        yield (edges[0, a:a + EDGE_PIECE].long(),
               edges[1, a:a + EDGE_PIECE].long())


class EdgeIndex:
    """The directed edge keys u * (n + 1) + v, sorted, split by source range
    into pieces of about KEY_PIECE keys: the membership test of rule 4.
    Build once per graph and pass to every `validate_bfs`."""

    def __init__(self, edges, n: int):
        self.stride = n + 1
        e = max(edges.shape[1], 1)
        n_pieces = -(-e // KEY_PIECE)
        self.src_per_piece = max(-(-n // n_pieces), 1)
        self.keys = []
        for p in range(n_pieces):
            lo = p * self.src_per_piece
            hi = lo + self.src_per_piece
            sel = []
            for u, v in _pieces(edges):
                mine = (u >= lo) & (u < hi)
                sel.append(u[mine] * self.stride + v[mine])
            self.keys.append(torch.sort(torch.cat(sel)).values)

    def contains(self, u, v):
        """Bool mask: is (u[k], v[k]) a directed edge?"""
        u, v = u.long(), v.long()
        key = u * self.stride + v
        found = torch.zeros_like(key, dtype=torch.bool)
        piece = u // self.src_per_piece
        for p, keys in enumerate(self.keys):
            mine = piece == p
            if keys.numel() == 0 or not bool(mine.any()):
                continue
            q = key[mine]
            pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
            found[mine] = keys[pos] == q
        return found


def _tree_rules(level, pred, root: int):
    """Rules 1-3, which read only level and pred; returns the visited
    vertices other than the root and their parents (int64)."""
    n = level.shape[0]
    _check(level[root] == 0, f"level[root]={int(level[root])}")
    _check(pred[root] == root, f"pred[root]={int(pred[root])}")

    vis = level >= 0
    _check(((pred >= 0) == vis).all(), "pred/level visited sets differ")

    w = torch.nonzero(vis).flatten()
    w = w[w != root]
    p = pred[w].long()
    _check((p < n).all(), "parent id out of range")
    _check((level[p] >= 0).all(), "parent not visited")
    _check((level[w] == level[p] + 1).all(), "tree edge not level+1")
    return w, p


def validate_bfs(edges, level, pred, root: int, index: EdgeIndex = None):
    """Raise AssertionError with a message on any rule violation.

    edges: (2, E) tensor; level / pred: (n,) tensors on the same device;
    index: the graph's EdgeIndex (built here when None)."""
    n = level.shape[0]
    w, p = _tree_rules(level, pred, root)

    # tree edges must exist in the graph (the input is symmetrised, so one
    # direction suffices)
    if index is None:
        index = EdgeIndex(edges, n)
    _check(index.contains(p, w).all(), "tree edge not in graph")

    for u, v in _pieces(edges):
        lu, lv = level[u], level[v]
        both = (lu >= 0) & (lv >= 0)
        _check(((lu - lv).abs() <= 1)[both].all(),
               "graph edge spans > 1 level")
        _check(not ((lu >= 0) ^ (lv >= 0)).any(),
               "edge joins visited and unvisited (incomplete BFS)")


# rules checked over a rank's share of the edges, in the order the JAX
# package checks them (the first failing one is reported); NONE = passed
GROUP_RULES = ("tree edge not in graph", "graph edge spans > 1 level",
               "edge joins visited and unvisited (incomplete BFS)")
NONE = len(GROUP_RULES)


def validate_bfs_group(pieces, level, pred, root: int, group=None):
    """`validate_bfs` across a process group: raise AssertionError on every
    rank, with the same message, on any rule violation.

    pieces: a callable returning an iterator of (u, v) int64 tensor pieces
    of this rank's share of the directed edges, on level's device (the
    shares of all ranks together are the edge list); level / pred: the
    whole (n,) outputs, the same on every rank; group: the ranks' process
    group (None = the world).  Rules 1-3 read only level and pred, so
    every rank reaches the same verdict alone; rule 4 marks the tree edges
    (pred[v], v) the share holds and merges the marks over the group;
    rule 5 checks the share.  Every rank then learns the first failing
    rule by one all_reduce, so all raise together or none does."""
    w, _ = _tree_rules(level, pred, root)
    found = torch.zeros(level.shape[0], dtype=torch.uint8,
                        device=level.device)
    span = cross = False
    for u, v in pieces():
        tree = (pred[v].long() == u) & (v != root)
        found[v[tree]] = 1
        lu, lv = level[u], level[v]
        both = (lu >= 0) & (lv >= 0)
        span = span or bool(((lu - lv).abs() > 1)[both].any())
        cross = cross or bool(((lu >= 0) ^ (lv >= 0)).any())
    found = MH.all_reduce_max_u8(found, group)
    codes = [k for k, bad in enumerate((not bool(found[w].all()), span,
                                        cross)) if bad]
    first = int(MH.all_reduce_i64([min(codes, default=NONE)], group,
                                  op="min")[0])
    if first < NONE:
        raise AssertionError(GROUP_RULES[first])


def validate_cc(edges, labels):
    """Raise AssertionError on a connected-components labelling that breaks
    a rule that every min-label fixpoint keeps: on a symmetrised edge list
    both endpoints of every edge carry one label; label[v] <= v; and
    label[label[v]] == label[v] (the label is a vertex labelled by itself).
    labels: (n,) tensor on the edges' device."""
    n = labels.shape[0]
    lab = labels.long()
    _check(((lab >= 0) & (lab <= torch.arange(n, device=lab.device))).all(),
           "a label above its vertex (or negative)")
    _check((lab[lab] == lab).all(), "label[label[v]] != label[v]")
    for u, v in _pieces(edges):
        _check((lab[u] == lab[v]).all(), "an edge joins two labels")


def validate_sssp(edges, weights, dist, root: int):
    """Raise AssertionError on shortest distances that break a rule of
    single-source shortest paths over non-negative weights: dist[root] ==
    0; an edge's endpoints are both reached or both unreached (the list is
    symmetrised); dist[v] <= dist[u] + w on every reached edge u -> v; and
    every reached v != root has an in-edge with equality.  dist: (n,)
    tensor, -1 = unreached; weights: (E,) aligned with edges."""
    n = dist.shape[0]
    _check(dist[root] == 0, f"dist[root]={int(dist[root])}")
    d = dist.long()
    tight = torch.zeros(n, dtype=torch.bool, device=dist.device)
    tight[root] = True
    for a, (u, v) in zip(range(0, edges.shape[1], EDGE_PIECE),
                         _pieces(edges)):
        du, dv = d[u], d[v]
        _check(((du >= 0) == (dv >= 0)).all(),
               "an edge joins reached and unreached vertices")
        via = du + weights[a:a + EDGE_PIECE].long()
        reached = du >= 0
        _check((dv <= via)[reached].all(), "dist[v] > dist[u] + w on an edge")
        tight[v[reached & (dv == via)]] = True
    _check((tight | (d < 0)).all(),
           "a reached vertex with no tight in-edge")


def count_component_edges(edges, level) -> int:
    """# directed input edge tuples with endpoints inside the component.
    Graph500 counts undirected input edges; our edge list is symmetrised, so
    divide by 2."""
    total = 0
    for u, v in _pieces(edges):
        total += int(((level[u] >= 0) & (level[v] >= 0)).sum())
    return total // 2


def teps(edges, level, seconds: float) -> float:
    """Traversed edges per second: the component's undirected input edges
    over the search's seconds."""
    return count_component_edges(edges, level) / max(seconds, 1e-12)


def harmonic_mean(xs) -> float:
    xs = [max(float(x), 1e-30) for x in xs]
    return len(xs) / sum(1.0 / x for x in xs)
