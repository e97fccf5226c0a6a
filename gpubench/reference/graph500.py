"""Graph500's rules for a BFS tree and its TEPS arithmetic, as counts.

A frozen copy of `src/repro_torch/core/validate.py` as of the port's first
benchmark: the tree rules of `_tree_rules`, rule 4 as
`validate_bfs_group` checks it (mark every directed edge (u, v) with
pred[v] == u) and `teps`.  The edit: each rule counts the
vertices that break it instead of raising, so that the benchmark can print
the number beside its limit.  `count_component_edges`' arithmetic (the
directed entries inside the component, halved) is `graph.component_edges`,
done once for every component.  Rule 5 (levels
of an edge's ends differ by at most one, no edge leaves the reached set)
is not copied: the benchmark compares the levels with the reference's
hop counts, which is stricter.
"""
from __future__ import annotations

import torch

from gpubench.reference.graph import edge_pieces


def bad_preds(edges, level, pred, root: int) -> int:
    """Vertices whose parent breaks a rule: pred[root] == root; pred set
    exactly where level is; for every reached v != root, pred[v] is
    reached, one level up, and (pred[v], v) is an edge of the graph."""
    n = level.shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=level.device)
    bad[root] = bool(pred[root] != root) or bool(level[root] != 0)
    vis = level >= 0
    bad |= (pred >= 0) != vis
    w = torch.nonzero(vis).flatten()
    w = w[w != root]
    p = pred[w].long()
    p_ok = (p >= 0) & (p < n)
    pc = p.clamp(0, n - 1)
    tree_ok = p_ok & (level[pc] >= 0) & (level[w] == level[pc] + 1)
    found = torch.zeros(n, dtype=torch.bool, device=level.device)
    for _, u, v in edge_pieces(edges):
        hit = pred[v].long() == u
        found[v[hit]] = True
    bad[w] |= ~(tree_ok & found[w])
    return int(bad.sum())


def teps(edges_traversed: int, seconds: float) -> float:
    """Traversed edges per second."""
    return edges_traversed / max(seconds, 1e-12)
