"""Reduced-scale analogs of the paper's real-world graphs (Table 3), the
port of `repro/graphgen/datasets.py`.

The four SNAP graphs are replaced by R-MAT graphs matched to each
dataset's (approximate) scale and edge factor as reported in the paper's
Table 3, reduced by `scale_reduction`.  The analog keeps the skew
(power-law-ish degree distribution) that makes these graphs interesting for
BFS load balance.  `scale_reduction=0` gives the paper's own scales: the
com-Friendster analog then has 2 * 27 * 2^25 = 1,811,939,328 directed
edges, which one H100 holds.
"""
from __future__ import annotations

from repro_torch.graphgen.rmat import rmat_edges

# name -> (paper_scale, paper_edge_factor)
REALWORLD_SPECS = {
    "com-LiveJournal": (22, 9),
    "soc-LiveJournal1": (22, 14),
    "com-Orkut": (22, 38),
    "com-Friendster": (25, 27),
}


def realworld_analog(name: str, generator=None, scale_reduction: int = 6,
                     device=None):
    """Return (edges, n, meta) for a reduced analog of a Table-3 graph:
    `rmat_edges` at scale max(8, paper_scale - scale_reduction) on
    `device` (None = CUDA), drawn from `generator`."""
    paper_scale, ef = REALWORLD_SPECS[name]
    scale = max(8, paper_scale - scale_reduction)
    edges = rmat_edges(scale, ef, generator, device)
    meta = dict(name=name, paper_scale=paper_scale, scale=scale,
                edge_factor=ef)
    return edges, 1 << scale, meta
