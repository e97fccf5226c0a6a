"""Uniform k-hop neighbour sampler (GraphSAGE; required for minibatch_lg),
the port's own copy of `repro/sparse/sampler.py` (pure numpy, so the same
seed draws the same neighbours bit for bit).

Host-side numpy over a CSR adjacency: sampling is data-pipeline work (the
paper's CPUs-as-coprocessors role), the sampled block is then a
static-shape device batch.  Sampling with replacement when deg > 0
(GraphSAGE standard); isolated vertices self-loop.
"""
from __future__ import annotations

import numpy as np


class NeighborSampler:
    def __init__(self, row_off: np.ndarray, col_idx: np.ndarray, seed: int = 0):
        self.row_off = np.asarray(row_off)
        self.col_idx = np.asarray(col_idx)
        self.rng = np.random.default_rng(seed)

    def sample_hop(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(B,) -> (B, fanout) sampled neighbour ids (self for isolated)."""
        lo = self.row_off[nodes]
        deg = self.row_off[nodes + 1] - lo
        r = self.rng.integers(0, 2**31, size=(nodes.size, fanout))
        pick = lo[:, None] + r % np.maximum(deg, 1)[:, None]
        nb = self.col_idx[pick]
        return np.where(deg[:, None] > 0, nb, nodes[:, None])

    def sample_block(self, seeds: np.ndarray, fanouts: list[int]) -> dict:
        """Layered block: returns dict with per-hop node sets + edges, all
        static shapes (B, prod(fanouts...)).

          nodes[0] = seeds (B,), nodes[k] (B * prod fanout_1..k,)
          edges[k] = (src=nodes[k], dst=repeat(nodes[k-1], fanout_k))
        """
        nodes = [np.asarray(seeds)]
        edges = []
        for f in fanouts:
            nb = self.sample_hop(nodes[-1], f)          # (cur, f)
            src = nb.reshape(-1)
            dst = np.repeat(np.arange(nodes[-1].size), f)
            edges.append((src, dst))
            nodes.append(src)
        return dict(nodes=nodes, edges=edges, fanouts=list(fanouts))
