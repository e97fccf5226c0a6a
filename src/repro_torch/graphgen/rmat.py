"""Graph500-style R-MAT (Kronecker) edge-list generator in plain torch, the
port of `repro/graphgen/rmat.py`.

The same construction as the JAX generator: one uniform draw per (edge,
bit level) picks the source bit with P(1) = C + D, a second picks the
destination bit with the conditional column probability of the chosen row
half; vertex labels are then randomly permuted and every edge gets its
opposite.  torch's generator cannot reproduce `jax.random`'s bits, so the
two packages give different graphs from the same seed; the tests feed the
port edges made by the JAX generator.

The JAX version materialises (scale, n_edges) float draws at once -- 112 GB
at scale 26.  Here the bits are drawn one level at a time for one batch of
edges at a time, straight into the (2, 2E) int32 output.  The steps are
also there on their own: `permute_labels` relabels an edge list, a batch
at a time, and `make_undirected` appends the opposites.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import resolve_device

A, B, C, D = 0.57, 0.19, 0.19, 0.05  # Graph500 defaults
BATCH = 1 << 24                      # edges generated per pass


def rmat_edges(scale: int, edge_factor: int = 16, generator=None,
               device=None, *, permute: bool = True,
               undirected: bool = True) -> torch.Tensor:
    """Generate an R-MAT graph edge list on `device`.

    Returns (2, E) int32 with E = edge_factor * 2**scale directed input
    edges, doubled to 2*E directed edges (the opposites appended after
    them) if `undirected`.  device: None = CUDA (raises without a card).
    generator: a torch.Generator on `device` (None: one seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if scale > 31:
        raise ValueError(f"scale={scale}: vertex ids are int32")
    n = 1 << scale
    n_edges = edge_factor * n
    out = torch.empty((2, 2 * n_edges if undirected else n_edges),
                      dtype=torch.int32, device=device)
    p_right_top = B / (A + B)
    p_right_bot = D / (C + D)
    for a in range(0, n_edges, BATCH):
        m = min(BATCH, n_edges - a)
        src = torch.zeros(m, dtype=torch.int32, device=device)
        dst = torch.zeros(m, dtype=torch.int32, device=device)
        for level in range(scale):
            u = torch.rand(m, generator=generator, device=device)
            u2 = torch.rand(m, generator=generator, device=device)
            src_bit = u >= A + B
            dst_bit = torch.where(src_bit, u2 < p_right_bot,
                                  u2 < p_right_top)
            weight = 1 << (scale - 1 - level)
            src += src_bit.to(torch.int32) * weight
            dst += dst_bit.to(torch.int32) * weight
        out[0, a:a + m] = src
        out[1, a:a + m] = dst
    if permute:
        perm = _permutation(n, generator, device)
        for a in range(0, n_edges, BATCH):
            b = min(a + BATCH, n_edges)
            out[:, a:b] = perm[out[:, a:b].long()]
    if undirected:
        out[0, n_edges:] = out[1, :n_edges]
        out[1, n_edges:] = out[0, :n_edges]
    return out


def _permutation(n: int, generator, device) -> torch.Tensor:
    """A random permutation of range(n) as int32 (the Graph500 scramble)."""
    return torch.randperm(n, generator=generator, device=device) \
        .to(torch.int32)


def permute_labels(edges: torch.Tensor, n: int,
                   generator=None) -> torch.Tensor:
    """Apply a random vertex relabeling (Graph500 'scramble'): perm[edges]
    for a permutation of range(n) drawn from `generator` (None: one on the
    edges' device seeded with 0), as a new int32 tensor, relabelled a
    batch of edges at a time."""
    device = edges.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    perm = _permutation(n, generator, device)
    out = torch.empty(tuple(edges.shape), dtype=torch.int32, device=device)
    for a in range(0, edges.shape[1], BATCH):
        out[:, a:a + BATCH] = perm[edges[:, a:a + BATCH].long()]
    return out


def make_undirected(edges: torch.Tensor) -> torch.Tensor:
    """Add the opposite of each edge (paper sec. 4): (2, 2E), the
    opposites after the edges."""
    return torch.cat([edges, edges.flip(0)], dim=1)
