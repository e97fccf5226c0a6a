"""The benchmark's own R-MAT (Kronecker) generator, Graph500's kernel 1
input.

A frozen copy of `src/repro_torch/graphgen/rmat.py` (`rmat_edges`,
`_permutation`) as of the port's first benchmark, so that a change to the
program cannot change the graphs the benchmark measures.  Two edits: a
batch holds 2^26 edges, not 2^24 (fewer, larger calls during set-up), and
the symmetrised weights (`symmetric_weights`) are new.

One uniform draw per (edge, bit level) picks the source bit with P(1) =
C + D, a second picks the destination bit with the conditional column
probability of the chosen row half; vertex labels are then randomly
permuted and every edge gets its opposite, appended after the edges.
"""
from __future__ import annotations

import torch

BATCH = 1 << 26                      # edges generated per pass


def rmat_edges(scale: int, edge_factor: int, abcd, generator,
               device) -> torch.Tensor:
    """(2, 2E) int32 on `device`: E = edge_factor * 2**scale input edges
    drawn from `generator` (a torch.Generator on `device`), then their
    opposites."""
    a_, b_, c_, d_ = abcd
    if scale > 31:
        raise ValueError(f"scale={scale}: vertex ids are int32")
    n = 1 << scale
    n_edges = edge_factor * n
    out = torch.empty((2, 2 * n_edges), dtype=torch.int32, device=device)
    p_right_top = b_ / (a_ + b_)
    p_right_bot = d_ / (c_ + d_)
    for a in range(0, n_edges, BATCH):
        m = min(BATCH, n_edges - a)
        src = torch.zeros(m, dtype=torch.int32, device=device)
        dst = torch.zeros(m, dtype=torch.int32, device=device)
        for level in range(scale):
            u = torch.rand(m, generator=generator, device=device)
            u2 = torch.rand(m, generator=generator, device=device)
            src_bit = u >= a_ + b_
            dst_bit = torch.where(src_bit, u2 < p_right_bot,
                                  u2 < p_right_top)
            weight = 1 << (scale - 1 - level)
            src += src_bit.to(torch.int32) * weight
            dst += dst_bit.to(torch.int32) * weight
        out[0, a:a + m] = src
        out[1, a:a + m] = dst
    perm = torch.randperm(n, generator=generator, device=device) \
        .to(torch.int32)
    for a in range(0, n_edges, BATCH):
        b = min(a + BATCH, n_edges)
        out[:, a:b] = perm[out[:, a:b].long()]
    out[0, n_edges:] = out[1, :n_edges]
    out[1, n_edges:] = out[0, :n_edges]
    return out


def symmetric_weights(n_input: int, low: int, high: int, generator,
                      device) -> torch.Tensor:
    """(2 * n_input,) uint8 weights uniform in low..high, one per input
    edge and the same on its opposite (Graph500 kernel 3 weighs the
    undirected edge)."""
    w = torch.randint(low, high + 1, (n_input,), dtype=torch.uint8,
                      generator=generator, device=device)
    return torch.cat([w, w])
