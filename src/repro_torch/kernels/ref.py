"""Plain-torch oracles of the kernel stages, the port of
`repro/kernels/ref.py`: the paper's formulas, written independently of the
kernels' own plain versions.  The tests, `scripts/torch_kernel_bench.py`
and `chip_smoke.py` hold the stage ops to them.  Words are the uint32
visited bitmap as int32 bit patterns."""
from __future__ import annotations

import torch


def binsearch_map_ref(cumul, gids):
    """k[t] = max{l : cumul[l] <= gids[t]} (the paper's binsearch_maxle);
    -1 where no entry is <= gids[t]."""
    return torch.searchsorted(cumul, gids, right=True, out_int32=True) - 1


def visited_filter_ref(v, valid, words):
    """won[t] = valid[t] and bit v[t] unset and t is the first valid slot
    carrying v[t], over ONE tile (a dense triangular compare).

    Mirrors the paper's atomicOr(&bmap[v/32], m) first-thread-wins check
    (Alg. 3 lines 5-8), deterministically."""
    n = v.shape[0]
    w = (v >> 5).clamp(0, words.shape[0] - 1)
    unvis = valid & (((words[w] >> (v & 31)) & 1) == 0)
    eq = (v[:, None] == v[None, :]) & valid[None, :]
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=v.device).tril(diagonal=-1)
    return unvis & ~(eq & earlier).any(dim=1)
