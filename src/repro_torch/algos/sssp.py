"""Single-source shortest paths on per-edge uint8 weights (DESIGN.md
sec. 8), the port of `repro/algos/sssp.py` on the stacked grid.

Frontier-driven Bellman-Ford: the frontier payload is the vertex's current
tentative distance, scanning edge u -> v proposes dist(u) + w(u, v), the
owner keeps the minimum and re-activates a vertex whenever its distance
improves.  The weights live with the partition (`partition_edge_vals`,
`DistGraph.from_edges(..., weights=)`); the CSR-ordered copy serves the
bottom-up pull.  Every codec gives the same distances.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.algos import program as PR
from repro_torch.algos.program import FrontierProgram, ValueState
from repro_torch.core.partition import local_col, local_row, owner_of


@dataclasses.dataclass
class SSSPOutput:
    """Global shortest-path result (scalar root or a (B,) batch)."""
    dist: torch.Tensor       # (n,) / (B, n) int32, -1 = unreachable
    n_iters: torch.Tensor    # () / (B,) int32 relaxation levels run
    edges_scanned: Any = None  # exact Python int, or a tuple of B ints
    directions: Any = None     # per-level direction trace under direction
                               #   optimisation (see BFSOutput), else None


def _relax(p, w):
    return p + w.to(torch.int32)


class SSSPProgram(FrontierProgram):
    """Bellman-Ford relaxation as a frontier program (arg = root)."""
    name = "sssp"
    codec_hint = "list"
    n_extra = 1            # the (R, C, e_max) uint8 weights in CSC order
    n_csr_extra = 3        # CSR row_off + col_idx + the CSR-ordered weights

    def init(self, engine, graph, root):
        grid, dev = engine.grid, engine.device
        R, C, S = grid.R, grid.C, grid.S
        val = torch.full((R, C, grid.n_rows_local), PR.I32_MAX,
                         dtype=torch.int32, device=dev)
        front = torch.full((R, C, S), -1, dtype=torch.int32, device=dev)
        cnt = torch.zeros((R, C), dtype=torch.int32, device=dev)
        oi, oj = owner_of(root, grid)
        val[oi, oj, local_row(root, grid)] = 0
        front[oi, oj, 0] = local_col(root, grid)
        cnt[oi, oj] = 1
        return ValueState(val=val, front=front,
                          payload=torch.zeros((R, C, S), dtype=torch.int32,
                                              device=dev),
                          front_cnt=cnt, it=1)

    def plan(self, engine, graph, st):
        return PR.plan_values(engine, graph, st, fill=0)

    def make_step(self, engine, graph, extra=()):
        return PR.make_value_step(engine, graph, relax=_relax,
                                  edge_vals=extra[0])

    def make_bottomup_step(self, engine, graph, extra):
        # the pull twin relaxes over the CSR-ordered weight copy (the same
        # edge multiset as the CSC scan; min combine -> the same candidates)
        from repro_torch.algos.direction import make_pull_scan
        plan, scan = make_pull_scan(engine, extra[-3], extra[-2],
                                    relax=_relax, csr_edge_vals=extra[-1])
        return plan, PR.make_value_step(engine, graph, relax=_relax,
                                        scan=scan)

    def front_count(self, st):
        return st.front_cnt

    def keep_going(self, engine, st, total: int) -> bool:
        return total > 0 and st.it <= engine.max_levels

    def finalize(self, engine, st):
        d = PR.global_order(PR.owned_rows(st.val, engine.grid))
        return torch.where(d == PR.I32_MAX, -1, d), st.it

    def assemble(self, engine, outs, B):
        dev = engine.device
        if B is None:
            dist, it, scanned = outs[0]
            return SSSPOutput(dist=dist,
                              n_iters=torch.tensor(it, dtype=torch.int32,
                                                   device=dev),
                              edges_scanned=scanned)
        return SSSPOutput(
            dist=torch.stack([o[0] for o in outs]),
            n_iters=torch.tensor([o[1] for o in outs], dtype=torch.int32,
                                 device=dev),
            edges_scanned=tuple(o[2] for o in outs))
