"""Connected components by min-label propagation (DESIGN.md sec. 8), the
port of `repro/algos/cc.py`.

Every vertex starts labelled with its own global id and in the frontier;
each level propagates labels along edges and keeps the minimum.  At the
fixpoint a vertex's label is the smallest vertex id that reaches it: on a
symmetrised edge list, the smallest id of its component.  The fold carries
(vertex, label) pairs through `FoldCodec.fold_values`, so every codec gives
the same labels.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.algos import program as PR
from repro_torch.algos.program import FrontierProgram, ValueState


@dataclasses.dataclass
class CCOutput:
    """Global connected-components result, on the search's device."""
    labels: torch.Tensor     # (n,) int32: min vertex id reaching each vertex
    n_iters: torch.Tensor    # () int32 propagation levels run
    edges_scanned: Any = None  # exact Python int
    directions: Any = None     # per-level direction trace under direction
                               #   optimisation (see BFSOutput), else None
    trace: Any = None          # LevelTrace when telemetry ran (a tuple of
                               #   B for a batch), else None


class ConnectedComponentsProgram(FrontierProgram):
    """Min-label propagation as a frontier program (argument-free)."""
    name = "cc"
    codec_hint = "bitmap"      # early levels activate near-full blocks

    def init(self, engine, graph, arg):
        grid, dev = engine.grid, engine.device
        R, S = grid.R, grid.S
        blk = engine.topo.local
        Rl, Cl = blk.Rl, blk.Cl
        t = torch.arange(S, dtype=torch.int32, device=dev)
        i = blk.rows(dev).view(Rl, 1, 1)
        j = blk.cols(dev).view(1, Cl, 1)
        gids = (j * R + i) * S + t                     # owned block ids
        val = torch.full((Rl, Cl, grid.n_rows_local), PR.I32_MAX,
                         dtype=torch.int32, device=dev)
        PR.set_owned_rows(val, gids, grid, blk.j0)
        # every owned vertex starts active; ROW2COL of owned rows
        return ValueState(val=val,
                          front=(i * S + t).expand(Rl, Cl, S).clone(),
                          payload=gids,
                          front_cnt=torch.full((Rl, Cl), S,
                                               dtype=torch.int32,
                                               device=dev), it=1)

    def plan(self, engine, graph, st):
        return PR.plan_values(engine, graph, st, fill=PR.I32_MAX)

    def make_step(self, engine, graph, extra=()):
        return PR.make_value_step(engine, graph, relax=PR.identity_relax)

    def make_bottomup_step(self, engine, graph, extra):
        # the same step with the pull scan: every local row scans its CSR
        # in-edges for frontier labels; the candidates are the push scan's
        from repro_torch.algos.direction import make_pull_scan
        plan, scan = make_pull_scan(engine, extra[-2], extra[-1],
                                    relax=PR.identity_relax)
        return plan, PR.make_value_step(engine, graph, relax=PR.identity_relax,
                                        scan=scan)

    def keep_going(self, engine, st, total: int) -> bool:
        return total > 0 and st.it <= engine.max_levels

    def level_count(self, st) -> int:
        return st.it

    def export_state(self, engine, st, n: int) -> dict:
        return PR.export_value_state(engine.grid, st, n, engine.topo)

    def import_state(self, engine, snap: dict) -> ValueState:
        # padding vertices of the new grid are isolated self-labelled
        # components -- exactly what an uninterrupted run holds after level 1
        return PR.import_value_state(engine.grid, snap, engine.device,
                                     pad="gid", ops=engine.fold_ops,
                                     local=engine.topo.local)

    def finalize(self, engine, st):
        topo = engine.topo
        owned = PR.owned_rows(st.val, engine.grid, topo.local.j0)
        return PR.global_order(owned, topo), st.it

    def assemble(self, engine, outs, B):
        labels, it, scanned = outs[0]
        return CCOutput(labels=labels,
                        n_iters=torch.tensor(it, dtype=torch.int32,
                                             device=engine.device),
                        edges_scanned=scanned)
