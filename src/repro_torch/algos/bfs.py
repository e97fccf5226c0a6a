"""BFS levels/preds as a `FrontierProgram` (DESIGN.md sec. 6 + 8), the port
of `repro/algos/bfs.py` on the stacked grid.

The paper's algorithm -- expand exchange, CSC scan, fold, frontier update,
deferred-predecessor resolution -- with the same ops in the same order as
the JAX program, so levels, preds, `n_levels` and `edges_scanned` are
bit-identical to it.  The local phases loop over the grid's processors;
the exchanges are the stacked topology's tensor collectives.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.algos import program as PR
from repro_torch.algos.program import FrontierProgram
from repro_torch.core import frontier as F
from repro_torch.core.partition import local_col, local_row, owner_of, \
    row2col
from repro_torch.core.types import BFSOutput, BFSState, Grid2D
from repro_torch.dist import exchange as X


def init_state(root: int, *, grid: Grid2D, device) -> BFSState:
    """Stacked state with `root` on its owner (levels / preds / visited
    carry the trailing sink slot, `core.types`)."""
    R, C, S = grid.R, grid.C, grid.S
    nrl = grid.n_rows_local
    level = torch.full((R, C, nrl + 1), -1, dtype=torch.int32, device=device)
    pred = torch.full((R, C, nrl + 1), -1, dtype=torch.int32, device=device)
    visited = torch.zeros((R, C, nrl + 1), dtype=torch.bool, device=device)
    front = torch.full((R, C, S), -1, dtype=torch.int32, device=device)
    cnt = torch.zeros((R, C), dtype=torch.int32, device=device)
    oi, oj = owner_of(root, grid)
    lr = local_row(root, grid)
    level[oi, oj, lr] = 0
    pred[oi, oj, lr] = root
    visited[oi, oj, lr] = True
    front[oi, oj, 0] = local_col(root, grid)
    cnt[oi, oj] = 1
    return BFSState(level=level, pred=pred, visited=visited, front=front,
                    front_cnt=cnt, lvl=1)


def canonical_front(front, cnt):
    """Sort the padded frontier ascending (pad -1 stays at the back).

    The frontier's order fixes the edge-scan order of the NEXT level, which
    fixes which parent wins each first-visit race -- so keeping it canonical
    makes levels AND predecessors independent of fold delivery order."""
    key = torch.where(front < 0, F.I32_MAX, front)
    s = torch.sort(key).values
    return torch.where(s == F.I32_MAX, -1, s), cnt


@dataclasses.dataclass
class LevelPlan:
    """A level's expand exchange and scan workload, before the host read."""
    all_front: torch.Tensor    # (R, C, n_cols_local) int32
    front_total: torch.Tensor  # (R, C) int32
    cumul: list                # per processor (row-major): (ncl + 1,) int32
    counts: torch.Tensor       # (1 + P,) int64: global frontier, then every
                               #   processor's edges to scan this level


def plan_level(engine, graph, st: BFSState) -> LevelPlan:
    """Expand exchange (paper line 13) + every processor's scan workload."""
    all_front, front_total = X.expand_exchange(
        st.front, st.front_cnt, topo=engine.topo, ops=engine.fold_ops)
    cumul, counts = PR.scan_workload(engine, graph, all_front, front_total,
                                     st.front_cnt)
    return LevelPlan(all_front, front_total, cumul, counts)


def topdown_step(engine, graph, st: BFSState, plan: LevelPlan,
                 block_edges) -> BFSState:
    """One top-down level (paper Alg. 2 lines 12-18).

    block_edges: every processor's edge total of `plan`, as ints (the host
    read the engine made).  level / pred / visited update in place."""
    topo, grid = engine.topo, engine.grid
    R, C, S = grid.R, grid.C, grid.S
    dev = st.front.device
    dst = torch.empty((R, C, C, S), dtype=torch.int32, device=dev)
    dst_cnt = torch.empty((R, C, C), dtype=torch.int32, device=dev)
    for p, (i, j) in enumerate(topo.coords()):
        # frontier expansion (local CSC column scan)
        ex = F.expand_frontier(
            graph.col_off[i, j], graph.row_idx[i, j], st.visited[i, j],
            st.level[i, j], st.pred[i, j], plan.all_front[i, j],
            plan.front_total[i, j], st.lvl, grid=grid, i=i, j=j,
            edge_chunk=engine.edge_chunk, expand_fn=engine.expand_fn,
            dedup=engine.dedup, plan=(plan.cumul[p], block_edges[p]))
        dst[i, j] = ex.dst
        dst_cnt[i, j] = ex.dst_cnt

    # own-column vertices go straight to the frontier (lines 15-16)
    own = [(dst[i, j, j].clone(), dst_cnt[i, j, j].clone())
           for i, j in topo.coords()]
    for i, j in topo.coords():
        dst[i, j, j] = -1
        dst_cnt[i, j, j] = 0

    # fold exchange: route discoveries to their owners (same grid row)
    int_verts, int_cnt = engine.codec.fold(dst, dst_cnt, topo=topo)

    # frontier update (paper sec. 3.5)
    front = torch.empty_like(st.front)
    front_cnt = torch.empty_like(st.front_cnt)
    arange_s = torch.arange(S, dtype=torch.int32, device=dev)
    for p, (i, j) in enumerate(topo.coords()):
        up = F.update_frontier(int_verts[i, j], int_cnt[i, j],
                               st.visited[i, j], st.level[i, j],
                               st.pred[i, j], st.lvl, grid=grid, i=i, j=j)
        own_rows, own_cnt = own[p]
        own_cols = row2col(own_rows, i, j, grid)
        nf = torch.full((S,), -1, dtype=torch.int32, device=dev)
        nc = torch.zeros((), dtype=torch.int32, device=dev)
        nf, nc = F.append_padded(nf, nc, own_cols, arange_s < own_cnt)
        nf, nc = F.append_padded(nf, nc, up.new_front,
                                 arange_s < up.new_cnt)
        front[i, j], front_cnt[i, j] = canonical_front(nf, nc)
    return BFSState(level=st.level, pred=st.pred, visited=st.visited,
                    front=front, front_cnt=front_cnt, lvl=st.lvl + 1)


class BFSLevelsProgram(FrontierProgram):
    """The paper's BFS (levels + deferred predecessors) on the engine."""
    name = "bfs"
    codec_hint = "list"

    def init(self, engine, graph, root):
        return init_state(root, grid=engine.grid, device=engine.device)

    def plan(self, engine, graph, st):
        return plan_level(engine, graph, st)

    def make_step(self, engine, graph, extra=()):
        def step(st, plan, counts):
            return (topdown_step(engine, graph, st, plan, counts[1:]),
                    sum(counts[1:]))
        return step

    def make_bottomup_step(self, engine, graph, extra):
        from repro_torch.algos.direction import make_bfs_bottomup_step
        return make_bfs_bottomup_step(engine, graph, extra)

    def front_count(self, st):
        return st.front_cnt

    def keep_going(self, engine, st, total: int) -> bool:
        return total > 0 and st.lvl <= engine.max_levels

    def finalize(self, engine, st):
        """Owned levels and resolved preds in global vertex order (block
        b = j*R + i, i.e. plain global ids), and the level count."""
        grid = engine.grid
        pred = X.resolve_preds(st.pred[..., :grid.n_rows_local],
                               topo=engine.topo)
        return (PR.global_order(PR.owned_rows(st.level, grid)),
                PR.global_order(pred), st.lvl)

    def assemble(self, engine, outs, B):
        """Per-search (level, pred, lvl, edges) -> BFSOutput: (n,) arrays,
        a () n_levels and an exact int for a scalar search; (B, n), (B,)
        and a tuple of B ints for a batch."""
        dev = engine.device
        if B is None:
            level, pred, lvl, scanned = outs[0]
            return BFSOutput(level=level, pred=pred,
                             n_levels=torch.tensor(lvl, dtype=torch.int32,
                                                   device=dev),
                             edges_scanned=scanned)
        return BFSOutput(
            level=torch.stack([o[0] for o in outs]),
            pred=torch.stack([o[1] for o in outs]),
            n_levels=torch.tensor([o[2] for o in outs], dtype=torch.int32,
                                  device=dev),
            edges_scanned=tuple(o[3] for o in outs))
