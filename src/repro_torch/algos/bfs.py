"""BFS levels/preds as a `FrontierProgram` (DESIGN.md sec. 6 + 8), the port
of `repro/algos/bfs.py`.

The paper's algorithm -- expand exchange, CSC scan, fold, frontier update,
deferred-predecessor resolution -- with the same ops in the same order as
the JAX program, so levels, preds, `n_levels` and `edges_scanned` are
bit-identical to it.  The local phases loop over the processors of the
topology's block; the exchanges are the topology's collectives (tensor
operations on the stacked grid, transfers across a process group).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algos import program as PR
from repro_torch.algos.program import FrontierProgram
from repro_torch.core import frontier as F
from repro_torch.core.partition import local_col, local_row, owner_of, \
    row2col
from repro_torch.core.types import BFSOutput, BFSState, Grid2D
from repro_torch.dist import exchange as X


def init_state(root: int, *, grid: Grid2D, device, local=None) -> BFSState:
    """State of the block `local` (a `topology.LocalBlock`; None = the
    whole grid) with `root` on its owner, if the block holds it (levels /
    preds / visited carry the trailing sink slot, `core.types`)."""
    S = grid.S
    Rl, Cl = (grid.R, grid.C) if local is None else (local.Rl, local.Cl)
    nrl = grid.n_rows_local
    level = torch.full((Rl, Cl, nrl + 1), -1, dtype=torch.int32,
                       device=device)
    pred = torch.full((Rl, Cl, nrl + 1), -1, dtype=torch.int32,
                      device=device)
    visited = torch.zeros((Rl, Cl, nrl + 1), dtype=torch.bool, device=device)
    front = torch.full((Rl, Cl, S), -1, dtype=torch.int32, device=device)
    cnt = torch.zeros((Rl, Cl), dtype=torch.int32, device=device)
    oi, oj = owner_of(root, grid)
    if local is None or local.owns(oi, oj):
        li, lj = (oi, oj) if local is None else local.loc(oi, oj)
        lr = local_row(root, grid)
        level[li, lj, lr] = 0
        pred[li, lj, lr] = root
        visited[li, lj, lr] = True
        front[li, lj, 0] = local_col(root, grid)
        cnt[li, lj] = 1
    return BFSState(level=level, pred=pred, visited=visited, front=front,
                    front_cnt=cnt, lvl=1)


def owned_level(level, *, grid: Grid2D, j):
    """The owned block of a processor in grid column j's level row."""
    return level[..., j * grid.S:(j + 1) * grid.S]


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
                 block_edges):
    """One top-down level (paper Alg. 2 lines 12-18).

    block_edges: every processor's edge total of `plan`, as ints (the host
    read the engine made).  level / pred / visited update in place.
    Returns (state', aux): aux is the telemetry channel (None with
    telemetry off) -- a SET fold, so the wire stamp is the exchange
    strategy's scaling of the codec's static `wire_bytes(grid)`, `msgs`
    the strategy's per-exchange message count and `folded` the entries
    routed to remote owners (the own column never travels)."""
    topo, grid = engine.topo, engine.grid
    C, S = grid.C, grid.S
    blk = topo.local
    dev = st.front.device
    dst = torch.empty((blk.Rl, blk.Cl, C, S), dtype=torch.int32, device=dev)
    dst_cnt = torch.empty((blk.Rl, blk.Cl, C), dtype=torch.int32,
                          device=dev)
    for p, (i, j) in enumerate(topo.coords()):
        li, lj = blk.loc(i, j)
        # frontier expansion (local CSC column scan)
        ex = F.expand_frontier(
            graph.col_off[li, lj], graph.row_idx[li, lj],
            st.visited[li, lj], st.level[li, lj], st.pred[li, lj],
            plan.all_front[li, lj], plan.front_total[li, lj], st.lvl,
            grid=grid, i=i, j=j, edge_chunk=engine.edge_chunk,
            expand_fn=engine.expand_fn, dedup=engine.dedup,
            plan=(plan.cumul[p], block_edges[p]))
        dst[li, lj] = ex.dst
        dst_cnt[li, lj] = ex.dst_cnt

    # own-column vertices go straight to the frontier (lines 15-16)
    own = []
    for i, j in topo.coords():
        li, lj = blk.loc(i, j)
        own.append((dst[li, lj, j].clone(), dst_cnt[li, lj, j].clone()))
        dst[li, lj, j] = -1
        dst_cnt[li, lj, j] = 0

    # fold exchange: route discoveries to their owners (same grid row)
    int_verts, int_cnt = engine.codec.fold(dst, dst_cnt, topo=topo)
    aux = None
    if engine.telemetry:
        strat = engine.exchange
        aux = {"scanned": plan.counts[1:],
               "folded": dst_cnt.sum(dim=2, dtype=torch.int32),
               "wire": strat.wire_bytes(engine.codec.wire_bytes(grid), C),
               "msgs": strat.msgs_per_exchange(C), "dir": 0}

    # frontier update (paper sec. 3.5)
    front = torch.empty_like(st.front)
    front_cnt = torch.empty_like(st.front_cnt)
    arange_s = torch.arange(S, dtype=torch.int32, device=dev)
    for p, (i, j) in enumerate(topo.coords()):
        li, lj = blk.loc(i, j)
        up = F.update_frontier(int_verts[li, lj], int_cnt[li, lj],
                               st.visited[li, lj], st.level[li, lj],
                               st.pred[li, lj], st.lvl, grid=grid, i=i, j=j)
        own_rows, own_cnt = own[p]
        own_cols = row2col(own_rows, i, j, grid)
        nf = torch.full((S,), -1, dtype=torch.int32, device=dev)
        nc = torch.zeros((), dtype=torch.int32, device=dev)
        nf, nc = F.append_padded(nf, nc, own_cols, arange_s < own_cnt)
        nf, nc = F.append_padded(nf, nc, up.new_front,
                                 arange_s < up.new_cnt)
        front[li, lj], front_cnt[li, lj] = canonical_front(nf, nc)
    return BFSState(level=st.level, pred=st.pred, visited=st.visited,
                    front=front, front_cnt=front_cnt, lvl=st.lvl + 1), aux


class BFSLevelsProgram(FrontierProgram):
    """The paper's BFS (levels + deferred predecessors) on the engine.

    step_factory: optional `(engine, graph, extra, topdown) -> step` hook
                  replacing the default top-down per-level step.  The
                  step runs over the topology's block (the whole grid on
                  one device, a rank's blocks in a process group):

                      step(st, prev_total) -> (st', total, scanned[, aux])

                  `prev_total` is the global frontier size entering the
                  level (an int); `total` the global size of the frontier
                  it leaves, which the engine reads from its next plan
                  instead; `scanned` the level's edges per processor of
                  the block, row-major (a sequence or a tensor; the
                  engine sums it, a host read for a tensor); `aux` the
                  optional telemetry dict (`obs.trace.normalize_aux`).
                  `topdown(st)` is the engine's own top-down level for the
                  state the engine planned, returning (st', total,
                  scanned, aux).  The JAX hook also takes the device
                  coordinates (i, j), which a block-wide step has no use
                  for.
    n_extra:      extra per-processor graph arrays the step consumes (the
                  CSR twin for bottom-up).
    """
    name = "bfs"
    codec_hint = "list"

    def __init__(self, step_factory=None, n_extra: int = 0):
        self.step_factory = step_factory
        self.n_extra = n_extra

    @property
    def key(self) -> tuple:
        return (self.name, self.step_factory, self.n_extra)

    def init(self, engine, graph, root):
        return init_state(root, grid=engine.grid, device=engine.device,
                          local=engine.topo.local)

    def plan(self, engine, graph, st):
        return plan_level(engine, graph, st)

    def make_step(self, engine, graph, extra=()):
        if self.step_factory is None:
            def step(st, plan, counts):
                st2, aux = topdown_step(engine, graph, st, plan, counts[1:])
                return st2, sum(counts[1:]), aux
            return step
        planned = {}                      # the level the engine planned

        def topdown(st):
            plan, counts = planned["plan"], planned["counts"]
            st2, aux = topdown_step(engine, graph, st, plan, counts[1:])
            return (st2, engine.topo.psum_all(st2.front_cnt), counts[1:],
                    aux)

        custom = self.step_factory(engine, graph, extra, topdown)

        def step(st, plan, counts):
            planned.update(plan=plan, counts=counts)
            res = custom(st, counts[0])
            scanned = res[2].tolist() if isinstance(res[2], torch.Tensor) \
                else [int(x) for x in res[2]]
            aux = dict(res[3] or {}) if len(res) > 3 else {}
            if engine.telemetry and "scanned" not in aux:
                aux["scanned"] = torch.tensor(scanned, dtype=torch.int64,
                                              device=engine.device)
            return res[0], sum(scanned), aux
        return step

    def make_bottomup_step(self, engine, graph, extra):
        from repro_torch.algos.direction import make_bfs_bottomup_step
        return make_bfs_bottomup_step(engine, graph, extra)

    def keep_going(self, engine, st, total: int) -> bool:
        return total > 0 and st.lvl <= engine.max_levels

    def finalize(self, engine, st):
        """Owned levels and resolved preds in global vertex order (block
        b = j*R + i, i.e. plain global ids), and the level count; across a
        process group every rank fetches the whole grid's."""
        grid, topo = engine.grid, engine.topo
        pred = X.resolve_preds(st.pred[..., :grid.n_rows_local], topo=topo)
        level = PR.owned_rows(st.level, grid, topo.local.j0)
        return (PR.global_order(level, topo), PR.global_order(pred, topo),
                st.lvl)

    def level_count(self, st) -> int:
        return st.lvl

    def export_state(self, engine, st, n: int) -> dict:
        """BFSState -> global canonical snapshot (JAX's schema).

        `level` and `pred` export from the owned blocks; deferred
        predecessor markers -(c+2) resolve at export time by reading the
        sender column's pred row (`resolve_preds`, the exchange finalize
        makes), so the snapshot is marker-free and grid-independent.
        Across a process group both are fetched whole to every rank.  The
        frontier is DERIVED state -- exactly the vertices with
        level == lvl-1 -- and the visited bitmap is derivable as
        level >= 0, so neither is stored.
        """
        level, pred, _ = self.finalize(engine, st)
        return {"level": PR.host(level, n), "pred": PR.host(pred, n),
                "lvl": np.asarray(st.lvl, np.int64),
                "levels_done": np.asarray(st.lvl - 1, np.int64)}

    def import_state(self, engine, snap: dict) -> BFSState:
        """Global snapshot -> BFSState of the engine topology's block.

        Every local row rebuilds `level` and `visited = level >= 0` from the
        global truth: for still-unvisited vertices no processor suppresses,
        and for claimed vertices extra suppression only drops proposals the
        owner would discard anyway -- so a resumed trajectory (same grid)
        is bit-identical, predecessors included.  `pred` is authoritative
        at the owned block only (the finalize resolution leaves resolved
        entries as they are); the frontier re-derives from level == lvl-1,
        ascending -- the canonical order the organic frontier carries.  The
        trailing sink slot takes `init_state`'s values.  Across a process
        group a rank builds only its blocks.
        """
        grid, dev, blk = engine.grid, engine.device, engine.topo.local
        C, S, nrl = grid.C, grid.S, grid.n_rows_local
        Rl, Cl = blk.Rl, blk.Cl
        gl = PR.padded_global(snap["level"], grid, -1, dev)
        gp = PR.padded_global(snap["pred"], grid, -1, dev)
        lvl = int(snap["lvl"])
        level = torch.full((Rl, Cl, nrl + 1), -1, dtype=torch.int32,
                           device=dev)
        level[:, :, :nrl] = PR.rows_from_global(gl, grid, blk)
        visited = level >= 0
        pred = torch.full((Rl, Cl, nrl + 1), -1, dtype=torch.int32,
                          device=dev)
        lj = torch.arange(Cl, device=dev)
        pred[:, :, :nrl].unflatten(2, (C, S))[:, lj, blk.j0 + lj] = \
            PR.owned_from_global(gp, grid, blk)
        owned = PR.owned_from_global(gl, grid, blk)
        front, _, cnt = PR.owned_to_front(owned == lvl - 1, owned, grid,
                                          ops=engine.fold_ops, i0=blk.i0)
        return BFSState(level=level, pred=pred, visited=visited, front=front,
                        front_cnt=cnt, lvl=lvl)

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
