"""Direction-optimised traversal (DESIGN.md sec. 11; Beamer et al., Buluc &
Madduri), the port of `repro/algos/direction.py`.

`DirectionProgram` wraps a `FrontierProgram` whose step has a bottom-up
twin: instead of scanning the frontier's out-edges (CSC), every unvisited
vertex scans its own in-edges (the CSR twin) for a parent in the frontier
-- the win on dense levels.  The heuristic is Beamer's alpha/beta
hysteresis: go bottom-up when the global frontier exceeds n / alpha, return
top-down once it falls below n / beta.  `mode="bottomup"` pins every level
bottom-up.

For BFS the bottom-up merge gives the owner's own column priority and
otherwise takes the minimum sender column, each proposing its minimum
frontier-neighbour column -- the parent top-down's visited suppression and
canonical scan order elect -- so levels, preds and n_levels equal top-down
bit for bit at any direction mix.  `edges_scanned` counts the masked
bottom-up workload on bottom-up levels, as the JAX package does.

The JAX program decides inside its compiled loop.  Here the decision is
made on the host: the level's first host read gives the global frontier
size (the plan's counts[0], the JAX `prev_total`), the step then plans the
chosen direction's workload and reads its per-processor edge totals -- a
second host read on every level of a direction-optimised search.  Both
reads are group-wide where a decision hangs on them: the frontier size is
the topology's `psum_all`, so every rank of a process group takes the same
direction and issues the same collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.algos import program as PR
from repro_torch.algos.program import FrontierProgram
from repro_torch.core import frontier as F
from repro_torch.core.types import BFSState

I32_MAX = 2**31 - 1


@dataclasses.dataclass
class DirState:
    """Wrapped program state + the per-level direction trace (its last
    entry is the hysteresis state: 1 while running bottom-up)."""
    inner: Any
    dirs: list            # per executed level: 0 top-down / 1 bottom-up


@dataclasses.dataclass
class FrontPlan:
    """A direction-optimised level before its decision: only the global
    frontier size."""
    counts: torch.Tensor  # (1,) int64


# ----------------------------------------------------------------------------
# The value programs' pull scan
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class PullPlan:
    """A bottom-up value level's frontier bitmap, dense payload and scan
    workload, before the host read."""
    all_words: torch.Tensor    # (Cl, R * W) int32 frontier bitmap per column
    dense_pay: torch.Tensor    # (Cl, n_cols_local) int32 payload per column
    cumul: list                # per processor: (nrl + 1,) int32 masked cumsum
    total: list                # per processor: () int32 live edges
    counts: torch.Tensor       # (1 + Pl,) int64: global frontier, then the
                               #   block's processors' edges to scan


def make_pull_scan(engine, row_off, col_idx, *, relax, csr_edge_vals=None,
                   skip_fn=None):
    """Bottom-up twin of a value step's push scan: every local row not
    skipped scans its CSR in-edges; an edge from frontier col c
    proposes `relax(dense_pay[c], w)`, min-combined per row.  CSR and CSC
    hold the same local edges and the combine is order-independent, so the
    candidates equal the push scan's on every row not skipped.

    row_off, col_idx, csr_edge_vals: the stacked CSR twin and its
    CSR-ordered edge values.  skip_fn: state -> (R, C, nrl) bool; skipped
    rows add no edges to the workload (multi-source BFS skips visited rows:
    JAX's `row_mask_fn`, negated).  Returns (plan_fn(state) -> PullPlan,
    scan(state, plan, block_edges) -> cand (Rl, Cl, nrl)), the scan half
    for `algos.program.make_value_step`."""
    topo, grid = engine.topo, engine.grid
    S = grid.S
    nrl, ncl = grid.n_rows_local, grid.n_cols_local
    blk = topo.local
    chunk = engine.edge_chunk
    dev = engine.device

    def plan(st):
        valid = st.front >= 0
        i_s = blk.rows(dev).view(-1, 1, 1) * S
        slot = torch.arange(S, dtype=torch.int32, device=dev)
        # a pad adds 0 at its own slot, never over a valid entry's payload
        own_pay = torch.zeros((blk.Rl, blk.Cl, S), dtype=torch.int32,
                              device=dev)
        own_pay.scatter_add_(2, torch.where(valid, st.front - i_s,
                                            slot).long(),
                             torch.where(valid, st.payload, 0))
        # column j's row-gather: grid row r's block at cols r*S ..
        dense_pay = topo.row_gather(own_pay)[0].reshape(blk.Cl, ncl)
        cumul, totals, counts = pull_workload(
            topo, row_off, st.front_cnt,
            skip=None if skip_fn is None else skip_fn(st))
        return PullPlan(frontier_words(topo, st.front), dense_pay, cumul,
                        totals, counts)

    def scan(st, plan, block_edges):
        bu_fn = engine.value_bottomup_fn
        cand = torch.full((blk.Rl, blk.Cl, nrl), I32_MAX, dtype=torch.int32,
                          device=dev)
        lanes = torch.arange(chunk, dtype=torch.int32, device=dev)
        slots = PR.own_slots(chunk, nrl, dev)
        for p, (i, j) in enumerate(topo.coords()):
            li, lj = blk.loc(i, j)
            words, pay_j = plan.all_words[lj], plan.dense_pay[lj]
            cumul, total = plan.cumul[p], plan.total[p]
            for start in range(0, block_edges[p], chunk):
                if bu_fn is None:
                    r, pay, addr, hit = F.reference_bottomup_values_chunk(
                        start + lanes, cumul, total, row_off[li, lj],
                        col_idx[li, lj], words, pay_j, block=S)
                else:
                    r, pay, addr, hit = bu_fn(start, chunk, cumul, total,
                                              row_off[li, lj],
                                              col_idx[li, lj], words, pay_j,
                                              block=S)
                w = None if csr_edge_vals is None \
                    else csr_edge_vals[li, lj][addr]
                val = torch.where(hit, relax(pay, w), I32_MAX)
                # a miss adds min's identity at its own slot
                cand[li, lj].scatter_reduce_(
                    0, torch.where(hit, r.long(), slots), val, "amin")
        return cand

    return plan, scan


# ----------------------------------------------------------------------------
# The BFS bottom-up step
# ----------------------------------------------------------------------------

def frontier_words(topo, front):
    """Own (Rl, Cl, S) frontier col ids -> every block column's
    row-gathered blocked bitmap, (Cl, R * W) int32.

    Processor (i, j)'s frontier entries lie in [i*S, (i+1)*S) (ROW2COL of
    owned rows), so its own block packs to exactly S bits; the row gather
    (`topo.row_gather`) stacks grid-row r's words at block r --
    `test_bit_blocks`'s addressing of local col c (block c // S, bit
    c % S).  Every grid row of a column receives the same gather."""
    R, S = topo.grid.R, topo.grid.S
    blk = topo.local
    W = (S + 31) // 32
    dev = front.device
    valid = front >= 0
    i = blk.rows(dev).view(-1, 1, 1)
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    # pads set no bit and add 0 to their own slot's word (no shared sink)
    t = torch.where(valid, front - i * S, slot)
    P = blk.Rl * blk.Cl
    base = torch.arange(P, dtype=torch.int32,
                        device=dev).view(blk.Rl, blk.Cl, 1) * (W * 32)
    words = torch.zeros(P * W, dtype=torch.int32, device=dev)
    F.set_bits(words, (base + t).reshape(-1), valid.reshape(-1))
    gathered = topo.row_gather(words.view(blk.Rl, blk.Cl, W))[0]
    return gathered.reshape(blk.Cl, R * W)


def pull_workload(topo, row_off, front_cnt, skip=None):
    """Every processor's bottom-up scan workload: the exclusive cumsum of
    its rows' CSR degrees, a row where `skip` (Rl, Cl, nrl[+ 1]) is set
    counting 0 edges.  Returns (per processor (nrl + 1,) int32 cumul, per
    processor () int32 total, the (1 + Pl,) int64 counts: the global
    frontier size, then the block's processors' edges to scan)."""
    nrl = topo.grid.n_rows_local
    loc = topo.local.loc
    cumul, totals = [], []
    for i, j in topo.coords():
        li, lj = loc(i, j)
        deg = torch.diff(row_off[li, lj])
        if skip is not None:
            deg = torch.where(skip[li, lj, :nrl], 0, deg)
        c = F.exclusive_cumsum(deg)
        cumul.append(c)
        totals.append(c[nrl])
    counts = torch.stack([topo.psum_all(front_cnt)] + totals)
    return cumul, totals, counts.to(torch.int64)


@dataclasses.dataclass
class BottomUpPlan:
    """A bottom-up level's frontier bitmap and scan workload, before the
    host read."""
    all_words: torch.Tensor    # (Cl, R * W) int32 frontier bitmap per column
    cumul: list                # per processor: (nrl + 1,) int32 masked cumsum
    total: list                # per processor: () int32 live edges
    counts: torch.Tensor       # (1 + Pl,) int64: global frontier, then the
                               #   block's processors' masked edges to scan


def plan_bottomup(engine, row_off, st: BFSState) -> BottomUpPlan:
    """The frontier bitmap and every processor's masked-degree workload:
    only unvisited rows' in-edges are scanned (the visited cache is
    consistent across the processor-row, so these are exactly the
    globally-undiscovered rows of the block)."""
    cumul, totals, counts = pull_workload(engine.topo, row_off, st.front_cnt,
                                          skip=st.visited)
    return BottomUpPlan(frontier_words(engine.topo, st.front), cumul, totals,
                        counts)


def bottomup_step(engine, row_off, col_idx, st: BFSState,
                  plan: BottomUpPlan, block_edges):
    """One bottom-up BFS level, equal to `bfs.topdown_step` in its result.

    Every unvisited local row scans its CSR in-edges for a frontier parent;
    the per-row minimum frontier col is this processor's proposal,
    value-folded to the owner; the owner merges with own-column priority,
    then the minimum sender.  level / pred / visited update in place.
    Returns (state', aux): the telemetry aux of a value fold, direction 1
    (None with telemetry off)."""
    topo, grid = engine.topo, engine.grid
    C, S = grid.C, grid.S
    nrl, ncl = grid.n_rows_local, grid.n_cols_local
    blk = topo.local
    Rl, Cl = blk.Rl, blk.Cl
    dev = st.front.device
    chunk = engine.edge_chunk
    bu_fn = engine.bottomup_fn
    lj_all = torch.arange(Cl, device=dev)
    cols = blk.j0 + lj_all                    # the block's grid columns
    vis_owned_prev = PR.owned_rows(st.visited, grid, blk.j0)
    found = torch.empty((Rl, Cl, nrl), dtype=torch.bool, device=dev)
    parent_g = torch.empty((Rl, Cl, nrl), dtype=torch.int32, device=dev)
    slots = torch.arange(chunk, dtype=torch.int32, device=dev)
    for p, (i, j) in enumerate(topo.coords()):
        li, lj = blk.loc(i, j)
        words = plan.all_words[lj]
        cumul, total = plan.cumul[p], plan.total[p]
        best = torch.full((nrl,), I32_MAX, dtype=torch.int32, device=dev)
        for start in range(0, block_edges[p], chunk):
            if bu_fn is None:
                r, c, hit = F.reference_bottomup_chunk(
                    start + slots, cumul, total, row_off[li, lj],
                    col_idx[li, lj], words, block=S)
            else:
                r, c, hit = bu_fn(start, chunk, cumul, total,
                                  row_off[li, lj], col_idx[li, lj], words,
                                  block=S)
            # a miss adds min's identity at its own row, not at a sink slot
            best.scatter_reduce_(0, r.long(), torch.where(hit, c, I32_MAX),
                                 "amin")
        f = best < I32_MAX                    # rows with a frontier parent
        found[li, lj] = f
        parent_g[li, lj] = torch.where(f, j * ncl + torch.where(f, best, 0),
                                       I32_MAX)
        st.visited[li, lj, :nrl] |= f         # the send-suppression cache

    # value-fold (vertex, parent) to the owners: the exchange the value
    # programs use, so every codec works here
    ids, cnt, vals = PR.pack_blocks(found, parent_g, grid,
                                    ops=engine.fold_ops)
    ri, _, rv = engine.codec.fold_values(ids, cnt, vals, topo=topo)
    aux = PR.value_fold_aux(engine, plan, cnt, 1) if engine.telemetry \
        else None

    # dense (Rl, Cl, C, S) per-sender parent table of each owned block;
    # senders propose each row at most once, and a pad adds I32_MAX at its
    # own slot
    jj = cols.view(1, Cl, 1, 1).to(torch.int32)
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    got = ri >= 0
    tt = torch.where(got, ri - jj * S, slot)
    dense = torch.full((Rl, Cl, C, S), I32_MAX, dtype=torch.int32,
                       device=dev)
    dense.scatter_reduce_(3, tt.long(), torch.where(got, rv, I32_MAX),
                          "amin")
    del tt, got, ri, rv
    # the owner's own column first, else the minimum proposing sender
    has = dense < I32_MAX
    first_m = has.to(torch.int8).argmax(dim=2)
    sel = torch.where(has[:, lj_all, cols], cols.view(1, Cl, 1), first_m)
    parent = torch.gather(dense, 2, sel.unsqueeze(2))[:, :, 0]
    new = has.any(dim=2) & ~vis_owned_prev
    del dense

    for i, j in topo.coords():
        li, lj = blk.loc(i, j)
        sl = slice(j * S, (j + 1) * S)
        n_ij = new[li, lj]
        st.visited[li, lj, sl] |= n_ij
        st.level[li, lj, sl] = torch.where(n_ij, st.lvl,
                                           st.level[li, lj, sl])
        st.pred[li, lj, sl] = torch.where(n_ij, parent[li, lj],
                                          st.pred[li, lj, sl])

    # the next frontier: owned rows as local cols (ROW2COL), ascending --
    # already the canonical order `canonical_front` would sort into
    ts, nc = F.compact_offsets(new.reshape(Rl * Cl, S), engine.fold_ops)
    i_s = blk.rows(dev).view(Rl, 1, 1) * S
    ts = ts.view(Rl, Cl, S)
    front = torch.where(ts >= 0, i_s + ts, -1)
    return BFSState(level=st.level, pred=st.pred, visited=st.visited,
                    front=front, front_cnt=nc.view(Rl, Cl),
                    lvl=st.lvl + 1), aux


def make_bfs_bottomup_step(engine, graph, extra):
    """(plan_fn, step_fn) of the bottom-up BFS level over the CSR twin at
    the end of `extra` (see `FrontierProgram.make_bottomup_step`)."""
    row_off, col_idx = extra[-2], extra[-1]

    def plan(st):
        return plan_bottomup(engine, row_off, st)

    def step(st, plan, counts):
        st2, aux = bottomup_step(engine, row_off, col_idx, st, plan,
                                 counts[1:])
        return st2, sum(counts[1:]), aux

    return plan, step


# ----------------------------------------------------------------------------
# The wrapper program
# ----------------------------------------------------------------------------

class DirectionProgram(FrontierProgram):
    """Direction-optimised wrapper around a bottom-up-capable program.

    mode:  "adaptive" (alpha/beta hysteresis per level) or "bottomup"
           (every level bottom-up).
    alpha: enter bottom-up when the global frontier exceeds n / alpha.
    beta:  leave it once the frontier falls below n / beta (beta > alpha).

    Outputs are the wrapped program's, equal to its pure top-down run, plus
    a `directions` trace ((max_levels,) int32 per search: -1 unused level /
    0 top-down / 1 bottom-up).
    """
    uses_bottomup = True

    def __init__(self, inner: FrontierProgram, *, mode: str = "adaptive",
                 alpha: int = 24, beta: int = 64):
        if mode not in ("adaptive", "bottomup"):
            raise ValueError(
                f"mode={mode!r}: expected 'adaptive' or 'bottomup'")
        self.inner = inner
        self.mode = mode
        self.alpha = int(alpha)
        self.beta = int(beta)
        self.name = "dir+" + inner.name
        self.codec_hint = inner.codec_hint
        # inner extras first, then the CSR twin (row_off, col_idx[, w_csr])
        self.n_extra = inner.n_extra + inner.n_csr_extra

    @property
    def key(self) -> tuple:
        return ("dir",) + tuple(self.inner.key) + (self.mode, self.alpha,
                                                   self.beta)

    def init(self, engine, graph, arg):
        return DirState(inner=self.inner.init(engine, graph, arg), dirs=[])

    def plan(self, engine, graph, st):
        total = engine.topo.psum_all(self.inner.front_count(st.inner))
        return FrontPlan(total.to(torch.int64).reshape(1))

    def make_step(self, engine, graph, extra=()):
        td_step = self.inner.make_step(engine, graph,
                                       extra[:self.inner.n_extra])
        bu_plan, bu_step = self.inner.make_bottomup_step(engine, graph,
                                                         extra)
        n = engine.grid.n                   # padded, as in the JAX program
        hi_thr = n // self.alpha            # enter bottom-up above this
        lo_thr = n // self.beta             # leave it below this

        def step(st: DirState, plan, counts):
            prev_total = counts[0]
            if self.mode == "bottomup":
                use_bu = True
            else:
                bottom_up_now = st.dirs[-1:] == [1]
                use_bu = prev_total > (lo_thr if bottom_up_now else hi_thr)
            sub = bu_plan(st.inner) if use_bu \
                else self.inner.plan(engine, graph, st.inner)
            sub_counts = sub.counts.tolist()      # the level's second read
            # both directions return (state, scanned, aux) with the same
            # aux keys, so telemetry records the sub-plan's scan and the
            # direction the level ran
            inner2, scanned, aux = (bu_step if use_bu else td_step)(
                st.inner, sub, sub_counts)
            return (DirState(inner=inner2, dirs=st.dirs + [int(use_bu)]),
                    scanned, aux)

        return step

    def front_count(self, st):
        return self.inner.front_count(st.inner)

    def keep_going(self, engine, st, total: int) -> bool:
        return self.inner.keep_going(engine, st.inner, total)

    def level_count(self, st) -> int:
        return self.inner.level_count(st.inner)

    def export_state(self, engine, st, n: int) -> dict:
        """Inner snapshot nested under "inner" + the direction bookkeeping
        in JAX's `DirState` form: `dir` the hysteresis (the last level's
        direction, 0 before the first), `dirs` the per-level directions
        (max_levels,) padded -1, `k` the levels run."""
        L = engine.max_levels
        dirs = np.full((L,), -1, np.int32)
        taken = st.dirs[:L]
        dirs[:len(taken)] = taken
        snap = {"inner": self.inner.export_state(engine, st.inner, n),
                "dir": np.asarray(st.dirs[-1] if st.dirs else 0, np.int32),
                "dirs": dirs,
                "k": np.asarray(len(st.dirs), np.int32)}
        snap["levels_done"] = snap["inner"]["levels_done"]
        return snap

    def import_state(self, engine, snap: dict) -> DirState:
        """The port's direction list from JAX's form: the first `k`
        entries of `dirs`, whose last is the hysteresis (`dir`)."""
        k = int(snap["k"])
        dirs = [int(d) for d in np.asarray(snap["dirs"])[:k]]
        if dirs and dirs[-1] != int(snap["dir"]):
            raise ValueError(
                f"direction snapshot disagrees with itself: dir="
                f"{int(snap['dir'])} but dirs[k-1]={dirs[-1]}")
        return DirState(inner=self.inner.import_state(engine, snap["inner"]),
                        dirs=dirs)

    def finalize(self, engine, st):
        L = engine.max_levels
        dirs = torch.full((L,), -1, dtype=torch.int32, device=engine.device)
        taken = st.dirs[:L]
        dirs[:len(taken)] = torch.tensor(taken, dtype=torch.int32)
        return tuple(self.inner.finalize(engine, st.inner)) + (dirs,)

    def assemble(self, engine, outs, B):
        # the engine appends edges_scanned after finalize's outputs, so the
        # direction trace sits second from the end
        out = self.inner.assemble(
            engine, [tuple(o[:-2]) + (o[-1],) for o in outs], B)
        dirs = [o[-2] for o in outs]
        return dataclasses.replace(
            out, directions=dirs[0] if B is None else torch.stack(dirs))
