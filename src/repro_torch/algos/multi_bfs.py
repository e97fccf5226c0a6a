"""Batched multi-source BFS / reachability (DESIGN.md sec. 8), the port of
`repro/algos/multi_bfs.py`.

ONE wave sweeps out from K sources at once: every vertex records the level
at which the combined wave first reached it and the index (into `sources`)
of the claiming source, same-wave ties broken by the minimum index.  With
`max_levels = k`, `level >= 0` marks the union k-hop neighbourhood of the
sources.  As in BFS, a visited bitmap over ALL local rows suppresses
re-folds; the fold carries (vertex, source index) pairs through
`FoldCodec.fold_values`, so every codec gives the same result.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.algos import program as PR
from repro_torch.algos.program import FrontierProgram, I32_MAX
from repro_torch.core.partition import local_row, owner_of
from repro_torch.dist import exchange as X


@dataclasses.dataclass
class MultiBFSState:
    """Stacked multi-source BFS state: `visited` spans all local rows (the
    suppression bitmap); `level` / `src` are authoritative on the owned
    block only."""
    visited: torch.Tensor    # (R, C, n_rows_local) bool
    level: torch.Tensor      # (R, C, n_rows_local) int32, -1 = unreached
    src: torch.Tensor        # (R, C, n_rows_local) int32 claiming source
    front: torch.Tensor      # (R, C, S) local col ids, ascending, pad -1
    payload: torch.Tensor    # (R, C, S) source indices aligned with front
    front_cnt: torch.Tensor  # (R, C) int32
    lvl: int                 # current wave


@dataclasses.dataclass
class MultiBFSOutput:
    """Global multi-source BFS result, on the search's device."""
    level: torch.Tensor      # (n,) int32 hops to the nearest source, -1 none
    src: torch.Tensor        # (n,) int32 claiming source index, -1 none
    n_levels: torch.Tensor   # () int32 waves run
    edges_scanned: Any = None  # exact Python int
    directions: Any = None     # per-level direction trace under direction
                               #   optimisation (see BFSOutput), else None
    trace: Any = None          # LevelTrace when telemetry ran (a tuple of
                               #   B for a batch), else None


class MultiSourceBFSProgram(FrontierProgram):
    """Simultaneous BFS from a (K,) sources vector (arg = sources)."""
    name = "multi_bfs"
    codec_hint = "list"

    def init(self, engine, graph, sources):
        grid, dev = engine.grid, engine.device
        nrl = grid.n_rows_local
        blk = engine.topo.local
        Rl, Cl = blk.Rl, blk.Cl
        s = torch.as_tensor(sources, dtype=torch.int64, device=dev)
        oi, oj = owner_of(s, grid)
        li, lj = oi - blk.i0, oj - blk.j0
        here = (li >= 0) & (li < Rl) & (lj >= 0) & (lj < Cl)
        # sources this block does not own land in the trailing sink slot
        flat = torch.where(here, (li * Cl + lj) * nrl + local_row(s, grid),
                           Rl * Cl * nrl)
        # min source index per claimed row (duplicate sources: first wins)
        src = torch.full((Rl * Cl * nrl + 1,), I32_MAX, dtype=torch.int32,
                         device=dev)
        src.scatter_reduce_(0, flat, torch.arange(s.shape[0],
                                                  dtype=torch.int32,
                                                  device=dev), "amin")
        src = src[:-1].view(Rl, Cl, nrl)
        claimed = src < I32_MAX
        owned_src = PR.owned_rows(src, grid, blk.j0)
        front, payload, cnt = PR.owned_to_front(owned_src < I32_MAX,
                                                owned_src, grid,
                                                ops=engine.fold_ops,
                                                i0=blk.i0)
        return MultiBFSState(visited=claimed,
                             level=torch.where(claimed, 0, -1).to(
                                 torch.int32),
                             src=src, front=front, payload=payload,
                             front_cnt=cnt, lvl=1)

    def plan(self, engine, graph, st):
        return PR.plan_values(engine, graph, st, fill=I32_MAX)

    def make_step(self, engine, graph, extra=()):
        return self._make_step(engine, PR.push_scan(engine, graph,
                                                    relax=PR.identity_relax),
                               step_dir=0)

    def make_bottomup_step(self, engine, graph, extra):
        # the pull twin also masks visited rows out of the workload: their
        # candidates are discarded by the visited discipline anyway
        from repro_torch.algos.direction import make_pull_scan
        plan, scan = make_pull_scan(engine, extra[-2], extra[-1],
                                    relax=PR.identity_relax,
                                    skip_fn=lambda st: st.visited)
        return plan, self._make_step(engine, scan, step_dir=1)

    def _make_step(self, engine, scan, step_dir: int):
        grid, topo = engine.grid, engine.topo
        i0, j0 = topo.local.i0, topo.local.j0

        def step(st: MultiBFSState, plan, counts):
            cand = scan(st, plan, counts[1:])
            vis_owned_prev = PR.owned_rows(st.visited, grid, j0)
            # first fold per vertex per processor (the BFS visited
            # discipline)
            improved = (cand < I32_MAX) & ~st.visited
            st.visited |= improved
            ids, cnt, vals = PR.pack_blocks(improved, cand, grid,
                                            ops=engine.fold_ops)
            del cand, improved
            ri, _, rv = engine.codec.fold_values(ids, cnt, vals, topo=topo)
            aux = None
            if engine.telemetry:
                # JAX's accounting as it is: the codec's static frame plus
                # 4 bytes per folded entry, not scaled by the exchange
                # strategy, and no `msgs` key (the trace records 0)
                folded = cnt.sum(dim=-1, dtype=torch.int32)
                aux = {"scanned": plan.counts[1:], "folded": folded,
                       "wire": engine.codec.wire_bytes(grid)
                       + 4 * folded.to(torch.int64),
                       "dir": step_dir}
            inc = PR.scatter_min_received(ri, rv, X.receiver_cols(topo),
                                          grid.S)
            # claims merge against the PRE-scan owned state: this
            # processor's own discoveries travel through the self bucket,
            # so judging them here would shadow a smaller source index
            # arriving from a peer in the same wave
            changed = (inc < I32_MAX) & ~vis_owned_prev
            new_src = torch.where(changed, inc,
                                  PR.owned_rows(st.src, grid, j0))
            PR.set_owned_rows(st.src, new_src, grid, j0)
            PR.set_owned_rows(st.level, torch.where(
                changed, st.lvl, PR.owned_rows(st.level, grid, j0)), grid,
                j0)
            PR.set_owned_rows(st.visited, PR.owned_rows(st.visited, grid, j0)
                              | changed, grid, j0)
            front, payload, nc = PR.owned_to_front(changed, new_src, grid,
                                                   ops=engine.fold_ops,
                                                   i0=i0)
            return (MultiBFSState(visited=st.visited, level=st.level,
                                  src=st.src, front=front, payload=payload,
                                  front_cnt=nc, lvl=st.lvl + 1),
                    sum(counts[1:]), aux)

        return step

    def keep_going(self, engine, st, total: int) -> bool:
        return total > 0 and st.lvl <= engine.max_levels

    def level_count(self, st) -> int:
        return st.lvl

    def export_state(self, engine, st, n: int) -> dict:
        """MultiBFSState -> global canonical snapshot (JAX's schema).

        `level` / `src` export RAW from the owned blocks (src keeps I32_MAX
        for unclaimed vertices; finalize's -1 remap is output-only), fetched
        whole to every rank across a process group.  The frontier derives
        from level == lvl-1 with the claiming source id as payload, and
        per-processor `visited` is rebuilt as level >= 0 -- a superset of
        any one processor's organic bitmap, which only suppresses proposals
        for already-claimed vertices (invisible to the owner's merge against
        its previous visited block), so a same-grid resume is bit-identical.
        """
        grid, topo = engine.grid, engine.topo
        j0 = topo.local.j0
        level = PR.global_order(PR.owned_rows(st.level, grid, j0), topo)
        src = PR.global_order(PR.owned_rows(st.src, grid, j0), topo)
        return {"level": PR.host(level, n), "src": PR.host(src, n),
                "lvl": np.asarray(st.lvl, np.int64),
                "levels_done": np.asarray(st.lvl - 1, np.int64)}

    def import_state(self, engine, snap: dict) -> MultiBFSState:
        """Global snapshot -> MultiBFSState of the engine topology's block.

        `level` / `src` are authoritative at the owned block only (steps
        never read the non-owned rows after init, so those import as
        -1 / I32_MAX); padding vertices of the new grid are unreached.
        """
        grid, dev, blk = engine.grid, engine.device, engine.topo.local
        nrl = grid.n_rows_local
        gl = PR.padded_global(snap["level"], grid, -1, dev)
        gs = PR.padded_global(snap["src"], grid, I32_MAX, dev)
        lvl = int(snap["lvl"])
        level = torch.full((blk.Rl, blk.Cl, nrl), -1, dtype=torch.int32,
                           device=dev)
        src = torch.full((blk.Rl, blk.Cl, nrl), I32_MAX, dtype=torch.int32,
                         device=dev)
        owned_l = PR.owned_from_global(gl, grid, blk)
        owned_s = PR.owned_from_global(gs, grid, blk)
        PR.set_owned_rows(level, owned_l, grid, blk.j0)
        PR.set_owned_rows(src, owned_s, grid, blk.j0)
        front, payload, cnt = PR.owned_to_front(owned_l == lvl - 1, owned_s,
                                                grid, ops=engine.fold_ops,
                                                i0=blk.i0)
        return MultiBFSState(visited=PR.rows_from_global(gl, grid, blk) >= 0,
                             level=level, src=src, front=front,
                             payload=payload, front_cnt=cnt, lvl=lvl)

    def finalize(self, engine, st):
        grid, topo = engine.grid, engine.topo
        j0 = topo.local.j0
        level = PR.global_order(PR.owned_rows(st.level, grid, j0), topo)
        src = PR.global_order(PR.owned_rows(st.src, grid, j0), topo)
        return level, torch.where(src == I32_MAX, -1, src), st.lvl

    def assemble(self, engine, outs, B):
        level, src, lvl, scanned = outs[0]
        return MultiBFSOutput(level=level, src=src,
                              n_levels=torch.tensor(lvl, dtype=torch.int32,
                                                    device=engine.device),
                              edges_scanned=scanned)
