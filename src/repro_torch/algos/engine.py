"""The frontier-program driver (DESIGN.md sec. 8), the port of
`repro/algos/engine.py:FrontierEngine`.

The JAX engine compiles the level loop into one `lax.while_loop`.  PyTorch
runs eagerly, so the loop is a Python loop with ONE host read per level:
the program's plan carries the global frontier size (for `keep_going`) and
every processor's edge total (how many chunks its scan runs) in one small
tensor, read together.  The chunk loops then run without further reads.
A direction-optimised program (`algos/direction.py`) reads twice per level:
the frontier size decides the direction, then the chosen direction's
workload is planned and its totals read.  `edges_scanned` sums the exact
totals in Python ints; `wide_add` / `wide_total` keep the JAX engine's
(hi, lo) uint32 pair contract for callers that hold such pairs.

A batch of searches runs root by root, as `lax.map` does.

Across a process group (`dist.topology.GroupTopology`) every rank runs the
same loop over its block of the grid.  Every decision that changes control
flow reads group-wide values -- `keep_going` and the direction read the
plan's counts[0], the topology's `psum_all` -- so the ranks issue the same
collectives in the same order; the edge totals that follow it are the
rank's own processors', and `edges_scanned` is summed over the group once,
when a search is finalized (an int64 all_reduce).  The roots of a batch
must be the same on every rank (JAX's `put_replicated`).  A rank records
the trace of its own processors and fetches every rank's when the search
is assembled; the segmented loop's decisions (`active`, the level count)
are group-wide already, and a snapshot's export fetches the rank's blocks
(`topo.fetch`), so every rank builds the same grid-independent snapshot,
and an import keeps only the rank's blocks of one.

With telemetry on, the loop records one level of `obs.trace` after each
step, where the JAX loop body does: the frontier total the level read, the
processors' frontier counts before the step, the step's per-processor
edges and its `aux` (folded entries, wire bytes, messages, direction).
The record stays on the device and is read once, when the search is
assembled, so the host reads per level do not change.

With fault tolerance on (DESIGN.md sec. 15) the same loop also runs in
segments of at most `ckpt_every` levels (`ft_start` / `ft_segment` /
`ft_finish`), its state held between segments in a host-side carry, one
per search: the program state, the exact `scanned` int, the last read's
frontier total and `active`, the pending plan and its read counts (so a
segment boundary adds no host read and no level work), and the trace
record.  `export_carry` / `import_carry` turn the carry into the JAX
package's grid-canonical snapshot and back, so either package resumes the
other's snapshots, on the same grid or a smaller one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.exchange import get_fold_codec
from repro_torch.dist.strategy import get_exchange
from repro_torch.kernels import bottomup as bottomup_kernels
from repro_torch.kernels import expand as expand_kernels
from repro_torch.kernels import fold as fold_kernels
from repro_torch.kernels.select import resolve_path
from repro_torch.obs import trace as T


def group_not_ported(what: str) -> NotImplementedError:
    """The error a process-group run raises for a feature the port keeps
    to one process (ROADMAP A13 part 3: the JAX server defines no batch
    order across processes, so a group server would be a feature the JAX
    package lacks)."""
    return NotImplementedError(
        f"{what} does not run over a process group: the JAX package's "
        f"server defines no batch order across processes (ROADMAP A13 part "
        f"3, outside the port); it runs on the stacked grid "
        f"(DistGraph.from_edges without mesh=)")


def wide_add(hi, lo, delta):
    """(hi, lo) uint32 pair += delta (any non-negative integer dtype; delta
    wraps to its low 32 bits, as the JAX engine's cast does).  Tensors in,
    tensors of the input dtypes out."""
    mask = 0xFFFFFFFF
    s = lo.to(torch.int64) + (torch.as_tensor(delta, device=lo.device)
                              .to(torch.int64) & mask)
    carry = s >> 32
    return ((hi.to(torch.int64) + carry) & mask).to(hi.dtype), \
        (s & mask).to(lo.dtype)


def wide_total(hi, lo) -> int:
    """Sum per-processor (hi, lo) pairs into one exact Python int."""
    hi = torch.as_tensor(hi).to(torch.int64)
    lo = torch.as_tensor(lo).to(torch.int64)
    return (int(hi.sum()) << 32) + int(lo.sum())


class FrontierEngine:
    """Whole-search driver for one `FrontierProgram` over a topology.

    topo:       `StackedTopology` (grid + device) or `GroupTopology`
                (this rank's block of a process group).
    program:    the FrontierProgram to drive.
    fold_codec: "list" | FoldCodec instance | None (program's hint).
    edge_chunk: CSC scan chunk size of the expand phase.
    max_levels: loop bound fed to `program.keep_going`.
    expand:     "auto" | "kernel" | "reference": the chunk scan through the
                CUDA `expand_chunk` kernel (`expand_chunk_values` for the
                value programs), hooked in through `kernels.expand.
                make_expand_fn` / `make_value_expand_fn`, or the plain
                torch formulas (`kernels/select.py`).
    expand_fn:  a custom chunk hook for the top-down BFS scan (signature of
                `make_expand_fn`'s hooks); it wins over `expand`, sets
                `expand_path = "custom"`, and leaves the value programs on
                the plain value scan.
    fold:       the same spellings for the fold kernels (`compact_rows`,
                the bitmap codec's `pack_bits` / `unpack_bits`, the delta
                codec's `delta_gaps` / `delta_positions`).
    dedup:      winner-selection method ("scatter" | "sort").
    bottomup:   the same spellings for the bottom-up chunk scan
                (`bottomup_chunk`, `bottomup_chunk_values`); consulted only
                by programs that declare `uses_bottomup` (the
                direction-optimising wrapper), through `kernels.bottomup.
                make_bottomup_fn` / `make_value_bottomup_fn`.
    exchange:   fold exchange strategy: "flat" | "butterfly" | "auto" |
                an ExchangeStrategy instance (`dist/strategy.py`).  The
                resolved strategy is bound into the engine's topology, so
                every codec and the predecessor resolution route through
                it; outputs are identical across strategies.
    telemetry:  when True, record the per-level `obs.trace` beside every
                search and return a `LevelTrace` with it (`output.trace`).
                Off, no step computes its aux.
                Outputs are identical either way.
    fault_tolerance:  when True, the segmented level loop (`ft_start`,
                `ft_segment`, `ft_finish`) and the carry export / import
                may be used; off, they raise.  The unsegmented `run` /
                `run_batch` are the same either way, and segmented outputs
                are bit-identical to them.
    ckpt_every: levels per resumable segment (the K of "checkpoint every
                K levels"); only consulted when fault_tolerance=True.

    `trace_count` counts the executable-cache entries built for this engine
    (`api.session.Runnable`): one per cache miss, where the JAX engine
    counts one trace of its level loop.
    """

    def __init__(self, topo, program, *, fold_codec=None,
                 edge_chunk: int = 8192, max_levels: int = 64,
                 expand: str = "auto", expand_fn=None, fold: str = "auto",
                 dedup: str = "scatter", bottomup: str = "auto",
                 exchange="flat", telemetry: bool = False,
                 fault_tolerance: bool = False, ckpt_every: int = 1):
        if edge_chunk < 1:
            raise ValueError(f"edge_chunk must be >= 1, got {edge_chunk}")
        # resolve + validate the strategy and bind it into the topology:
        # the codecs and resolve_preds call topo.col_all_to_all
        self.exchange = get_exchange(exchange, topo.grid)
        if topo.exchange is not self.exchange:
            topo = topo.with_exchange(self.exchange)
        self.topo = topo
        self.grid = topo.grid
        self.device = topo.device
        self.program = program
        self.edge_chunk = int(edge_chunk)
        self.max_levels = int(max_levels)
        self.dedup = dedup
        self.telemetry = bool(telemetry)
        self.fault_tolerance = bool(fault_tolerance)
        self.ckpt_every = max(1, int(ckpt_every))
        self.fold_path = resolve_path(fold, self.device, knob="fold")
        self.bottomup_path = resolve_path(bottomup, self.device,
                                          knob="bottomup")
        # a custom hook wins over `expand`; the value programs then run the
        # plain value scan (JAX's precedence)
        self.value_expand_fn = None
        if expand_fn is not None:
            self.expand_path = "custom"
        else:
            self.expand_path = resolve_path(expand, self.device,
                                            knob="expand")
            if self.expand_path == "kernel":
                expand_fn = expand_kernels.make_expand_fn(path="kernel")
                self.value_expand_fn = expand_kernels.make_value_expand_fn(
                    path="kernel")
        self.expand_fn = expand_fn
        self.fold_ops = fold_kernels if self.fold_path == "kernel" else None
        self.bottomup_fn = self.value_bottomup_fn = None
        if program.uses_bottomup and self.bottomup_path == "kernel":
            self.bottomup_fn = bottomup_kernels.make_bottomup_fn(
                path="kernel")
            self.value_bottomup_fn = \
                bottomup_kernels.make_value_bottomup_fn(path="kernel")
        self.codec = get_fold_codec(
            fold_codec if fold_codec is not None else program.codec_hint,
            topo.grid, ops=self.fold_ops)
        self.trace_count = 0

    # -- the level loop -------------------------------------------------------
    #
    # One search's loop state is a `run` dict: the program state `st`, the
    # pending `plan` of the next level with its read `counts` (None once
    # the search stopped), the read frontier `total`, `active` (the
    # program's keep_going on it), the exact `scanned` int and the trace
    # record.  The unsegmented search advances one run to convergence; the
    # segmented loop advances it K levels at a time.

    def _begin(self, graph, arg) -> dict:
        """A search's initial run: init, the first level's plan and read."""
        blk = self.topo.local
        tr = T.init_trace(self.max_levels, (blk.Rl, blk.Cl), self.device) \
            if self.telemetry else None
        run = {"st": self.program.init(self, graph, arg), "scanned": 0,
               "trace": tr}
        self._replan(run, graph)
        return run

    def _replan(self, run, graph) -> None:
        """Plan the run's next level and make the level's ONE host read."""
        prog = self.program
        plan = prog.plan(self, graph, run["st"])
        counts = plan.counts.tolist()          # the level's host read
        active = bool(prog.keep_going(self, run["st"], counts[0]))
        run.update(plan=plan if active else None,
                   counts=counts if active else None, total=counts[0],
                   active=active)

    def _advance(self, run, graph, extra, limit=None) -> None:
        """Run up to `limit` levels of the run (None = to convergence), in
        place."""
        prog = self.program
        step = prog.make_step(self, graph, extra)
        tr = run["trace"]
        k = 0
        while run["active"] and (limit is None or k < limit):
            counts = run["counts"]
            front_dev = None if tr is None else prog.front_count(run["st"])
            st, level_scanned, aux = step(run["st"], run["plan"], counts)
            run["st"] = st
            run["scanned"] += level_scanned
            if tr is not None:
                T.record_level(tr, frontier=counts[0], front_dev=front_dev,
                               scanned=aux["scanned"],
                               aux=T.normalize_aux(aux))
            self._replan(run, graph)
            k += 1

    def _outputs(self, run) -> tuple:
        """A run's per-search outputs: finalize's, then edges_scanned, then
        the trace outputs with telemetry on."""
        outs = tuple(self.program.finalize(self, run["st"])) \
            + (self.topo.total(run["scanned"]),)
        tr = run["trace"]
        return outs if tr is None else outs + T.trace_outputs(tr)

    def _search(self, graph, arg, extra):
        run = self._begin(graph, arg)
        self._advance(run, graph, extra)
        return self._outputs(run)

    def assemble(self, outs, B):
        """Per-search outputs -> the program's output object, with the
        telemetry split off, assembled into host `LevelTrace`s (one read of
        the device record, every rank's fetched in it across a group),
        attached as the output's `trace`."""
        if not self.telemetry:
            return self.program.assemble(self, outs, B)
        n = T.N_TRACE_OUTS
        trace = T.assemble_traces(
            [o[-n:] for o in outs], B, grid=self.grid,
            program=self.program.name, codec=self.codec.name,
            fetch=self.topo.fetch)
        out = self.program.assemble(self, [o[:-n] for o in outs], B)
        return dataclasses.replace(out, trace=trace)

    def run(self, graph, arg, extra=()):
        """One search from `arg` (a root); extra = the program's further
        per-processor graph arrays (the CSR twin for direction
        optimisation)."""
        return self.assemble([self._search(graph, arg, extra)], None)

    def run_batch(self, graph, args, extra=()):
        """A batch of searches, one after another (`lax.map`'s order)."""
        outs = [self._search(graph, int(a), extra) for a in args]
        return self.assemble(outs, len(outs))

    # -- segmented level loop (DESIGN.md sec. 15) ----------------------------
    #
    # The same init / step / finalize as `_search`, split at checkpoint
    # lines: `ft_start` runs init and the first read, `ft_segment` at most
    # `ckpt_every` levels of every search in the carry (a batch advances
    # all its searches, as the JAX package's `lax.map` does), `ft_finish`
    # finalize.  The carry is a list of runs, one per search.  Level k's
    # inputs are exactly the run level k-1 produced, so segmented outputs
    # are bit-identical to the unsegmented loop for every K.

    def _ft(self) -> None:
        if not self.fault_tolerance:
            raise ValueError(
                "segmented traversal needs BFSConfig(fault_tolerance=True)")

    def ft_start(self, graph, arg, *extra, batched=False) -> list:
        """Init carry for one search (scalar arg) or a batch (a sequence of
        args)."""
        self._ft()
        return [self._begin(graph, a) for a in (arg if batched else [arg])]

    def ft_segment(self, graph, carry, *extra, batched=False) -> list:
        """Advance every active search of the carry by at most `ckpt_every`
        levels.  The input carry is left untouched: the steps update their
        state tensors in place, so each active search continues on a
        device clone of its state and trace record (the plan is only
        read), and a failed segment retries from the same input."""
        self._ft()
        out = []
        for run in carry:
            if run["active"]:
                run = _clone_run(run)
                if run["plan"] is None:        # imported: plan, read
                    self._replan(run, graph)
                self._advance(run, graph, extra, limit=self.ckpt_every)
            out.append(run)
        return out

    def ft_finish(self, carry, B=None):
        """Finalize a converged carry through the shared assemble funnel."""
        self._ft()
        return self.assemble([self._outputs(run) for run in carry], B)

    def ft_active(self, carry) -> bool:
        """Host check: does any search in the carry still have work?"""
        return any(run["active"] for run in carry)

    def ft_levels_done(self, carry) -> int:
        """Host readout: levels completed so far (max over a batch)."""
        return max(self.program.level_count(run["st"]) for run in carry) - 1

    # -- carry export / import (the checkpoint schema; DESIGN.md sec. 15) ----

    def export_carry(self, carry, *, n=None, B=None) -> dict:
        """Segmented-loop carry -> grid-independent host snapshot, the JAX
        package's schema array for array.

        `arrays` is a nested dict of numpy arrays (what CheckpointManager
        persists); `meta` is the JSON-able identity the checkpointer keys
        on.  The per-vertex state is exported in GLOBAL vertex-id order and
        sliced to the raw `n`, so the snapshot can re-shard onto any grid
        (`import_carry` re-pads); `total` / `active` are the last read
        (0-d, or (B,) for a batch) and `scanned` the exact edge count as
        one int64 each (JAX sums its (hi, lo) uint32 pairs into it).
        Across a process group the programs fetch the rank's blocks and
        `scanned` sums every rank's, so every rank returns the same
        snapshot.
        """
        n = int(self.grid.n if n is None else n)
        prog = self.program
        snaps = [prog.export_state(self, run["st"], n) for run in carry]

        def per_search(vals, dtype):
            return np.asarray(vals[0] if B is None else vals, dtype)

        scanned = self.topo.totals([run["scanned"] for run in carry])
        arrays = {"st": snaps[0] if B is None
                  else {f"b{b}": s for b, s in enumerate(snaps)},
                  "total": per_search([r["total"] for r in carry], np.int64),
                  "active": per_search([r["active"] for r in carry], bool),
                  "scanned": per_search(scanned, np.int64)}
        if self.telemetry:
            arrays["trace"] = self._export_trace(carry, B)
        meta = {"program": prog.name, "codec": self.codec.name,
                "grid": [self.grid.R, self.grid.C], "B": B, "n": n,
                "max_levels": int(self.max_levels),
                "levels_done": max(int(s["levels_done"]) for s in snaps)}
        return {"arrays": arrays, "meta": meta}

    def import_carry(self, snapshot: dict, *, B=None) -> list:
        """Host snapshot -> carry on THIS engine's grid (the resume half of
        `export_carry`; the grids need not match -- elastic resume
        re-shards the global state onto the survivor grid).  The pending
        plan is left out: the first segment plans and reads it, the read
        the resumed loop makes anyway."""
        arrays = snapshot["arrays"]
        prog = self.program
        snaps = [arrays["st"]] if B is None \
            else [arrays["st"][f"b{b}"] for b in range(B)]
        sts = [prog.import_state(self, s) for s in snaps]
        traces = None
        if self.telemetry:
            traces = self._import_trace(arrays.get("trace"), B,
                                        snapshot["meta"]["levels_done"])
        return self._place_carry(sts, arrays, traces)

    def _place_carry(self, sts, arrays, traces) -> list:
        """Imported states + the snapshot's per-search scalars + host trace
        channels -> the carry's runs on this engine's device (the
        `reshard_state` placement of elastic resume).  Across a process
        group a rank keeps its blocks of the trace channels, and the rank
        holding processor (0, 0) carries the snapshot's `scanned` (JAX
        puts its (hi, lo) pair there), the others 0, so the group's sum
        stays exact."""
        from repro_torch.ckpt.elastic import reshard_state

        total = np.atleast_1d(arrays["total"])
        active = np.atleast_1d(arrays["active"])
        blk = self.topo.local
        scanned = np.atleast_1d(arrays["scanned"]) if blk.owns(0, 0) \
            else np.zeros(len(sts), np.int64)
        runs = []
        for b, st in enumerate(sts):
            tr = None
            if traces is not None:
                tr = reshard_state(
                    {c: traces[b][c][blk.i0:blk.i0 + blk.Rl,
                                     blk.j0:blk.j0 + blk.Cl]
                     for c in T.TRACE_CHANNELS}, self.device)
                for c in ("scanned", "wire"):
                    tr[c] = tr[c].to(torch.int64)
                tr["k"], tr["L"] = int(traces[b]["k"]), int(self.max_levels)
            runs.append({"st": st, "plan": None, "counts": None,
                         "total": int(total[b]), "active": bool(active[b]),
                         "scanned": int(scanned[b]), "trace": tr})
        return runs

    def _export_trace(self, carry, B) -> dict:
        """Every run's trace record -> JAX's raw trace carry: each channel
        (R, C[, B], L) with L = max_levels (padded as a fresh record:
        0, `dir` -1; `scanned` / `wire` uint32), `k` (R, C[, B]).  For the
        value programs L = n + 1, as in the JAX snapshot.  Across a process
        group every rank's channels are fetched, in one read a search."""
        R, C, L = self.grid.R, self.grid.C, int(self.max_levels)
        recs = []
        for run in carry:
            tr = run["trace"]
            chans = torch.stack([tr[c].to(torch.int64)
                                 for c in T.TRACE_CHANNELS], dim=2)
            host = self.topo.fetch(chans).movedim(2, 0).cpu().numpy()
            rec = {}
            for ci, c in enumerate(T.TRACE_CHANNELS):
                a = host[ci]
                out = np.full((R, C, L), -1 if c == "dir" else 0,
                              np.uint32 if c in ("scanned", "wire")
                              else np.int32)
                out[:, :, :a.shape[-1]] = a
                rec[c] = out
            rec["k"] = np.full((R, C), tr["k"], np.int32)
            recs.append(rec)
        if B is None:
            return recs[0]
        return {c: np.stack([r[c] for r in recs], axis=2) for c in recs[0]}

    def _import_trace(self, traw, B, levels_done: int) -> list:
        """Raw (R0, C0[, B], L) trace channels -> one host record per search
        on this grid (channels (R, C, levels), `k`).

        Same grid: exact reimport.  Shrunken grid: per-processor work
        channels collapse onto processor (0, 0) (sums -- global per-level
        figures survive exactly, per-processor attribution does not) and
        the replicated channels broadcast from processor (0, 0).  No trace
        in the snapshot: a blank history with k advanced to `levels_done`,
        so post-resume levels land in the right slots.  Only the first
        max(64, k) levels are kept (the record grows from there)."""
        R, C = self.grid.R, self.grid.C
        shp = (R, C) + (() if B is None else (B,))
        L = int(self.max_levels)
        if traw is None:
            tr = {c: np.zeros(shp + (L,),
                              np.uint32 if c in ("scanned", "wire")
                              else np.int32)
                  for c in T.TRACE_CHANNELS}
            tr["dir"] = np.full(shp + (L,), -1, np.int32)
            tr["k"] = np.full(shp, levels_done, np.int32)
        elif tuple(traw["k"].shape[:2]) == (R, C):
            tr = {k: np.asarray(v) for k, v in traw.items()}
        else:
            tr = {}
            for c in ("front_dev", "scanned", "folded", "wire", "msgs"):
                a = np.asarray(traw[c])
                out = np.zeros(shp + (L,), a.dtype)
                out[0, 0] = a.sum(axis=(0, 1), dtype=np.int64).astype(a.dtype)
                tr[c] = out
            for c in ("frontier", "dir"):
                a = np.asarray(traw[c])
                tr[c] = np.broadcast_to(a[0, 0], shp + (L,)).copy()
            tr["k"] = np.broadcast_to(
                np.asarray(traw["k"])[0, 0], shp).copy().astype(np.int32)
        recs = []
        for b in range(1 if B is None else B):
            one = tr if B is None else {c: a[:, :, b] for c, a in tr.items()}
            k = int(one["k"][0, 0])
            cap = min(L, max(T.FIRST_LEVELS, k))
            rec = {c: one[c][..., :cap] for c in T.TRACE_CHANNELS}
            rec["k"] = k
            recs.append(rec)
        return recs


def _clone(x):
    """A copy of a state whose tensors a step may update in place."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return list(x)
    return x


def _clone_run(run: dict) -> dict:
    """A run a segment may advance without touching `run`: its state and
    trace record cloned, the plan shared (steps only read it)."""
    tr = run["trace"]
    return dict(run, st=_clone(run["st"]),
                trace=None if tr is None else {k: _clone(v)
                                               for k, v in tr.items()})
