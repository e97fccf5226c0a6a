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
totals in Python ints (the JAX engine's `wide_add` (hi, lo) uint32 pair is
not needed).

A batch of searches runs root by root, as `lax.map` does.

With telemetry on, the loop records one level of `obs.trace` after each
step, where the JAX loop body does: the frontier total the level read, the
processors' frontier counts before the step, the step's per-processor
edges and its `aux` (folded entries, wire bytes, messages, direction).
The record stays on the device and is read once, when the search is
assembled, so the host reads per level do not change.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dist.exchange import get_fold_codec
from repro_torch.dist.strategy import get_exchange
from repro_torch.kernels import bottomup as bottomup_kernels
from repro_torch.kernels import expand as expand_kernels
from repro_torch.kernels import fold as fold_kernels
from repro_torch.kernels.select import resolve_path
from repro_torch.obs import trace as T


class FrontierEngine:
    """Whole-search driver for one `FrontierProgram` over a topology.

    topo:       `StackedTopology` (grid + device).
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
    """

    def __init__(self, topo, program, *, fold_codec=None,
                 edge_chunk: int = 8192, max_levels: int = 64,
                 expand: str = "auto", expand_fn=None, fold: str = "auto",
                 dedup: str = "scatter", bottomup: str = "auto",
                 exchange="flat", telemetry: bool = False):
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

    def _search(self, graph, arg, extra):
        prog = self.program
        st = prog.init(self, graph, arg)
        step = prog.make_step(self, graph, extra)
        scanned = 0
        tr = T.init_trace(self.max_levels, self.grid, self.device) \
            if self.telemetry else None
        plan = prog.plan(self, graph, st)
        while True:
            counts = plan.counts.tolist()      # the level's host read
            if not prog.keep_going(self, st, counts[0]):
                break
            front_dev = None if tr is None else prog.front_count(st)
            st, level_scanned, aux = step(st, plan, counts)
            scanned += level_scanned
            if tr is not None:
                T.record_level(tr, frontier=counts[0], front_dev=front_dev,
                               scanned=aux["scanned"],
                               aux=T.normalize_aux(aux))
            plan = prog.plan(self, graph, st)
        outs = tuple(prog.finalize(self, st)) + (scanned,)
        return outs if tr is None else outs + T.trace_outputs(tr)

    def assemble(self, outs, B):
        """Per-search outputs -> the program's output object, with the
        telemetry split off, assembled into host `LevelTrace`s (one read of
        the device record), attached as the output's `trace`."""
        if not self.telemetry:
            return self.program.assemble(self, outs, B)
        n = T.N_TRACE_OUTS
        trace = T.assemble_traces([o[-n:] for o in outs], B, grid=self.grid,
                                  program=self.program.name,
                                  codec=self.codec.name)
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
