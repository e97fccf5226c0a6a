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
"""
from __future__ import annotations

from repro_torch.dist.exchange import get_fold_codec
from repro_torch.dist.strategy import get_exchange
from repro_torch.kernels import bottomup as bottomup_kernels
from repro_torch.kernels import expand as expand_kernels
from repro_torch.kernels import fold as fold_kernels
from repro_torch.kernels.select import resolve_path


class FrontierEngine:
    """Whole-search driver for one `FrontierProgram` over a topology.

    topo:       `StackedTopology` (grid + device).
    program:    the FrontierProgram to drive.
    fold_codec: "list" | FoldCodec instance | None (program's hint).
    edge_chunk: CSC scan chunk size of the expand phase.
    max_levels: loop bound fed to `program.keep_going`.
    expand:     "auto" | "kernel" | "reference": the chunk scan through the
                CUDA `expand_chunk` kernel (`expand_chunk_values` for the
                value programs) or the plain torch formulas
                (`kernels/select.py`).
    fold:       the same spellings for the fold kernels (`compact_rows`,
                the bitmap codec's `pack_bits` / `unpack_bits`, the delta
                codec's `delta_gaps` / `delta_positions`).
    dedup:      winner-selection method ("scatter" | "sort").
    bottomup:   the same spellings for the bottom-up chunk scan
                (`bottomup_chunk`, `bottomup_chunk_values`); consulted only
                by programs that declare `uses_bottomup` (the
                direction-optimising wrapper).
    exchange:   fold exchange strategy ("flat").
    """

    def __init__(self, topo, program, *, fold_codec=None,
                 edge_chunk: int = 8192, max_levels: int = 64,
                 expand: str = "auto", fold: str = "auto",
                 dedup: str = "scatter", bottomup: str = "auto",
                 exchange: str = "flat"):
        if edge_chunk < 1:
            raise ValueError(f"edge_chunk must be >= 1, got {edge_chunk}")
        self.topo = topo
        self.grid = topo.grid
        self.device = topo.device
        self.program = program
        self.edge_chunk = int(edge_chunk)
        self.max_levels = int(max_levels)
        self.dedup = dedup
        self.exchange = get_exchange(exchange, topo.grid)
        self.expand_path = resolve_path(expand, self.device, knob="expand")
        self.fold_path = resolve_path(fold, self.device, knob="fold")
        self.bottomup_path = resolve_path(bottomup, self.device,
                                          knob="bottomup")
        expand_k = self.expand_path == "kernel"
        self.expand_fn = expand_kernels.expand_chunk if expand_k else None
        self.value_expand_fn = (expand_kernels.expand_chunk_values
                                if expand_k else None)
        self.fold_ops = fold_kernels if self.fold_path == "kernel" else None
        bottomup_k = program.uses_bottomup and self.bottomup_path == "kernel"
        self.bottomup_fn = (bottomup_kernels.bottomup_chunk
                            if bottomup_k else None)
        self.value_bottomup_fn = (bottomup_kernels.bottomup_chunk_values
                                  if bottomup_k else None)
        self.codec = get_fold_codec(
            fold_codec if fold_codec is not None else program.codec_hint,
            topo.grid, ops=self.fold_ops)

    def _search(self, graph, arg, extra):
        prog = self.program
        st = prog.init(self, graph, arg)
        step = prog.make_step(self, graph, extra)
        scanned = 0
        plan = prog.plan(self, graph, st)
        while True:
            counts = plan.counts.tolist()      # the level's host read
            if not prog.keep_going(self, st, counts[0]):
                break
            st, level_scanned = step(st, plan, counts)
            scanned += level_scanned
            plan = prog.plan(self, graph, st)
        return tuple(prog.finalize(self, st)) + (scanned,)

    def run(self, graph, arg, extra=()):
        """One search from `arg` (a root); extra = the program's further
        per-processor graph arrays (the CSR twin for direction
        optimisation)."""
        return self.program.assemble(
            self, [self._search(graph, arg, extra)], None)

    def run_batch(self, graph, args, extra=()):
        """A batch of searches, one after another (`lax.map`'s order)."""
        outs = [self._search(graph, int(a), extra) for a in args]
        return self.program.assemble(self, outs, len(outs))
