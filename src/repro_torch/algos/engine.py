"""The frontier-program driver (DESIGN.md sec. 8), the port of
`repro/algos/engine.py:FrontierEngine`.

The JAX engine compiles the level loop into one `lax.while_loop`.  PyTorch
runs eagerly, so the loop is a Python loop with ONE host read per level:
the program's plan carries the global frontier size (for `keep_going`) and
every processor's edge total (how many chunks its scan runs) in one small
tensor, read together.  The chunk loops then run without further reads.
`edges_scanned` sums those exact totals in Python ints (the JAX engine's
`wide_add` (hi, lo) uint32 pair is not needed).

A batch of searches runs root by root, as `lax.map` does.
"""
from __future__ import annotations

import torch

from repro_torch.dist.exchange import get_fold_codec
from repro_torch.dist.strategy import get_exchange
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
                CUDA `expand_chunk` kernel or the plain torch formulas
                (`kernels/select.py`).
    fold:       the same spellings for the compaction (`compact_rows`).
    dedup:      winner-selection method ("scatter" | "sort").
    exchange:   fold exchange strategy ("flat").
    """

    def __init__(self, topo, program, *, fold_codec=None,
                 edge_chunk: int = 8192, max_levels: int = 64,
                 expand: str = "auto", fold: str = "auto",
                 dedup: str = "scatter", exchange: str = "flat"):
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
        self.codec = get_fold_codec(
            fold_codec if fold_codec is not None else program.codec_hint,
            topo.grid)
        self.expand_path = resolve_path(expand, self.device, knob="expand")
        self.fold_path = resolve_path(fold, self.device, knob="fold")
        self.expand_fn = (expand_kernels.expand_chunk
                          if self.expand_path == "kernel" else None)
        self.fold_ops = fold_kernels if self.fold_path == "kernel" else None

    def _search(self, graph, arg):
        prog = self.program
        st = prog.init(self, graph, arg)
        step = prog.make_step(self, graph)
        scanned = 0
        plan = prog.plan(self, graph, st)
        while True:
            counts = plan.counts.tolist()      # the level's one host read
            if not prog.keep_going(self, st, counts[0]):
                break
            st = step(st, plan, counts[1:])
            scanned += sum(counts[1:])
            plan = prog.plan(self, graph, st)
        return tuple(prog.finalize(self, st)) + (scanned,)

    def run(self, graph, arg):
        """One search from `arg` (a root)."""
        return self.program.assemble(self, [self._search(graph, arg)], None)

    def run_batch(self, graph, args):
        """A batch of searches, one after another (`lax.map`'s order)."""
        outs = [self._search(graph, int(a)) for a in args]
        return self.program.assemble(self, outs, len(outs))
