"""The distributed-BFS engine under its historical constructor, the port of
`repro/dist/engine.py`.

The generic parts -- the level loop, batches, the exact edge accounting --
live in `repro_torch.algos.engine.FrontierEngine`, and BFS itself is one
frontier program (`repro_torch.algos.bfs.BFSLevelsProgram`).
`DistBFSEngine` is that pair under the JAX package's constructor: drivers
stay thin configurations (a topology, a fold codec and optionally a custom
per-level step).

Per-level step contract (what `step_factory` must produce; see
`BFSLevelsProgram`): the step runs over the topology's block,

    step(st: BFSState, prev_total: int) ->
        (new_st: BFSState, total, scanned[, aux])

`prev_total` is the global size of the frontier entering the level;
`scanned` the level's edges per processor of the block.  The default step
is the engine's own top-down expand -> scan -> fold -> update.  The JAX
hook `(engine, graph, extra, i, j, topdown)` takes the device coordinates
too; the port's `(engine, graph, extra, topdown)` covers the block.

Edge totals are exact Python ints (`wide_add` / `wide_total` keep the JAX
package's (hi, lo) uint32 pair contract for callers that hold such pairs).
"""
from __future__ import annotations

# Re-exports: these historically lived here and stay importable from here.
from repro_torch.algos.engine import FrontierEngine, wide_add, wide_total  # noqa: F401
from repro_torch.core.types import BFSOutput, LocalGraph2D  # noqa: F401
from repro_torch.dist.topology import Topology  # noqa: F401

# The BFS building blocks live in repro_torch.algos.bfs, which imports
# repro_torch.dist.exchange; PEP 562 keeps `from repro_torch.dist.engine
# import canonical_front` (etc.) working lazily, as in JAX.
_BFS_REEXPORTS = ("BFSLevelsProgram", "canonical_front", "init_state",
                  "owned_level", "topdown_step")


def __getattr__(name):
    if name in _BFS_REEXPORTS:
        from repro_torch.algos import bfs
        return getattr(bfs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class DistBFSEngine(FrontierEngine):
    """Whole-search BFS over a topology -- `BFSLevelsProgram` on the
    frontier engine.

    Parameters
    ----------
    topo:         `StackedTopology` or `GroupTopology` (see
                  `dist.topology.Topology` for binding a grid to a mesh).
    fold_codec:   "list" | "bitmap" | "delta" | FoldCodec instance.
    expand, fold, bottomup:
                  "auto" | "kernel" | "reference": the CUDA kernels or
                  their plain torch versions (`FrontierEngine`),
                  bit-identical either way.
    expand_fn:    explicit chunk-expansion hook (wins over `expand`).
    dedup:        winner-selection method ("scatter" | "sort").
    exchange:     fold exchange strategy ("flat" | "butterfly" | "auto" |
                  an ExchangeStrategy instance).
    step_factory: optional `(engine, graph, extra, topdown) -> step` hook
                  replacing the default top-down per-level step.
    n_extra:      number of extra per-processor (R, C, ...) graph arrays
                  the step consumes (e.g. the CSR twin for bottom-up).
    program:      optional BFS-shaped FrontierProgram overriding the
                  default `BFSLevelsProgram` (e.g. the direction-optimising
                  `DirectionProgram`); wins over step_factory / n_extra.
    telemetry, fault_tolerance, ckpt_every: as on `FrontierEngine`.
    """

    def __init__(self, topo, *, fold_codec="list", edge_chunk: int = 8192,
                 max_levels: int = 64, expand: str = "auto", expand_fn=None,
                 fold: str = "auto", dedup: str = "scatter",
                 bottomup: str = "auto", exchange="flat", step_factory=None,
                 n_extra: int = 0, program=None, telemetry: bool = False,
                 fault_tolerance: bool = False, ckpt_every: int = 1):
        from repro_torch.algos.bfs import BFSLevelsProgram

        if program is None:
            program = BFSLevelsProgram(step_factory=step_factory,
                                       n_extra=n_extra)
        self.step_factory = step_factory
        self.n_extra = program.n_extra
        super().__init__(
            topo, program,
            fold_codec=fold_codec, edge_chunk=edge_chunk,
            max_levels=max_levels, expand=expand, expand_fn=expand_fn,
            fold=fold, dedup=dedup, bottomup=bottomup, exchange=exchange,
            telemetry=telemetry, fault_tolerance=fault_tolerance,
            ckpt_every=ckpt_every)

    def topdown_step(self, graph: LocalGraph2D, st):
        """One top-down level (paper Alg. 2 lines 12-18) over the block:
        plans it (one host read), then (st', total, scanned, aux) as the
        step contract's `topdown` returns them."""
        from repro_torch.algos.bfs import plan_level, topdown_step

        plan = plan_level(self, graph, st)
        counts = plan.counts.tolist()
        st2, aux = topdown_step(self, graph, st, plan, counts[1:])
        return st2, self.topo.psum_all(st2.front_cnt), counts[1:], aux

    def run(self, graph: LocalGraph2D, root, *extra) -> BFSOutput:
        """Search from `root`; extra = the step_factory's per-processor
        arrays.

        Returns global (n,) level / pred in vertex-block order (b = j*R +
        i, i.e. plain global vertex ids), plus the exact scanned-edge count
        summed over processors and levels."""
        return super().run(graph, int(root), extra)

    def run_batch(self, graph: LocalGraph2D, roots, *extra) -> BFSOutput:
        """A batch of searches (the roots one after another): (B, n)
        level / pred, (B,) n_levels, a tuple of B edge counts."""
        return super().run_batch(graph, [int(r) for r in roots], extra)

    def assemble_batch(self, outs, B: int) -> BFSOutput:
        """Per-search outputs (`FrontierEngine._search`'s) -> the global
        (B, n) BFSOutput."""
        return self.assemble(outs, B)
