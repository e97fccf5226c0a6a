"""The `FrontierProgram` contract (DESIGN.md sec. 8), the port of
`repro/algos/program.py`.

A frontier program is a distributed graph algorithm expressed against the
2D-partitioned engine: per-vertex state, a per-level step that expands the
frontier and folds to the owners, and a convergence predicate.  The engine
(`repro_torch.algos.engine.FrontierEngine`) supplies the eager level loop.
Only the contract is ported so far; the value programs (CC, SSSP,
multi-source BFS) and their shared blocks come with ROADMAP A8.
"""
from __future__ import annotations


class FrontierProgram:
    """What a distributed frontier algorithm implements.

    The engine calls, per search: `init`, `make_step` and `plan`, then the
    loop -- one host read of the plan's counts, `keep_going`, the step,
    `plan` again -- and finally `finalize`; `assemble` turns the per-search
    outputs into the program's output object.
    """
    name = "?"
    codec_hint = "list"

    def init(self, engine, graph, arg):
        """Stacked initial state for one search argument."""
        raise NotImplementedError

    def plan(self, engine, graph, st):
        """The level's device-side preparation.  Its `counts` attribute is
        a (1 + P,) int64 tensor: the global frontier size, then every
        processor's edges to scan -- the loop's ONE host read per level."""
        raise NotImplementedError

    def make_step(self, engine, graph):
        """Return step(state, plan, block_edges) -> state'."""
        raise NotImplementedError

    def keep_going(self, engine, st, total: int) -> bool:
        """Convergence predicate (True = run another level)."""
        raise NotImplementedError

    def finalize(self, engine, st) -> tuple:
        """Per-search output tensors."""
        raise NotImplementedError

    def assemble(self, engine, outs, B):
        """Per-search outputs -> output object (B=None for a scalar
        search, else the batch size)."""
        raise NotImplementedError
