"""The `FrontierProgram` contract (DESIGN.md sec. 8), the port of
`repro/algos/program.py`.

A frontier program is a distributed graph algorithm expressed against the
2D-partitioned engine: per-vertex state, a per-level step that expands the
frontier and folds to the owners, and a convergence predicate.  The engine
(`repro_torch.algos.engine.FrontierEngine`) supplies the eager level loop.
The contract and `pack_blocks` (the canonical value-fold buckets, which the
bottom-up BFS step uses) are ported; the value programs (CC, SSSP,
multi-source BFS) and their other shared blocks come with ROADMAP A8.
"""
from __future__ import annotations

import torch

from repro_torch.core import frontier as F
from repro_torch.core.types import Grid2D

I32_MAX = 2**31 - 1


class FrontierProgram:
    """What a distributed frontier algorithm implements.

    The engine calls, per search: `init`, `make_step` and `plan`, then the
    loop -- one host read of the plan's counts, `keep_going`, the step,
    `plan` again -- and finally `finalize`; `assemble` turns the per-search
    outputs into the program's output object.  `extra` is the program's
    per-processor graph arrays beyond the CSC (the CSR twin for direction
    optimisation), stacked (R, C, ...).
    """
    name = "?"
    codec_hint = "list"
    uses_bottomup = False

    def init(self, engine, graph, arg):
        """Stacked initial state for one search argument."""
        raise NotImplementedError

    def plan(self, engine, graph, st):
        """The level's device-side preparation.  Its `counts` attribute is
        a (1 + P,) int64 tensor: the global frontier size, then every
        processor's edges to scan -- the loop's ONE host read per level."""
        raise NotImplementedError

    def make_step(self, engine, graph, extra=()):
        """Return step(state, plan, counts) -> (state', edges scanned this
        level), counts being the plan's counts as read (ints)."""
        raise NotImplementedError

    def make_bottomup_step(self, engine, graph, extra):
        """Bottom-up twin of `plan` + `make_step`, consuming the CSR arrays
        at the END of `extra`: returns (plan_fn, step_fn), plan_fn(state)
        -> a plan whose counts are the global frontier size then every
        processor's bottom-up edges to scan, and step_fn like `make_step`'s
        step.  Its state trajectory must equal the top-down step's, so the
        direction driver may mix directions level by level."""
        raise NotImplementedError(
            f"{self.name} has no bottom-up step; it cannot run under "
            f"direction optimisation")

    def front_count(self, st):
        """Every processor's own frontier size, (R, C) int32."""
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


def pack_blocks(improved, vals, grid: Grid2D, fill_val=I32_MAX, ops=None):
    """Dense (..., n_rows_local) improvements -> canonical fold buckets.

    Local row m*S + t of block m maps to bucket row m, so the dense array IS
    the bucket structure after a reshape; per bucket, improved entries are
    front-packed ascending (the canonical form `FoldCodec.fold_values`
    requires).  Returns (ids (..., C, S) local-row ids pad -1, cnt
    (..., C), vals (..., C, S) aligned, pad `fill_val`).

    ops: the fold-kernel bundle for `core.frontier.compact_offsets`, which
    front-packs the offsets; bit-identical either way."""
    C, S = grid.C, grid.S
    lead = improved.shape[:-1]
    imp = improved.reshape(-1, S)
    ts, cnt = F.compact_offsets(imp, ops)
    m = torch.arange(C, dtype=torch.int32,
                     device=imp.device).repeat(imp.shape[0] // C)[:, None]
    ok = ts >= 0
    # pads are -1, so m*S + ts cannot overflow and one mask suffices
    ids = torch.where(ok, m * S + ts, -1)
    vs = torch.where(ok, torch.gather(vals.reshape(-1, S), 1,
                                      ts.clamp(min=0).long()), fill_val)
    return (ids.reshape(lead + (C, S)), cnt.reshape(lead + (C,)),
            vs.reshape(lead + (C, S)))
