"""The standard fault-drill matrix (DESIGN.md sec. 15), the port of
`repro/scenarios/fault_drills.py`.

Three drill families over the program x codec grid:

  loss-at-level-L   transient loss crossing level L, absorbed by the
                    segment retry -- every program x codec, session runner;
                    plus the "fold"-phase variant for BFS (the loss lands
                    while the fold exchange is in flight; segments are
                    atomic, so recovery is identical -- the drill proves
                    the phase makes no difference).
  loss-then-shrink  persistent loss exhausts the retries; the
                    ElasticCoordinator re-plans onto the survivor grid and
                    resumes -- every program x codec (the acceptance
                    matrix), plus one repeated-loss drill (two shrinks).
  serve-drain       a GraphServer batch interrupted mid-traversal drains
                    through recovery: zero lost queries, bit-identical
                    answers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.scenarios.base import Scenario, run_drill

PROGRAMS = ("bfs", "cc", "sssp", "multi_bfs")
CODECS = ("list", "bitmap")


def standard_matrix(*, programs=PROGRAMS, codecs=CODECS,
                    at_level: int = 2) -> list:
    """The drill list the CI fault-smoke runs."""
    out = []
    for p in programs:
        for c in codecs:
            out.append(Scenario(name=f"loss-at-level/{p}/{c}", program=p,
                                codec=c, at_level=at_level,
                                kind="transient", runner="session"))
    for c in codecs:
        out.append(Scenario(name=f"loss-during-fold/bfs/{c}", program="bfs",
                            codec=c, at_level=at_level, phase="fold",
                            kind="transient", runner="session"))
    for p in programs:
        for c in codecs:
            out.append(Scenario(name=f"loss-then-shrink/{p}/{c}", program=p,
                                codec=c, at_level=at_level,
                                kind="persistent", runner="elastic"))
    out.append(Scenario(name="repeated-loss-then-shrink/bfs/list",
                        program="bfs", codec="list", at_level=at_level,
                        kind="repeated", runner="elastic"))
    out.append(Scenario(name="serve-drain/bfs/list", program="bfs",
                        codec="list", at_level=at_level, kind="persistent",
                        runner="serve"))
    return out


def run_matrix(edges, config, *, weights=None, n=None, scenarios=None,
               log=None, device=None) -> list:
    """Run the matrix, sharing one uninterrupted baseline per
    (program, codec) across its drills.  Returns the DrillResult list."""
    from repro_torch.api.session import DistGraph
    from repro_torch.scenarios.base import _host_edges, _query_args

    if n is None:
        n = int(_host_edges(edges).max()) + 1
    scenarios = scenarios if scenarios is not None else standard_matrix()
    baselines: dict = {}
    results = []
    for sc in scenarios:
        bkey = (sc.program, sc.codec)
        if bkey not in baselines:
            bcfg = dataclasses.replace(config, fold_codec=sc.codec)
            sess = DistGraph.from_edges(edges, bcfg, n=n, weights=weights,
                                        device=device).session()
            method, arg = _query_args(sc, edges, n)
            baselines[bkey] = getattr(sess, method)(
                *(() if arg is None else (arg,)))
        res = run_drill(sc, edges=edges, config=config, weights=weights,
                        n=n, baseline=baselines[bkey], device=device)
        results.append(res)
        if log is not None:
            log(f"drill {res.name}: ok={res.ok} "
                f"bit_identical={res.bit_identical} "
                f"grid={res.grid_before}->{res.grid_after} "
                f"lost={res.lost_queries}"
                + (f" error={res.error}" if res.error else ""))
    return results
