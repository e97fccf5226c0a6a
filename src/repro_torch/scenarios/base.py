"""Fault-drill harness: scenario x injector x runner (DESIGN.md sec. 15),
the port of `repro/scenarios/base.py`.

A drill runs ONE query under an injected device-loss schedule and judges the
recovered output against the same query run uninterrupted:

  Scenario  what breaks: the program/codec under test, the level the loss
            lands on, the phase label, and the loss kind --
            "transient" (one loss, absorbed by the segment retry),
            "persistent" (retries exhaust -> elastic shrink-and-resume), or
            "repeated" (a second loss after the first resume -> two
            shrinks).
  Runner    who recovers: "session" (RecoveryPlan on a GraphSession query),
            "elastic" (ElasticCoordinator re-plans onto the survivor grid),
            or "serve" (a GraphServer drains the in-flight batch through
            recovery).
  DrillResult  the verdict: completion, bit-identity against the
            uninterrupted baseline, Graph500 predecessor validity where
            bit-identity is not the contract (BFS preds after a SHRUNKEN
            resume are grid-dependent), lost queries, and the recovery
            latency (recorded, never gated).
"""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.runtime.fault import RetryPolicy
from repro_torch.runtime.recovery import (DeviceLossInjector,
                                          ElasticCoordinator, RecoveryPlan)


@dataclasses.dataclass
class Scenario:
    """One drill: which query breaks, where, and who recovers it."""
    name: str
    program: str              # "bfs" | "cc" | "sssp" | "multi_bfs"
    codec: str = "list"       # fold codec under test
    at_level: int = 2         # the level the loss schedule crosses
    phase: str = "level"      # "level" | "fold" (drill label; see injector)
    kind: str = "transient"   # "transient" | "persistent" | "repeated"
    runner: str = "session"   # "session" | "elastic" | "serve"


@dataclasses.dataclass
class DrillResult:
    """Verdict of one drill (the BENCH_fault row)."""
    name: str
    scenario: str
    injector: str
    runner: str
    ok: bool
    bit_identical: "bool | None" = None   # None = not the contract here
    pred_valid: "bool | None" = None      # BFS only
    lost_queries: int = 0
    resumed_from_level: "int | None" = None
    time_to_first_resumed_level_s: "float | None" = None
    grid_before: "tuple | None" = None
    grid_after: "tuple | None" = None
    retries: int = 0
    resumes: int = 0
    error: "str | None" = None

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        for k in ("grid_before", "grid_after"):
            if row[k] is not None:
                row[k] = list(row[k])
        return row


def _policy(kind: str) -> RetryPolicy:
    # jittered so the drill exercises the seeded backoff; near-zero base so
    # drills stay fast
    return RetryPolicy(max_retries=2, backoff_s=1e-4, jitter_s=1e-4, seed=3)


def _injector(sc: Scenario, policy: RetryPolicy) -> DeviceLossInjector:
    if sc.kind == "transient":
        return DeviceLossInjector(sc.at_level, phase=sc.phase,
                                  transient=True)
    # persistent/repeated: enough fires to exhaust one full retry budget
    # per loss event, then quiet so the resumed traversal completes
    per_loss = policy.max_retries + 1
    n_losses = 2 if sc.kind == "repeated" else 1
    return DeviceLossInjector(sc.at_level, phase=sc.phase,
                              fires=per_loss * n_losses)


def _host_edges(edges) -> np.ndarray:
    return edges.cpu().numpy() if isinstance(edges, torch.Tensor) \
        else np.asarray(edges)


def _query_args(sc: Scenario, edges, n: int):
    """(method name, positional arg) for the scenario's program."""
    deg = np.bincount(_host_edges(edges)[0], minlength=n)
    live = np.flatnonzero(deg > 0)
    picks = np.random.default_rng(0).choice(live, 4, replace=False)
    roots = picks.astype(np.int32)
    if sc.program == "bfs":
        return "bfs", roots
    if sc.program == "sssp":
        return "sssp", roots
    if sc.program == "multi_bfs":
        return "multi_bfs", roots
    if sc.program == "cc":
        return "connected_components", None
    raise ValueError(f"unknown drill program {sc.program!r}")


def _eq(a, b, n: int) -> bool:
    """Equal on the raw vertex range (the last axis cut to n)."""
    return torch.equal(a[..., :n].cpu(), b[..., :n].cpu())


def _compare(sc: Scenario, out, base, edges, arg, n: int):
    """(bit_identical, pred_valid) of a recovered output vs the baseline.

    Everything except BFS predecessors is grid-independent, so it must be
    bit-identical even after a shrink; BFS preds are only required
    bit-identical on a same-grid recovery (the "session" runner) and
    Graph500-validated otherwise (on the output's device).
    """
    from repro_torch.core.validate import validate_bfs
    same_grid = sc.runner != "elastic"
    pred_valid = None
    if sc.program == "bfs":
        bit = (_eq(out.level, base.level, n)
               and torch.equal(out.n_levels.cpu(), base.n_levels.cpu())
               and tuple(out.edges_scanned) == tuple(base.edges_scanned))
        if same_grid:
            bit = bit and _eq(out.pred, base.pred, n)
        e = edges if isinstance(edges, torch.Tensor) \
            else torch.from_numpy(np.array(edges, np.int32))
        e = e.to(out.level.device)
        try:
            for b, root in enumerate(arg):
                validate_bfs(e, out.level[b][:n], out.pred[b][:n], int(root))
            pred_valid = True
        except AssertionError:
            pred_valid = False
        return bool(bit), pred_valid
    if sc.program == "cc":
        bit = (_eq(out.labels, base.labels, n)
               and int(out.n_iters) == int(base.n_iters)
               and out.edges_scanned == base.edges_scanned)
        return bool(bit), None
    if sc.program == "sssp":
        bit = (_eq(out.dist, base.dist, n)
               and tuple(out.edges_scanned) == tuple(base.edges_scanned))
        return bool(bit), None
    bit = (_eq(out.level, base.level, n) and _eq(out.src, base.src, n)
           and out.edges_scanned == base.edges_scanned)
    return bool(bit), None


def _run_serve(sc: Scenario, ft_config, graph_factory, arg, stats: dict):
    """Serve-drain drill: one FT batch interrupted mid-traversal must
    drain through recovery with zero lost queries.

    The server runs with max_retries=0, so ONE fire makes the loss escape
    the segmented loop; the drain re-dispatch then resumes past it --
    that is the persistent-loss story at serve granularity."""
    from repro_torch.serve import GraphServer, ServeConfig

    injector = DeviceLossInjector(sc.at_level, phase=sc.phase, fires=1)
    graph = graph_factory(ft_config)
    with tempfile.TemporaryDirectory() as d:
        cfg = ServeConfig(retry=RetryPolicy(max_retries=0, backoff_s=0.0),
                          recovery_dir=d, window_s=0.05,
                          max_batch=len(arg))
        with GraphServer({"drill": graph}, cfg) as srv:
            tickets = [srv.bfs("drill", int(r), tenant=f"t{i}",
                               injector=injector if i == 0 else None)
                       for i, r in enumerate(arg)]
            results = [t.result(timeout=300) for t in tickets]
            srv.drain()
            snap = srv.metrics_snapshot()["runners"]["drill"]
    stats["resumes"] = snap["recovery_resumes"]
    lost = sum(0 if r.ok else 1 for r in results)
    values = [r.value for r in results if r.ok]
    return values, lost


def run_drill(sc: Scenario, *, edges, config, weights=None, n=None,
              baseline=None, device=None) -> DrillResult:
    """Execute one scenario and judge the recovery.

    edges/weights/n/config describe the graph and base query config (grid
    included); `baseline` optionally reuses a precomputed uninterrupted
    output (keyed by program+codec -- `run_matrix` shares them across
    scenarios); device: where every graph is planned (None = CUDA).
    """
    from repro_torch.api.session import DistGraph

    if n is None:
        n = int(_host_edges(edges).max()) + 1
    method, arg = _query_args(sc, edges, n)
    ft_config = dataclasses.replace(config, fault_tolerance=True,
                                    fold_codec=sc.codec)
    base_config = dataclasses.replace(config, fold_codec=sc.codec)

    def graph_factory(cfg):
        return DistGraph.from_edges(edges, cfg, n=n, weights=weights,
                                    device=device)

    if baseline is None:
        bsess = graph_factory(base_config).session()
        baseline = getattr(bsess, method)(*(() if arg is None else (arg,)))

    policy = _policy(sc.kind)
    injector = _injector(sc, policy)
    inj_desc = (f"at_level={sc.at_level} phase={sc.phase} kind={sc.kind} "
                f"fires={injector.fires}")
    plan = RecoveryPlan(injector=injector, policy=policy)
    grid = config.resolve_grid(n)
    result = DrillResult(name=sc.name, scenario=f"{sc.program}/{sc.codec}",
                         injector=inj_desc, runner=sc.runner, ok=False,
                         grid_before=(grid.R, grid.C))
    try:
        if sc.runner == "serve":
            stats = {}
            values, lost = _run_serve(sc, ft_config, graph_factory, arg,
                                      stats)
            result.lost_queries = lost
            result.resumes = int(stats.get("resumes", 0))
            result.grid_after = (grid.R, grid.C)
            if lost == 0:
                result.bit_identical = all(
                    _eq(v.level, baseline.level[b], n)
                    and _eq(v.pred, baseline.pred[b], n)
                    for b, v in enumerate(values))
                result.ok = result.bit_identical
        elif sc.runner == "elastic":
            coord = ElasticCoordinator(edges, ft_config, weights=weights,
                                       n=n, device=device,
                                       max_shrinks=2 if sc.kind != "repeated"
                                       else 3)
            out = coord.run(method, arg, plan=plan)
            result.grid_after = coord.grids[-1]
            result.bit_identical, result.pred_valid = _compare(
                sc, out, baseline, edges, arg, n)
            result.ok = result.bit_identical and result.pred_valid in (
                None, True) and coord.shrinks >= (
                2 if sc.kind == "repeated" else 1)
        else:
            sess = graph_factory(ft_config).session()
            out = getattr(sess, method)(
                *(() if arg is None else (arg,)), recovery=plan)
            result.grid_after = (grid.R, grid.C)
            result.bit_identical, result.pred_valid = _compare(
                sc, out, baseline, edges, arg, n)
            result.ok = result.bit_identical and result.pred_valid in (
                None, True)
    except Exception as exc:     # noqa: BLE001 -- drills report, not raise
        result.error = f"{type(exc).__name__}: {exc}"
        result.ok = False
        return result
    result.resumed_from_level = plan.stats.get("resumed_from_level")
    result.time_to_first_resumed_level_s = plan.stats.get(
        "time_to_first_resumed_level_s")
    result.retries = int(plan.stats.get("retries", 0))
    result.resumes = result.resumes or int(plan.stats.get("resumes", 0))
    return result
