"""Mid-traversal fault tolerance (DESIGN.md sec. 15), the port of
`repro/runtime/recovery.py`.

The segmented engine loop (`FrontierEngine.ft_start/ft_segment/ft_finish`)
runs the eager level loop in checkpoint-bounded segments of at most
`ckpt_every` levels, with the level-loop carry held on the host side
between segments.  This module is the driver around it:

  DeviceLossInjector   simulated device loss, fired when a segment crosses a
                       scheduled level (there are no real link errors to
                       observe on one card, so the failure signal is
                       injected -- same stance as `FaultInjector`).
  run_segmented        the segment loop: StepRunner-wrapped retry of each
                       segment (a failed segment re-executes from its input
                       carry -- `ft_segment` works on a clone and leaves it
                       untouched, so rollback is free), a checkpoint after
                       every successful segment, and escalation of
                       exhausted retries to UnrecoverableLoss carrying the
                       last good snapshot.
  TraversalCheckpointer  CheckpointManager glue: persists `export_carry`
                       snapshots keyed by (graph, arg batch, config) so a
                       restarted or re-gridded process resumes the query.
  ElasticCoordinator   shrink-and-resume: on UnrecoverableLoss drop the
                       failed processors, pick the survivor grid
                       (`shrink_grid`), re-plan the graph onto the new grid
                       on the same device and resume from the last
                       completed level.

Across a process group (`DistGraph.from_edges(..., mesh=)`) every rank
drives the same loop: the level count an injected loss checks is the
group's, so every rank fails and retries the same segment, and the retry
delays are a pure function of (seed, step, attempt).  A checkpoint is
written by the mesh's rank 0 alone (synchronously), in the same layout,
and its outcome reaches every rank before any goes on (`multihost.
raise_together`); every rank loads the same directory, which must be one
filesystem the ranks share.  The elastic coordinator plans across the
group as the JAX package's plans across `jax.devices()`, the survivor grid
on the first ranks (see `ElasticCoordinator`).

Bit-identity contract: segment boundaries add no arithmetic and no host
read, so segmented outputs equal the unsegmented loop's for every
ckpt_every; a same-grid resume is bit-identical including BFS
predecessors; a shrunken resume keeps levels / labels / distances /
n_levels / edges_scanned bit-identical (BFS predecessors are
grid-dependent -- the bottom-up merge gives the own column block priority
-- so they re-validate by the Graph500 rules instead; see DESIGN.md
sec. 15).  Snapshots are the JAX package's schema, so either package
resumes the other's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch.runtime.fault import RetryPolicy, StepRunner


class DeviceLoss(RuntimeError):
    """A (simulated) device dropped out mid-segment."""

    def __init__(self, msg: str, devices: int = 1):
        super().__init__(msg)
        self.devices = int(devices)


class UnrecoverableLoss(RuntimeError):
    """Retries exhausted: the query cannot continue on this grid.

    Carries everything elastic resume needs: the last good snapshot (the
    carry BEFORE the failed segment -- segments are atomic, so no partial
    level is ever visible), the level it covers, and the failed device
    count.
    """

    def __init__(self, snapshot: dict, level: int, failed: int = 1):
        super().__init__(
            f"device loss unrecoverable at level {level} "
            f"({failed} device(s) down)")
        self.snapshot = snapshot
        self.level = int(level)
        self.failed = int(failed)


class DeviceLossInjector:
    """Deterministic device-loss schedule for drills and tests.

    Fires a DeviceLoss when a segment CROSSES `at_level` -- i.e. the segment
    advanced the traversal from below `at_level` to at/past it -- which is
    exactly when a real mid-level link failure would surface from the
    collective.  `phase` labels where in the level the loss lands ("level" |
    "fold" -- the segment is atomic either way, so the label only names the
    drill); `transient` losses fire once and stay quiet (a retry succeeds),
    persistent ones fire on every crossing attempt until the optional
    `fires` budget runs out (retries exhaust -> UnrecoverableLoss).
    """

    def __init__(self, at_level: int, *, devices: int = 1,
                 phase: str = "level", transient: bool = False,
                 fires: int | None = None):
        if phase not in ("level", "fold"):
            raise ValueError(f"phase={phase!r}: expected 'level' or 'fold'")
        self.at_level = int(at_level)
        self.devices = int(devices)
        self.phase = phase
        if fires is None:
            fires = 1 if transient else None
        self.fires = fires          # None = every crossing attempt
        self.count = 0              # losses actually fired

    def check(self, lv_before: int, lv_after: int) -> None:
        if not (lv_before < self.at_level <= lv_after):
            return
        if self.fires is not None and self.count >= self.fires:
            return
        self.count += 1
        raise DeviceLoss(
            f"injected loss of {self.devices} device(s) crossing level "
            f"{self.at_level} ({self.phase})", devices=self.devices)


class TraversalCheckpointer:
    """Persist `export_carry` snapshots through a CheckpointManager.

    One directory per query identity: `query_key` (whatever JSON-able string
    the caller derives from graph + arg batch + config, EXCLUDING the grid
    and exchange strategy -- the snapshot is grid-canonical, so an elastic
    resume on a different grid must still match) is stamped into every
    manifest and validated on load, so a directory accidentally shared
    between queries fails loudly instead of resuming the wrong search.
    """

    def __init__(self, directory: str, query_key: str, *, keep: int = 3,
                 async_write: bool = True):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        self.manager = CheckpointManager(directory, keep=keep,
                                         async_write=async_write)
        self.query_key = str(query_key)

    def save(self, snapshot: dict) -> None:
        meta = snapshot["meta"]
        self.manager.save(int(meta["levels_done"]), snapshot["arrays"],
                          extra_meta={**meta, "query_key": self.query_key})

    def load(self) -> dict | None:
        """Latest snapshot, or None when the directory holds none."""
        arrays, manifest = self.manager.restore_tree()
        if arrays is None:
            return None
        meta = dict(manifest["meta"])
        saved_key = meta.pop("query_key", None)
        if saved_key != self.query_key:
            raise ValueError(
                f"checkpoint directory holds query_key={saved_key!r} but "
                f"this query is {self.query_key!r}; refusing to resume a "
                "different search")
        return {"arrays": arrays, "meta": meta}

    def join(self) -> None:
        self.manager.join()


def _fresh_stats() -> dict:
    return {"resumes": 0, "segments": 0, "retries": 0, "delays": [],
            "resumed_from_level": None,
            "time_to_first_resumed_level_s": None}


@dataclasses.dataclass
class RecoveryPlan:
    """Everything one fault-tolerant query threads through the driver.

    checkpointer: persists a snapshot after every successful segment and is
                  the default resume source.  None = in-memory only (the
                  UnrecoverableLoss snapshot still enables elastic resume).
    injector:     simulated loss schedule (None in production).
    policy:       per-segment retry/backoff (the jittered RetryPolicy).
    resume:       explicit snapshot to resume from (wins over the
                  checkpointer's latest).
    stats:        filled by `run_segmented`: resumes, segments, retries,
                  the jittered delays actually slept, resumed_from_level and
                  time_to_first_resumed_level_s (the recovery-latency figure
                  the drill harness records; never a gate).
    """
    checkpointer: TraversalCheckpointer | None = None
    injector: DeviceLossInjector | None = None
    policy: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    resume: dict | None = None
    stats: dict = dataclasses.field(default_factory=_fresh_stats)


def run_segmented(engine, graph, arg, *extra, B=None, n=None, plan=None):
    """Drive one query through the segmented engine loop.

    engine/graph/arg/extra mirror the engine's compiled entry points (arg is
    the device-placed root / roots batch / sources vector); B is the batch
    size (None = scalar program), n the raw vertex count exported into
    snapshots.  Returns the program's assembled output, bit-identical to the
    unsegmented run.  Raises UnrecoverableLoss when a segment exhausts its
    retries; the caller (ElasticCoordinator, the serve drain path) decides
    whether to shrink, re-queue, or give up.
    """
    plan = plan if plan is not None else RecoveryPlan()
    for k, v in _fresh_stats().items():
        plan.stats.setdefault(k, v)
    batched = B is not None
    injector = plan.injector

    carry = None
    if plan.resume is not None:
        carry = engine.import_carry(plan.resume, B=B)
    elif plan.checkpointer is not None:
        snap = plan.checkpointer.load()
        if snap is not None:
            carry = engine.import_carry(snap, B=B)
    resumed = carry is not None
    if carry is None:
        carry = engine.ft_start(graph, arg, *extra, batched=batched)
    if resumed:
        plan.stats["resumes"] += 1
        plan.stats["resumed_from_level"] = engine.ft_levels_done(carry)
    # recovery latency reference: the coordinator stamps the moment of loss
    # (so re-plan + recompile count); a plain checkpointer resume counts
    # from here
    t_ref = plan.stats.pop("_t_loss", None)
    if t_ref is None:
        t_ref = time.perf_counter()
    awaiting_first = resumed

    def step_fn(c, _batch):
        lv0 = engine.ft_levels_done(c)
        c2 = engine.ft_segment(graph, c, *extra, batched=batched)
        lv1 = engine.ft_levels_done(c2)
        if injector is not None:
            # inside the step so a retry re-checks the same crossing; the
            # input carry is untouched by ft_segment, so the rollback to
            # the segment boundary is implicit
            injector.check(lv0, lv1)
        return c2, lv1

    runner = StepRunner(step_fn, policy=plan.policy)
    step_no = 0
    try:
        while engine.ft_active(carry):
            try:
                carry, _ = runner.run(carry, [None], start_step=step_no)
            except DeviceLoss as e:
                snap = engine.export_carry(carry, n=n, B=B)
                if plan.checkpointer is not None:
                    # make the last snapshot durable BEFORE handing off --
                    # the resuming process may open the directory instantly
                    plan.checkpointer.join()
                raise UnrecoverableLoss(snap, engine.ft_levels_done(carry),
                                        failed=e.devices) from e
            step_no += 1
            plan.stats["segments"] += 1
            if awaiting_first:
                plan.stats["time_to_first_resumed_level_s"] = (
                    time.perf_counter() - t_ref)
                awaiting_first = False
            if plan.checkpointer is not None:
                _save_together(plan.checkpointer,
                               engine.export_carry(carry, n=n, B=B),
                               engine.topo)
    finally:
        plan.stats["retries"] += runner.retries
        plan.stats["delays"].extend(runner.delays)
    if plan.checkpointer is not None:
        plan.checkpointer.join()
    return engine.ft_finish(carry, B=B)


def _save_together(checkpointer, snap, topo) -> None:
    """Persist a snapshot: on the stacked grid through the checkpointer as
    it is; across a process group by the mesh's rank 0 alone, waited for,
    its outcome raised on every rank together."""
    if not topo.distributed:
        checkpointer.save(snap)
        return
    from repro_torch.dist import multihost
    err = None
    if topo.mesh.rank == 0:
        try:
            checkpointer.save(snap)
            checkpointer.join()
        except Exception as e:          # noqa: BLE001 -- raised together
            err = e
    multihost.raise_together(err, topo.mesh.group)


class ElasticCoordinator:
    """Shrink-and-resume driver: re-plan onto the survivors and continue.

    Owns the edge list (re-partitioning needs it) and the query config;
    each UnrecoverableLoss drops the failed processors from the pool, picks
    the survivor grid via `shrink_grid`, re-plans the graph onto it and
    resumes the query from the loss snapshot.  `max_shrinks` bounds the
    repeated-loss drill.

    Without a process group every grid is stacked on `device` (None =
    CUDA, as the session entry points), so the coordinator re-plans on the
    same device.  `edges` may be a tensor already there: it is kept as it
    is (no second copy), and every plan partitions from it without a host
    transfer.  The session and graph of a failed attempt are released
    before the next plan, so at most one partitioned graph is resident at
    a time.

    In an initialised process group (`multihost.initialize`), every rank
    of the world constructs and runs the coordinator alike, and it plans
    as the JAX package's does across `jax.devices()`: the first grid over
    the whole group, L = R0*C0 / world processors a rank, and every later
    grid over the first R*C / L ranks (`multihost.global_mesh(...,
    processes=)`, JAX's `jax.devices()[:R*C]`), each rank of it planning
    its blocks from the host edge list (streamed) on its device.  A grid
    whose R*C is not a multiple of L raises ValueError on every rank.  The
    ranks outside a survivor grid wait; rank 0 then tells every rank how
    the attempt ended, and hands its output (and the plan's stats) to
    every rank, so every rank returns the same result.

    The session/graph are rebuilt per shrink, so `run` takes the QUERY,
    not a session: the method name plus its argument.
    """

    def __init__(self, edges, config, *, weights=None, n=None,
                 max_shrinks: int = 2, device=None):
        import numpy as np
        import torch

        from repro_torch.core.types import resolve_device
        from repro_torch.dist import multihost
        self.group = multihost.is_initialized()
        self.device = None if self.group else resolve_device(device)
        self.edges = edges if isinstance(edges, torch.Tensor) \
            or self.group else np.asarray(edges)
        self.config = config
        self.weights = weights
        self.n = n
        self.max_shrinks = int(max_shrinks)
        self.shrinks = 0            # shrinks performed by the last run()
        self.grids = []             # grid trajectory of the last run()

    def _mesh(self, R: int, C: int, per_rank: int):
        """The process mesh of a (R, C) grid over the first R*C / per_rank
        ranks (every rank calls this; None on a rank outside it)."""
        from repro_torch.dist import multihost
        if (R * C) % per_rank:
            raise ValueError(
                f"the survivor grid {R}x{C} holds {R * C} processors, not a "
                f"multiple of the {per_rank} each rank holds, so no set of "
                f"whole ranks carries it")
        return multihost.global_mesh((R, C), processes=R * C // per_rank)

    def _plan(self, config, mesh=None):
        from repro_torch.api.session import DistGraph

        graph = DistGraph.from_edges(self.edges, config, mesh=mesh,
                                     device=self.device, n=self.n,
                                     weights=self.weights)
        try:
            return graph.session()
        except ValueError:
            # the planned exchange strategy (e.g. butterfly) may not fit
            # the survivor grid's column count -- fall back to flat, which
            # is valid everywhere and bit-identical
            graph.config = dataclasses.replace(config, exchange="flat")
            return graph.session()

    def _attempt(self, config, method: str, args, plan, kw, last: bool,
                 mesh=None):
        """One planned grid: (True, output), or (False, (snapshot, level,
        failed)) after an UnrecoverableLoss.  The session, the graph and
        the exception's frames die with this call, so the next plan does
        not meet them on the device."""
        sess = self._plan(config) if mesh is None \
            else self._plan(config, mesh)
        try:
            return True, getattr(sess, method)(*args, recovery=plan, **kw)
        except UnrecoverableLoss as e:
            if last:
                raise
            return False, (e.snapshot, e.level, e.failed)

    def run(self, method: str, arg=None, plan: RecoveryPlan | None = None,
            **kw) -> Any:
        """Run `session.<method>(arg, recovery=plan)` with elastic retries.

        On UnrecoverableLoss: accumulate the failed processors, shrink the
        grid, re-plan, and resume from the loss snapshot.  Raises the final
        UnrecoverableLoss once `max_shrinks` is exhausted or the survivor
        set is empty.
        """
        import gc

        from repro_torch.ckpt.elastic import shrink_grid

        plan = plan if plan is not None else RecoveryPlan()
        config = self.config
        R0, C0 = config.resolve_grid(1).R, config.resolve_grid(1).C
        per_rank = None
        if self.group:
            import torch.distributed as dist
            per_rank = (R0 * C0) // dist.get_world_size()
            if per_rank < 1 or per_rank * dist.get_world_size() != R0 * C0:
                raise ValueError(
                    f"the {R0}x{C0} grid does not split over the "
                    f"{dist.get_world_size()} ranks of the process group")
        failed_total = 0
        self.shrinks = 0
        self.grids = [(R0, C0)]
        args = () if arg is None else (arg,)
        R, C = R0, C0
        while True:
            last = self.shrinks >= self.max_shrinks
            if per_rank is None:
                done, res = self._attempt(config, method, args, plan, kw,
                                          last=last)
            else:
                done, res = self._group_attempt(
                    config, method, args, plan, kw, last,
                    self._mesh(R, C, per_rank), whole=(R, C) == (R0, C0))
            if done:
                return res
            snapshot, _, failed = res
            del res
            gc.collect()            # frames of the failed attempt
            failed_total += max(1, failed)
            plan.stats["_t_loss"] = time.perf_counter()
            R, C = shrink_grid(R0, C0, failed_total)  # ValueError when
            #                                           nobody survives
            config = dataclasses.replace(config, grid=(R, C))
            plan.resume = snapshot
            self.shrinks += 1
            self.grids.append((R, C))

    def _group_attempt(self, config, method, args, plan, kw, last, mesh,
                       whole: bool):
        """One grid across the process group: the ranks of `mesh` run the
        attempt (a rank outside it has mesh None and waits), then every
        rank learns how it ended -- done, a loss to shrink after (the
        failed count; the members hold the snapshot), the final
        UnrecoverableLoss, or an error -- from rank 0 (a member of every
        grid), and, unless every rank ran the attempt (`whole`), rank 0
        hands its output (or its final snapshot) and the plan's stats to
        every rank."""
        from repro_torch.dist import multihost
        status, res = None, None
        if mesh is not None:
            try:
                done, res = self._attempt(config, method, args, plan, kw,
                                          last, mesh)
                status = ("done",) if done else ("loss", res[2])
            except UnrecoverableLoss as e:
                status, res = ("unrecoverable", e.level, e.failed), e
            except Exception as e:      # noqa: BLE001 -- raised together
                status, res = ("error", f"{type(e).__name__}: {e}"), e
        every = multihost.gather_objects(status)
        for r, st in enumerate(every):
            if st is not None and st[0] == "error":
                if status is not None and status[0] == "error":
                    raise res
                raise RuntimeError(f"rank {r} of the process group failed: "
                                   f"{st[1]}")
        status = every[0]
        if status[0] == "loss":
            return False, (res if mesh is not None
                           else (None, None, status[1]))
        if status[0] == "unrecoverable":
            snap = None
            if not whole:
                snap = multihost.broadcast_object(
                    res.snapshot if mesh is not None and mesh.rank == 0
                    else None)
            if mesh is not None:
                raise res
            raise UnrecoverableLoss(snap, status[1], status[2])
        if whole:
            return True, res
        out, stats = multihost.broadcast_tree(
            (res, dict(plan.stats)) if mesh is not None and mesh.rank == 0
            else None, multihost.current_device())
        plan.stats.clear()
        plan.stats.update(stats)
        return True, out
