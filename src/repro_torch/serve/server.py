"""GraphServer: concurrent graph queries over resident DistGraphs
(DESIGN.md sec. 12), the port of `repro/serve/server.py` over the torch
session.

One server holds N resident graphs; each graph gets one executor thread
driving a `ContinuousBatcher`.  Clients `submit()` BFS / CC / SSSP /
multi-source-BFS requests from any thread and block on the returned
`QueryTicket`; the executor coalesces compatible requests (same graph,
program, config) into the session layer's cached batched multi-root entry
points, padding to the nearest capacity class, and demuxes each slot back
to its caller -- bit-identical to a direct `GraphSession` call by
construction (the engine runs a batch's searches one after another, each
independent of the others, and padding slots repeat a live root and are
discarded; on one card a padding slot costs a whole search).

Fault path: every batch runs through `repro_torch.runtime.fault.StepRunner`
(retry + exponential backoff + straggler watchdog).  A batch whose retries
are exhausted is replayed one request at a time, so a poisoned query fails
alone -- the isolation replay -- while the server keeps serving; transient
faults are absorbed by the retries and the request never notices.
Admission is validated (`check_vertex_ids`) and bounded (`max_pending`
backpressure -> `ServerSaturated`), so bad or excess requests never reach
the engines.  Each batch runs under a `torch.profiler.record_function`
range named serve/<program>, and is synchronised on a CUDA graph before its
wall time is taken.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings

import numpy as np
import torch

from repro_torch.algos.sssp import SSSPOutput
from repro_torch.api.session import DistGraph, GraphSession, \
    check_vertex_ids
from repro_torch.core.types import BFSOutput
from repro_torch.obs import EventLog, MetricsRegistry, request_trace, \
    to_prometheus
from repro_torch.runtime.fault import RetryPolicy, StepRunner, \
    StragglerWatchdog
from repro_torch.serve.accounting import BatchRecord, ServeAccounting
from repro_torch.serve.protocol import (PROGRAMS, QueryRequest, QueryResult,
                                        QueryTicket, pad_class, pad_classes)
from repro_torch.serve.scheduler import ContinuousBatcher, Entry, batch_key


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _host(x) -> np.ndarray:
    """Vertex ids (numpy, Python ints, torch) as a numpy array, dtype kept
    (so admission can refuse a non-integer one)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class ServeConfig:
    """Server-wide knobs (per-query knobs ride in each request's
    BFSConfig).

    max_batch:  coalescing cap = the largest roots-batch capacity class
                (powers of two up to this are warmed/cached).
    window_s:   max-latency admission window: a non-full batch dispatches
                once its oldest request has waited this long.
    max_pending: admission-queue bound per graph; beyond it `submit`
                raises ServerSaturated (backpressure).
    retry:      StepRunner retry/backoff policy for batch execution.
    straggler_factor: StragglerWatchdog flag threshold (x p99).
    event_log_path: optional JSONL path the server's
                `repro_torch.obs.EventLog`
                appends batch / reject / retry / straggler / failure events
                to (None = in-memory ring only).
    recovery_dir: optional directory for mid-traversal checkpoints of
                fault-tolerant batches (requests whose BFSConfig has
                fault_tolerance=True); a batch interrupted by device loss
                then DRAINS through recovery -- resumed from its last
                completed level -- instead of failing its requests.
    """
    max_batch: int = 8
    window_s: float = 0.01
    max_pending: int = 1024
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    straggler_factor: float = 3.0
    event_log_path: "str | None" = None
    recovery_dir: "str | None" = None


class _Outstanding:
    """Tickets admitted but not yet fulfilled (what `drain()` waits on)."""

    def __init__(self):
        self.n = 0
        self.cond = threading.Condition()

    def inc(self):
        with self.cond:
            self.n += 1

    def dec(self):
        with self.cond:
            self.n -= 1
            self.cond.notify_all()

    def wait_zero(self, timeout=None) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: self.n == 0, timeout)


class _GraphWorker:
    """One resident graph's executor: queue -> batch -> demux."""

    def __init__(self, name: str, graph: DistGraph, cfg: ServeConfig,
                 acct: ServeAccounting, outstanding: _Outstanding,
                 exec_lock: threading.Lock, metrics: MetricsRegistry = None,
                 events: EventLog = None):
        self.name = name
        self.graph = graph
        self.cfg = cfg
        self.acct = acct
        self.outstanding = outstanding
        self.exec_lock = exec_lock
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events = events
        self.batcher = ContinuousBatcher(window_s=cfg.window_s,
                                         max_pending=cfg.max_pending)
        # per-tenant fault attribution: every retry / straggler flag of a
        # batch counts once for each tenant riding it (DESIGN.md sec. 13)
        self._retry_c = self.metrics.counter(
            "fault_retries_total", "Batch execution retries",
            labelnames=("graph", "tenant"))
        self._straggler_c = self.metrics.counter(
            "fault_straggler_total", "Straggler-flagged batch executions",
            labelnames=("graph", "tenant"))
        self._recovery_resume_c = self.metrics.counter(
            "recovery_resumes_total",
            "Batches re-driven through mid-traversal recovery",
            labelnames=("graph",))
        self._recovery_drain_c = self.metrics.counter(
            "recovery_drained_total",
            "Requests drained through recovery instead of failing",
            labelnames=("graph",))
        self.runner = StepRunner(
            self._step, policy=cfg.retry,
            watchdog=StragglerWatchdog(factor=cfg.straggler_factor),
            on_retry=self._on_retry, on_straggler=self._on_straggler)
        # request-lifecycle latency breakdown (queue-wait vs execute)
        self._queue_h = self.metrics.histogram(
            "serve_queue_wait_seconds",
            "Admission -> execution-start wall per request",
            labelnames=("graph", "program"))
        self._exec_h = self.metrics.histogram(
            "serve_execute_seconds",
            "Batch execution wall attributed per request",
            labelnames=("graph", "program"))
        self._sessions: dict = {}        # resolved BFSConfig -> GraphSession
        self._session_lock = threading.Lock()
        self._step_no = 0
        self._thread = None

    def _on_retry(self, tenants):
        for t in tenants:
            self._retry_c.labels(graph=self.name, tenant=t).inc()
        if self.events is not None:
            self.events.emit("retry", graph=self.name, tenants=list(tenants))

    def _on_straggler(self, tenants, seconds):
        for t in tenants:
            self._straggler_c.labels(graph=self.name, tenant=t).inc()
        if self.events is not None:
            self.events.emit("straggler", graph=self.name,
                             tenants=list(tenants), seconds=seconds)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"serve-{self.name}", daemon=True)
            self._thread.start()

    def join(self):
        if self._thread is not None:
            self._thread.join()

    def _loop(self):
        while True:
            item = self.batcher.next_batch()
            if item is None:
                return
            self._serve_batch(*item)

    # -- execution -----------------------------------------------------------

    def session_for(self, config) -> GraphSession:
        with self._session_lock:
            sess = self._sessions.get(config)
            if sess is None:
                sess = GraphSession(self.graph, config)
                self._sessions[config] = sess
            return sess

    def _step(self, state, batch):
        """StepRunner step fn: execute ONE coalesced batch.  Raises on any
        fault (injected or real); StepRunner owns retry/backoff."""
        from repro_torch.runtime.recovery import DeviceLossInjector
        key, entries = batch
        # per-request fault hook: a FaultInjector keyed by this request's
        # attempt counter (see repro_torch.serve.protocol.QueryRequest
        # .injector).
        # A DeviceLossInjector rides PAST this hook into the segmented
        # level loop instead -- it fires mid-traversal, not at admission.
        for e in entries:
            if e.req.injector is not None and \
                    not isinstance(e.req.injector, DeviceLossInjector):
                attempt = e.req.attempts
                e.req.attempts += 1
                e.req.injector.check(attempt)
        return state, self._execute(key, entries)

    def _recovery_plan(self, key, entries):
        """RecoveryPlan for one fault-tolerant batch: the first request's
        DeviceLossInjector (drills ride on requests like FaultInjectors do)
        plus, when the server has a recovery_dir, a TraversalCheckpointer
        keyed by the batch identity -- so a re-dispatch of the SAME batch
        resumes mid-flight from its last completed level."""
        import hashlib
        import os
        from repro_torch.runtime.recovery import (DeviceLossInjector,
                                                  RecoveryPlan,
                                                  TraversalCheckpointer)
        injector = None
        for e in entries:
            if isinstance(e.req.injector, DeviceLossInjector):
                injector = e.req.injector
                break
        checkpointer = None
        if self.cfg.recovery_dir is not None:
            args = ",".join(str(e.req.arg) for e in entries)
            query_key = f"{self.name}:{key.program}:{args}"
            sub = hashlib.sha1(query_key.encode()).hexdigest()[:16]
            checkpointer = TraversalCheckpointer(
                os.path.join(self.cfg.recovery_dir, sub), query_key)
        return RecoveryPlan(checkpointer=checkpointer, injector=injector,
                            policy=self.cfg.retry)

    def _execute(self, key, entries):
        """Run the batch through the session layer; returns per-slot
        (values, edges) plus the padded capacity class.

        Each execution runs under a `torch.profiler.record_function` range
        named serve/<program>, so device profiles line up with the span
        names on `QueryResult.trace`, and is synchronised (`_sync`) inside
        it, so the batch's wall time is its device time; telemetry-enabled
        sessions also demux their per-slot `LevelTrace` onto each value.
        """
        sess = self.session_for(key.config)
        program = key.program
        recovery = self._recovery_plan(key, entries) \
            if key.config.fault_tolerance else None
        if program == "bfs":
            roots = [int(e.req.arg) for e in entries]
            B = pad_class(len(roots), key.cap)
            padded = roots + [roots[0]] * (B - len(roots))
            with torch.profiler.record_function("serve/bfs"):
                out = sess.bfs(np.asarray(padded, np.int32),
                               recovery=recovery)
                self._sync()
            values = [
                BFSOutput(level=out.level[s], pred=out.pred[s],
                          n_levels=out.n_levels[s],
                          edges_scanned=out.edges_scanned[s],
                          directions=None if out.directions is None
                          else out.directions[s],
                          trace=None if out.trace is None else out.trace[s])
                for s in range(len(roots))]
            edges = [v.edges_scanned for v in values]
            return values, edges, B
        if program == "sssp":
            roots = [int(e.req.arg) for e in entries]
            B = pad_class(len(roots), key.cap)
            padded = roots + [roots[0]] * (B - len(roots))
            with torch.profiler.record_function("serve/sssp"):
                out = sess.sssp(np.asarray(padded, np.int32),
                                recovery=recovery)
                self._sync()
            values = [
                SSSPOutput(dist=out.dist[s], n_iters=out.n_iters[s],
                           edges_scanned=out.edges_scanned[s],
                           directions=None if out.directions is None
                           else out.directions[s],
                           trace=None if out.trace is None else out.trace[s])
                for s in range(len(roots))]
            edges = [v.edges_scanned for v in values]
            return values, edges, B
        if program == "cc":
            # argument-free: ONE execution, every caller gets the result;
            # the whole search's edges are accounted to the first caller
            with torch.profiler.record_function("serve/cc"):
                out = sess.connected_components(recovery=recovery)
                self._sync()
            values = [out] * len(entries)
            edges = [out.edges_scanned] + [0] * (len(entries) - 1)
            return values, edges, 1
        if program == "multi_bfs":
            assert len(entries) == 1, "multi_bfs requests never coalesce"
            req = entries[0].req
            with torch.profiler.record_function("serve/multi_bfs"):
                out = sess.multi_bfs(np.asarray(req.arg, np.int32), k=req.k,
                                     recovery=recovery)
                self._sync()
            return [out], [out.edges_scanned], 1
        raise ValueError(f"unknown program {program!r}")

    def _sync(self) -> None:
        """Wait for the batch's device work (nothing to wait for on the
        CPU)."""
        if self.graph.device.type == "cuda":
            torch.cuda.synchronize(self.graph.device)

    def _serve_batch(self, key, entries):
        # one batch at a time across ALL resident graphs.  The stacked grid
        # has no collective rendezvous to deadlock (the JAX server's
        # reason), but two remain: every session over a graph shares its
        # engines (graph._engines), whose steps update state in place, and
        # two full-size searches at once would double the transient memory
        # of one card.  So execution serializes here (lock wait counts as
        # queued_s, not exec_s) while admission and batch assembly stay
        # concurrent
        t_dispatch = time.perf_counter()
        with self.exec_lock:
            self._serve_batch_locked(key, entries, t_dispatch)

    def _serve_batch_locked(self, key, entries, t_dispatch):
        from repro_torch.runtime.recovery import DeviceLoss, \
            UnrecoverableLoss
        tenants = tuple(sorted({e.req.tenant for e in entries}))
        t_start = time.perf_counter()
        # the recovery re-dispatch and the isolation replay run AFTER the
        # except blocks: a caught exception's traceback holds the failed
        # attempt's frames, and with them its search state on the card
        lost = failed = None
        try:
            _, infos = self.runner.run(None, [(key, entries)],
                                       start_step=self._step_no,
                                       labels=tenants)
            values, edges, padded = infos[0]
        except (DeviceLoss, UnrecoverableLoss) as exc:
            lost = f"{type(exc).__name__}: {exc}"
        except Exception:
            failed = True
        self._step_no += 1
        if failed:
            self._isolate(key, entries, t_dispatch)
            return
        if lost is not None:
            # device loss escaped the segmented loop's own retries: drain
            # the in-flight requests through recovery -- ONE re-dispatch
            # resumes the traversal from its last checkpointed level (the
            # injected loss schedule has spent its budget by now), so no
            # query is lost to the failure
            self._recovery_resume_c.labels(graph=self.name).inc()
            if self.events is not None:
                self.events.emit("recovery_resume", graph=self.name,
                                 program=key.program, tenants=list(tenants),
                                 error=lost)
            try:
                _, (values, edges, padded) = self._step(None, (key, entries))
            except Exception:
                failed = True
            if failed:
                self._isolate(key, entries, t_dispatch)
                return
            for _ in entries:
                self._recovery_drain_c.labels(graph=self.name).inc()
        t_exec_end = time.perf_counter()
        exec_s = t_exec_end - t_start
        self.acct.record_batch(BatchRecord(
            graph=self.name, program=key.program, live=len(entries),
            padded_to=padded, exec_s=exec_s))
        for e, value, n_edges in zip(entries, values, edges):
            self._fulfil(e, ok=True, value=value, edges=n_edges,
                         exec_s=exec_s, t_start=t_start,
                         t_dispatch=t_dispatch, t_exec_end=t_exec_end,
                         live=len(entries), padded=padded)

    def _isolate(self, key, entries, t_dispatch):
        """Batch retries exhausted: replay each request alone so only the
        poisoned one fails (transient faults were already retried)."""
        for e in entries:
            t0 = time.perf_counter()
            try:
                _, (values, edges, padded) = self._step(None, (key, [e]))
            except Exception as exc:
                t1 = time.perf_counter()
                self.acct.record_batch(BatchRecord(
                    graph=self.name, program=key.program, live=1,
                    padded_to=1, exec_s=t1 - t0, isolated=True))
                self._fulfil(e, ok=False, error=f"{type(exc).__name__}: "
                             f"{exc}", exec_s=t1 - t0, t_start=t0,
                             t_dispatch=t_dispatch, t_exec_end=t1,
                             live=1, padded=1, isolated=True)
                continue
            t1 = time.perf_counter()
            exec_s = t1 - t0
            self.acct.record_batch(BatchRecord(
                graph=self.name, program=key.program, live=1,
                padded_to=padded, exec_s=exec_s, isolated=True))
            self._fulfil(e, ok=True, value=values[0], edges=edges[0],
                         exec_s=exec_s, t_start=t0, t_dispatch=t_dispatch,
                         t_exec_end=t1, live=1, padded=padded,
                         isolated=True)

    def _fulfil(self, entry, *, ok, exec_s, t_start, live, padded,
                t_dispatch=None, t_exec_end=None, value=None, edges=0,
                error=None, isolated=False):
        req = entry.req
        t_done = time.perf_counter()
        queued_s = max(t_start - entry.t_admit, 0.0)
        if t_dispatch is None:
            t_dispatch = t_start
        if t_exec_end is None:
            t_exec_end = t_start + exec_s
        trace = request_trace(
            req.seq, self.name, req.program, t_admit=entry.t_admit,
            t_dispatch=t_dispatch, t_exec_start=t_start,
            t_exec_end=t_exec_end, t_done=t_done, live=live, padded=padded,
            isolated=isolated)
        self._queue_h.labels(graph=self.name,
                             program=req.program).observe(queued_s)
        self._exec_h.labels(graph=self.name,
                            program=req.program).observe(exec_s)
        result = QueryResult(
            ok=ok, seq=req.seq, tenant=req.tenant, graph=self.name,
            program=req.program, value=value, error=error,
            queued_s=queued_s, exec_s=exec_s,
            batch_size=live, padded_to=padded, t_done=t_done, trace=trace)
        self.acct.record_result(result, edges=edges)
        entry.ticket._fulfil(result)
        self.outstanding.dec()


class GraphServer:
    """N resident graphs behind one concurrent query frontend.

        server = GraphServer({"web": graph_a, "road": graph_b}).start()
        t1 = server.bfs("web", root=17, tenant="alice")
        t2 = server.sssp("road", root=3, tenant="bob")
        out = t1.result(timeout=60).value        # BFSOutput, bit-identical
        server.stop()                            #   to session.bfs(17)

    Also usable as a context manager (`with GraphServer(...) as s:`).
    Construction does not start the executors -- tests exploit that to
    pre-fill the queue and observe full-batch coalescing.
    """

    def __init__(self, graphs: "dict[str, DistGraph] | None" = None,
                 config: "ServeConfig | None" = None):
        self.config = config if config is not None else ServeConfig()
        # one metrics registry + event log per server (DESIGN.md sec. 13):
        # every counter this server emits lives here, so a fresh server
        # over long-lived graphs starts its accounting from zero
        self.metrics = MetricsRegistry()
        self.events = EventLog(self.config.event_log_path)
        self.metrics.register_collector(self._collect)
        self.accounting = ServeAccounting(registry=self.metrics,
                                          events=self.events)
        # serializes execution across graph workers (see
        # _GraphWorker._serve_batch)
        self._exec_lock = threading.Lock()
        self._outstanding = _Outstanding()
        self._workers: dict[str, _GraphWorker] = {}
        self._seq = itertools.count()
        self._started = False
        for name, graph in (graphs or {}).items():
            self.add_graph(name, graph)

    # -- residency -----------------------------------------------------------

    def add_graph(self, name: str, graph: DistGraph) -> None:
        if graph.topology.distributed:
            from repro_torch.algos.engine import group_not_ported
            raise group_not_ported("GraphServer")
        if name in self._workers:
            raise ValueError(f"graph {name!r} already resident")
        worker = _GraphWorker(name, graph, self.config, self.accounting,
                              self._outstanding, self._exec_lock,
                              metrics=self.metrics, events=self.events)
        self._workers[name] = worker
        if self._started:
            worker.start()

    def graph(self, name: str) -> DistGraph:
        return self._worker(name).graph

    @property
    def graphs(self) -> tuple:
        return tuple(self._workers)

    def _worker(self, name: str) -> _GraphWorker:
        worker = self._workers.get(name)
        if worker is None:
            raise ValueError(f"no resident graph {name!r}; serving "
                             f"{sorted(self._workers)}")
        return worker

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "GraphServer":
        self._started = True
        for worker in self._workers.values():
            worker.start()
        return self

    def stop(self) -> None:
        """Flush the queues (remaining requests are still served), then
        stop the executors.  The server does not restart."""
        for worker in self._workers.values():
            worker.batcher.close()
        for worker in self._workers.values():
            worker.join()
        self._started = False

    def drain(self, timeout: "float | None" = 120) -> None:
        """Block until every admitted request has been fulfilled."""
        if not self._outstanding.wait_zero(timeout):
            raise TimeoutError(
                f"{self._outstanding.n} requests still outstanding after "
                f"{timeout}s")

    def __enter__(self) -> "GraphServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- admission -----------------------------------------------------------

    def submit(self, graph: str, program: str, arg=None, *,
               tenant: str = "default", config=None, k: "int | None" = None,
               injector=None) -> QueryTicket:
        """Admit one query; returns immediately with a ticket.

        Validation happens HERE, before anything reaches an engine:
        unknown graph/program, out-of-range or wrong-dtype ids,
        and SSSP on a weightless graph all raise ValueError at the caller;
        a full queue raises ServerSaturated (backpressure).
        """
        worker = self._worker(graph)
        if program not in PROGRAMS:
            raise ValueError(f"unknown program {program!r}; serving "
                             f"{PROGRAMS}")
        n = worker.graph.n
        if program in ("bfs", "sssp"):
            if arg is None or _ndim(arg) != 0:
                raise ValueError(f"{program} serves one root per request; "
                                 f"got {arg!r}")
            check_vertex_ids(arg, n, "roots")
            arg = int(arg)
            if program == "sssp" and worker.graph.weights is None:
                raise ValueError(
                    f"sssp on graph {graph!r} needs resident per-edge "
                    f"weights; plan it with DistGraph.from_edges(edges, "
                    f"config, weights=w)")
        elif program == "multi_bfs":
            arg = _host(arg)
            if arg.ndim != 1 or arg.shape[0] == 0:
                raise ValueError(f"multi_bfs needs a non-empty (K,) "
                                 f"sources vector, got shape {arg.shape}")
            check_vertex_ids(arg, n, "sources")
            arg = arg.astype(np.int32)
        elif arg is not None:    # cc
            raise ValueError(f"cc is argument-free, got arg={arg!r}")
        cfg = config if config is not None else worker.graph.config
        req = QueryRequest(seq=next(self._seq), tenant=tenant, graph=graph,
                           program=program, arg=arg, config=cfg, k=k,
                           injector=injector)
        key = batch_key(graph, program, cfg, arg, k, self.config.max_batch)
        entry = Entry(key=key, req=req, ticket=QueryTicket(req))
        self._outstanding.inc()
        try:
            worker.batcher.put(entry)
        except Exception:
            self._outstanding.dec()
            self.accounting.record_reject(tenant)
            raise
        self.accounting.record_admit(tenant)
        return entry.ticket

    # ergonomic per-program spellings
    def bfs(self, graph, root, **kw) -> QueryTicket:
        return self.submit(graph, "bfs", root, **kw)

    def connected_components(self, graph, **kw) -> QueryTicket:
        return self.submit(graph, "cc", **kw)

    def sssp(self, graph, root, **kw) -> QueryTicket:
        return self.submit(graph, "sssp", root, **kw)

    def multi_bfs(self, graph, sources, k=None, **kw) -> QueryTicket:
        return self.submit(graph, "multi_bfs", sources, k=k, **kw)

    # -- capacity ------------------------------------------------------------

    def warm(self, programs=("bfs",), batch_classes=None) -> None:
        """Build the padding capacity classes' cache entries through the
        session layer's public `compiled_for` surface before admitting
        traffic.  "sssp" warms by running root 0 at each class, "cc" by one
        labelling; multi_bfs depends on the request's (K, k) and warms on
        first traffic.
        """
        classes = batch_classes if batch_classes is not None \
            else pad_classes(self.config.max_batch)
        for worker in self._workers.values():
            sess = worker.session_for(worker.graph.config)
            for program in programs:
                if program == "bfs":
                    for B in classes:
                        sess.compiled_for(B)
                elif program == "sssp" and worker.graph.weights is not None:
                    for B in classes:
                        sess.sssp(np.zeros(B, np.int32))
                elif program == "cc":
                    sess.connected_components()

    # -- observability -------------------------------------------------------

    def _collect(self):
        """Registry collector: pull-time samples from sources that keep
        their own authoritative counters (queue depths, the executable
        caches, engine trace counts, runner retry/straggler totals)."""
        for n, w in self._workers.items():
            yield ("serve_pending", "gauge",
                   "Requests admitted, not yet dispatched", {"graph": n},
                   w.batcher.pending)
            for k, v in w.graph.cache_stats().items():
                if v is not None:
                    yield (f"aot_cache_{k}", "gauge",
                           "Executable cache state", {"graph": n}, v)
            for key, eng in w.graph._engines.items():
                yield ("engine_trace_count", "gauge",
                       "Cache entries this engine has built",
                       {"graph": n, "engine": str(key)}, eng.trace_count)
            yield ("runner_retries", "gauge", "StepRunner retries",
                   {"graph": n}, w.runner.retries)
            yield ("runner_restores", "gauge", "StepRunner restores",
                   {"graph": n}, w.runner.restores)
            yield ("runner_straggler_flagged", "gauge",
                   "Straggler-flagged steps", {"graph": n},
                   len(w.runner.watchdog.flagged))

    def metrics_snapshot(self) -> dict:
        """Accounting snapshot + per-graph cache/runner/queue state -- every
        number a view over the server's one metrics registry (plus the
        runners' own attribution dicts).  Same dict shape the deprecated
        `stats()` always returned, with per-tenant retry attribution added
        under runners.<graph>.retries_by_tenant."""
        snap = self.accounting.snapshot()
        snap["pending"] = {n: w.batcher.pending
                           for n, w in self._workers.items()}
        snap["aot_cache"] = {n: w.graph.cache_stats()
                             for n, w in self._workers.items()}
        snap["runners"] = {
            n: {"retries": w.runner.retries, "restores": w.runner.restores,
                "straggler_flagged": len(w.runner.watchdog.flagged),
                "retries_by_tenant": dict(w.runner.retries_by),
                "straggler_by_tenant": dict(w.runner.straggler_by),
                # the jittered backoff actually slept (bounded tail)
                "delays": list(w.runner.delays)[-256:],
                "recovery_resumes": w._recovery_resume_c.labels(
                    graph=n).value,
                "recovery_drained": w._recovery_drain_c.labels(
                    graph=n).value}
            for n, w in self._workers.items()}
        snap["trace_counts"] = {
            n: {str(key): eng.trace_count
                for key, eng in w.graph._engines.items()}
            for n, w in self._workers.items()}
        return snap

    def stats(self) -> dict:
        """Deprecated spelling of `metrics_snapshot()` (same dict)."""
        warnings.warn(
            "GraphServer.stats() is deprecated; use metrics_snapshot() "
            "(same dict), prometheus() for text exposition, or the "
            "server's .metrics registry directly", DeprecationWarning,
            stacklevel=2)
        return self.metrics_snapshot()

    def prometheus(self) -> str:
        """Prometheus text-format exposition of the server's registry."""
        return to_prometheus(self.metrics)

    def reset_metrics(self) -> None:
        """Zero the serve counters AND the per-graph runner attribution
        (the load generator's between-points reset; collectors pull from
        live sources and are unaffected)."""
        self.accounting.reset()
        for w in self._workers.values():
            w.runner.reset_stats()
