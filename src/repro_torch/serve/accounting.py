"""Per-tenant and per-batch serve accounting (DESIGN.md sec. 12 + 13), a
copy of `repro/serve/accounting.py` over `repro_torch.obs`.

Everything the load generator, the CI gates and a capacity planner need to
read back out of a serving run: per-tenant query/edge/wall-time counters,
per-batch occupancy records (live slots vs padded capacity -- the
continuous-batching win is literally `occupancy() > 1`), and the resident
graphs' executable-cache hit/miss/eviction counters folded into one snapshot.

Since the telemetry subsystem (DESIGN.md sec. 13) the counters themselves
live in a `repro_torch.obs.MetricsRegistry` -- `ServeAccounting` is a writer plus
a snapshot VIEW over that registry, so the same numbers serve the legacy
`snapshot()` dict, the JSON exposition and the Prometheus text endpoint
without double bookkeeping.  A `GraphServer` passes its own registry (and
its JSONL `EventLog`); standalone construction makes a private one.

Thread-safe: the scheduler worker threads and any number of client threads
record concurrently (the registry lock; the `batches` list keeps its own).
"""
from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class TenantStats:
    """Counters for one tenant (accounting unit = one query)."""
    queries: int = 0         # admitted
    ok: int = 0
    failed: int = 0
    rejected: int = 0        # refused at admission (backpressure)
    edges_scanned: int = 0   # exact per-slot counts (CC riders count 0)
    exec_s: float = 0.0      # summed batch-execution wall per query
    queued_s: float = 0.0    # summed admission -> execution-start wall

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BatchRecord:
    """One executed batch (or isolation replay slot)."""
    graph: str
    program: str
    live: int                # real requests served
    padded_to: int           # capacity class B it ran at
    exec_s: float
    isolated: bool = False   # True for a post-fault singleton replay


# the per-tenant registry counters backing TenantStats, in field order
_TENANT_COUNTERS = (
    ("queries", "serve_admitted_total", "Queries admitted"),
    ("ok", "serve_ok_total", "Queries fulfilled ok"),
    ("failed", "serve_failed_total", "Queries fulfilled failed"),
    ("rejected", "serve_rejected_total",
     "Queries refused at admission (backpressure)"),
    ("edges_scanned", "serve_edges_scanned_total",
     "Exact scanned edges attributed per request"),
    ("exec_s", "serve_exec_seconds_total",
     "Summed batch-execution wall per query"),
    ("queued_s", "serve_queued_seconds_total",
     "Summed admission -> execution-start wall"),
)


class ServeAccounting:
    """Registry-backed tenant/batch accounting for one GraphServer.

    registry: the `repro_torch.obs.MetricsRegistry` the counters live in (the
              owning GraphServer's; a private one when None).
    events:   optional `repro_torch.obs.EventLog`; batch executions, rejections
              and failures are emitted as JSONL events.
    """

    def __init__(self, registry=None, events=None):
        from repro_torch.obs import MetricsRegistry

        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.events = events
        self._lock = threading.Lock()
        self.batches: list[BatchRecord] = []
        r = self.registry
        self._tenant_c = {
            field: r.counter(name, help, labelnames=("tenant",))
            for field, name, help in _TENANT_COUNTERS}
        bl = ("graph", "program")
        self._batches_c = r.counter(
            "serve_batches_total", "Executed batches", labelnames=bl)
        self._batch_live_c = r.counter(
            "serve_batch_live_total", "Live requests over executed batches",
            labelnames=bl)
        self._batch_padded_c = r.counter(
            "serve_batch_padded_total",
            "Capacity slots over executed batches", labelnames=bl)
        self._isolated_c = r.counter(
            "serve_isolated_total", "Isolation-replay slots", labelnames=bl)
        self._batch_exec_h = r.histogram(
            "serve_batch_exec_seconds", "Batch device-execution wall",
            labelnames=bl)

    @property
    def tenants(self) -> "dict[str, TenantStats]":
        """Per-tenant stats reconstructed FROM the registry (a view: the
        registry's series are the authority)."""
        out: dict[str, TenantStats] = {}
        for field, counter in self._tenant_c.items():
            for key, value in counter.series().items():
                stats = out.setdefault(key[0], TenantStats())
                setattr(stats, field, value)
        return out

    def record_admit(self, tenant: str) -> None:
        self._tenant_c["queries"].labels(tenant=tenant).inc()

    def record_reject(self, tenant: str) -> None:
        self._tenant_c["rejected"].labels(tenant=tenant).inc()
        if self.events is not None:
            self.events.emit("reject", tenant=tenant)

    def record_batch(self, record: BatchRecord) -> None:
        with self._lock:
            self.batches.append(record)
        kv = {"graph": record.graph, "program": record.program}
        if record.isolated:
            self._isolated_c.labels(**kv).inc()
        else:
            self._batches_c.labels(**kv).inc()
            self._batch_live_c.labels(**kv).inc(record.live)
            self._batch_padded_c.labels(**kv).inc(record.padded_to)
        self._batch_exec_h.labels(**kv).observe(record.exec_s)
        if self.events is not None:
            self.events.emit("batch", graph=record.graph,
                             program=record.program, live=record.live,
                             padded_to=record.padded_to,
                             exec_s=record.exec_s,
                             isolated=record.isolated)

    def record_result(self, result, edges: int = 0) -> None:
        """Fold one fulfilled QueryResult into its tenant's counters.
        `edges` is the request's own scanned-edge count: the exact per-slot
        number for bfs/sssp/multi_bfs, the whole search for the first CC
        caller in a shared run and 0 for the riders."""
        tenant = result.tenant
        if result.ok:
            self._tenant_c["ok"].labels(tenant=tenant).inc()
            self._tenant_c["edges_scanned"].labels(tenant=tenant).inc(
                int(edges))
        else:
            self._tenant_c["failed"].labels(tenant=tenant).inc()
            if self.events is not None:
                self.events.emit("request_failed", tenant=tenant,
                                 graph=result.graph, program=result.program,
                                 seq=result.seq, error=result.error)
        self._tenant_c["exec_s"].labels(tenant=tenant).inc(result.exec_s)
        self._tenant_c["queued_s"].labels(tenant=tenant).inc(result.queued_s)

    def occupancy(self) -> "float | None":
        """Mean live requests per executed batch (isolation replays
        excluded -- they are the fault path, not the steady state)."""
        with self._lock:
            live = [b.live for b in self.batches if not b.isolated]
        return sum(live) / len(live) if live else None

    def reset(self) -> None:
        """Zero the serve_* series and the batch records (the load
        generator resets between offered-load points so each point's
        occupancy/latency stands alone).  Other registry metrics and
        collectors are untouched."""
        with self._lock:
            self.batches = []
        for counter in self._tenant_c.values():
            counter.clear()
        for m in (self._batches_c, self._batch_live_c, self._batch_padded_c,
                  self._isolated_c, self._batch_exec_h):
            m.clear()

    def snapshot(self) -> dict:
        with self._lock:
            batches = list(self.batches)
        tenants = {t: s.as_dict() for t, s in self.tenants.items()}
        live = [b.live for b in batches if not b.isolated]
        padded = [b.padded_to for b in batches if not b.isolated]
        return {
            "tenants": tenants,
            "n_batches": len(live),
            "n_isolated": sum(1 for b in batches if b.isolated),
            "mean_occupancy": sum(live) / len(live) if live else None,
            "mean_padded_to": sum(padded) / len(padded) if padded else None,
            # padding waste: capacity slots that carried no live request
            "pad_waste_frac": (1 - sum(live) / sum(padded)) if padded and
                              sum(padded) else None,
        }
