"""Wire types of the serve layer (DESIGN.md sec. 12), a copy of
`repro/serve/protocol.py` (framework-free).

A query is one request for one search: a BFS/SSSP root, a CC labelling, or
a multi-source BFS over a (K,) sources vector.  Requests are admitted into
per-graph queues, coalesced by `BatchKey` -- same graph, program and config
(codec, direction mode, kernel paths all ride in `BFSConfig`, which is
frozen/hashable exactly so it can key this) -- and executed through the
resident graph's cached batched entry points.  The caller holds a
`QueryTicket` and blocks on `result()`; the scheduler demuxes each batch
slot back into its ticket's `QueryResult`.

Coalescing shape per program:

  bfs / sssp   batchable along the roots axis: up to `cap` requests pad
               into one (B,)-roots sweep.
  cc           argument-free, so every concurrent CC request on one
               (graph, config) shares ONE execution (dedup-coalescing).
  multi_bfs    the (K,) sources vector IS the one search argument; each
               request runs alone (cap = 1) but still flows through the
               same queue, accounting and fault path.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

PROGRAMS = ("bfs", "cc", "sssp", "multi_bfs")


class ServeError(RuntimeError):
    """Base class of serve-layer signalling errors."""


class ServerSaturated(ServeError):
    """Backpressure: the admission queue is at `max_pending`.  Open-loop
    clients should shed or retry later; closed-loop clients should block on
    outstanding tickets first."""


class ServerClosed(ServeError):
    """Submitted to a server that has been stopped."""


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """What makes two requests coalescible into one execution."""
    graph: str          # resident-graph name on the server
    program: str        # one of PROGRAMS
    config: Any         # resolved BFSConfig (frozen, hashable)
    arg_shape: tuple = ()   # () for root queries / cc; (K, k) for multi_bfs
    cap: int = 1        # max requests per executed batch for this key


@dataclasses.dataclass
class QueryRequest:
    """One admitted query.

    injector: optional `repro_torch.runtime.FaultInjector` checked (keyed
    by this request's attempt counter) every time the request enters an
    execution -- the test/bench hook that makes a request transiently
    faulty (schedule covers early attempts only; the batch-level retry
    recovers it) or poisoned (schedule covers every attempt; the isolation
    replay fails just this request).
    """
    seq: int
    tenant: str
    graph: str
    program: str
    arg: Any = None          # int root | (K,) sources | None for cc
    config: Any = None       # resolved BFSConfig
    k: int | None = None     # multi_bfs hop bound
    injector: Any = None
    attempts: int = 0


@dataclasses.dataclass
class QueryResult:
    """What a ticket resolves to (ok or failed; never an exception)."""
    ok: bool
    seq: int
    tenant: str
    graph: str
    program: str
    value: Any = None        # BFSOutput / CCOutput / SSSPOutput /
                             #   MultiBFSOutput slice for this request
    error: str | None = None
    queued_s: float = 0.0    # admission -> execution start
    exec_s: float = 0.0      # batch execution wall (shared by the batch)
    batch_size: int = 1      # live requests in the executed batch
    padded_to: int = 1       # capacity class B the batch ran at
    t_done: float = 0.0      # perf_counter stamp at fulfilment
    trace: Any = None        # repro_torch.obs.RequestTrace span lifecycle
                             #   (queue/coalesce/execute/demux)


class QueryTicket:
    """Caller-side handle: blocks on `result()` until the slot demuxes."""

    def __init__(self, request: QueryRequest):
        self.request = request
        self._event = threading.Event()
        self._result: QueryResult | None = None

    def _fulfil(self, result: QueryResult) -> None:
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query seq={self.request.seq} ({self.request.program} on "
                f"{self.request.graph!r}) not served within {timeout}s")
        return self._result


def pad_class(n_live: int, cap: int) -> int:
    """Capacity class a batch of `n_live` requests pads to: the next power
    of two, clipped to `cap` -- so the executable cache holds at
    most log2(cap)+1 entries per (engine, program) instead of one per
    observed batch size."""
    if n_live < 1:
        raise ValueError(f"batch must hold >= 1 requests, got {n_live}")
    b = 1
    while b < n_live:
        b <<= 1
    return min(b, cap)


def pad_classes(cap: int) -> tuple:
    """Every capacity class `pad_class` can produce under `cap` (what the
    server warms before admitting traffic)."""
    classes = []
    b = 1
    while b < cap:
        classes.append(b)
        b <<= 1
    classes.append(cap)
    return tuple(classes)
