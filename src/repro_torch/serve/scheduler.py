"""Continuous-batching admission scheduler (DESIGN.md sec. 12), a copy of
`repro/serve/scheduler.py` (framework-free).

The same admission trick LLM inference servers use, applied to graph
queries: requests accumulate in per-`BatchKey` queues while the executor is
busy; whenever the executor asks for work the scheduler hands it the most
urgent coalescible group, dispatching early only when a group has filled
its capacity `cap`.  A group that has not filled waits at most
`window_s` past its oldest request's admission -- the max-latency window
that trades p50 latency for batch occupancy.

No wall-clock policy lives anywhere else: the executor calls `next_batch()`
in a loop and the scheduler alone decides when waiting longer could still
improve occupancy.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from repro_torch.serve.protocol import (BatchKey, QueryRequest, QueryTicket,
                                  ServerClosed, ServerSaturated)


@dataclass
class Entry:
    """One queued request with its ticket and admission stamp."""
    key: BatchKey
    req: QueryRequest
    ticket: QueryTicket
    t_admit: float = field(default_factory=time.perf_counter)


class ContinuousBatcher:
    """Thread-safe per-graph admission queue with window dispatch.

    put():        admit an entry (raises ServerSaturated at max_pending --
                  the server's backpressure signal -- and ServerClosed
                  after close()).
    next_batch(): block until a group is dispatchable, then return
                  (key, entries) with len(entries) <= key.cap.  Returns
                  None when closed and drained.
    """

    def __init__(self, *, window_s: float = 0.01, max_pending: int = 1024):
        self.window_s = window_s
        self.max_pending = max_pending
        self._queues: dict[BatchKey, list[Entry]] = {}
        self._pending = 0
        self._closed = False
        self._cond = threading.Condition()

    @property
    def pending(self) -> int:
        with self._cond:
            return self._pending

    def put(self, entry: Entry) -> None:
        with self._cond:
            if self._closed:
                raise ServerClosed("server is stopped; request not admitted")
            if self._pending >= self.max_pending:
                raise ServerSaturated(
                    f"admission queue full ({self._pending} pending >= "
                    f"max_pending={self.max_pending}); retry later")
            self._queues.setdefault(entry.key, []).append(entry)
            self._pending += 1
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _pick(self, now: float, flush: bool):
        """The dispatch decision under the lock: (key, soonest_deadline).
        A group dispatches when full or once its window has expired; with
        `flush` (server stopping) any nonempty group dispatches at once.
        key is None while every group should keep waiting."""
        best_key, best_deadline = None, None
        for key, entries in self._queues.items():
            if not entries:
                continue
            if len(entries) >= key.cap:
                return key, now                      # full: dispatch now
            deadline = entries[0].t_admit + self.window_s
            if best_deadline is None or deadline < best_deadline:
                best_key, best_deadline = key, deadline
        if best_key is not None and (flush or best_deadline <= now):
            return best_key, now
        return None, best_deadline

    def next_batch(self) -> "tuple[BatchKey, list[Entry]] | None":
        with self._cond:
            while True:
                now = time.perf_counter()
                key, deadline = self._pick(now, self._closed)
                if key is not None:
                    entries = self._queues[key]
                    take = min(len(entries), key.cap)
                    batch, rest = entries[:take], entries[take:]
                    if rest:
                        self._queues[key] = rest
                    else:
                        del self._queues[key]
                    self._pending -= take
                    self._cond.notify_all()
                    return key, batch
                if self._closed:
                    if self._pending == 0:
                        return None
                    continue                         # flush the remainder
                self._cond.wait(None if deadline is None
                                else max(deadline - now, 0))


def batch_key(graph_name: str, program: str, config: Any, arg: Any,
              k: "int | None", max_batch: int) -> BatchKey:
    """Coalescing key for one request (see repro_torch.serve.protocol for the
    per-program shapes).  `config` must already be resolved (hashable)."""
    if program in ("bfs", "sssp"):
        return BatchKey(graph_name, program, config, (), cap=max_batch)
    if program == "cc":
        # argument-free: all concurrent CC callers share one execution
        return BatchKey(graph_name, "cc", config, (), cap=max_batch)
    if program == "multi_bfs":
        K = int(len(arg))
        return BatchKey(graph_name, "multi_bfs", config, (K, k), cap=1)
    raise ValueError(f"unknown program {program!r}")
