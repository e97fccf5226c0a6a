"""Serve-layer request tracing: span-per-request lifecycle
(DESIGN.md sec. 13), the port's copy of `repro/obs/spans.py`.

A request admitted to a `GraphServer` moves through a fixed lifecycle --
admit -> queue -> coalesce -> execute -> demux -- and each fulfilled
`QueryResult` carries a `RequestTrace` whose spans cover it wall to wall:

  queue     admission until the batcher dispatched the coalesced group
            (the max-latency-window wait)
  coalesce  dispatch until execution start (batch assembly + the server's
            device-execution lock wait)
  execute   the batch's device execution (shared by every rider)
  demux     execution end until this request's slot was demuxed into its
            ticket

Spans are host wall-clock (`time.perf_counter` stamps the workers already
take); the in-program per-level counters are `repro_torch.obs.trace`.
"""
from __future__ import annotations

import dataclasses

# Lifecycle phase order (golden in tests: spans appear in this order and
# tile the admit -> done interval).
PHASES = ("queue", "coalesce", "execute", "demux")


@dataclasses.dataclass
class Span:
    """One closed interval of a request's lifecycle."""
    name: str
    t0: float
    t1: float
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "dur_s": self.dur_s, **({"attrs": self.attrs}
                                        if self.attrs else {})}


@dataclasses.dataclass
class RequestTrace:
    """All spans of one request, in lifecycle order."""
    seq: int
    graph: str
    program: str
    spans: list = dataclasses.field(default_factory=list)

    def add(self, name: str, t0: float, t1: float, **attrs) -> Span:
        span = Span(name=name, t0=t0, t1=max(t1, t0), attrs=attrs)
        self.spans.append(span)
        return span

    def span(self, name: str) -> "Span | None":
        for s in self.spans:
            if s.name == name:
                return s
        return None

    def dur_s(self, name: str) -> float:
        s = self.span(name)
        return s.dur_s if s is not None else 0.0

    @property
    def total_s(self) -> float:
        if not self.spans:
            return 0.0
        return max(s.t1 for s in self.spans) - min(s.t0 for s in self.spans)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "graph": self.graph,
                "program": self.program, "total_s": self.total_s,
                "spans": [s.to_dict() for s in self.spans]}


def request_trace(seq, graph, program, *, t_admit, t_dispatch, t_exec_start,
                  t_exec_end, t_done, **exec_attrs) -> RequestTrace:
    """Build the standard 4-span lifecycle trace from the worker's stamps."""
    tr = RequestTrace(seq=seq, graph=graph, program=program)
    tr.add("queue", t_admit, t_dispatch)
    tr.add("coalesce", t_dispatch, t_exec_start)
    tr.add("execute", t_exec_start, t_exec_end, **exec_attrs)
    tr.add("demux", t_exec_end, t_done)
    return tr
