"""Telemetry (DESIGN.md sec. 13), the port of `repro/obs`: three layers.

1. In-program per-level traces: `BFSConfig(telemetry=True)` keeps a
   per-level record beside each search in the engine's level loop; every
   search returns a `LevelTrace` (frontier counts, direction, fold wire
   bytes and messages, scanned and folded work), also readable as
   `GraphSession.last_trace()`.  Off by default and keyed into every
   engine cache; outputs are identical either way.

2. The metrics registry: thread-safe labeled counters / gauges /
   histograms (`MetricsRegistry`), JSON + Prometheus-text exposition
   (`to_prometheus`, `to_json`) and the JSONL `EventLog` (copies of the
   JAX package's framework-free modules, for the serving layer).

3. Request tracing: the span-per-request lifecycle
   (admit -> queue -> coalesce -> execute -> demux) of `RequestTrace`.
"""
from repro_torch.obs.export import EventLog, to_json, to_prometheus, \
    write_json
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.spans import PHASES, RequestTrace, Span, request_trace
from repro_torch.obs.trace import (N_TRACE_OUTS, TRACE_CHANNELS, LevelTrace,
                                   assemble_traces, init_trace,
                                   normalize_aux, record_level,
                                   trace_outputs)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "EventLog", "to_prometheus", "to_json", "write_json",
    "LevelTrace", "assemble_traces", "init_trace", "normalize_aux",
    "record_level", "trace_outputs", "TRACE_CHANNELS", "N_TRACE_OUTS",
    "RequestTrace", "Span", "PHASES", "request_trace",
]
