"""Exposition: JSON + Prometheus text + the JSONL event log
(DESIGN.md sec. 13), the port's copy of `repro/obs/export.py`.

`to_prometheus` renders a `MetricsRegistry` in the Prometheus text format
(version 0.0.4): HELP/TYPE headers, one sample line per labeled series,
histograms as cumulative `_bucket{le=...}` + `_sum` + `_count`.  The format
is the contract a scraper parses, so `tests/test_torch_obs.py` pins it
golden.

`EventLog` is the discrete-event side channel: batch executions, retries,
straggler flags and isolation replays as one JSON object per line --
buffered in a bounded ring and optionally appended to a `.jsonl` file (the
artifact the CI obs-smoke job uploads).
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque

from repro_torch.obs.metrics import Histogram, MetricsRegistry


def _escape(value) -> str:
    return str(value).replace("\\", r"\\").replace("\n", r"\n") \
                     .replace('"', r'\"')


def _labels_text(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in zip(names, values))
    return "{" + inner + "}"


def _num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render every metric + collector sample as Prometheus text."""
    lines = []
    for name, m in sorted(registry.metrics().items()):
        series = m.series()
        if not series:
            continue
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        lines.append(f"# TYPE {name} {m.kind}")
        for key, val in sorted(series.items()):
            if isinstance(m, Histogram):
                for le, c in val["buckets"].items():
                    lt = _labels_text(m.labelnames + ("le",),
                                      key + (_num(le),))
                    lines.append(f"{name}_bucket{lt} {c}")
                lt = _labels_text(m.labelnames, key)
                lines.append(f"{name}_sum{lt} {_num(val['sum'])}")
                lines.append(f"{name}_count{lt} {val['count']}")
            else:
                lines.append(
                    f"{name}{_labels_text(m.labelnames, key)} {_num(val)}")
    typed = set()
    for name, kind, help, labels, value in registry.collected():
        if name not in typed:
            typed.add(name)
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
        items = sorted(labels.items())
        lines.append(f"{name}"
                     f"{_labels_text([k for k, _ in items], [v for _, v in items])}"
                     f" {_num(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(registry: MetricsRegistry) -> dict:
    """JSON-able snapshot (metrics + collector samples)."""
    return registry.snapshot()


def write_json(registry: MetricsRegistry, path) -> None:
    with open(path, "w") as f:
        json.dump(to_json(registry), f, indent=2, sort_keys=True)
        f.write("\n")


class EventLog:
    """Bounded ring of discrete events, optionally mirrored to a JSONL file.

    emit() stamps wall-clock time and a monotone sequence number; every
    event is one JSON object per line, so the file tails cleanly and the
    CI artifact diffs by line.  Thread-safe.
    """

    def __init__(self, path=None, maxlen: int = 4096):
        self.path = None if path is None else str(path)
        self._buf = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = open(self.path, "a") if self.path is not None else None

    def emit(self, kind: str, **fields) -> dict:
        event = {"t": time.time(), "kind": str(kind), **fields}
        with self._lock:
            event["seq"] = self._seq
            self._seq += 1
            self._buf.append(event)
            if self._fh is not None:
                self._fh.write(json.dumps(event, sort_keys=True,
                                          default=str) + "\n")
                self._fh.flush()
        return event

    def tail(self, n: int = 50) -> list:
        with self._lock:
            return list(self._buf)[-n:]

    def to_list(self) -> list:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return self._seq

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
