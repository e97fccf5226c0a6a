"""The unified metrics registry (DESIGN.md sec. 13), the port's copy of
`repro/obs/metrics.py` (framework-free; the serving layer will use it).

One `MetricsRegistry` per observable component (each `GraphServer` owns
one, so counters are reset-safe across server restarts) holds every
counter / gauge / histogram the layer emits, as LABELED series:

    reg = MetricsRegistry()
    admitted = reg.counter("serve_admitted_total", "admitted queries",
                           labelnames=("tenant",))
    admitted.labels(tenant="alice").inc()

    lat = reg.histogram("serve_execute_seconds", labelnames=("graph",))
    lat.labels(graph="web").observe(0.012)

Exposition lives in `repro_torch.obs.export` (JSON snapshot + Prometheus
text); sources that keep their own authoritative counters (the AOT cache,
engine trace counts, queue depths) join the registry through
`register_collector` -- a zero-cost pull at scrape time instead of a write
on every event.

Thread-safe throughout: scheduler worker threads and any number of client
threads record concurrently (one registry-wide lock; metric mutation is a
dict update, so contention is negligible next to a graph search).
"""
from __future__ import annotations

import math
import threading

# Latency-shaped default buckets (seconds): spans queue waits in the
# hundreds of microseconds up to multi-second compiles.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labelnames, kv) -> tuple:
    if set(kv) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got {tuple(kv)}")
    return tuple(str(kv[name]) for name in labelnames)


class _Bound:
    """One labeled series of a metric, bound for direct mutation."""

    def __init__(self, metric: "Metric", key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, amount=1):
        self._metric._inc(self._key, amount)

    def dec(self, amount=1):
        self._metric._inc(self._key, -amount)

    def set(self, value):
        self._metric._set(self._key, value)

    def observe(self, value):
        self._metric._observe(self._key, value)

    @property
    def value(self):
        return self._metric.value_for(self._key)


class Metric:
    """Base labeled metric: a dict of series keyed by label-value tuples."""
    kind = "?"

    def __init__(self, name: str, help: str = "", labelnames: tuple = (),
                 lock: "threading.RLock | None" = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict = {}
        self._lock = lock if lock is not None else threading.RLock()

    def labels(self, **kv) -> _Bound:
        return _Bound(self, _label_key(self.labelnames, kv))

    # unlabeled ergonomic forms -------------------------------------------
    def inc(self, amount=1):
        self._inc((), amount)

    def dec(self, amount=1):
        self._inc((), -amount)

    def set(self, value):
        self._set((), value)

    def observe(self, value):
        self._observe((), value)

    @property
    def value(self):
        return self.value_for(())

    # series access --------------------------------------------------------
    def series(self) -> dict:
        """{label-values tuple: plain value} snapshot of every series."""
        with self._lock:
            return {k: self._plain(v) for k, v in self._series.items()}

    def value_for(self, key: tuple, default=0):
        with self._lock:
            if key not in self._series:
                return default
            return self._plain(self._series[key])

    def clear(self):
        with self._lock:
            self._series.clear()

    # subclass hooks -------------------------------------------------------
    def _plain(self, stored):
        return stored

    def _inc(self, key, amount):
        raise TypeError(f"{self.kind} {self.name!r} does not support inc()")

    def _set(self, key, value):
        raise TypeError(f"{self.kind} {self.name!r} does not support set()")

    def _observe(self, key, value):
        raise TypeError(
            f"{self.kind} {self.name!r} does not support observe()")


class Counter(Metric):
    """Monotone counter (ints stay ints, so query counts snapshot exact)."""
    kind = "counter"

    def _inc(self, key, amount):
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount


class Gauge(Metric):
    """Settable instantaneous value."""
    kind = "gauge"

    def _inc(self, key, amount):
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def _set(self, key, value):
        with self._lock:
            self._series[key] = value


class Histogram(Metric):
    """Fixed-bucket histogram: cumulative bucket counts + sum + count."""
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None,
                 lock=None):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted(buckets if buckets is not None else
                          DEFAULT_BUCKETS))
        if not bs:
            raise ValueError(f"histogram {name!r} needs >= 1 finite bucket")
        self.buckets = bs

    def _observe(self, key, value):
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = {
                    "buckets": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            st["buckets"][i] += 1
            st["sum"] += float(value)
            st["count"] += 1

    def _plain(self, stored):
        # cumulative counts per upper bound, Prometheus-style
        cum, acc = [], 0
        for c in stored["buckets"]:
            acc += c
            cum.append(acc)
        return {"buckets": dict(zip([*self.buckets, math.inf], cum)),
                "sum": stored["sum"], "count": stored["count"]}


class MetricsRegistry:
    """All metrics of one component + pull-time collectors.

    `counter` / `gauge` / `histogram` are get-or-create: asking twice with
    the same name returns the same metric (and raises if the kind or label
    set changed -- two writers disagreeing about a metric is a bug).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, Metric] = {}
        self._collectors: list = []

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}")
                return m
            m = cls(name, help, labelnames, lock=self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def register_collector(self, fn) -> None:
        """`fn() -> iterable of (name, kind, help, labels_dict, value)`;
        called at snapshot/exposition time.  For sources that keep their own
        authoritative counters (AOT cache, trace counts, queue depths)."""
        with self._lock:
            self._collectors.append(fn)

    def collected(self) -> list:
        """Materialize every collector's samples (scrape-time pull)."""
        with self._lock:
            collectors = list(self._collectors)
        out = []
        for fn in collectors:
            out.extend(tuple(s) for s in fn())
        return out

    def metrics(self) -> "dict[str, Metric]":
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """JSON-able view: {name: {kind, help, series: {label-str: value}}}
        including collector samples (kind-prefixed under their own names)."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            series = {",".join(f"{k}={v}" for k, v in
                               zip(m.labelnames, key)): val
                      for key, val in sorted(m.series().items())}
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        for name, kind, help, labels, value in self.collected():
            entry = out.setdefault(
                name, {"kind": kind, "help": help, "series": {}})
            entry["series"][",".join(
                f"{k}={v}" for k, v in sorted(labels.items()))] = value
        return out

    def reset(self) -> None:
        """Zero every series (collectors are pull-through and unaffected:
        their sources own their lifecycle)."""
        for m in self.metrics().values():
            m.clear()
