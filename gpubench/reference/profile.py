"""What a `torch.profiler` trace of the measured window says about the
device: busy seconds, the idle share, the device ops that took most time
and the longest idle gaps by what the host was doing.

The idle arithmetic is a frozen copy of `scripts/torch_bfs_profile.py` as
of the port's first benchmark: the device's own events (kernels, copies,
memsets) carry the device time, and idle share = 1 - busy / window, with
the window on the host clock.  The edit: busy is the union of the device
events' intervals, not their sum, so that work overlapping on two streams
is not counted twice; on one stream the two are equal.
"""
from __future__ import annotations

import bisect

from gpubench.reference.peaks import HBM_BYTES_PER_S

TOP = 10
NAME_CHARS = 160
# namespaces dropped from kernel names, so that the template arguments
# that tell kernels apart (a scatter's reduction) fit in NAME_CHARS
NOISE = ("void ", "at::native::", "(anonymous namespace)::",
         "at_cuda_detail::cub::", "at::cuda::cub::detail::", "c10::")


def short(name: str) -> str:
    for word in NOISE:
        name = name.replace(word, "")
    return name[:NAME_CHARS]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(events, window_s: float, device_kind) -> dict:
    """events: `prof.events()` of a profile over the window (FunctionEvents
    with `device_type` and `time_range` in microseconds); device_kind: the
    profiler's `DeviceType.CUDA`.  Returns busy_s, window_s, idle_share and
    the breakdown's two lists."""
    dev, host = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == device_kind:
            dev.append((tr.start, tr.end, ev.name))
        else:
            host.append((tr.start, tr.end, ev.name, ev.thread))
    busy = _merged((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_op = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "idle_share": 1.0 - busy_s / window_s,
            "device_ops": [[short(k), v] for k, v in device_ops],
            "idle_gaps": _idle_by_host_op(busy, host)}


def _idle_by_host_op(busy, host, walk: int = 256):
    """Idle seconds between device intervals, summed by the innermost host
    op of the main thread (the one with most events) running at each gap's
    middle; the TOP largest sums."""
    if not busy or not host:
        return []
    counts = {}
    for *_, t in host:
        counts[t] = counts.get(t, 0) + 1
    main = max(counts, key=counts.get)
    ops = sorted((s, e, name) for s, e, name, t in host if t == main)
    starts = [s for s, _, _ in ops]
    sums = {}
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "(python, between ops)"
        for j in range(i, max(i - walk, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
    return [[short(k), v] for k, v in
            sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def hbm_share(bytes_moved: int, busy_s: float) -> float:
    """Per cent of the device's busy time that HBM needs, at its published
    rate, to move `bytes_moved` once."""
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / busy_s
