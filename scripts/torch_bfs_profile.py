#!/usr/bin/env python3
"""Where one search of the PyTorch port spends its time on an NVIDIA GPU.

    python3 scripts/torch_bfs_profile.py [--scale 26] [--grid 2x2]
        [--edge-chunk 4194304] [--seed 1] [--direction]
        [--algo bfs|cc|sssp] [--exchange flat|butterfly|auto]
        [--telemetry] [--out FILE.json]

Generates the R-MAT graph on the card (as chip_smoke.py does, with the same
uint8 weights in 1..255 for SSSP), plans it, runs one warm-up search, then
one search under torch.profiler with CUDA activity.  --direction profiles
the direction-optimised path (`BFSConfig(direction=True,
fold_codec="bitmap")`, CSR twin planned first) instead of the top-down one.
--algo picks the program: BFS from the first vertex with an edge (the
default), connected components (`connected_components()`, its bitmap
codec), or SSSP from that vertex.  Prints the search's wall time, the
device-busy time (sum of the kernels' device time) and the idle share, and
the ops with the most device time: what bounds the search today, in order.
Under the bitmap codec it also splits the device time of
`BitmapFold.encode` (wrapped in a profiler range here) by the ops it runs:
the index arithmetic, the zeroed N*S `hits` buffer, its `index_add_`, the
`ne` and B3 `pack_bits`.  --exchange picks the fold's exchange strategy;
every exchange (`StackedTopology.col_all_to_all`, the folds and the final
predecessor resolution) runs in a profiler range whose device time is
split by op the same way.  --telemetry runs the session with
`BFSConfig(telemetry=True)` and splits the device time of the per-level
record (`obs.trace.record_level`) and of the trace's assembly likewise.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ENCODE = "BitmapFold.encode"
EXCHANGE = "col_all_to_all"
RECORD = "record_level"
ASSEMBLE = "assemble_traces"
RANGES = (ENCODE, EXCHANGE, RECORD, ASSEMBLE)


def range_split(prof, name) -> dict:
    """{op: [calls, device ms]} over the `name` ranges' child events: each
    op's device time with its children's.  A kernel launched through
    ctypes (B3 in the encode) is not among them (its `cudaLaunchKernel`
    carries none of its time): read it from its kernel row."""
    split = {}
    for ev in prof.events():
        if ev.name != name:
            continue
        for ch in ev.cpu_children:
            row = split.setdefault(ch.name, [0, 0.0])
            row[0] += 1
            row[1] += ch.device_time_total / 1e3
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--edge-chunk", type=int, default=1 << 22)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--direction", action="store_true",
                    help="profile direction=True with the bitmap codec")
    ap.add_argument("--algo", choices=("bfs", "cc", "sssp"), default="bfs")
    ap.add_argument("--exchange", default="flat",
                    help="the fold's exchange strategy: flat, butterfly or "
                         "auto")
    ap.add_argument("--telemetry", action="store_true",
                    help="run with BFSConfig(telemetry=True)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.dist.exchange import BitmapFold
    from repro_torch.dist.topology import StackedTopology
    from repro_torch.graphgen import rmat_edges
    from repro_torch.obs import trace as T

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    BitmapFold.encode = staticmethod(ranged(ENCODE, BitmapFold.encode))
    StackedTopology.col_all_to_all = ranged(EXCHANGE,
                                            StackedTopology.col_all_to_all)
    T.record_level = ranged(RECORD, T.record_level)
    T.assemble_traces = ranged(ASSEMBLE, T.assemble_traces)

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    R, C = (int(x) for x in args.grid.lower().split("x"))
    n = 1 << args.scale
    edges = rmat_edges(args.scale, args.edge_factor,
                       torch.Generator(device=dev).manual_seed(args.seed),
                       dev)
    weights = None
    if args.algo == "sssp":
        weights = torch.randint(1, 256, (edges.shape[1],), dtype=torch.uint8,
                                device=dev, generator=torch.Generator(
                                    device=dev).manual_seed(args.seed + 1))
    knobs = dict(direction=True, fold_codec="bitmap") if args.direction \
        else {}
    knobs.update(exchange=args.exchange, telemetry=args.telemetry)
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk, **knobs),
        n=n, weights=weights)
    deg = torch.bincount(edges[0].long(), minlength=n)
    root = int(torch.nonzero(deg > 0)[0])
    del deg
    sess = graph.session()
    search = {"bfs": lambda: sess.bfs(root),
              "cc": sess.connected_components,
              "sssp": lambda: sess.sssp(root)}[args.algo]
    search()                                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = search()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    # the device's own events are the kernels (and copies/memsets); the
    # aten ops that launched them carry the same time again, so the busy
    # time sums the device events only, less the ranges' own device-side
    # spans, which cover kernels counted already
    rows = [{"op": ev.key, "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.key not in RANGES]
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    directions = None if out.directions is None \
        else "".join("TB"[d] for d in out.directions.tolist() if d >= 0)
    levels = int(out.n_levels if args.algo == "bfs" else out.n_iters)
    report = {"device": smi, "scale": args.scale, "grid": [R, C],
              "edge_chunk": args.edge_chunk, "algo": args.algo,
              "root": None if args.algo == "cc" else root,
              "config": knobs, "exchange": sess.engine.exchange.name,
              "directions": directions,
              "levels": levels,
              "edges_scanned": out.edges_scanned,
              "search_s": plain_s, "profiled_search_s": prof_s,
              "device_busy_ms": busy_ms,
              "idle_share": 1 - busy_ms / (prof_s * 1e3),
              "top": rows[:args.top],
              "ranges": {name: range_split(prof, name) for name in RANGES}}
    print(f"device: {smi}")
    print(f"SCALE {args.scale} grid {R}x{C} edge_chunk {args.edge_chunk} "
          f"{args.algo} root {report['root']} {knobs}: {levels} levels, "
          f"{out.edges_scanned} edges scanned, directions {directions}")
    print(f"search {plain_s:.4f} s unprofiled, {prof_s:.4f} s profiled; "
          f"device busy {busy_ms:.1f} ms; idle share "
          f"{report['idle_share']:.4f}")
    for r in rows[:args.top]:
        print(f"  {r['device_ms']:10.2f} ms  {r['calls']:7d} calls  "
              f"{r['op'][:100]}")
    print(f"exchange: {report['exchange']}")
    for name, split in report["ranges"].items():
        if not split:
            continue
        total = sum(ms for _, ms in split.values())
        print(f"{name}: {total:.3f} device ms, by op:")
        for op, (calls, ms) in sorted(split.items(),
                                      key=lambda kv: -kv[1][1]):
            print(f"  {ms:10.3f} ms  {calls:7d} calls  {op[:100]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
