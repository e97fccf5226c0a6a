#!/usr/bin/env python3
"""Where one search of the PyTorch port spends its time on an NVIDIA GPU.

    python3 scripts/torch_bfs_profile.py [--scale 26] [--grid 2x2]
        [--edge-chunk 4194304] [--seed 1] [--direction]
        [--algo bfs|cc|sssp] [--out FILE.json]

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
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.graphgen import rmat_edges

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
    # time sums the device events only
    rows = [{"op": ev.key, "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    directions = None if out.directions is None \
        else "".join("TB"[d] for d in out.directions.tolist() if d >= 0)
    levels = int(out.n_levels if args.algo == "bfs" else out.n_iters)
    report = {"device": smi, "scale": args.scale, "grid": [R, C],
              "edge_chunk": args.edge_chunk, "algo": args.algo,
              "root": None if args.algo == "cc" else root,
              "config": knobs, "directions": directions,
              "levels": levels,
              "edges_scanned": out.edges_scanned,
              "search_s": plain_s, "profiled_search_s": prof_s,
              "device_busy_ms": busy_ms,
              "idle_share": 1 - busy_ms / (prof_s * 1e3),
              "top": rows[:args.top]}
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
