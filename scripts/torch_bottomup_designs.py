#!/usr/bin/env python3
"""Stage-1 designs of the bottom-up kernels (B7 `bottomup_chunk`, B9
`bottomup_chunk_values`) timed on the real calls of a search, on an NVIDIA
GPU.

    python3 scripts/torch_bottomup_designs.py [--scale 26] [--roots 4]
        [--against DIR] [--budget-gib 8] [--out FILE.json]

Generates the R-MAT graph on the card (as chip_smoke.py does), plans it on
a 2x2 grid with its CSR twin, and keeps the arguments of every B7 call of
--roots direction-optimised BFS searches (chip_smoke.py's first roots) and
of the B9 calls of one direction-optimised connected components, until the
tensors they hold pass --budget-gib.  Then it builds variants of
`src/repro_torch/csrc/bottomup.cu` and `stages.cuh` into build/designs/,
each made by replacing a line of the source:

  committed    the sources as they are
  search       every spanned block searches by lane (no walk)
  walk         every spanned block walks its slots (no lane searches)
  limit_N      the walk limit at N = 8, 16, 32, 128 slots a lane (the
               sources have 64)
  atomic_32    the walk limit at 32, and each walked slot writing with
               atomicMax, as before the run-end store
  against      DIR/src/repro_torch/csrc/bottomup.cu as it is there (e.g. a
               parent checkout), with --against

Each variant's kernels must equal the plain versions on every kept call.
It prints, per kernel, the kept calls' row slots spanned per block (mean,
max, the share of blocks past the walk limit) and each variant's device
time over all kept calls (CUDA events, the calls queued behind a device
sleep), the variants timed in turns, forward then backward.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WALK_LIMIT = "constexpr int kWalkSlotsPerLane = 64;"
RUN_END_STORE = "if (l <= k_last && next[j] != v[j]) kmap[v[j] - g0] = l;"
ATOMIC = (RUN_END_STORE, "if (l <= k_last) atomicMax(&kmap[v[j] - g0], l);")


def _limit(slots: int):
    return (WALK_LIMIT, f"constexpr int kWalkSlotsPerLane = {slots};")


DESIGNS = {"committed": (), "search": (_limit(0),),
           "walk": (_limit(1 << 20),),
           **{f"limit_{n}": (_limit(n),) for n in (8, 16, 32, 128)},
           "atomic_32": (_limit(32), ATOMIC)}


def build_designs(against) -> dict:
    """{name: path of its built library}, all nvcc runs in parallel."""
    from repro_torch.kernels import build
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    sources = {}
    for name, edits in DESIGNS.items():
        out = os.path.join(ROOT, "build", "designs", name)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(csrc, "stages.cuh")) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"design {name}: stages.cuh no longer "
                                   f"has the line {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(out, "stages.cuh"), "w") as f:
            f.write(text)
        with open(os.path.join(csrc, "bottomup.cu")) as src, \
                open(os.path.join(out, "bottomup.cu"), "w") as dst:
            dst.write(src.read())
        sources[name] = os.path.join(out, "bottomup.cu")
    if against:
        sources["against"] = os.path.join(against, "src", "repro_torch",
                                          "csrc", "bottomup.cu")
    running = []
    for name, src in sources.items():
        lib = os.path.join(ROOT, "build", "designs", f"lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src]
        running.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        libs[name] = lib
    return libs


class Keep:
    """Wraps a chunk hook and keeps every call's arguments while the
    distinct per-level tensors they hold (all but the graph's own row_off
    and col_idx) stay under `budget` bytes."""

    def __init__(self, fn, budget):
        self.fn, self.budget = fn, budget
        self.calls, self.seen, self.bytes, self.dropped = [], set(), 0, 0

    def __call__(self, *args, **kw):
        import torch
        new = {a.data_ptr(): a.numel() * a.element_size()
               for i, a in enumerate(args) if i not in (4, 5)
               and isinstance(a, torch.Tensor)
               and a.data_ptr() not in self.seen}
        if self.bytes + sum(new.values()) <= self.budget:
            self.calls.append((args, kw))
            self.seen.update(new)
            self.bytes += sum(new.values())
        else:
            self.dropped += 1
        return self.fn(*args, **kw)


def spans(torch, calls) -> dict:
    """Row slots spanned per kernel block over the kept calls
    (`chip_smoke.block_span_tensor`): over the blocks that span any, the
    mean, quantiles and max, and the blocks past the walk limit."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    s = torch.cat([chip_smoke.block_span_tensor(torch, start, E, cumul,
                                                total)
                   for (start, E, cumul, total, *_), _ in calls])
    live = s[s > 0].float()
    limit = chip_smoke.WALK_SLOTS_PER_LANE * chip_smoke.BU_BLOCK_LANES
    return {"blocks": s.numel(), "spanning_blocks": live.numel(),
            "mean_span": float(live.mean()),
            "p50_p90_p99": torch.quantile(live, torch.tensor(
                [0.5, 0.9, 0.99], device=live.device)).tolist(),
            "max_span": int(s.max()), "past_walk_limit": int((s > limit).sum())}


def time_calls(torch, fn, calls) -> float:
    """Device ms of fn over every kept call, the calls queued behind a
    device sleep."""
    for args, kw in calls[:2]:
        fn(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1e-3 + 1e-4 * len(calls))))
    start.record()
    for args, kw in calls:
        fn(*args, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--roots", type=int, default=4)
    ap.add_argument("--edge-chunk", type=int, default=1 << 22)
    ap.add_argument("--budget-gib", type=float, default=8.0)
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from repro_torch.algos.cc import ConnectedComponentsProgram
    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.graphgen import rmat_edges
    from repro_torch.kernels import bottomup as KB
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = build_designs(args.against)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    n = 1 << args.scale
    edges = rmat_edges(args.scale, args.edge_factor,
                       torch.Generator(device=dev).manual_seed(args.seed),
                       dev)
    deg = torch.bincount(edges[0].long(), minlength=n)
    cand = torch.nonzero(deg > 0).flatten()
    roots = cand[torch.randperm(cand.numel(), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(args.seed))[:args.roots]]
    roots = roots.tolist()
    del deg, cand
    knobs = dict(grid=(2, 2), edge_chunk=args.edge_chunk, direction=True,
                 fold_codec="bitmap")
    graph = DistGraph.from_edges(edges, BFSConfig(**knobs), n=n)
    graph.ensure_csr()
    del edges
    graph.edges = None
    sess = graph.session(BFSConfig(**knobs))
    budget = int(args.budget_gib * 2**30) // 2
    keep7 = Keep(sess.engine.bottomup_fn, budget)
    sess.engine.bottomup_fn = keep7
    for r in roots:
        sess.bfs(r)
    sess.engine.bottomup_fn = keep7.fn
    eng = sess._algo_engine(ConnectedComponentsProgram(), None,
                            graph.grid.n + 1)
    keep9 = Keep(eng.value_bottomup_fn, budget)
    eng.value_bottomup_fn = keep9
    sess.connected_components()
    eng.value_bottomup_fn = keep9.fn
    torch.cuda.synchronize()
    report = {"device": smi, "scale": args.scale, "roots": roots}
    for kname, keep, fn, plain in (
            ("bottomup_chunk", keep7, KB.bottomup_chunk,
             KB.plain_bottomup_chunk),
            ("bottomup_chunk_values", keep9, KB.bottomup_chunk_values,
             KB.plain_bottomup_chunk_values)):
        calls = keep.calls
        if not calls:
            raise AssertionError(f"no {kname} call was kept")
        sp = spans(torch, calls)
        print(f"{kname}: {len(calls)} calls kept ({keep.dropped} past the "
              f"budget), {keep.bytes / 2**30:.2f} GiB; blocks {sp['blocks']}"
              f", spanning {sp['spanning_blocks']}, row slots a spanning "
              f"block spans mean {sp['mean_span']:.1f}, quantiles 0.5 / 0.9 "
              f"/ 0.99 {[round(x) for x in sp['p50_p90_p99']]}, max "
              f"{sp['max_span']},"
              f" past the walk limit {sp['past_walk_limit']}", flush=True)
        for name, path in libs.items():
            build._libs["bottomup"] = ctypes.CDLL(path)
            for cargs, kw in calls:
                got, want = fn(*cargs, **kw), plain(*cargs, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{kname} design {name} differs "
                                         f"from the plain version")
        times = {name: [] for name in libs}
        for name in list(libs) + list(reversed(libs)):
            build._libs["bottomup"] = ctypes.CDLL(libs[name])
            times[name].append(time_calls(torch, fn, calls))
        build._libs.pop("bottomup")
        for name, ms in times.items():
            print(f"  {name:12s} {ms[0]:9.3f} / {ms[1]:9.3f} ms over the "
                  f"calls, {sum(ms) / 2 / len(calls):.4f} ms a call; equal "
                  f"to the plain version", flush=True)
        report[kname] = {"calls": len(calls), "dropped": keep.dropped,
                         "spans": sp, "ms": times}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
