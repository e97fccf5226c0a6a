#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--scale 26] [--roots 64] [--batch 16] [--seed 1]

Phases, one line or more each on stdout:
  1. device    the card's name and power limit (nvidia-smi) and torch's view;
  2. build     nvcc builds both CUDA kernels from src/repro_torch/csrc for
               sm_90a (-Xptxas -v register / shared-memory summary);
  3. parity    each kernel against its plain torch version on the card, bit
               for bit, on random inputs;
  4. run       the Graph500 "toy" problem class by default: R-MAT SCALE 26,
               edgefactor 16, generated on the card from --seed, planned
               with `DistGraph.from_edges` on a 2x2 grid stacked on the card
               (edge_chunk 2^22), searched from --roots roots, each root
               timed alone and validated by the Graph500 rules on the card,
               then one batched `bfs(roots[:batch])` held equal to those
               roots' scalar results; harmonic-mean TEPS, peak memory, launch
               counts (each kernel's count must be > 0);
  3b. parity   each kernel again on one real chunk and one real expand-
               exchange row captured from that run, with its time (CUDA
               events) beside its plain version's and its bytes bound;
  5. path      one root again with expand="reference", fold="reference":
               levels, preds, n_levels and edges_scanned equal the kernel
               path's;
  6. report    the {"kernels": [...]} line, the nvidia-smi line, and last
               {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line.  Without a CUDA device, or
run outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, published peak


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms, CUDA events around `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Tap:
    """Wraps a kernel wrapper on the main path and keeps the arguments of
    one call (`pick(call_no, args)` chooses it; the first call is kept until
    a picked one comes).  Arguments at positions `copy` are cloned, since
    the loop updates them in place after the call."""

    def __init__(self, fn, pick, copy=()):
        self.fn, self.pick, self.copy = fn, pick, copy
        self.calls = 0
        self.saved = None
        self.picked = False

    def __call__(self, *args, **kw):
        self.calls += 1
        picked = self.pick(self.calls, args)
        if self.saved is None or (picked and not self.picked):
            self.saved = (tuple(a.clone() if i in self.copy else a
                                for i, a in enumerate(args)), dict(kw))
            self.picked = picked
        return self.fn(*args, **kw)


def max_abs_err(torch, a, b) -> int:
    """Largest absolute difference between two tuples of int/bool tensors
    (0 = bit for bit equal)."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--roots", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16,
                    help="roots of the batched search (its (B, n) output "
                         "must fit on the card beside the graph)")
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--edge-chunk", type=int, default=1 << 22)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        log("FAIL: src/repro_torch not found beside chip_smoke.py; run it "
            "from a checkout of the repository")
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script "
            "measures the port on an NVIDIA GPU")
        return 1

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.core import frontier as F
    from repro_torch.core.validate import count_component_edges, \
        harmonic_mean, validate_bfs
    from repro_torch.graphgen import rmat_edges
    from repro_torch.kernels import build
    from repro_torch.kernels import expand as K
    from repro_torch.kernels import fold as KF

    report = {"args": vars(args)}
    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] nvidia-smi: {smi}; torch: {kind}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    report["device"] = {"nvidia_smi": smi, "kind": kind}

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptx = [ln.strip() for ln in info["log"].splitlines()
               if "registers" in ln or "spill" in ln]
        log(f"[2 build] {name}.cu: {'cached' if info['cached'] else 'nvcc'}"
            f" {info['seconds']:.1f} s; " + " | ".join(ptx))
    log(f"[2 build] all kernels in {build_s:.1f} s")
    report["build_s"] = build_s

    # -- 3. parity on random inputs -----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ncl, n_rows, ft = 1 << 20, 1 << 21, 700_000
    deg = torch.randint(0, 9, (ncl,), generator=gen, device=dev,
                        dtype=torch.int32)
    col_off = F.exclusive_cumsum(deg)
    nnz = int(col_off[-1])
    row_idx = torch.randint(0, n_rows, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
    front = torch.full((ncl,), -1, dtype=torch.int32, device=dev)
    front[:ft] = torch.randperm(ncl, generator=gen, device=dev)[:ft].to(
        torch.int32)
    visited = torch.rand(n_rows, generator=gen, device=dev) < 0.3
    ftot = torch.tensor(ft, dtype=torch.int32, device=dev)
    cumul, total = F.scan_plan(col_off, front, ftot)
    words = F.pack_bitmap(visited)
    rnd = (cumul, front, ftot, col_off, row_idx, words)
    for start, E in ((0, 1 << 22), (int(total) - 5000, 1 << 20),
                     (12345, 3000)):
        err = max_abs_err(torch, K.expand_chunk(start, E, *rnd),
                          K.plain_expand_chunk(start, E, *rnd))
        log(f"[3 parity] expand_chunk random start={start} E={E}: "
            f"max_abs_err {err}")
        if err:
            raise AssertionError("expand_chunk differs from its plain "
                                 "version")
    for N, S, p in ((1, 1 << 25, 0.3), (3, 1_000_003, 0.9), (2, 77, 0.0)):
        mask = torch.rand((N, S), generator=gen, device=dev) < p
        vals = torch.randint(-9, 1 << 30, (N, S), generator=gen, device=dev,
                             dtype=torch.int32)
        kout, kcnt = KF.compact_rows(mask, (vals,), (-1,))
        pout, pcnt = KF.plain_compact_rows(mask, (vals,), (-1,))
        err = max_abs_err(torch, kout + (kcnt,), pout + (pcnt,))
        log(f"[3 parity] compact_rows random N={N} S={S}: max_abs_err {err}")
        if err:
            raise AssertionError("compact_rows differs from its plain "
                                 "version")
    torch.cuda.synchronize()
    del rnd, deg, col_off, row_idx, front, visited, cumul, words

    # -- 4. the full-size run -------------------------------------------------
    R, C = (int(x) for x in args.grid.lower().split("x"))
    t0 = time.perf_counter()
    edges = rmat_edges(args.scale, args.edge_factor,
                       torch.Generator(device=dev).manual_seed(args.seed),
                       dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n = 1 << args.scale
    log(f"[4 run] rmat_edges SCALE {args.scale} edgefactor "
        f"{args.edge_factor}: {edges.shape[1]} directed edges in "
        f"{gen_s:.1f} s")
    config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk)
    t0 = time.perf_counter()
    graph = DistGraph.from_edges(edges, config, n=n)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    log(f"[4 run] DistGraph.from_edges grid {R}x{C}: nnz per block "
        f"{graph.csc.nnz.flatten().tolist()} in {plan_s:.1f} s")
    t0 = time.perf_counter()
    index = graph.edge_index()
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    log(f"[4 run] Graph500 edge index ({len(index.keys)} sorted pieces) in "
        f"{index_s:.1f} s")

    deg0 = torch.bincount(edges[0].long(), minlength=n)
    cand = torch.nonzero(deg0 > 0).flatten()
    pick = torch.randperm(cand.numel(), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(args.seed))[:args.roots]
    roots = cand[pick].tolist()
    del deg0, cand, pick
    sess = graph.session()
    eng = sess.engine
    assert eng.expand_path == "kernel" and eng.fold_path == "kernel"

    # warm-up search through taps that keep one real chunk / exchange row
    expand_tap = Tap(eng.expand_fn, lambda k, a: a[0] > 0, copy=(7,))
    compact_tap = Tap(KF.compact_rows, lambda k, a: k == 2 * C + 1)

    class TappedFold:
        compact_rows = compact_tap

    eng.expand_fn, eng.fold_ops = expand_tap, TappedFold
    t0 = time.perf_counter()
    sess.bfs(roots[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    eng.expand_fn, eng.fold_ops = K.expand_chunk, KF
    log(f"[4 run] warm-up search {warm_s:.2f} s (taps: {expand_tap.calls} "
        f"chunks, {compact_tap.calls} exchange rows)")

    # the main path: counts to 0, timed scalar searches, one batched search
    K.expand_chunk.launches = 0
    KF.compact_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, teps, scalar = [], [], []
    scanned_total = 0
    for r in roots:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.bfs(r)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        level, pred = out.level[:n], out.pred[:n]
        t1 = time.perf_counter()
        validate_bfs(edges, level, pred, r, index=index)
        m = count_component_edges(edges, level)
        val_s = time.perf_counter() - t1
        times.append(dt)
        teps.append(m / dt)
        scanned_total += out.edges_scanned
        if len(scalar) < args.batch:
            scalar.append((out.level.cpu(), out.pred.cpu(),
                           int(out.n_levels), out.edges_scanned))
        log(f"[4 run] root {r}: {int(out.n_levels)} levels, "
            f"{out.edges_scanned} edges scanned, component {m} edges, "
            f"{dt:.3f} s, {m / dt:.4e} TEPS, validated in {val_s:.1f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = sess.bfs(roots[:len(scalar)])
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = {"expand_chunk": K.expand_chunk.launches,
                "compact_rows": KF.compact_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    for b, (lv, pr, nl, es) in enumerate(scalar):
        if not (torch.equal(batch.level[b].cpu(), lv)
                and torch.equal(batch.pred[b].cpu(), pr)
                and int(batch.n_levels[b]) == nl
                and batch.edges_scanned[b] == es):
            raise AssertionError(f"batched search {b} differs from scalar")
    del batch
    hm = harmonic_mean(teps)
    n_searches = len(roots) + len(scalar)
    log(f"[4 run] {len(roots)} roots validated (Graph500 rules); batched "
        f"bfs({len(scalar)} roots) equal to scalar, {batch_s:.2f} s")
    log(f"[4 run] harmonic-mean TEPS {hm:.6e}; mean search "
        f"{sum(times) / len(times):.4f} s; peak memory {peak / 2**30:.2f} "
        f"GiB; launches over {n_searches} searches {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    report["run"] = {"n": n, "directed_edges": int(edges.shape[1]),
                     "gen_s": gen_s, "plan_s": plan_s, "index_s": index_s,
                     "roots": roots, "search_s": times, "teps": teps,
                     "harmonic_teps": hm, "batch_s": batch_s,
                     "peak_bytes": peak, "launches": launches,
                     "searches": n_searches,
                     "edges_scanned_scalar_total": scanned_total}

    # -- 3b. parity and time on real main-path inputs ------------------------
    kernels = []
    (start, E, *eargs), ekw = expand_tap.saved
    kern = K.expand_chunk(start, E, *eargs, **ekw)
    plain = K.plain_expand_chunk(start, E, *eargs, **ekw)
    err = max_abs_err(torch, kern, plain)
    if err:
        raise AssertionError("expand_chunk differs on the real chunk")
    cumul, front, ftot, col_off, row_idx, words = eargs
    live = int((start + torch.arange(E, device=dev) < cumul[ftot]).sum())
    k_lo = int(torch.searchsorted(cumul[:int(ftot) + 1],
                                  torch.tensor([start], device=dev,
                                               dtype=torch.int32),
                                  right=True)) - 1
    k_hi = int(torch.searchsorted(cumul[:int(ftot) + 1],
                                  torch.tensor([start + max(live, 1) - 1],
                                               device=dev,
                                               dtype=torch.int32),
                                  right=True)) - 1
    v, won, u = kern
    n_words = int(torch.unique(v[:live] >> 5).numel())
    # row_idx + the touched cumul/front/col_off entries + visited words in,
    # v/u/won out
    e_bytes = (4 * live + 12 * (k_hi - k_lo + 1) + 4 * n_words + 9 * E)
    e_ms = cuda_ms(torch, lambda: K.expand_chunk(start, E, *eargs, **ekw))
    e_plain = cuda_ms(torch,
                      lambda: K.plain_expand_chunk(start, E, *eargs, **ekw),
                      reps=3)
    kernels.append({
        "name": "expand_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/expand.cu",
        "replaces": "src/repro/kernels/expand.py:103",
        "launches": launches["expand_chunk"], "max_abs_err": err,
        "ms": e_ms, "plain_ms": e_plain,
        "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None})
    log(f"[3b parity] expand_chunk real chunk start={start} E={E} live={live}"
        f" frontier slots {k_hi - k_lo + 1}: max_abs_err {err}; kernel "
        f"{e_ms:.4f} ms, plain {e_plain:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms ({e_bytes} B)")

    (mask, arrays, fills), ckw = compact_tap.saved
    kern = KF.compact_rows(mask, arrays, fills)
    plain = KF.plain_compact_rows(mask, arrays, fills)
    err = max_abs_err(torch, kern[0] + (kern[1],), plain[0] + (plain[1],))
    if err:
        raise AssertionError("compact_rows differs on the real row")
    N, S = mask.shape
    c_bytes = N * S * (1 + 8 * len(arrays)) + 4 * N
    c_ms = cuda_ms(torch, lambda: KF.compact_rows(mask, arrays, fills))
    c_plain = cuda_ms(torch,
                      lambda: KF.plain_compact_rows(mask, arrays, fills))
    kernels.append({
        "name": "compact_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/compact.cu",
        "replaces": "src/repro/kernels/fold.py:112",
        "launches": launches["compact_rows"], "max_abs_err": err,
        "ms": c_ms, "plain_ms": c_plain,
        "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None})
    log(f"[3b parity] compact_rows real exchange row N={N} S={S} valid "
        f"{int(kern[1].sum())}: max_abs_err {err}; kernel {c_ms:.4f} ms, "
        f"plain {c_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms")
    del expand_tap, compact_tap, eargs, kern, plain, v, won, u

    # -- 5. whole-path parity: the plain path on the card --------------------
    ref_sess = graph.session(BFSConfig(grid=(R, C),
                                       edge_chunk=args.edge_chunk,
                                       expand="reference", fold="reference"))
    assert ref_sess.engine.expand_fn is None and \
        ref_sess.engine.fold_ops is None
    t0 = time.perf_counter()
    ref = ref_sess.bfs(roots[0])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    lv, pr, nl, es = scalar[0]
    same = (torch.equal(ref.level.cpu(), lv) and torch.equal(ref.pred.cpu(), pr)
            and int(ref.n_levels) == nl and ref.edges_scanned == es)
    log(f"[5 path] expand='reference', fold='reference' at full size "
        f"(SCALE {args.scale}) root {roots[0]}: {ref_s:.2f} s, equal to the "
        f"kernel path: {same}")
    if not same:
        raise AssertionError("the plain path differs from the kernel path")
    report["path_parity"] = {"scale": args.scale, "root": roots[0],
                             "reference_s": ref_s, "equal": same}
    report["kernels"] = kernels

    # -- 6. report ------------------------------------------------------------
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke aborted", flush=True)
        sys.exit(1)
