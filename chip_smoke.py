#!/usr/bin/env python3
"""Drive the PyTorch port's two session paths once on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--scale 26] [--roots 64] [--td-roots 16]
                          [--batch 8] [--dir-batch 4] [--seed 1]

Phases, one line or more each on stdout:
  1. device    the card's name and power limit (nvidia-smi) and torch's view;
  2. build     nvcc builds every CUDA kernel from src/repro_torch/csrc for
               sm_90a, all sources in parallel (-Xptxas -v register /
               shared-memory summary);
  3. parity    each kernel against its plain torch version on the card, bit
               for bit, on random inputs (pack/unpack_bits with S % 32 != 0
               and all-false / all-true masks; bottomup_chunk with
               block % 32 != 0, an empty and a full frontier, total = 0 and
               a chunk straddling the live total);
  4. run       the top-down path at the Graph500 "toy" problem class by
               default: R-MAT SCALE 26, edgefactor 16, generated on the card
               from --seed, planned with `DistGraph.from_edges` on a 2x2
               grid stacked on the card (edge_chunk 2^22), --td-roots roots
               each timed alone and validated by the Graph500 rules on the
               card, then one batched `bfs(roots[:batch])` held equal to
               those roots' scalar results; harmonic-mean TEPS, peak memory,
               launch counts (B1 and B2 must be > 0);
  3b. parity   B1 and B2 again on one real chunk and one real expand-
               exchange row captured from that run, with their time (CUDA
               events) beside their plain versions' and their bytes bound;
  5. path      one root again with expand="reference", fold="reference":
               levels, preds, n_levels and edges_scanned equal the kernel
               path's;
  7. dir-run   the same resident graph, `ensure_csr()`, then the direction-
               optimised path `BFSConfig(direction=True, fold_codec=
               "bitmap")`: --roots roots each timed alone and validated;
               the first 8 equal the top-down path's levels, preds and
               n_levels; `directions` holds a bottom-up level; a batched
               `bfs(roots[:dir_batch])` equals the scalar results; launch
               counts of B1, B2, B3, B4 and B7 must each be > 0;
  7b. parity   B3, B4 and B7 on one real call each captured from phase 7,
               with time, plain time and bytes bound;
  8. dir-path  one root with expand, fold and bottomup = "reference": equal
               to the kernel path (levels, preds, n_levels, edges_scanned,
               directions); one root with direction="bottomup": levels and
               preds equal top-down;
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
TD_EQUAL_ROOTS = 8               # direction roots held to the top-down path


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


def check_equal(torch, what, a, b) -> int:
    err = max_abs_err(torch, a, b)
    if err:
        raise AssertionError(f"{what} differs from its plain version "
                             f"(max_abs_err {err})")
    return err


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               bytes_):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}


def parity_random_dir(torch, dev, gen, KF, KB) -> None:
    """Phase 3 for B3, B4 and B7: random inputs, bit for bit."""
    for N, S, p in ((8, 1 << 24, 0.3), (3, 1_000_003, 0.6), (2, 77, 0.0),
                    (5, 33, 1.0)):
        mask = torch.rand((N, S), generator=gen, device=dev) < p
        words = KF.pack_bits(mask)
        err = check_equal(torch, "pack_bits", (words,),
                          (KF.plain_pack_bits(mask),))
        err += check_equal(torch, "unpack_bits", (KF.unpack_bits(words, S),),
                           (KF.plain_unpack_bits(words, S), mask))
        log(f"[3 parity] pack_bits + unpack_bits random N={N} S={S} p={p}: "
            f"max_abs_err {err}")
    R, block = 2, (1 << 20) + 5                 # block % 32 != 0
    nrl = 2 * block
    deg = torch.randint(0, 17, (nrl,), generator=gen, device=dev,
                        dtype=torch.int32)
    row_off = torch.zeros(nrl + 1, dtype=torch.int32, device=dev)
    row_off[1:] = torch.cumsum(deg, 0)
    col_idx = torch.randint(0, R * block, (int(row_off[-1]) + 11,),
                            generator=gen, device=dev, dtype=torch.int32)
    visited = torch.rand(nrl, generator=gen, device=dev) < 0.4
    for frac in (0.0, 0.5, 1.0):
        fmask = torch.rand((R, block), generator=gen, device=dev) < frac
        words = KF.plain_pack_bits(fmask).reshape(-1)
        for zero_total in (False, True):
            masked = torch.where(visited | zero_total, 0, deg)
            cumul = torch.zeros(nrl + 1, dtype=torch.int32, device=dev)
            cumul[1:] = torch.cumsum(masked, 0)
            total = cumul[nrl].clone()
            t = int(total)
            args = (cumul, total, row_off, col_idx, words)
            for start, E in ((0, 1 << 22), (max(t - 5000, 0), 1 << 20)):
                err = check_equal(
                    torch, "bottomup_chunk",
                    KB.bottomup_chunk(start, E, *args, block=block),
                    KB.plain_bottomup_chunk(start, E, *args, block=block))
                log(f"[3 parity] bottomup_chunk random frontier {frac} "
                    f"total {t} start={start} E={E}: max_abs_err {err}")
    torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--roots", type=int, default=64,
                    help="timed roots of the direction-optimised path")
    ap.add_argument("--td-roots", type=int, default=16,
                    help="timed roots of the top-down path")
    ap.add_argument("--batch", type=int, default=8,
                    help="roots of the top-down batched search (its (B, n) "
                         "output must fit on the card beside the graph)")
    ap.add_argument("--dir-batch", type=int, default=4,
                    help="roots of the direction path's batched search")
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--edge-chunk", type=int, default=1 << 22)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    t_script = time.perf_counter()

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
    from repro_torch.kernels import bottomup as KB
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
        err = check_equal(torch, "expand_chunk",
                          K.expand_chunk(start, E, *rnd),
                          K.plain_expand_chunk(start, E, *rnd))
        log(f"[3 parity] expand_chunk random start={start} E={E}: "
            f"max_abs_err {err}")
    for N, S, p in ((1, 1 << 25, 0.3), (3, 1_000_003, 0.9), (2, 77, 0.0)):
        mask = torch.rand((N, S), generator=gen, device=dev) < p
        vals = torch.randint(-9, 1 << 30, (N, S), generator=gen, device=dev,
                             dtype=torch.int32)
        kout, kcnt = KF.compact_rows(mask, (vals,), (-1,))
        pout, pcnt = KF.plain_compact_rows(mask, (vals,), (-1,))
        err = check_equal(torch, "compact_rows", kout + (kcnt,),
                          pout + (pcnt,))
        log(f"[3 parity] compact_rows random N={N} S={S}: max_abs_err {err}")
    del rnd, deg, col_off, row_idx, front, visited, cumul, words
    parity_random_dir(torch, dev, gen, KF, KB)

    # -- 4. the full-size top-down run ---------------------------------------
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
    td_roots = roots[:args.td_roots]
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

    # the top-down path: counts to 0, timed scalar searches, one batch
    K.expand_chunk.launches = 0
    KF.compact_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, teps, scalar = [], [], []
    keep = max(args.batch, TD_EQUAL_ROOTS)
    for r in td_roots:
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
        if len(scalar) < keep:
            scalar.append((out.level.cpu(), out.pred.cpu(),
                           int(out.n_levels), out.edges_scanned))
        log(f"[4 run] root {r}: {int(out.n_levels)} levels, "
            f"{out.edges_scanned} edges scanned, component {m} edges, "
            f"{dt:.3f} s, {m / dt:.4e} TEPS, validated in {val_s:.1f} s")
    del out, level, pred
    n_batch = min(args.batch, len(scalar))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = sess.bfs(td_roots[:n_batch])
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = {"expand_chunk": K.expand_chunk.launches,
                "compact_rows": KF.compact_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    for b, (lv, pr, nl, es) in enumerate(scalar[:n_batch]):
        if not (torch.equal(batch.level[b].cpu(), lv)
                and torch.equal(batch.pred[b].cpu(), pr)
                and int(batch.n_levels[b]) == nl
                and batch.edges_scanned[b] == es):
            raise AssertionError(f"batched search {b} differs from scalar")
    del batch
    hm = harmonic_mean(teps)
    n_searches = len(td_roots) + n_batch
    log(f"[4 run] {len(td_roots)} roots validated (Graph500 rules); batched "
        f"bfs({n_batch} roots) equal to scalar, {batch_s:.2f} s")
    log(f"[4 run] harmonic-mean TEPS {hm:.6e}; mean search "
        f"{sum(times) / len(times):.4f} s; peak memory {peak / 2**30:.2f} "
        f"GiB; launches over {n_searches} searches {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    report["run"] = {"n": n, "directed_edges": int(edges.shape[1]),
                     "gen_s": gen_s, "plan_s": plan_s, "index_s": index_s,
                     "roots": td_roots, "search_s": times, "teps": teps,
                     "harmonic_teps": hm, "batch_s": batch_s,
                     "peak_bytes": peak, "launches": launches,
                     "searches": n_searches}

    # -- 3b. parity and time on real main-path inputs ------------------------
    kernels = []
    (start, E, *eargs), ekw = expand_tap.saved
    kern = K.expand_chunk(start, E, *eargs, **ekw)
    err = check_equal(torch, "expand_chunk on the real chunk", kern,
                      K.plain_expand_chunk(start, E, *eargs, **ekw))
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
    v = kern[0]
    n_words = int(torch.unique(v[:live] >> 5).numel())
    # row_idx + the touched cumul/front/col_off entries + visited words in,
    # v/u/won out
    e_bytes = (4 * live + 12 * (k_hi - k_lo + 1) + 4 * n_words + 9 * E)
    e_ms = cuda_ms(torch, lambda: K.expand_chunk(start, E, *eargs, **ekw))
    e_plain = cuda_ms(torch,
                      lambda: K.plain_expand_chunk(start, E, *eargs, **ekw),
                      reps=3)
    kernels.append(kernel_row(
        "expand_chunk", "src/repro_torch/csrc/expand.cu",
        "src/repro/kernels/expand.py:103", launches["expand_chunk"], err,
        e_ms, e_plain, e_bytes))
    log(f"[3b parity] expand_chunk real chunk start={start} E={E} live={live}"
        f" frontier slots {k_hi - k_lo + 1}: max_abs_err {err}; kernel "
        f"{e_ms:.4f} ms, plain {e_plain:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms ({e_bytes} B)")

    (mask, arrays, fills), _ = compact_tap.saved
    kern = KF.compact_rows(mask, arrays, fills)
    plain = KF.plain_compact_rows(mask, arrays, fills)
    err = check_equal(torch, "compact_rows on the real row",
                      kern[0] + (kern[1],), plain[0] + (plain[1],))
    N, S = mask.shape
    c_bytes = N * S * (1 + 8 * len(arrays)) + 4 * N
    c_ms = cuda_ms(torch, lambda: KF.compact_rows(mask, arrays, fills))
    c_plain = cuda_ms(torch,
                      lambda: KF.plain_compact_rows(mask, arrays, fills))
    kernels.append(kernel_row(
        "compact_rows", "src/repro_torch/csrc/compact.cu",
        "src/repro/kernels/fold.py:112", launches["compact_rows"], err,
        c_ms, c_plain, c_bytes))
    log(f"[3b parity] compact_rows real exchange row N={N} S={S} valid "
        f"{int(kern[1].sum())}: max_abs_err {err}; kernel {c_ms:.4f} ms, "
        f"plain {c_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms")
    del expand_tap, compact_tap, eargs, kern, plain, v, mask, arrays

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
    del ref, ref_sess

    # -- 7. the direction-optimised path -------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph.ensure_csr()
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    csr_peak = torch.cuda.max_memory_allocated()
    log(f"[7 dir-run] ensure_csr: CSR twin nnz per block "
        f"{graph.csr['nnz'].flatten().tolist()} in {csr_s:.1f} s; peak "
        f"memory {csr_peak / 2**30:.2f} GiB, resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    dir_config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                           direction=True, fold_codec="bitmap")
    dsess = graph.session(dir_config)
    deng = dsess.engine
    assert deng.bottomup_path == "kernel" and deng.codec.name == "bitmap"

    bu_tap = Tap(deng.bottomup_fn, lambda k, a: a[0] > 0)
    pack_tap = Tap(KF.pack_bits, lambda k, a: k == 3)
    unpack_tap = Tap(KF.unpack_bits, lambda k, a: k == 3)

    class TappedBits:
        compact_rows = KF.compact_rows
        pack_bits = pack_tap
        unpack_bits = unpack_tap

    deng.bottomup_fn = bu_tap
    deng.fold_ops = deng.codec.ops = TappedBits
    t0 = time.perf_counter()
    dsess.bfs(roots[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    deng.bottomup_fn = KB.bottomup_chunk
    deng.fold_ops = deng.codec.ops = KF
    log(f"[7 dir-run] warm-up search {warm_s:.2f} s (taps: {bu_tap.calls} "
        f"bottom-up chunks, {pack_tap.calls} packs, {unpack_tap.calls} "
        f"unpacks)")

    counted = (K.expand_chunk, KF.compact_rows, KF.pack_bits,
               KF.unpack_bits, KB.bottomup_chunk)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    dtimes, dteps, dscalar = [], [], []
    n_bu_levels = 0
    n_equal = min(TD_EQUAL_ROOTS, len(scalar))
    for k, r in enumerate(roots):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dsess.bfs(r)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        level, pred = out.level[:n], out.pred[:n]
        t1 = time.perf_counter()
        validate_bfs(edges, level, pred, r, index=index)
        m = count_component_edges(edges, level)
        val_s = time.perf_counter() - t1
        dtimes.append(dt)
        dteps.append(m / dt)
        dirs = out.directions.cpu()
        n_bu_levels += int((dirs == 1).sum())
        if k < n_equal:
            lv, pr, nl, _ = scalar[k]
            if not (torch.equal(out.level.cpu(), lv)
                    and torch.equal(out.pred.cpu(), pr)
                    and int(out.n_levels) == nl):
                raise AssertionError(f"direction path root {r} differs from "
                                     f"the top-down path")
        if k < max(args.dir_batch, 1):
            dscalar.append((out.level.cpu(), out.pred.cpu(),
                            int(out.n_levels), out.edges_scanned, dirs))
        live = dirs[dirs >= 0].tolist()
        log(f"[7 dir-run] root {r}: {int(out.n_levels)} levels, directions "
            f"{''.join('B' if d else 'T' for d in live)}, "
            f"{out.edges_scanned} edges scanned, component {m} edges, "
            f"{dt:.3f} s, {m / dt:.4e} TEPS, validated in {val_s:.1f} s")
    del out, level, pred
    if n_bu_levels == 0:
        raise AssertionError("no search ran a bottom-up level")
    n_dbatch = min(args.dir_batch, len(dscalar))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dbatch = dsess.bfs(roots[:n_dbatch])
    torch.cuda.synchronize()
    dbatch_s = time.perf_counter() - t0
    dlaunches = {fn.__name__: fn.launches for fn in counted}
    dpeak = torch.cuda.max_memory_allocated()
    for b, (lv, pr, nl, es, dr) in enumerate(dscalar[:n_dbatch]):
        if not (torch.equal(dbatch.level[b].cpu(), lv)
                and torch.equal(dbatch.pred[b].cpu(), pr)
                and int(dbatch.n_levels[b]) == nl
                and dbatch.edges_scanned[b] == es
                and torch.equal(dbatch.directions[b].cpu(), dr)):
            raise AssertionError(f"direction batched search {b} differs "
                                 f"from scalar")
    del dbatch
    dhm = harmonic_mean(dteps)
    d_searches = len(roots) + n_dbatch
    log(f"[7 dir-run] {len(roots)} roots validated (Graph500 rules), first "
        f"{n_equal} equal to the top-down path; "
        f"{n_bu_levels} bottom-up levels; batched bfs({n_dbatch} roots) "
        f"equal to scalar, {dbatch_s:.2f} s")
    log(f"[7 dir-run] harmonic-mean TEPS {dhm:.6e}; mean search "
        f"{sum(dtimes) / len(dtimes):.4f} s; peak memory "
        f"{dpeak / 2**30:.2f} GiB; launches over {d_searches} searches "
        f"{dlaunches}")
    for name, cnt in dlaunches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the direction "
                                 f"path")
    report["dir_run"] = {"csr_s": csr_s, "csr_peak_bytes": csr_peak,
                         "roots": roots, "search_s": dtimes, "teps": dteps,
                         "harmonic_teps": dhm, "batch_s": dbatch_s,
                         "peak_bytes": dpeak, "launches": dlaunches,
                         "searches": d_searches,
                         "bottomup_levels": n_bu_levels}

    # -- 7b. B3, B4, B7 on real direction-path calls -------------------------
    (mask,), _ = pack_tap.saved
    kern = KF.pack_bits(mask)
    err = check_equal(torch, "pack_bits on the real fold", (kern,),
                      (KF.plain_pack_bits(mask),))
    N, S = mask.shape
    W = kern.shape[1]
    p_bytes = N * S + 4 * N * W
    p_ms = cuda_ms(torch, lambda: KF.pack_bits(mask))
    p_plain = cuda_ms(torch, lambda: KF.plain_pack_bits(mask), reps=3)
    kernels.append(kernel_row(
        "pack_bits", "src/repro_torch/csrc/bits.cu",
        "src/repro/kernels/fold.py:144", dlaunches["pack_bits"], err, p_ms,
        p_plain, p_bytes))
    log(f"[7b parity] pack_bits real fold N={N} S={S} set "
        f"{int(mask.sum())}: max_abs_err {err}; kernel {p_ms:.4f} ms, plain "
        f"{p_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms")

    (uwords, uS), _ = unpack_tap.saved
    kern = KF.unpack_bits(uwords, uS)
    err = check_equal(torch, "unpack_bits on the real fold", (kern,),
                      (KF.plain_unpack_bits(uwords, uS),))
    N, W = uwords.shape
    u_bytes = 4 * N * W + N * uS
    u_ms = cuda_ms(torch, lambda: KF.unpack_bits(uwords, uS))
    u_plain = cuda_ms(torch, lambda: KF.plain_unpack_bits(uwords, uS),
                      reps=3)
    kernels.append(kernel_row(
        "unpack_bits", "src/repro_torch/csrc/bits.cu",
        "src/repro/kernels/fold.py:170", dlaunches["unpack_bits"], err, u_ms,
        u_plain, u_bytes))
    log(f"[7b parity] unpack_bits real fold N={N} S={uS} set "
        f"{int(kern.sum())}: max_abs_err {err}; kernel {u_ms:.4f} ms, plain "
        f"{u_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms")

    (start, E, *bargs), bkw = bu_tap.saved
    kern = KB.bottomup_chunk(start, E, *bargs, **bkw)
    err = check_equal(torch, "bottomup_chunk on the real chunk", kern,
                      KB.plain_bottomup_chunk(start, E, *bargs, **bkw))
    bcumul, btotal, _, _, bwords = bargs
    r_out, c_out, _ = kern
    live_mask = start + torch.arange(E, device=dev) < btotal
    live = int(live_mask.sum())
    block = bkw["block"]
    # the rows that own a live lane: visited rows between them are zero-width
    # runs of cumul that the search never has to read
    rows = int(torch.unique(r_out[live_mask]).numel())
    c_live = c_out[live_mask].long()
    wid = (c_live // block) * ((block + 31) // 32) + (c_live % block) // 32
    n_words = int(torch.unique(wid).numel())
    # col_idx per live lane + distinct frontier words + each owning row's
    # row_off[r], cumul[r], cumul[r + 1] in; r / c / hit out
    b_bytes = 4 * live + 4 * n_words + 12 * rows + 9 * E
    b_ms = cuda_ms(torch, lambda: KB.bottomup_chunk(start, E, *bargs, **bkw))
    b_plain = cuda_ms(
        torch, lambda: KB.plain_bottomup_chunk(start, E, *bargs, **bkw),
        reps=3)
    kernels.append(kernel_row(
        "bottomup_chunk", "src/repro_torch/csrc/bottomup.cu",
        "src/repro/kernels/bottomup.py:96", dlaunches["bottomup_chunk"], err,
        b_ms, b_plain, b_bytes))
    log(f"[7b parity] bottomup_chunk real chunk start={start} E={E} "
        f"live={live} rows {rows} frontier words {n_words} hits "
        f"{int(kern[2].sum())}: max_abs_err {err}; kernel {b_ms:.4f} ms, "
        f"plain {b_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms "
        f"({b_bytes} B)")
    del pack_tap, unpack_tap, bu_tap, mask, uwords, bargs, kern, r_out, \
        c_out, bcumul, btotal, bwords

    # -- 8. direction-path parity: reference path, bottom-up pinned ----------
    ref_sess = graph.session(BFSConfig(
        grid=(R, C), edge_chunk=args.edge_chunk, direction=True,
        fold_codec="bitmap", expand="reference", fold="reference",
        bottomup="reference"))
    reng = ref_sess.engine
    assert reng.expand_fn is None and reng.fold_ops is None \
        and reng.bottomup_fn is None and reng.codec.ops is None
    t0 = time.perf_counter()
    ref = ref_sess.bfs(roots[0])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    lv, pr, nl, es, dr = dscalar[0]
    same = (torch.equal(ref.level.cpu(), lv)
            and torch.equal(ref.pred.cpu(), pr)
            and int(ref.n_levels) == nl and ref.edges_scanned == es
            and torch.equal(ref.directions.cpu(), dr))
    log(f"[8 dir-path] expand, fold, bottomup = 'reference' root "
        f"{roots[0]}: {ref_s:.2f} s, equal to the kernel path: {same}")
    if not same:
        raise AssertionError("the direction path's plain version differs "
                             "from its kernel path")
    del ref, ref_sess
    bu_sess = graph.session(BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                                      direction="bottomup",
                                      fold_codec="bitmap"))
    t0 = time.perf_counter()
    bu = bu_sess.bfs(roots[0])
    torch.cuda.synchronize()
    bu_s = time.perf_counter() - t0
    lv, pr, nl, _ = scalar[0]
    dirs = bu.directions.cpu()
    bu_same = (torch.equal(bu.level.cpu(), lv)
               and torch.equal(bu.pred.cpu(), pr) and int(bu.n_levels) == nl
               and bool((dirs[dirs >= 0] == 1).all()))
    log(f"[8 dir-path] direction='bottomup' root {roots[0]}: {bu_s:.2f} s, "
        f"{bu.edges_scanned} edges scanned, levels and preds equal to "
        f"top-down: {bu_same}")
    if not bu_same:
        raise AssertionError("direction='bottomup' differs from top-down")
    report["dir_path_parity"] = {"root": roots[0], "reference_s": ref_s,
                                 "bottomup_s": bu_s,
                                 "bottomup_edges": bu.edges_scanned}
    del bu, bu_sess
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_script

    # -- 6. report ------------------------------------------------------------
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"[6 report] whole script {report['script_s']:.1f} s")
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
