#!/usr/bin/env python3
"""Drive the PyTorch port's two session paths once on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--scale 26] [--roots 64] [--td-roots 16]
                          [--batch 8] [--dir-batch 4] [--sssp-roots 4]
                          [--delta-scale 22] [--seed 1]

Phases, one line or more each on stdout:
  1. device    the card's name and power limit (nvidia-smi) and torch's view;
  2. build     nvcc builds every CUDA kernel from src/repro_torch/csrc for
               sm_90a, all sources in parallel (-Xptxas -v register /
               shared-memory summary);
  3. parity    each kernel against its plain torch version on the card, bit
               for bit, on random inputs (pack/unpack_bits with S % 32 != 0
               and all-false / all-true masks; bottomup_chunk and
               bottomup_chunk_values with block % 32 != 0, an empty and a
               full frontier, total = 0 and a chunk straddling the live
               total; expand_chunk_values with an empty frontier, total = 0
               and a straddling chunk; delta_gaps / delta_positions with
               all-invalid rows, full rows of S = 65536 and S % 32 != 0);
  4. run       the top-down path at the Graph500 "toy" problem class by
               default: R-MAT SCALE 26, edgefactor 16, generated on the card
               from --seed with uint8 weights drawn from 1..255, planned
               with `DistGraph.from_edges(..., weights=)` on a 2x2 grid
               stacked on the card (edge_chunk 2^22), --td-roots roots each
               timed alone and validated by the Graph500 rules on the card
               (keeping each root's reached count and smallest reached id,
               and the per-vertex minimum level over the roots with the
               first root reaching it), then one batched
               `bfs(roots[:batch])` held equal to those roots' scalar
               results; harmonic-mean TEPS, peak memory, launch counts (B1
               and B2 must be > 0);
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
  9. values    the value programs on the top-down path, same graph:
               `connected_components()` (bitmap codec) timed, passing
               `validate_cc`, each phase-4 root's label its smallest reached
               id and that label's count its reached count, equal under the
               list codec; `sssp(root)` for --sssp-roots phase-4 roots, each
               timed, passing `validate_sssp`, reaching BFS's set, and
               `sssp(roots[:2])` batched equal to them; `multi_bfs(phase-4
               roots)` equal to phase 4's per-vertex minimum, with k=2 the
               same masked to level <= 2; B8 launched (> 0);
  9b. parity   B8 on one real chunk of CC's first level: time, plain time,
               bytes bound;
  10. dir-val  the same programs direction-optimised (`direction=True`,
               bitmap codec): CC, 2 SSSP roots and the multi-BFS, each equal
               to phase 9 and running a bottom-up level; one SSSP root and
               CC again with expand, fold and bottomup = "reference", equal
               to the kernel path; B9 launched (> 0), then on one real call:
               time, plain time, bound;
  11. delta    after the SCALE 26 graph is freed, the delta codec at its
               limit: R-MAT SCALE --delta-scale on an 8x8 grid, so S =
               65536 (weights as above): `bfs` top-down and direction-
               optimised with fold_codec="delta" from 4 roots, equal to
               "list" (levels, preds, n_levels, edges_scanned) and
               validated; CC, one SSSP root and the multi-BFS under delta
               equal to list; B5 and B6 launched (> 0), then on one real
               call each: time, plain time, bound, and for B6 the time of
               torch.cumsum on the same gaps;
  6. report    the {"kernels": [...]} line, the nvidia-smi line, and last
               {"ok": true, "device": {...}}.

Every phase prints its seconds.

Any failure exits non-zero before the last line.  Without a CUDA device, or
run outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, published peak
TD_EQUAL_ROOTS = 8               # direction roots held to the top-down path
I32_MAX = 2**31 - 1


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
               bytes_, library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms}


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.seconds = {}
        self.t0 = time.perf_counter()

    def end(self, name: str) -> None:
        t = time.perf_counter()
        self.seconds[name] = t - self.t0
        log(f"[{name}] phase done in {t - self.t0:.1f} s")
        self.t0 = t


def timed(torch, fn):
    """(result, seconds) of fn() on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same(torch, a, b) -> bool:
    """Two outputs' tensors (moved to the CPU) and ints are equal."""
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def parity_random_values(torch, dev, gen, F, K, KB, KF) -> None:
    """Phase 3 for B5, B6, B8 and B9: random inputs, bit for bit."""
    ncl, n_rows = 1 << 20, 1 << 21
    deg = torch.randint(0, 9, (ncl,), generator=gen, device=dev,
                        dtype=torch.int32)
    col_off = F.exclusive_cumsum(deg)
    row_idx = torch.randint(0, n_rows, (int(col_off[-1]),), generator=gen,
                            device=dev, dtype=torch.int32)
    pay = torch.randint(0, I32_MAX, (ncl,), generator=gen, device=dev,
                        dtype=torch.int32)
    front = torch.randperm(ncl, generator=gen, device=dev).to(torch.int32)
    for ft in (0, 700_000):
        ftot = torch.tensor(ft, dtype=torch.int32, device=dev)
        fr = torch.where(torch.arange(ncl, device=dev) < ft, front, -1) \
            .to(torch.int32)
        cumul, total = F.scan_plan(col_off, fr, ftot)
        t = int(total)
        args = (cumul, fr, pay, ftot, col_off, row_idx)
        for start, E in ((0, 1 << 22), (max(t - 5000, 0), 1 << 20),
                         (12345, 3000)):
            err = check_equal(torch, "expand_chunk_values",
                              K.expand_chunk_values(start, E, *args),
                              K.plain_expand_chunk_values(start, E, *args))
            log(f"[3 parity] expand_chunk_values random frontier {ft} total "
                f"{t} start={start} E={E}: max_abs_err {err}")
    R, block = 2, (1 << 20) + 5                 # block % 32 != 0
    nrl = 2 * block
    deg = torch.randint(0, 17, (nrl,), generator=gen, device=dev,
                        dtype=torch.int32)
    row_off = F.exclusive_cumsum(deg)
    col_idx = torch.randint(0, R * block, (int(row_off[-1]) + 11,),
                            generator=gen, device=dev, dtype=torch.int32)
    dense_pay = torch.randint(0, I32_MAX, (R * block,), generator=gen,
                              device=dev, dtype=torch.int32)
    visited = torch.rand(nrl, generator=gen, device=dev) < 0.4
    for frac in (0.0, 0.5, 1.0):
        fmask = torch.rand((R, block), generator=gen, device=dev) < frac
        words = KF.plain_pack_bits(fmask).reshape(-1)
        for zero_total in (False, True):
            cumul = F.exclusive_cumsum(torch.where(visited | zero_total, 0,
                                                   deg))
            total = cumul[nrl].clone()
            t = int(total)
            args = (cumul, total, row_off, col_idx, words, dense_pay)
            for start, E in ((0, 1 << 22), (max(t - 5000, 0), 1 << 20)):
                err = check_equal(
                    torch, "bottomup_chunk_values",
                    KB.bottomup_chunk_values(start, E, *args, block=block),
                    KB.plain_bottomup_chunk_values(start, E, *args,
                                                   block=block))
                log(f"[3 parity] bottomup_chunk_values random frontier "
                    f"{frac} total {t} start={start} E={E}: max_abs_err "
                    f"{err}")
    for N, S, p in ((512, 1 << 16, 0.3), (8, 1 << 16, 1.0), (5, 33, 0.5),
                    (3, 1000, 0.0)):
        mask = torch.rand((N, S), generator=gen, device=dev) < p
        slot = torch.arange(S, dtype=torch.int32, device=dev)
        ts = torch.sort(torch.where(mask, slot, I32_MAX), dim=1).values
        valid = slot < mask.sum(dim=1, keepdim=True)
        gaps = KF.delta_gaps(ts, valid)
        err = check_equal(torch, "delta_gaps", (gaps,),
                          (KF.plain_delta_gaps(ts, valid),))
        err += check_equal(torch, "delta_positions",
                           (KF.delta_positions(gaps),),
                           (KF.plain_delta_positions(gaps),))
        log(f"[3 parity] delta_gaps + delta_positions random N={N} S={S} "
            f"p={p}: max_abs_err {err}")
    torch.cuda.synchronize()


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


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import bottomup as KB
    from repro_torch.kernels import expand as K
    from repro_torch.kernels import fold as KF
    return {f.__name__: f for f in (
        K.expand_chunk, K.expand_chunk_values, KF.compact_rows, KF.pack_bits,
        KF.unpack_bits, KF.delta_gaps, KF.delta_positions,
        KB.bottomup_chunk, KB.bottomup_chunk_values)}


def zero_counts() -> None:
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in counters().items()}


def require_launched(counts: dict, names, where: str) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on {where}")


def run_values(torch, args, graph, edges, weights, td_roots, scalar,
               reached, mb_ref, kernels, report, phases):
    """Phases 9 and 9b: CC, SSSP and multi-source BFS on the top-down path
    of the resident graph.  Returns the results phase 10 is held to."""
    from repro_torch.algos.cc import ConnectedComponentsProgram
    from repro_torch.api import BFSConfig
    from repro_torch.core.validate import validate_cc, validate_sssp
    from repro_torch.kernels import expand as K

    dev = edges.device
    grid = graph.grid
    n = graph.n
    sess = graph.session(BFSConfig(grid=(grid.R, grid.C),
                                   edge_chunk=args.edge_chunk))
    eng = sess._algo_engine(ConnectedComponentsProgram(), None, grid.n + 1)
    assert eng.value_expand_fn is K.expand_chunk_values
    # 9b: keep one chunk of CC's first level (full frontier, start > 0)
    tap = Tap(K.expand_chunk_values, lambda k, a: a[0] > 0)
    eng.value_expand_fn = tap
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    cc, cc_s = timed(torch, sess.connected_components)
    eng.value_expand_fn = K.expand_chunk_values
    cc_launches = read_counts()
    labels = cc.labels[:n]
    t0 = time.perf_counter()
    validate_cc(edges, labels)
    for r, count, smallest in reached:
        lab = int(labels[r])
        size = int((labels == lab).sum())
        if lab != smallest or size != count:
            raise AssertionError(
                f"CC: root {r} has label {lab} over {size} vertices; BFS "
                f"reached {count} vertices, smallest id {smallest}")
    val_s = time.perf_counter() - t0
    n_comp = int((labels == torch.arange(n, device=dev)).sum())
    log(f"[9 values] connected_components (bitmap): {int(cc.n_iters)} "
        f"iterations, {cc.edges_scanned} edges scanned, {n_comp} components,"
        f" {cc_s:.3f} s; validated ({len(reached)} BFS components agree) in "
        f"{val_s:.1f} s; launches {cc_launches}")
    cc_list, cc_list_s = timed(
        torch, lambda: sess.connected_components(fold_codec="list"))
    if not same(torch, (cc_list.labels, int(cc_list.n_iters),
                        cc_list.edges_scanned),
                (cc.labels, int(cc.n_iters), cc.edges_scanned)):
        raise AssertionError("CC under the list codec differs from bitmap")
    log(f"[9 values] connected_components (list): equal to bitmap, "
        f"{cc_list_s:.3f} s")
    del cc_list

    sssp_roots = td_roots[:args.sssp_roots]
    sssp_s, sssp_out = [], []
    for k, r in enumerate(sssp_roots):
        before = read_counts()["expand_chunk_values"]
        out, dt = timed(torch, lambda: sess.sssp(r))
        b8 = read_counts()["expand_chunk_values"] - before
        dist = out.dist[:n]
        t0 = time.perf_counter()
        validate_sssp(edges, weights, dist, r)
        if not torch.equal((dist >= 0).cpu(), scalar[k][0][:n] >= 0):
            raise AssertionError(f"SSSP root {r} reaches another set than "
                                 f"BFS")
        val_s = time.perf_counter() - t0
        sssp_s.append(dt)
        sssp_out.append((out.dist.cpu(), int(out.n_iters),
                         out.edges_scanned))
        log(f"[9 values] sssp root {r}: {int(out.n_iters)} iterations, "
            f"{out.edges_scanned} edges scanned, max distance "
            f"{int(dist.max())}, {dt:.3f} s; validated in {val_s:.1f} s; "
            f"expand_chunk_values launches {b8}")
    del out, dist
    n_batch = min(2, len(sssp_out))
    batch, batch_s = timed(torch, lambda: sess.sssp(sssp_roots[:n_batch]))
    for b in range(n_batch):
        if not same(torch, (batch.dist[b], int(batch.n_iters[b]),
                            batch.edges_scanned[b]), sssp_out[b]):
            raise AssertionError(f"batched sssp {b} differs from scalar")
    log(f"[9 values] batched sssp({n_batch} roots) equal to scalar, "
        f"{batch_s:.3f} s")
    del batch

    mb, mb_s = timed(torch, lambda: sess.multi_bfs(td_roots))
    if not (torch.equal(mb.level[:n], mb_ref[0])
            and torch.equal(mb.src[:n], mb_ref[1])):
        raise AssertionError("multi_bfs differs from the per-root BFS "
                             "minimum of phase 4")
    hop, hop_s = timed(torch, lambda: sess.multi_bfs(td_roots, k=2))
    near = mb.level <= 2
    if not (torch.equal(hop.level, torch.where(near, mb.level, -1))
            and torch.equal(hop.src, torch.where(near, mb.src, -1))):
        raise AssertionError("multi_bfs(k=2) differs from the full sweep "
                             "masked to level <= 2")
    log(f"[9 values] multi_bfs({len(td_roots)} sources): "
        f"{int(mb.n_levels)} waves, {mb.edges_scanned} edges scanned, "
        f"equal to phase 4's per-vertex minimum, {mb_s:.3f} s; k=2: "
        f"{int(hop.n_levels)} waves, {int((hop.level >= 0).sum())} "
        f"vertices, equal to the sweep masked to level <= 2, {hop_s:.3f} s")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[9 values] peak memory {peak / 2**30:.2f} GiB; launches over the "
        f"phase {launches}")
    require_launched(launches, ("expand_chunk_values", "compact_rows",
                                "pack_bits", "unpack_bits"),
                     "the value programs' top-down path")
    vals = {"cc": (cc.labels.cpu(), int(cc.n_iters), cc.edges_scanned),
            "sssp_roots": sssp_roots[:2], "sssp": sssp_out[:2],
            "mbfs": (mb.level.cpu(), mb.src.cpu(), int(mb.n_levels),
                     mb.edges_scanned), "sources": td_roots}
    report["values"] = {
        "cc_s": cc_s, "cc_iters": int(cc.n_iters),
        "cc_edges": cc.edges_scanned, "cc_launches": cc_launches,
        "components": n_comp, "cc_list_s": cc_list_s,
        "sssp_roots": sssp_roots, "sssp_s": sssp_s,
        "sssp_iters": [o[1] for o in sssp_out],
        "sssp_edges": [o[2] for o in sssp_out], "sssp_batch_s": batch_s,
        "mbfs_s": mb_s, "mbfs_levels": int(mb.n_levels),
        "mbfs_edges": mb.edges_scanned, "khop_s": hop_s,
        "peak_bytes": peak, "launches": launches}
    del cc, labels, mb, hop, near
    phases.end("9 values")

    # -- 9b. B8 on the real chunk ------------------------------------------
    (start, E, *vargs), _ = tap.saved
    kern = K.expand_chunk_values(start, E, *vargs)
    err = check_equal(torch, "expand_chunk_values on the real chunk", kern,
                      K.plain_expand_chunk_values(start, E, *vargs))
    cumul, front, payload, ftot, col_off, row_idx = vargs
    live = int(kern[3].sum())
    lane = torch.tensor([start, start + max(live, 1) - 1], device=dev,
                        dtype=torch.int32)
    k_lo, k_hi = (torch.searchsorted(cumul[:int(ftot) + 1], lane,
                                     right=True) - 1).tolist()
    # row_idx per live lane + each spanned frontier slot's cumul, front,
    # payload and col_off entries in; v / pay / addr / valid out
    v_bytes = 4 * live + 16 * (k_hi - k_lo + 1) + 13 * E
    v_ms = cuda_ms(torch, lambda: K.expand_chunk_values(start, E, *vargs))
    v_plain = cuda_ms(
        torch, lambda: K.plain_expand_chunk_values(start, E, *vargs), reps=3)
    kernels.append(kernel_row(
        "expand_chunk_values", "src/repro_torch/csrc/expand.cu",
        "src/repro/kernels/expand.py:176",
        launches["expand_chunk_values"], err, v_ms, v_plain, v_bytes))
    log(f"[9b parity] expand_chunk_values real chunk (CC level 1) "
        f"start={start} E={E} live={live} frontier slots "
        f"{k_hi - k_lo + 1}: max_abs_err {err}; kernel {v_ms:.4f} ms, plain "
        f"{v_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms "
        f"({v_bytes} B)")
    del tap, vargs, kern
    phases.end("9b parity")
    return vals


def run_values_direction(torch, args, graph, vals, kernels, report, phases):
    """Phase 10: the value programs direction-optimised (bitmap codec) on
    the same graph, held to phase 9; the plain path; B9 on a real call."""
    from repro_torch.algos.cc import ConnectedComponentsProgram
    from repro_torch.api import BFSConfig
    from repro_torch.kernels import bottomup as KB

    dev = graph.device
    grid = graph.grid
    n = graph.n
    knobs = dict(grid=(grid.R, grid.C), edge_chunk=args.edge_chunk,
                 direction=True, fold_codec="bitmap")
    dsess = graph.session(BFSConfig(**knobs))
    eng = dsess._algo_engine(ConnectedComponentsProgram(), None, grid.n + 1)
    assert eng.value_bottomup_fn is KB.bottomup_chunk_values
    tap = Tap(KB.bottomup_chunk_values, lambda k, a: a[0] > 0)
    eng.value_bottomup_fn = tap
    torch.cuda.reset_peak_memory_stats()
    zero_counts()

    def bottomup_levels(out):
        d = out.directions.cpu()
        return "".join("TB"[x] for x in d[d >= 0].tolist())

    cc, cc_s = timed(torch, dsess.connected_components)
    eng.value_bottomup_fn = KB.bottomup_chunk_values
    trace = {"cc": bottomup_levels(cc)}
    if not same(torch, (cc.labels, int(cc.n_iters)), vals["cc"][:2]):
        raise AssertionError("direction-optimised CC differs from top-down")
    log(f"[10 dir-val] connected_components: equal to phase 9, directions "
        f"{trace['cc']}, {cc.edges_scanned} edges scanned, {cc_s:.3f} s")
    sssp_s, sssp_out = [], []
    for r, (dist, iters, _) in zip(vals["sssp_roots"], vals["sssp"]):
        out, dt = timed(torch, lambda: dsess.sssp(r))
        if not same(torch, (out.dist, int(out.n_iters)), (dist, iters)):
            raise AssertionError(f"direction-optimised sssp root {r} "
                                 f"differs from top-down")
        trace[f"sssp {r}"] = bottomup_levels(out)
        sssp_s.append(dt)
        sssp_out.append(out)
        log(f"[10 dir-val] sssp root {r}: equal to phase 9, directions "
            f"{trace[f'sssp {r}']}, {out.edges_scanned} edges scanned, "
            f"{dt:.3f} s")
    level, src, waves, _ = vals["mbfs"]
    mb, mb_s = timed(torch, lambda: dsess.multi_bfs(vals["sources"]))
    if not same(torch, (mb.level, mb.src, int(mb.n_levels)),
                (level, src, waves)):
        raise AssertionError("direction-optimised multi_bfs differs from "
                             "top-down")
    trace["multi_bfs"] = bottomup_levels(mb)
    log(f"[10 dir-val] multi_bfs: equal to phase 9, directions "
        f"{trace['multi_bfs']}, {mb.edges_scanned} edges scanned, "
        f"{mb_s:.3f} s")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[10 dir-val] peak memory {peak / 2**30:.2f} GiB; launches over "
        f"the phase {launches}")
    for what, dirs in trace.items():
        if "B" not in dirs:
            raise AssertionError(f"direction-optimised {what} ran no "
                                 f"bottom-up level")
    require_launched(launches, ("bottomup_chunk_values",
                                "expand_chunk_values", "compact_rows",
                                "pack_bits", "unpack_bits"),
                     "the value programs' direction-optimised path")

    # the plain path on the card: one SSSP root and CC
    rsess = graph.session(BFSConfig(**knobs, expand="reference",
                                    fold="reference", bottomup="reference"))
    r0 = vals["sssp_roots"][0]
    ref, ref_s = timed(torch, lambda: rsess.sssp(r0))
    o = sssp_out[0]
    if not same(torch, (ref.dist, int(ref.n_iters), ref.edges_scanned,
                        ref.directions),
                (o.dist, int(o.n_iters), o.edges_scanned, o.directions)):
        raise AssertionError("the plain direction-optimised sssp differs "
                             "from the kernel path")
    rcc, rcc_s = timed(torch, rsess.connected_components)
    if not same(torch, (rcc.labels, int(rcc.n_iters), rcc.edges_scanned,
                        rcc.directions),
                (cc.labels, int(cc.n_iters), cc.edges_scanned,
                 cc.directions)):
        raise AssertionError("the plain direction-optimised CC differs from "
                             "the kernel path")
    log(f"[10 dir-val] expand, fold, bottomup = 'reference': sssp root {r0} "
        f"{ref_s:.3f} s and CC {rcc_s:.3f} s, equal to the kernel path")
    report["dir_values"] = {"cc_s": cc_s, "cc_edges": cc.edges_scanned,
                            "sssp_s": sssp_s, "mbfs_s": mb_s,
                            "directions": trace, "launches": launches,
                            "peak_bytes": peak, "reference_sssp_s": ref_s,
                            "reference_cc_s": rcc_s}
    del cc, mb, sssp_out, o, ref, rcc, rsess
    phases.end("10 dir-val")

    (start, E, *bargs), bkw = tap.saved
    kern = KB.bottomup_chunk_values(start, E, *bargs, **bkw)
    err = check_equal(torch, "bottomup_chunk_values on the real chunk", kern,
                      KB.plain_bottomup_chunk_values(start, E, *bargs,
                                                     **bkw))
    _, btotal, row_off, col_idx, _, _ = bargs
    live_mask = start + torch.arange(E, device=dev) < btotal
    live = int(live_mask.sum())
    block = bkw["block"]
    rows = int(torch.unique(kern[0][live_mask]).numel())
    c = col_idx[kern[2][live_mask].long()].long()
    wid = (c // block) * ((block + 31) // 32) + (c % block) // 32
    n_words = int(torch.unique(wid).numel())
    n_cols = int(torch.unique(c).numel())
    # col_idx per live lane + distinct frontier words + distinct dense_pay
    # entries + each owning row's row_off[r], cumul[r], cumul[r + 1] in;
    # r / pay / addr / hit out
    b_bytes = 4 * live + 4 * n_words + 4 * n_cols + 12 * rows + 13 * E
    b_ms = cuda_ms(torch, lambda: KB.bottomup_chunk_values(start, E, *bargs,
                                                           **bkw))
    b_plain = cuda_ms(torch, lambda: KB.plain_bottomup_chunk_values(
        start, E, *bargs, **bkw), reps=3)
    kernels.append(kernel_row(
        "bottomup_chunk_values", "src/repro_torch/csrc/bottomup.cu",
        "src/repro/kernels/bottomup.py:162",
        launches["bottomup_chunk_values"], err, b_ms, b_plain, b_bytes))
    log(f"[10b parity] bottomup_chunk_values real chunk (CC) start={start} "
        f"E={E} live={live} rows {rows} frontier words {n_words} cols "
        f"{n_cols} hits {int(kern[3].sum())}: max_abs_err {err}; kernel "
        f"{b_ms:.4f} ms, plain {b_plain:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms ({b_bytes} B)")
    del tap, bargs, kern
    phases.end("10b parity")


def run_delta(torch, dev, args, kernels, report, phases):
    """Phase 11: the delta codec at its limit, S = 65536 on an 8x8 grid:
    BFS both directions, CC, SSSP and multi-BFS equal to the list codec;
    B5 and B6 on real calls."""
    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.core.validate import validate_bfs, validate_sssp
    from repro_torch.graphgen import rmat_edges
    from repro_torch.kernels import fold as KF

    scale = args.delta_scale
    n = 1 << scale
    edges = rmat_edges(scale, args.edge_factor,
                       torch.Generator(device=dev).manual_seed(args.seed),
                       dev)
    weights = torch.randint(1, 256, (edges.shape[1],), dtype=torch.uint8,
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(args.seed + 1))
    knobs = dict(grid=(8, 8), edge_chunk=args.delta_edge_chunk)
    graph, plan_s = timed(torch, lambda: DistGraph.from_edges(
        edges, BFSConfig(**knobs), n=n, weights=weights))
    S = graph.grid.S
    index = graph.edge_index()
    deg = torch.bincount(edges[0].long(), minlength=n)
    cand = torch.nonzero(deg > 0).flatten()
    roots = cand[torch.randperm(cand.numel(), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(args.seed))[:4]].tolist()
    del deg, cand
    log(f"[11 delta] R-MAT SCALE {scale} on 8x8: S = {S}, "
        f"{edges.shape[1]} directed edges, planned in {plan_s:.1f} s; "
        f"roots {roots}")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    gaps_tap = Tap(KF.delta_gaps, lambda k, a: k == 2)
    pos_tap = Tap(KF.delta_positions, lambda k, a: k == 2)

    class TappedDelta:
        compact_rows = KF.compact_rows
        pack_bits = KF.pack_bits
        unpack_bits = KF.unpack_bits
        delta_gaps = gaps_tap
        delta_positions = pos_tap

    bfs_s = {}
    for direction in (False, True):
        dsess = graph.session(BFSConfig(**knobs, direction=direction,
                                        fold_codec="delta"))
        lsess = graph.session(BFSConfig(**knobs, direction=direction,
                                        fold_codec="list"))
        if not direction:
            dsess.engine.fold_ops = dsess.engine.codec.ops = TappedDelta
        for r in roots:
            d, d_s = timed(torch, lambda: dsess.bfs(r))
            lst, l_s = timed(torch, lambda: lsess.bfs(r))
            if not same(torch, (d.level, d.pred, int(d.n_levels),
                                d.edges_scanned),
                        (lst.level, lst.pred, int(lst.n_levels),
                         lst.edges_scanned)):
                raise AssertionError(f"delta bfs root {r} (direction "
                                     f"{direction}) differs from list")
            validate_bfs(edges, d.level[:n], d.pred[:n], r, index=index)
            bfs_s.setdefault(str(direction), []).append((d_s, l_s))
            log(f"[11 delta] bfs root {r} direction={direction}: "
                f"{int(d.n_levels)} levels, {d.edges_scanned} edges "
                f"scanned, equal to list and validated; delta {d_s:.3f} s, "
                f"list {l_s:.3f} s")
        dsess.engine.fold_ops = dsess.engine.codec.ops = KF
    sess = graph.session(BFSConfig(**knobs))
    for what, call in (
            ("connected_components", lambda c: sess.connected_components(
                fold_codec=c)),
            (f"sssp root {roots[0]}", lambda c: sess.sssp(roots[0],
                                                           fold_codec=c)),
            ("multi_bfs", lambda c: sess.multi_bfs(roots, fold_codec=c))):
        d, d_s = timed(torch, lambda: call("delta"))
        lst, l_s = timed(torch, lambda: call("list"))
        fields = [f.name for f in dataclasses.fields(d)
                  if getattr(d, f.name) is not None]
        if not same(torch, [getattr(d, f) for f in fields],
                    [getattr(lst, f) for f in fields]):
            raise AssertionError(f"{what} under delta differs from list")
        if what.startswith("sssp"):
            validate_sssp(edges, weights, d.dist[:n], roots[0])
        log(f"[11 delta] {what}: equal to list ({', '.join(fields)}); "
            f"delta {d_s:.3f} s, list {l_s:.3f} s")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[11 delta] peak memory {peak / 2**30:.2f} GiB; launches over the "
        f"phase {launches}")
    require_launched(launches, ("delta_gaps", "delta_positions"),
                     "the delta codec's path")
    report["delta"] = {"scale": scale, "S": S, "roots": roots,
                       "bfs_s": bfs_s, "launches": launches,
                       "peak_bytes": peak}

    (ts, valid), _ = gaps_tap.saved
    kern = KF.delta_gaps(ts, valid)
    err = check_equal(torch, "delta_gaps on the real fold", (kern,),
                      (KF.plain_delta_gaps(ts, valid),))
    N, S = ts.shape
    g_ms = cuda_ms(torch, lambda: KF.delta_gaps(ts, valid))
    g_plain = cuda_ms(torch, lambda: KF.plain_delta_gaps(ts, valid), reps=3)
    kernels.append(kernel_row(
        "delta_gaps", "src/repro_torch/csrc/delta.cu",
        "src/repro/kernels/fold.py:198", launches["delta_gaps"], err, g_ms,
        g_plain, 7 * N * S))
    log(f"[11 delta] delta_gaps real fold N={N} S={S} valid "
        f"{int(valid.sum())}: max_abs_err {err}; kernel {g_ms:.4f} ms, "
        f"plain {g_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.4f} ms")
    (gaps,), _ = pos_tap.saved
    kern = KF.delta_positions(gaps)
    err = check_equal(torch, "delta_positions on the real fold", (kern,),
                      (KF.plain_delta_positions(gaps),))
    N, S = gaps.shape
    wide = gaps.to(torch.int32) & 0xFFFF
    p_ms = cuda_ms(torch, lambda: KF.delta_positions(gaps))
    p_plain = cuda_ms(torch, lambda: KF.plain_delta_positions(gaps), reps=3)
    p_lib = cuda_ms(torch, lambda: torch.cumsum(wide, dim=1,
                                                dtype=torch.int32))
    kernels.append(kernel_row(
        "delta_positions", "src/repro_torch/csrc/delta.cu",
        "src/repro/kernels/fold.py:218", launches["delta_positions"], err,
        p_ms, p_plain, 6 * N * S, library_ms=p_lib))
    log(f"[11 delta] delta_positions real fold N={N} S={S}: max_abs_err "
        f"{err}; kernel {p_ms:.4f} ms, plain {p_plain:.4f} ms, "
        f"torch.cumsum of the widened gaps {p_lib:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms")
    del graph, edges, weights, index, gaps_tap, pos_tap
    torch.cuda.empty_cache()
    phases.end("11 delta")


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
    ap.add_argument("--sssp-roots", type=int, default=4,
                    help="phase-4 roots each run through sssp (phase 9)")
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--edge-chunk", type=int, default=1 << 22)
    ap.add_argument("--delta-scale", type=int, default=22,
                    help="R-MAT SCALE of the delta-codec phase (8x8 grid; "
                         "22 gives S = 65536, the codec's limit)")
    ap.add_argument("--delta-edge-chunk", type=int, default=1 << 20)
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

    from repro_torch.core.validate import validate_cc, validate_sssp

    report = {"args": vars(args)}
    dev = torch.device("cuda")
    phases = Phases()

    # -- 1. device ----------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] nvidia-smi: {smi}; torch: {kind}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    report["device"] = {"nvidia_smi": smi, "kind": kind}
    phases.end("1 device")

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
    phases.end("2 build")

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
    parity_random_values(torch, dev, gen, F, K, KB, KF)
    phases.end("3 parity")

    # -- 4. the full-size top-down run ---------------------------------------
    R, C = (int(x) for x in args.grid.lower().split("x"))
    t0 = time.perf_counter()
    edges = rmat_edges(args.scale, args.edge_factor,
                       torch.Generator(device=dev).manual_seed(args.seed),
                       dev)
    weights = torch.randint(1, 256, (edges.shape[1],), dtype=torch.uint8,
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(args.seed + 1))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n = 1 << args.scale
    log(f"[4 run] rmat_edges SCALE {args.scale} edgefactor "
        f"{args.edge_factor}: {edges.shape[1]} directed edges and uint8 "
        f"weights in 1..255 in {gen_s:.1f} s")
    config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk)
    t0 = time.perf_counter()
    graph = DistGraph.from_edges(edges, config, n=n, weights=weights)
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
    keep = max(args.batch, TD_EQUAL_ROOTS, args.sssp_roots)
    reached = []             # per root: (root, reached count, smallest id)
    best_level = torch.full((n,), I32_MAX, dtype=torch.int32, device=dev)
    best_src = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for k, r in enumerate(td_roots):
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
        # for phase 9: CC's component of r, multi-BFS's nearest source
        hit = level >= 0
        reached.append((r, int(hit.sum()), int(torch.nonzero(hit)[0])))
        closer = hit & (level < best_level)
        best_level = torch.where(closer, level, best_level)
        best_src = torch.where(closer, k, best_src)
        del hit, closer
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
    phases.end("4 run")

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
    phases.end("3b parity")

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
    phases.end("5 path")

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
    phases.end("7 dir-run")

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
    phases.end("7b parity")

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
    phases.end("8 dir-path")

    mb_ref = (torch.where(best_level == I32_MAX, -1, best_level),
              torch.where(best_level == I32_MAX, -1, best_src))
    del best_level, best_src
    vals = run_values(torch, args, graph, edges, weights, td_roots, scalar,
                      reached, mb_ref, kernels, report, phases)
    del mb_ref
    run_values_direction(torch, args, graph, vals, kernels, report, phases)
    del graph, edges, weights, index, sess, dsess, eng, deng, vals
    torch.cuda.empty_cache()
    run_delta(torch, dev, args, kernels, report, phases)
    report["kernels"] = kernels
    report["phase_s"] = phases.seconds
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
