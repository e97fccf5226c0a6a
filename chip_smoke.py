#!/usr/bin/env python3
"""Drive the PyTorch port's two session paths, its kernel-stage surface,
its fault-tolerant level loop, its serving layer, its process-group
topology, its launcher, its graph build and single-device BFS, its
graph-learning and recsys models and its LMs once on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--scale 26] [--roots 12] [--td-roots 11]
                          [--batch 4] [--dir-batch 4] [--sssp-roots 2]
                          [--delta-scale 22] [--seed 1]

Phases, one line or more each on stdout:
  1. device    the card's name and power limit (nvidia-smi) and torch's view;
  2. build     nvcc builds every CUDA kernel from src/repro_torch/csrc for
               sm_90a, all sources in parallel (-Xptxas -v register /
               shared-memory summary);
  3. parity    each kernel against its plain torch version on the card, bit
               for bit, on random inputs (pack/unpack_bits with S % 32 != 0
               and all-false / all-true masks, and on the BITS_CASES of
               scripts/torch_stage_cases.py: S % 32 == 16, S % 16 != 0,
               one-word rows, the fold's density, views offset into their
               buffers, each printing its form, both forms of each launched;
               compact_rows on random rows and on the COMPACT_CASES of the
               same script: the exchange row, all-false / all-true rows,
               counts at a kernel tile's edge, S % 16 != 0, S = 1, 600
               short rows, densities 0.001 / 0.999, fills at INT32_MIN /
               INT32_MAX, the slot-offset channel at N = 8, both forms
               launched; expand_chunk and
               expand_chunk_values on the stage stress cases of
               scripts/torch_stage_cases.py: one vertex on every lane,
               vertices congruent modulo the hash table, all-visited /
               all-clear words, tiles 1, 3 and 384, a zero-degree run
               longer than a block, one slot spanning many blocks, chunks
               straddling and wholly past the live total, front_total =
               0, n_lanes % 256 != 0; bottomup_chunk and
               bottomup_chunk_values with block % 32 != 0, an empty and a
               full frontier, total = 0 and a chunk straddling the live
               total, and on the bottom-up stress cases of the same script
               (zero-width runs longer than a block, the flat tail past the
               live total, a row spanning many blocks, 99 % and 99.8 % of
               rows visited, ragged chunks), each with the row slots its
               kernel blocks span; expand_chunk_values with an empty frontier,
               total = 0 and a straddling chunk; delta_gaps /
               delta_positions with all-invalid rows, full rows of S =
               65536 and S % 32 != 0);
  13. card-cpu right after 3: one R-MAT graph (SCALE --card-cpu-scale, made
               with numpy) on the card and on the CPU, whose path the CPU
               tests hold to the JAX package: BFS under five direction x
               codec x dedup configurations, CC, SSSP and multi-BFS
               top-down and direction-optimised, every output field equal
               (scripts/torch_card_vs_cpu.py --quick);
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
               events) beside their plain versions' and their bytes bound
               (for B2 its form and share of the bound, beside a dense
               read of its source channel);
  12. stages   right after 3b, on the same real chunk and resident graph:
               (a) B10 binsearch_map and B11 visited_filter against their
               plain versions, bit for bit, on random inputs (zero-degree
               runs in cumul, front_total = 0, chunks straddling the live
               total, n_cumul < 256, lanes below cumul[0], tiles 64, 256,
               512 and 1024, n_rows % 32 != 0, all-visited and all-clear
               words, all-invalid lanes; B10 on the BINSEARCH_CASES of
               scripts/torch_stage_cases.py: consecutive gids, wide and
               narrow gaps, repeats, tiles sorted but descending across
               tiles, one tile spanning the whole cumul, lanes below
               cumul[0] and past the live total, zero-degree runs; the
               hash-claim stress cases of
               scripts/torch_stage_cases.py at tiles 64 to 1024: one
               vertex on every lane, vertices congruent modulo the table
               size, v = -1 / INT32_MIN / INT32_MAX); then, with the
               counts at 0, the
               surface through its entry points: (b) on the real 2^22-lane
               chunk, front[binsearch_map(clip_cumul(cumul), gids)] equals
               B1's u and visited_filter(v, valid, words, tile=512) equals
               B1's won on every lane; (c) `local_expand(path="kernel")`
               equals path="reference" on all five fields over block (0, 0),
               the frontier being phase 4's first root's local columns at
               its most populous level, both timed; (d) one root with
               `BFSConfig(expand_fn=make_expand_fn(path="kernel"))` equals
               phase 4 (levels, preds, n_levels, edges_scanned) and B1
               launches through the hook; (e) `scripts/torch_kernel_bench.
               py`'s rows, printed as one {"kernel_bench": [...]} line;
               B10 and B11 launched (> 0); then both on the real chunk:
               equal to their plain versions, time, plain time, bytes
               bound, and for B10 the time of torch.searchsorted, B10's
               three times with the L2 flushed before each call (the
               chunk's 33.6 MB would otherwise stay in the 50 MB L2);
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
               with time, plain time and bytes bound (for B3 and B4 the
               form that ran and the share of the bound); for B7 the row slots
               each kernel block spans (mean, max), the blocks that search
               by lane and the slots the rest walk; B2 on the bitmap
               decode's compaction (the slot-offset channel, N = 8) as in
               3b;
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
               bytes bound; B2 on the values row of CC's second level (ids
               and labels, N = 2) as in 3b.  B2 launches once for all the
               channels of a call (up to four), so a values row counts one
               launch;
  10. dir-val  the same programs direction-optimised (`direction=True`,
               bitmap codec): CC, 2 SSSP roots and the multi-BFS, each equal
               to phase 9 and running a bottom-up level; one SSSP root and
               CC again with expand, fold and bottomup = "reference", equal
               to the kernel path; B9 launched (> 0), then on one real call:
               time, plain time, bound, and the row slots its kernel blocks
               span as in 7b;
  11. delta    after the SCALE 26 graph is freed, the delta codec at its
               limit: R-MAT SCALE --delta-scale on an 8x8 grid, so S =
               65536 (weights as above): `bfs` top-down and direction-
               optimised with fold_codec="delta" from 2 roots, equal to
               "list" (levels, preds, n_levels, edges_scanned) and
               validated; CC, one SSSP root and the multi-BFS under delta
               equal to list; B5 and B6 launched (> 0), then on one real
               call each: time, plain time, bound, and for B6 the time of
               torch.cumsum on the same gaps;
  14. exch-obs after 10, on the resident SCALE 26 graph: the butterfly
               exchange (`BFSConfig(exchange="butterfly")`, one stage at
               C = 2) with `telemetry=True`: top-down BFS from phase 4's
               first 2 roots equal to phase 4, direction-optimised (bitmap)
               from 2 roots equal to phase 7, CC and one SSSP root equal
               to phase 9; each `LevelTrace` against its output (scanned
               total, frontier per level from the levels, n_levels, the
               wire formula, log2(C) messages a processor a level,
               `dir` = `directions`); B1 and B2, and B3, B4 and B7 on the
               direction run, launched (> 0); one root's wall time under
               flat / butterfly with telemetry off / on, in turns (no limit
               asserted); the phase's seconds and peak memory;
  15. ft       after 14, mid-traversal fault tolerance on the resident
               SCALE 26 graph (`BFSConfig(fault_tolerance=True)`, every
               query with a `RecoveryPlan`): (a) the segmented level loop
               -- top-down BFS from phase 4's first 2 roots at ckpt_every=1
               equal to phase 4, direction-optimised (bitmap) from 2 roots
               equal to phase 7, CC and one SSSP root at ckpt_every=2 equal
               to phase 9, each search's wall time beside the same root's
               in phase 4 / 7 / 9 (what segmentation costs), B1 and B2, B3,
               B4 and B7 on the direction run, B8 on the value programs
               launched (> 0); (b) a transient loss crossing level 3
               absorbed by one retry, equal to phase 4; (c) a persistent
               loss crossing level 3 raising UnrecoverableLoss, its
               snapshot (bytes, export ms) resumed in a fresh session equal
               to phase 4, preds included; (d) one search through a
               `TraversalCheckpointer` in a temporary directory under
               build/ (seconds per checkpoint, bytes on disk), the latest
               checkpoint loaded and resumed, equal to phase 4; then, with
               the resident graph dropped, (e) `ElasticCoordinator` over
               the edge list on the card: top-down BFS and CC under a
               persistent loss crossing level 3 shrink 2x2 -> 1x3 and
               resume -- levels, n_levels, edges_scanned equal to phase 4
               and preds validated on the card, labels equal to phase 9 --
               with the memory in use when each grid is planned and the
               peak; every plan's retries equal to its injector's fires
               less the losses that escalated, and
               time_to_first_resumed_level_s printed;
  16. serve    after 15 (d), before 15 (e) drops the graph: the serving
               layer on the resident SCALE 26 graph -- a `GraphServer`
               (max_batch 4, window 10 ms) warmed for bfs / sssp / cc
               (every class's `compiled_for`, `cache_stats()`); a burst
               from four tenant threads, all admitted before the server
               starts: 11 top-down BFS roots of phase 4 (classes 4, 4, 4,
               3 live in the last), 4 direction-optimised (bitmap) roots of
               phase 7, 2 SSSP roots and the k=2 multi-BFS of phase 9, two
               CC callers sharing one run; every result ok and equal to
               phases 4, 7, 9 field for field; per program the p50 / p99
               of queued_s and exec_s, queries/s over the burst's wall
               time, occupancy, pad slots and their seconds, each top-down
               batch's exec_s against phase 4's times of its slots; B1-B4,
               B7 and B8 launched (> 0); then serve-drain: 2 roots in one
               fault-tolerant batch (ckpt_every=2, checkpoints under
               build/) lose a device at level 3 with max_retries=0 and
               drain through recovery: 0 lost, one resume, equal to phase
               4; `release_edges()` and the phase's peak.  Phase 7 prints
               the memory around `ensure_csr` (which drops the graph's
               edge list, weights and EdgeIndex), and after 15 (e) the
               memory freed when the script drops its own;
  14b. exch-8x8 after 11, on its 8x8 graph: exchange="auto" resolves to
               the butterfly (3 stages); BFS both ways, CC and multi-BFS
               under list and delta equal flat, their traces reading 3
               messages a processor a level (multi-BFS 0, as in JAX);
  17. group    after 14b, the SCALE 26 graph, its edge list and index and the
               card's cache dropped (the edge list, weights and the stacked
               outputs below written under build/phase17 after phase 16,
               removed at the end): the port across a real process group
               (`repro_torch.dist.multihost`, `GroupTopology`) on the one
               card.  The gloo leg: 4 ranks of this script on cuda:0
               (host-staged gloo, a file:// store), a 2x2 grid, one
               processor each, every rank planning only its block from the
               edge file it streams a piece at a time; under the flat and
               the butterfly exchange: top-down `bfs` of phase 4's first
               root and, under flat, `bfs(roots[:2])` (the second root
               alone in a flat warm-up), `connected_components()`,
               `sssp` of phase 9's first root and the direction-optimised
               (bitmap) `bfs` of phase 7's first root -- every output field
               on every rank equal to the stacked session's.  The NCCL leg:
               one rank holding the whole 2x2 grid, top-down `bfs` and CC
               through the same group code path, equal likewise, each
               query run once (twice until phase 20 came).  Then the
               search's
               contract across the group, each rank held to stacked
               references the parent computes on the resident graph before
               the ranks start (build/phase17): (a) a top-down `bfs` with
               telemetry=True, its LevelTrace equal to the stacked one;
               (b, gloo) `bfs(root, validate=True)` and `validate=edges`
               passing, then one output with a leaf cut off the tree
               failing the same rule with the same message on every rank;
               (c) fault_tolerance=True, ckpt_every=2: a top-down `bfs`
               (and, gloo, CC) with a transient loss at level 3 and a
               checkpoint directory (rank 0 writes it) -- outputs equal to
               the stacked session's, the directory reloaded by every
               rank, and the snapshot of a loss at level 3 equal to the
               stacked one array for array; (d, gloo) the elastic shrink
               2x2 -> 1x3 of phase 15 (e)'s top-down `bfs` (its loss at
               level 3): rank 3 leaves, ranks 0-2 re-plan from the edge
               file, every rank's output equal to phase 15 (e)'s.  The NCCL
               leg runs (a) and (c) for BFS.  Printed:
               each rank's wall time per query and its seconds inside
               row_gather / col_all_to_all / psum_all (and the outputs'
               fetch), timed by wrappers this script puts around the
               topology's methods; each rank's launches (B1 and B2 > 0 on
               every query that searches, B7 on the direction run), plan
               seconds and peak memory; the group's top-down TEPS
               (the slowest rank's time; four ranks sharing one card: a
               correctness run, not a scaling figure); per rank the
               seconds in `fetch` for the trace and the snapshots, the
               snapshot export ms, the checkpoint seconds, the re-plan
               seconds and time_to_first_resumed_level_s.  A rank that fails,
               differs or outlives the leg's deadline fails the phase;
  18. launch   after 17, the card's memory free again: (a) the launcher,
               `python3 -m repro_torch.launch.bfs_run --grid 2x2 --scale
               26 --ef 16 --roots 1 --validate 1` (--grid, --scale, --ef
               and --edge-chunk follow this script's) and the same with
               `--direction --fold bitmap`, each a child process (the
               launcher's `main`, then its launch counts and peak): exit
               0, the JAX driver's summary line with "(1 validated)" and
               TEPS > 0, B1 and B2 (and B3, B4 and B7) launched; its line,
               seconds and peak printed; (b) the four Table 3 analogs
               (`graphgen.realworld_analog`) at the paper's scales
               (scale_reduction=0; com-Friendster: SCALE 25, edgefactor
               27, 1,811,939,328 edges), each planned 2x2 and searched
               from 1 root, validated on the card, B1 and B2 launched;
               (c) on the com-Friendster analog, `graphgen.build_csc` on
               the card, then `core.bfs_single` from the same root:
               levels equal to the session's, preds validated, seconds a
               root against the session's, and the peak memory;
  19. models   after 18, in a child process on the freed card
               (`scripts/torch_models_card.py`, its lines printed as they
               come): (a) GraphSAGE-Reddit on minibatch_lg, 20 sampled
               steps of batch 1024 (fanout 15-10) on 114,615,892 edges,
               the first step held to the CPU path; (b) GraphSAGE on
               ogb_products (2,449,029 vertices, 61,859,140 edges, 2x2),
               5 full-graph steps on `make_spmm2d`, the SpMM held to an
               edge-list reference; (c) `make_spmm2d` on phase 4's SCALE
               26 graph (2x2, d 16, unweighted and with the uint8
               weights), held to a float64 edge-list reference; (d) NequIP,
               MACE and EGNN on 128 molecules: energies, forces, rotation
               invariance and covariance, card = CPU, each held per
               molecule in float64, then fp32 against float64, a
               training step;
               (e) DeepFM at the Criteo vocabularies: FM = pairwise sum,
               card = CPU, train_batch, serve_p99 (p50 / p99 of 200
               calls), serve_bulk and retrieval_cand.  Every check fails
               the phase; no kernel of csrc/ runs in it (JAX computes
               these models outside Pallas);
  20. lm       after 19, last, in a child process on the freed card
               (`scripts/torch_lm_card.py`): (a) h2o-danube-1.8b at full
               width, 64 greedy steps at decode_32k's batch 128 over the
               4096-slot ring buffer, 16 long_500k steps at batch 1 from
               position 524,272, then in fp32 at 2 layers 4160 tokens
               teacher-forced through `decode_step` (the buffer wraps),
               the last 64 next tokens = `forward`'s argmax, and forward
               card = CPU; (b) qwen2-moe-a2.7b at full width (64 experts,
               60 routed), 32 greedy steps at batch 8 over a 4096-token
               cache, then in fp32 at 2 layers logits, aux and routing
               card = CPU, no copy to experts 60-63; (c) gemma2-2b at full
               width, 3 training steps at seq 4096, batch 1, remat on,
               bf16 weights and fp32 moments, then in fp32 at 2 layers the
               first step card = CPU and remat on = off; (d) `smoke_lm` of
               the five configs on the card.  Every check fails the phase;
               no kernel of csrc/ runs in it (JAX computes the LM, the MoE
               layer and the train step outside Pallas);
  6. report    every phase's peak memory, the {"kernels": [...]} line,
               the nvidia-smi line, and last
               {"ok": true, "device": {...}}.

Every phase prints its seconds.  Kernel times are CUDA events around ten
calls queued behind a device sleep (`cuda_ms`), so they read the device's
work and not the wrappers' host work.

Any failure exits non-zero before the last line.  Without a CUDA device, or
run outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, published peak
TD_EQUAL_ROOTS = 8               # direction roots held to the top-down path
# phases 14 and 15 (a): roots a program runs on (4 until phase 20 came;
# cut to 2 for its time)
PHASE14_15_ROOTS = 2
I32_MAX = 2**31 - 1
BU_BLOCK_LANES = 1024            # stage::kLanes * kThreads, csrc/bottomup.cu
WALK_SLOTS_PER_LANE = 64         # stage::kWalkSlotsPerLane, csrc/stages.cuh


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms: CUDA events around `reps` calls,
    queued behind a `torch.cuda._sleep` that outlasts the host's queueing
    of them, so that the events read the device's work and not the
    wrapper's host work.  The sleep is sized from one untimed pass (twice
    its host time, plus 1 ms, at 2 GHz) and quadrupled while the device
    reached the first call before the host had queued the last (at most
    three tries: a fn that synchronises itself is read as it is)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sleep_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda._sleep(int(sleep_s * 2e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            break
        sleep_s *= 4
    return start.elapsed_time(end) / reps


def cuda_ms_cold(torch, fn, reps: int = 10,
                 flush_bytes: int = 128 << 20) -> float:
    """Mean device time of fn() in ms with the L2 cache flushed before each
    call: a `flush_bytes` buffer (past the H100's 50 MB L2) is written
    between the calls, and CUDA events around each call alone read its
    time; the calls are queued behind a device sleep as in `cuda_ms`."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        flush.fill_(i)
        fn()
    sleep_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(sleep_s * 2e9))
    for i, (start, end) in enumerate(marks):
        flush.fill_(i)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def compact_bytes(mask, arrays) -> tuple:
    """(bytes B2 must move on (mask, arrays), the dense count): 1 B of mask
    a slot, 4 B out a slot per channel, 4 B in per kept slot of a source
    channel (the dense count: per slot), nothing in for a SLOT_OFFSETS
    channel, 4 B a row of counts."""
    from repro_torch.kernels import fold as KF
    N, S = mask.shape
    kept = int(mask.sum())
    reads = sum(a is not KF.SLOT_OFFSETS for a in arrays)
    base = N * S + 4 * N * S * len(arrays) + 4 * N
    return base + 4 * kept * reads, base + 4 * N * S * reads


def time_compact(torch, what, mask, arrays, fills) -> dict:
    """B2 on one real call: equal to its plain version, its time, its bound
    and its form; logs a line and returns the numbers."""
    from repro_torch.kernels import fold as KF
    kern = KF.compact_rows(mask, arrays, fills)
    form = KF.compact_rows.last_form
    plain = KF.plain_compact_rows(mask, arrays, fills)
    err = check_equal(torch, f"compact_rows on the {what}",
                      kern[0] + (kern[1],), plain[0] + (plain[1],))
    N, S = mask.shape
    need, dense = compact_bytes(mask, arrays)
    ms = cuda_ms(torch, lambda: KF.compact_rows(mask, arrays, fills))
    plain_ms = cuda_ms(torch,
                       lambda: KF.plain_compact_rows(mask, arrays, fills),
                       reps=3)
    bound = need / HBM_BYTES_PER_S * 1e3
    dense_bound = dense / HBM_BYTES_PER_S * 1e3
    chans = ["offsets" if a is KF.SLOT_OFFSETS else "source"
             for a in arrays]
    log(f"[compact_rows] {what} N={N} S={S} channels {chans} valid "
        f"{int(kern[1].sum())}: max_abs_err {err}; form {form}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
        f"({need} B), {bound / ms:.3f} of it; a dense read of the source "
        f"channels {dense_bound:.5f} ms, {dense_bound / ms:.3f} of it")
    return {"what": what, "N": N, "S": S, "channels": chans,
            "valid": int(kern[1].sum()), "err": err, "form": form, "ms": ms,
            "plain_ms": plain_ms, "bytes": need, "bound_ms": bound,
            "dense_bound_ms": dense_bound}


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


def block_span_tensor(torch, start, E, cumul, total):
    """The row slots k_last - k_first that each kernel block of B7 / B9
    (BU_BLOCK_LANES lanes) spans over the value-clipped cumul of one chunk,
    as stage 1 (`stage::workload_map_block`) meets them: (blocks,) int64."""
    dev = cumul.device
    cc = torch.where(cumul < total, cumul, I32_MAX).to(torch.int32)
    first = start + torch.arange(0, E, BU_BLOCK_LANES, device=dev,
                                 dtype=torch.int32)
    last = (first + BU_BLOCK_LANES - 1).clamp(max=start + E - 1)
    k = [(torch.searchsorted(cc, g, right=True, out_int32=True) - 1)
         .clamp(min=0) for g in (first, last)]
    return (k[1] - k[0]).long()


def block_spans(torch, start, E, cumul, total) -> dict:
    """`block_span_tensor` summed up: its mean and max, the blocks whose
    span passes WALK_SLOTS_PER_LANE slots a lane and so search by lane, and
    the slots the other blocks walk (each one cumul read, beside the bound,
    which counts only the rows that own a live lane)."""
    span = block_span_tensor(torch, start, E, cumul, total)
    search = span > WALK_SLOTS_PER_LANE * BU_BLOCK_LANES
    return {"blocks": span.numel(), "mean": float(span.float().mean()),
            "max": int(span.max()), "search_blocks": int(search.sum()),
            "walked_slots": int(span[~search].sum())}


def peaks(report: dict, prefix: str = ""):
    """(path, bytes) of every peak the phases recorded in the report."""
    for k, v in report.items():
        if isinstance(v, dict):
            yield from peaks(v, f"{prefix}{k}.")
        elif k.endswith("peak_bytes"):
            yield f"{prefix}{k}", v


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


def stage_cases():
    """scripts/torch_stage_cases.py, the stress cases of the stages."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_stage_cases
    return torch_stage_cases


def parity_stage_cases(torch, dev, K, KB) -> None:
    """Phase 3 for B1, B8, B7 and B9: the stage stress cases, bit for
    bit."""
    SC = stage_cases()
    for name in SC.EXPAND_CASES:
        c = SC.expand_case(name)
        start, E = c["start"], c["E"]
        args = SC.expand_args(c, dev)
        err = check_equal(torch, f"expand_chunk {name}",
                          K.expand_chunk(start, E, *args),
                          K.plain_expand_chunk(start, E, *args))
        args = SC.value_args(c, dev)
        err += check_equal(torch, f"expand_chunk_values {name}",
                           K.expand_chunk_values(start, E, *args),
                           K.plain_expand_chunk_values(start, E, *args))
        log(f"[3 parity] expand_chunk + expand_chunk_values stage case "
            f"{name} start={start} E={E} tile {K.pick_tile(E, 512)}: "
            f"max_abs_err {err}")
    for name in SC.BOTTOMUP_CASES:
        c = SC.bottomup_case(name)
        start, E, block = c["start"], c["E"], c["block"]
        args = SC.bottomup_args(c, dev)
        err = check_equal(torch, f"bottomup_chunk {name}",
                          KB.bottomup_chunk(start, E, *args, block=block),
                          KB.plain_bottomup_chunk(start, E, *args,
                                                  block=block))
        args = SC.bottomup_args(c, dev, values=True)
        err += check_equal(
            torch, f"bottomup_chunk_values {name}",
            KB.bottomup_chunk_values(start, E, *args, block=block),
            KB.plain_bottomup_chunk_values(start, E, *args, block=block))
        span = block_spans(torch, start, E, args[0], args[1])
        log(f"[3 parity] bottomup_chunk + bottomup_chunk_values stage case "
            f"{name} start={start} E={E} total {c['total']} block {block}: "
            f"row slots a kernel block spans mean {span['mean']:.1f} max "
            f"{span['max']}, {span['search_blocks']} of {span['blocks']} "
            f"blocks search by lane; max_abs_err {err}")
    torch.cuda.synchronize()


def parity_compact_cases(torch, dev, KF) -> None:
    """Phase 3 for B2: the COMPACT_CASES of scripts/torch_stage_cases.py,
    bit for bit, both forms launched."""
    SC = stage_cases()
    forms = set()
    for name in SC.COMPACT_CASES:
        mask, arrays, fills = SC.compact_args(SC.compact_case(name), dev)
        kout, kcnt = KF.compact_rows(mask, arrays, fills)
        form = KF.compact_rows.last_form
        pout, pcnt = KF.plain_compact_rows(mask, arrays, fills)
        err = check_equal(torch, f"compact_rows {name}", kout + (kcnt,),
                          pout + (pcnt,))
        forms.add(form)
        N, S = mask.shape
        log(f"[3 parity] compact_rows stage case {name} N={N} S={S} "
            f"channels {len(arrays)}: form {form}, max_abs_err {err}")
    if forms != {"vector", "general"}:
        raise AssertionError(f"phase 3 did not launch both forms of B2: "
                             f"{forms}")
    torch.cuda.synchronize()


def parity_bits(torch, KF, what, mask, words, forms) -> str:
    """B3 and B4 against their plain versions on (mask, words), bit for bit;
    adds the forms that launched to `forms`; returns a log line's tail."""
    S = mask.shape[1]
    err = check_equal(torch, f"pack_bits {what}", (KF.pack_bits(mask),),
                      (KF.plain_pack_bits(mask),))
    pack_form = KF.pack_bits.last_form
    bits = KF.unpack_bits(words, S)
    err += check_equal(torch, f"unpack_bits {what}", (bits, bits),
                       (KF.plain_unpack_bits(words, S), mask))
    forms["pack_bits"].add(pack_form)
    forms["unpack_bits"].add(KF.unpack_bits.last_form)
    return (f"forms pack {pack_form}, unpack {KF.unpack_bits.last_form}; "
            f"max_abs_err {err}")


def parity_random_dir(torch, dev, gen, KF, KB) -> None:
    """Phase 3 for B3, B4 and B7: random inputs and the BITS_CASES of
    scripts/torch_stage_cases.py, bit for bit, both forms of B3 and B4."""
    forms = {"pack_bits": set(), "unpack_bits": set()}
    for N, S, p in ((8, 1 << 24, 0.3), (3, 1_000_003, 0.6), (2, 77, 0.0),
                    (5, 33, 1.0)):
        mask = torch.rand((N, S), generator=gen, device=dev) < p
        tail = parity_bits(torch, KF, "random", mask,
                           KF.plain_pack_bits(mask), forms)
        log(f"[3 parity] pack_bits + unpack_bits random N={N} S={S} p={p}: "
            f"{tail}")
    SC = stage_cases()
    for name in SC.BITS_CASES:
        mask, words = SC.bits_args(SC.bits_case(name), dev)
        N, S = mask.shape
        tail = parity_bits(torch, KF, name, mask, words, forms)
        log(f"[3 parity] pack_bits + unpack_bits stage case {name} N={N} "
            f"S={S}: {tail}")
    if any(f != {"vector", "general"} for f in forms.values()):
        raise AssertionError(f"phase 3 did not launch both forms of B3 and "
                             f"B4: {forms}")
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
    from repro_torch.kernels import stages as S
    return {f.__name__: f for f in (
        K.expand_chunk, K.expand_chunk_values, KF.compact_rows, KF.pack_bits,
        KF.unpack_bits, KF.delta_gaps, KF.delta_positions,
        KB.bottomup_chunk, KB.bottomup_chunk_values, S.binsearch_map,
        S.visited_filter)}


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
    from repro_torch.kernels import fold as KF

    dev = edges.device
    grid = graph.grid
    n = graph.n
    sess = graph.session(BFSConfig(grid=(grid.R, grid.C),
                                   edge_chunk=args.edge_chunk))
    eng = sess._algo_engine(ConnectedComponentsProgram(), None, grid.n + 1)
    hook = eng.value_expand_fn
    assert eng.expand_path == "kernel" and hook is not None
    # 9b: keep one chunk of CC's first level (full frontier, start > 0) and
    # the values row of its second level's exchange (ids and labels)
    tap = Tap(hook, lambda k, a: a[0] > 0)
    rows = []

    def second_values_row(k, a):
        if len(a[1]) == 2:
            rows.append(k)
        return len(rows) == 2 and rows[-1] == k

    row_tap = Tap(KF.compact_rows, second_values_row)

    class TappedValues:
        compact_rows = row_tap
        pack_bits = KF.pack_bits
        unpack_bits = KF.unpack_bits
        delta_gaps = KF.delta_gaps
        delta_positions = KF.delta_positions

    eng.value_expand_fn = tap
    eng.fold_ops = eng.codec.ops = TappedValues
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    cc, cc_s = timed(torch, sess.connected_components)
    eng.value_expand_fn = hook
    eng.fold_ops = eng.codec.ops = KF
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
                     mb.edges_scanned), "sources": td_roots,
            "khop": (hop.level.cpu(), hop.src.cpu(), int(hop.n_levels),
                     hop.edges_scanned)}
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
    (mask, arrays, fills), _ = row_tap.saved
    if len(arrays) != 2:
        raise AssertionError("phase 9 kept no values row")
    report["compact_rows"].append(time_compact(
        torch, "real values row (9b, CC level 2)", mask, arrays, fills))
    del tap, row_tap, vargs, kern, mask, arrays
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
    hook = eng.value_bottomup_fn
    assert eng.bottomup_path == "kernel" and hook is not None
    tap = Tap(hook, lambda k, a: a[0] > 0)
    eng.value_bottomup_fn = tap
    torch.cuda.reset_peak_memory_stats()
    zero_counts()

    def bottomup_levels(out):
        d = out.directions.cpu()
        return "".join("TB"[x] for x in d[d >= 0].tolist())

    cc, cc_s = timed(torch, dsess.connected_components)
    eng.value_bottomup_fn = hook
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
    span = block_spans(torch, start, E, bargs[0], btotal)
    log(f"[10b spans] bottomup_chunk_values real chunk: {E} lanes ({live} "
        f"live) in {span['blocks']} blocks of {BU_BLOCK_LANES}, rows {rows};"
        f" row slots a block spans mean {span['mean']:.1f} max "
        f"{span['max']}; {span['search_blocks']} blocks search by lane, the "
        f"rest walk {span['walked_slots']} slots "
        f"({4 * span['walked_slots']} B of cumul beside the bound)")
    report["b9_spans"] = dict(span, rows=rows, live=live, lanes=E)
    del tap, bargs, kern
    phases.end("10b parity")


def check_trace(torch, what, out, n, wire=None, msgs=None, levels=None):
    """A search's LevelTrace against its output: the scanned total, the
    level count (the output's minus one, as in JAX), the per-processor
    frontiers summing to the global one, the frontier per level from the
    output's levels (`levels`, BFS), the wire bytes and messages a
    processor a level (`wire`, `msgs`: ints; None = not a constant), and
    the directions (`out.directions`, or all top-down).  Returns the
    trace."""
    tr = out.trace
    n_out = int(out.n_levels if hasattr(out, "n_levels") else out.n_iters)
    bad = []
    if tr.total_scanned != out.edges_scanned:
        bad.append(f"scanned {tr.total_scanned} != {out.edges_scanned}")
    if tr.n_levels != n_out - 1:
        bad.append(f"n_levels {tr.n_levels} != {n_out} - 1")
    if not (tr.frontier_dev.sum(axis=0) == tr.frontier).all():
        bad.append("frontier_dev does not sum to frontier")
    if levels is not None:
        lv = levels[:n]
        hist = torch.bincount(lv[lv >= 0].long()).tolist()
        if tr.frontier.tolist() != hist:
            bad.append(f"frontier {tr.frontier.tolist()} != levels {hist}")
    if wire is not None and not (tr.wire_dev == wire).all():
        bad.append(f"wire {sorted(set(tr.wire_dev.ravel().tolist()))} != "
                   f"{wire}")
    if msgs is not None and not (tr.msgs_dev == msgs).all():
        bad.append(f"msgs {sorted(set(tr.msgs_dev.ravel().tolist()))} != "
                   f"{msgs}")
    dirs = [0] * tr.n_levels if out.directions is None \
        else out.directions.cpu().tolist()[:tr.n_levels]
    if tr.direction.tolist() != dirs:
        bad.append(f"dir {tr.direction.tolist()} != directions {dirs}")
    if bad:
        raise AssertionError(f"{what}: trace disagrees: {'; '.join(bad)}")
    return tr


def run_exchange_obs(torch, args, graph, td_roots, scalar, dscalar, vals,
                     report, phases):
    """Phase 14: the butterfly exchange and the per-level telemetry on the
    resident SCALE 26 graph, held to phases 4, 7 and 9."""
    from repro_torch.api import BFSConfig

    grid = graph.grid
    n, C, S = graph.n, grid.C, grid.S
    log2c = C.bit_length() - 1
    base = dict(grid=(grid.R, grid.C), edge_chunk=args.edge_chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    sess = graph.session(BFSConfig(**base, exchange="butterfly",
                                   telemetry=True))
    eng = sess.engine
    if eng.exchange.name != "butterfly" or not eng.telemetry \
            or eng.topo.exchange is not eng.exchange:
        raise AssertionError("phase 14's session runs no traced butterfly")
    # the list codec's set fold: C buckets of [count | S ids], of which the
    # butterfly ships C/2 a stage over log2(C) stages
    wire = (4 * S + 4) * (C // 2) * log2c
    zero_counts()
    n_td = min(PHASE14_15_ROOTS, len(scalar))
    for k, r in enumerate(td_roots[:n_td]):
        out, dt = timed(torch, lambda: sess.bfs(r))
        lv, pr, nl, es = scalar[k]
        if not (torch.equal(out.level.cpu(), lv)
                and torch.equal(out.pred.cpu(), pr)
                and int(out.n_levels) == nl and out.edges_scanned == es):
            raise AssertionError(f"butterfly bfs root {r} differs from "
                                 f"phase 4")
        tr = check_trace(torch, f"butterfly bfs root {r}", out, n,
                         wire=wire, msgs=log2c, levels=out.level)
        if sess.last_trace() is not tr:
            raise AssertionError("last_trace() is not the query's trace")
        log(f"[14 exch-obs] butterfly + telemetry bfs root {r}: equal to "
            f"phase 4, {dt:.3f} s; trace {tr.n_levels} levels, frontier "
            f"{tr.frontier.tolist()}, scanned {tr.total_scanned}, wire "
            f"{tr.total_wire_bytes} B, msgs {tr.total_msgs}")
    td_launches = read_counts()
    require_launched(td_launches, ("expand_chunk", "compact_rows"),
                     "phase 14's top-down butterfly")

    dsess = graph.session(BFSConfig(**base, direction=True,
                                    fold_codec="bitmap", exchange="butterfly",
                                    telemetry=True))
    zero_counts()
    n_dir = min(PHASE14_15_ROOTS, len(dscalar))
    for k, r in enumerate(td_roots[:n_dir]):
        out, dt = timed(torch, lambda: dsess.bfs(r))
        lv, pr, nl, es, dr = dscalar[k]
        if not (torch.equal(out.level.cpu(), lv)
                and torch.equal(out.pred.cpu(), pr)
                and int(out.n_levels) == nl and out.edges_scanned == es
                and torch.equal(out.directions.cpu(), dr)):
            raise AssertionError(f"butterfly direction bfs root {r} "
                                 f"differs from phase 7")
        tr = check_trace(torch, f"butterfly direction bfs root {r}", out, n,
                         msgs=log2c, levels=out.level)
        log(f"[14 exch-obs] butterfly + telemetry direction bfs root {r}: "
            f"equal to phase 7, {dt:.3f} s; trace dir "
            f"{''.join('TB'[d] for d in tr.direction.tolist())}, wire "
            f"{tr.total_wire_bytes} B, msgs {tr.total_msgs}")
    dir_launches = read_counts()
    require_launched(dir_launches, ("pack_bits", "unpack_bits",
                                    "bottomup_chunk"),
                     "phase 14's direction-optimised butterfly")

    cc, cc_s = timed(torch, sess.connected_components)
    if not same(torch, (cc.labels, int(cc.n_iters), cc.edges_scanned),
                vals["cc"]):
        raise AssertionError("butterfly CC differs from phase 9")
    tr = check_trace(torch, "butterfly CC", cc, n, msgs=log2c)
    log(f"[14 exch-obs] butterfly + telemetry connected_components: equal "
        f"to phase 9, {cc_s:.3f} s; trace {tr.n_levels} levels, folded "
        f"{tr.folded.tolist()}, wire {tr.total_wire_bytes} B")
    r = vals["sssp_roots"][0]
    sp, sp_s = timed(torch, lambda: sess.sssp(r))
    if not same(torch, (sp.dist, int(sp.n_iters), sp.edges_scanned),
                vals["sssp"][0]):
        raise AssertionError(f"butterfly sssp root {r} differs from phase 9")
    tr = check_trace(torch, f"butterfly sssp root {r}", sp, n, msgs=log2c)
    log(f"[14 exch-obs] butterfly + telemetry sssp root {r}: equal to "
        f"phase 9, {sp_s:.3f} s; trace {tr.n_levels} levels, wire "
        f"{tr.total_wire_bytes} B")
    del cc, sp, out

    # one root's wall time under each exchange, telemetry on and off, in
    # turns (a, b, c, d, d, c, b, a); no limit is asserted
    r = td_roots[0]
    arms = {(ex, tel): graph.session(BFSConfig(**base, exchange=ex,
                                               telemetry=tel))
            for ex in ("flat", "butterfly") for tel in (False, True)}
    walls = {key: [] for key in arms}
    order = list(arms)
    for key in order + order[::-1]:
        _, dt = timed(torch, lambda: arms[key].bfs(r))
        walls[key].append(dt)
    for (ex, tel), ts in walls.items():
        log(f"[14 exch-obs] wall time root {r} exchange={ex} "
            f"telemetry={tel}: {sum(ts) / len(ts):.4f} s (runs "
            f"{', '.join(f'{t:.4f}' for t in ts)})")
    del arms
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    log(f"[14 exch-obs] {phase_s:.1f} s, peak memory {peak / 2**30:.2f} "
        f"GiB; launches top-down {td_launches}, direction {dir_launches}")
    report["exch_obs"] = {
        "wall_s": {f"{ex}/telemetry={tel}": ts
                   for (ex, tel), ts in walls.items()},
        "root": r, "td_launches": td_launches,
        "dir_launches": dir_launches, "peak_bytes": peak,
        "seconds": phase_s}
    phases.end("14 exch-obs")


def ft_plan(torch, *, injector=None, checkpointer=None, resume=None,
            retries=2):
    """A RecoveryPlan with a near-zero backoff (the drills' policy)."""
    from repro_torch.runtime import RecoveryPlan, RetryPolicy
    return RecoveryPlan(injector=injector, checkpointer=checkpointer,
                        resume=resume,
                        policy=RetryPolicy(max_retries=retries,
                                           backoff_s=1e-4, jitter_s=1e-4,
                                           seed=3))


def check_retries(plan, what: str, escalations: int = 0) -> None:
    """Every retry the plan counted was one its injector caused: each fire
    is retried except the one a loss escalates with."""
    fired = 0 if plan.injector is None else plan.injector.count
    if plan.stats["retries"] != fired - escalations:
        raise AssertionError(
            f"{what}: {plan.stats['retries']} retries, but the injector "
            f"fired {fired} times and {escalations} loss(es) escalated")


class TimedExport:
    """Wraps an engine's `export_carry`: the host seconds of each call."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, []

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return out


def snapshot_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(snapshot_bytes(v) for v in tree.values())
    return int(tree.nbytes)


def run_ft(torch, args, graph, td_roots, scalar, dscalar, vals, report,
           phases):
    """Phase 15 (a)-(d): the segmented level loop, retry, resume and a
    checkpoint directory on the resident SCALE 26 graph, held to phases 4,
    7 and 9."""
    from repro_torch.algos.engine import _clone_run
    from repro_torch.api import BFSConfig
    from repro_torch.runtime import (DeviceLossInjector,
                                     TraversalCheckpointer,
                                     UnrecoverableLoss)

    grid = graph.grid
    n = graph.n
    base = dict(grid=(grid.R, grid.C), edge_chunk=args.edge_chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rep = {}
    td_s = report["run"]["search_s"]
    dir_s = report["dir_run"]["search_s"]

    def bfs_equal(out, k):
        lv, pr, nl, es = scalar[k]
        return (torch.equal(out.level.cpu(), lv)
                and torch.equal(out.pred.cpu(), pr)
                and int(out.n_levels) == nl and out.edges_scanned == es)

    # (a) segmented searches, ckpt_every=1 (BFS) and 2 (CC, SSSP)
    sess = graph.session(BFSConfig(**base, fault_tolerance=True,
                                   ckpt_every=1))
    eng = sess.engine
    assert eng.fault_tolerance and eng.expand_path == "kernel" \
        and eng.fold_path == "kernel"
    zero_counts()
    n_td = min(PHASE14_15_ROOTS, len(scalar))
    rep["td_s"] = []
    for k, r in enumerate(td_roots[:n_td]):
        plan = ft_plan(torch)
        out, dt = timed(torch, lambda: sess.bfs(r, recovery=plan))
        if not bfs_equal(out, k):
            raise AssertionError(f"FT bfs root {r} differs from phase 4")
        check_retries(plan, f"FT bfs root {r}")
        rep["td_s"].append(dt)
        log(f"[15 ft] (a) ckpt_every=1 bfs root {r}: equal to phase 4, "
            f"{plan.stats['segments']} segments, {dt:.3f} s against "
            f"{td_s[k]:.3f} s in phase 4 ({dt / td_s[k] - 1:+.2%})")
    td_launches = read_counts()
    require_launched(td_launches, ("expand_chunk", "compact_rows"),
                     "phase 15's segmented top-down search")
    # what a segment adds on the device: the clone of its input state (and
    # trace) the segment advances, timed on a carry two levels in
    carry = eng.ft_start(graph.csc, [td_roots[0]], *sess.extra,
                         batched=True)
    for _ in range(2):
        carry = eng.ft_segment(graph.csc, carry, *sess.extra, batched=True)
    st = carry[0]["st"]
    clone_bytes = sum(t.numel() * t.element_size() for t in (
        st.level, st.pred, st.visited, st.front, st.front_cnt))
    clone_ms = cuda_ms(torch, lambda: _clone_run(carry[0]))
    del carry, st
    rep.update(clone_ms=clone_ms, clone_bytes=clone_bytes)
    log(f"[15 ft] (a) a segment's state clone: {clone_bytes} B in "
        f"{clone_ms:.4f} device ms ({2 * clone_bytes / clone_ms / 1e6:.0f} "
        f"GB/s read + written), once a segment")
    dsess = graph.session(BFSConfig(**base, direction=True,
                                    fold_codec="bitmap",
                                    fault_tolerance=True, ckpt_every=1))
    zero_counts()
    rep["dir_s"] = []
    for k, r in enumerate(td_roots[:min(2, len(dscalar))]):
        plan = ft_plan(torch)
        out, dt = timed(torch, lambda: dsess.bfs(r, recovery=plan))
        check_retries(plan, f"FT direction bfs root {r}")
        lv, pr, nl, es, dr = dscalar[k]
        if not (torch.equal(out.level.cpu(), lv)
                and torch.equal(out.pred.cpu(), pr)
                and int(out.n_levels) == nl and out.edges_scanned == es
                and torch.equal(out.directions.cpu(), dr)):
            raise AssertionError(f"FT direction bfs root {r} differs from "
                                 f"phase 7")
        rep["dir_s"].append(dt)
        live = dr[dr >= 0].tolist()
        log(f"[15 ft] (a) ckpt_every=1 direction bfs root {r}: equal to "
            f"phase 7 ({''.join('TB'[d] for d in live)}), {dt:.3f} s "
            f"against {dir_s[k]:.3f} s in phase 7 "
            f"({dt / dir_s[k] - 1:+.2%})")
    dir_launches = read_counts()
    require_launched(dir_launches, ("expand_chunk", "compact_rows",
                                    "pack_bits", "unpack_bits",
                                    "bottomup_chunk"),
                     "phase 15's segmented direction search")
    vsess = graph.session(BFSConfig(**base, fault_tolerance=True,
                                    ckpt_every=2))
    zero_counts()
    plan = ft_plan(torch)
    cc, cc_s = timed(torch, lambda: vsess.connected_components(
        recovery=plan))
    check_retries(plan, "FT CC")
    if not same(torch, (cc.labels, int(cc.n_iters), cc.edges_scanned),
                vals["cc"]):
        raise AssertionError("FT CC differs from phase 9")
    r = vals["sssp_roots"][0]
    plan = ft_plan(torch)
    sp, sp_s = timed(torch, lambda: vsess.sssp(r, recovery=plan))
    check_retries(plan, f"FT sssp root {r}")
    if not same(torch, (sp.dist, int(sp.n_iters), sp.edges_scanned),
                vals["sssp"][0]):
        raise AssertionError(f"FT sssp root {r} differs from phase 9")
    val_launches = read_counts()
    require_launched(val_launches, ("expand_chunk_values", "compact_rows"),
                     "phase 15's segmented value programs")
    v = report["values"]
    rep.update(cc_s=cc_s, sssp_s=sp_s)
    log(f"[15 ft] (a) ckpt_every=2 connected_components: equal to phase 9, "
        f"{cc_s:.3f} s against {v['cc_s']:.3f} s; sssp root {r}: equal to "
        f"phase 9, {sp_s:.3f} s against {v['sssp_s'][0]:.3f} s")
    del cc, sp, out

    # (b) a transient loss crossing level 3: one retry absorbs it
    r = td_roots[0]
    plan = ft_plan(torch, injector=DeviceLossInjector(3, transient=True))
    out, dt = timed(torch, lambda: sess.bfs(r, recovery=plan))
    if not bfs_equal(out, 0):
        raise AssertionError("bfs after a transient loss differs from "
                             "phase 4")
    check_retries(plan, "transient loss")
    if plan.injector.count != 1:
        raise AssertionError(f"transient loss: {plan.injector.count} fires")
    rep["transient_s"] = dt
    log(f"[15 ft] (b) transient loss at level 3, bfs root {r}: equal to "
        f"phase 4, retries {plan.stats['retries']} = fires "
        f"{plan.injector.count}, {dt:.3f} s")

    # (c) a persistent loss crossing level 3: its snapshot resumes
    eng.export_carry = timer = TimedExport(eng.export_carry)
    plan = ft_plan(torch, injector=DeviceLossInjector(3, fires=3))
    t0 = time.perf_counter()
    try:
        sess.bfs(r, recovery=plan)
        raise AssertionError("the persistent loss did not escalate")
    except UnrecoverableLoss as e:
        snap, level = e.snapshot, e.level
    fail_s = time.perf_counter() - t0
    check_retries(plan, "persistent loss", escalations=1)
    if plan.injector.count != 3:
        raise AssertionError(f"persistent loss: {plan.injector.count} "
                             f"fires")
    fresh = graph.session(BFSConfig(**base, fault_tolerance=True,
                                    ckpt_every=1))
    plan2 = ft_plan(torch, resume=snap)
    out, dt = timed(torch, lambda: fresh.bfs(r, recovery=plan2))
    if not bfs_equal(out, 0):
        raise AssertionError("the resumed bfs differs from phase 4")
    rep.update(persistent_fail_s=fail_s, resume_s=dt, resumed_from=level,
               export_s=timer.seconds, snapshot_bytes=snapshot_bytes(
                   snap["arrays"]),
               t_first_resumed_s=plan2.stats[
                   "time_to_first_resumed_level_s"])
    log(f"[15 ft] (c) persistent loss at level 3, bfs root {r}: "
        f"UnrecoverableLoss, snapshot after level {level}, {fail_s:.3f} s "
        f"(retries {plan.stats['retries']}, fires {plan.injector.count}); "
        f"snapshot {rep['snapshot_bytes']} B exported in "
        f"{timer.seconds[-1] * 1e3:.1f} ms; resumed in a fresh session: "
        f"equal to phase 4 (preds included), {dt:.3f} s, "
        f"time_to_first_resumed_level_s "
        f"{rep['t_first_resumed_s']:.4f}")
    del out, snap

    # (d) one query through a checkpoint directory, resumed from disk
    class TimedCheckpointer(TraversalCheckpointer):
        """Writes each checkpoint before the next segment (timed)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.save_s = []

        def save(self, snapshot):
            t0 = time.perf_counter()
            super().save(snapshot)
            self.join()
            self.save_s.append(time.perf_counter() - t0)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        timer.seconds = []
        ck = TimedCheckpointer(d, f"bfs root {r}")
        plan = ft_plan(torch, checkpointer=ck, retries=0,
                       injector=DeviceLossInjector(3, fires=1))
        try:
            sess.bfs(r, recovery=plan)
            raise AssertionError("the loss did not escalate")
        except UnrecoverableLoss:
            pass
        check_retries(plan, "checkpointed loss", escalations=1)
        n_ck = len(ck.save_s)
        on_disk = sum(os.path.getsize(os.path.join(root, f))
                      for root, _, files in os.walk(d) for f in files)
        # a new process would open the directory the same way: the latest
        # checkpoint, its query key checked
        t0 = time.perf_counter()
        disk = TraversalCheckpointer(d, f"bfs root {r}").load()
        load_s = time.perf_counter() - t0
    plan2 = ft_plan(torch, resume=disk)
    out, dt = timed(torch, lambda: fresh.bfs(r, recovery=plan2))
    if not bfs_equal(out, 0) or plan2.stats["resumes"] != 1:
        raise AssertionError("bfs resumed from disk differs from phase 4")
    per_ck = [a + b for a, b in zip(timer.seconds, ck.save_s)]
    rep.update(ckpt_s=per_ck, ckpt_dir_bytes=on_disk, load_s=load_s,
               disk_resume_s=dt, disk_resumed_from=plan2.stats[
                   "resumed_from_level"],
               disk_t_first_s=plan2.stats["time_to_first_resumed_level_s"])
    log(f"[15 ft] (d) TraversalCheckpointer: {n_ck} checkpoints before the "
        f"loss at level 3 ({on_disk} B on disk), seconds per checkpoint "
        f"(export + write) {', '.join(f'{t:.3f}' for t in per_ck)}; the "
        f"latest loaded in {load_s:.3f} s and resumed at level "
        f"{plan2.stats['resumed_from_level']}: equal to phase 4, {dt:.3f} s,"
        f" time_to_first_resumed_level_s {rep['disk_t_first_s']:.4f}")
    del disk
    del eng.export_carry
    peak = torch.cuda.max_memory_allocated()
    rep.update(td_launches=td_launches, dir_launches=dir_launches,
               val_launches=val_launches, peak_bytes=peak)
    log(f"[15 ft] (a)-(d) peak memory {peak / 2**30:.2f} GiB; launches "
        f"top-down {td_launches}, direction {dir_launches}, values "
        f"{val_launches}")
    rep["seconds_ad"] = time.perf_counter() - t_phase
    report["ft"] = rep
    phases.end("15 ft")


def run_ft_elastic(torch, args, edges, index, n, td_roots, scalar, vals,
                   report, phases):
    """Phase 15 (e), after the resident graph is dropped: the elastic
    shrink 2x2 -> 1x3 of top-down BFS and CC under a persistent loss at
    level 3, held to phases 4 and 9.  Returns the elastic BFS output
    (level, pred on the host, n_levels, edges_scanned), phase 17 (d)'s
    reference."""
    from repro_torch.api import BFSConfig
    from repro_torch.core.validate import validate_bfs
    from repro_torch.runtime import DeviceLossInjector, ElasticCoordinator

    R, C = (int(x) for x in args.grid.lower().split("x"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rep = {"resident_gib": torch.cuda.memory_allocated() / 2**30}
    plans_at = []

    class Probe(ElasticCoordinator):
        """Records the device memory in use as each grid is planned."""

        def _plan(self, config):
            plans_at.append((config.grid, torch.cuda.memory_allocated()))
            return super()._plan(config)

    config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                       fault_tolerance=True, ckpt_every=1)
    zero_counts()
    for what, method, arg in (("bfs", "bfs", td_roots[0]),
                              ("cc", "connected_components", None)):
        plans_at.clear()
        torch.cuda.reset_peak_memory_stats()
        coord = Probe(edges, config, n=n, device=edges.device)
        if coord.edges is not edges:
            raise AssertionError("the coordinator copied the edge list")
        plan = ft_plan(torch, injector=DeviceLossInjector(3, fires=3))
        out, dt = timed(torch, lambda: coord.run(method, arg, plan=plan))
        peak = torch.cuda.max_memory_allocated()
        if coord.grids != [(R, C), (1, 3)] or coord.shrinks != 1:
            raise AssertionError(f"elastic {what}: grids {coord.grids}")
        check_retries(plan, f"elastic {what}", escalations=1)
        if plan.injector.count != 3:
            raise AssertionError(f"elastic {what}: {plan.injector.count} "
                                 f"fires")
        if what == "bfs":
            lv, _, nl, es = scalar[0]
            el_bfs = (out.level.cpu(), out.pred.cpu(), int(out.n_levels),
                      out.edges_scanned)
            level, pred = out.level[:n], out.pred[:n]
            if not (torch.equal(level.cpu(), lv[:n])
                    and int(out.n_levels) == nl and out.edges_scanned == es):
                raise AssertionError("elastic bfs differs from phase 4")
            t0 = time.perf_counter()
            validate_bfs(edges, level, pred, td_roots[0], index=index)
            val_s = time.perf_counter() - t0
            pred_same = torch.equal(pred.cpu(), scalar[0][1][:n])
            note = (f"levels, n_levels, edges_scanned equal to phase 4, "
                    f"preds validated on the card in {val_s:.1f} s (equal "
                    f"to phase 4's 2x2 preds: {pred_same})")
            del level, pred
        else:
            labels, iters, es = vals["cc"]
            if not (torch.equal(out.labels[:n].cpu(), labels[:n])
                    and int(out.n_iters) == iters
                    and out.edges_scanned == es):
                raise AssertionError("elastic CC differs from phase 9")
            note = "labels, n_iters, edges_scanned equal to phase 9"
        stats = plan.stats
        rep[what] = {"s": dt, "peak_bytes": peak, "grids": coord.grids,
                     "resumed_from": stats["resumed_from_level"],
                     "t_first_resumed_s":
                         stats["time_to_first_resumed_level_s"],
                     "allocated_at_plan": [(list(g), b)
                                           for g, b in plans_at]}
        log(f"[15 ft] (e) elastic {what}: grids "
            f"{' -> '.join(f'{a}x{b}' for a, b in coord.grids)}, resumed "
            f"from level {stats['resumed_from_level']}; {note}; {dt:.3f} s,"
            f" time_to_first_resumed_level_s "
            f"{stats['time_to_first_resumed_level_s']:.4f}; allocated "
            f"when each grid was planned "
            f"{', '.join(f'{g}: {b / 2**30:.2f} GiB' for g, b in plans_at)}"
            f"; peak {peak / 2**30:.2f} GiB")
        del out, coord
    launches = read_counts()
    require_launched(launches, ("expand_chunk", "compact_rows",
                                "expand_chunk_values"),
                     "phase 15's elastic runs")
    rep["launches"] = launches
    phase_s = time.perf_counter() - t_phase
    rep["seconds"] = phase_s
    report["ft_elastic"] = rep
    log(f"[15 ft] (e) {phase_s:.1f} s; launches {launches}")
    phases.end("15 ft-elastic")
    return el_bfs


SERVE_TD_ROOTS = 11              # phase 16: top-down BFS requests
SERVE_DIR_ROOTS = 4              # phase 16: direction-optimised requests


def percentiles(xs) -> str:
    xs = sorted(xs)

    def pct(q):
        return xs[min(len(xs) - 1, int(q / 100 * len(xs)))]
    return f"p50 {pct(50):.4f} s p99 {pct(99):.4f} s"


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def run_serve(torch, args, graph, td_roots, dir_roots, scalar, dscalar,
              td_s, dir_s, dir_config, vals, report, phases):
    """Phase 16: the serving layer on the resident SCALE 26 graph -- a
    GraphServer warmed through `compiled_for`, a burst from four tenant
    threads (top-down and direction-optimised BFS, SSSP, two CC callers, a
    k-hop multi-BFS), every result held to phases 4, 7 and 9 field for
    field; the burst's latency, throughput, occupancy and padding; then a
    fault-tolerant batch that loses a device mid-search and drains through
    recovery from a checkpoint directory."""
    import shutil
    import threading

    import numpy as np

    from repro_torch.api import BFSConfig
    from repro_torch.runtime import DeviceLossInjector, RetryPolicy
    from repro_torch.serve import GraphServer, ServeConfig, pad_classes

    R, C = graph.grid.R, graph.grid.C
    name = f"g{args.scale}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rep = {}

    # -- (a) the server, warmed ---------------------------------------------
    srv = GraphServer({name: graph}, ServeConfig(max_batch=4,
                                                  window_s=0.01))
    stats0 = graph.cache_stats()
    _, warm_s = timed(torch, lambda: srv.warm(("bfs", "sssp", "cc")))
    warm_stats = graph.cache_stats()
    sess = srv._worker(name).session_for(graph.config)
    entries = {B: repr(sess.compiled_for(B)) for B in pad_classes(4)}
    log(f"[16 serve] warm(bfs, sssp, cc) in {warm_s:.2f} s: compiled_for "
        f"{entries}; cache_stats before {stats0}, after warm {warm_stats}, "
        f"after the lookups {graph.cache_stats()}")
    rep["warm_s"] = warm_s

    # -- (b) the burst --------------------------------------------------------
    sources = vals["sources"]
    # as many as phases 4 and 7 kept (fewer on a quick check)
    n_td = min(SERVE_TD_ROOTS, len(scalar))
    n_dir = min(SERVE_DIR_ROOTS, len(dscalar))
    requests = ([("td", r, k) for k, r in enumerate(td_roots[:n_td])]
                + [("dir", r, k) for k, r in enumerate(dir_roots[:n_dir])]
                + [("sssp", r, k) for k, r in
                   enumerate(vals["sssp_roots"][:2])]
                + [("cc", None, 0), ("cc", None, 1), ("mbfs", None, 0)])
    tenants = [requests[t::4] for t in range(4)]
    barrier = threading.Barrier(5)
    failures, done = [], []

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def want_of(kind, k):
        if kind == "td":
            lv, pr, nl, es = scalar[k]
            return {"level": lv, "pred": pr, "n_levels": nl,
                    "edges_scanned": es, "directions": None}
        if kind == "dir":
            lv, pr, nl, es, dr = dscalar[k]
            return {"level": lv, "pred": pr, "n_levels": nl,
                    "edges_scanned": es, "directions": dr}
        if kind == "sssp":
            dist, it, es = vals["sssp"][k]
            return {"dist": dist, "n_iters": it, "edges_scanned": es}
        if kind == "cc":
            labels, it, es = vals["cc"]
            return {"labels": labels, "n_iters": it, "edges_scanned": es}
        level, src, nl, es = vals["khop"]
        return {"level": level, "src": src, "n_levels": nl,
                "edges_scanned": es}

    def tenant(t, mine):
        tickets = []
        try:
            for kind, r, k in mine:
                kw = {"tenant": f"tenant{t}"}
                if kind == "td":
                    tk = srv.bfs(name, r, **kw)
                elif kind == "dir":
                    tk = srv.bfs(name, r, config=dir_config, **kw)
                elif kind == "sssp":
                    tk = srv.sssp(name, r, **kw)
                elif kind == "cc":
                    tk = srv.connected_components(name, **kw)
                else:
                    tk = srv.multi_bfs(name, np.asarray(sources), k=2,
                                       **kw)
                tickets.append((kind, r, k, tk))
        except Exception as exc:       # noqa: BLE001 -- raised below
            failures.append(f"admission: {type(exc).__name__}: {exc}")
        finally:
            barrier.wait()
        # the results stay on the card until the burst is over: a client's
        # copy of a 512 MiB result to pageable host memory, made while the
        # next batch runs, slows that batch's launches
        for kind, r, k, tk in tickets:
            try:
                res = tk.result(timeout=600)
                if not res.ok:
                    raise AssertionError(f"{kind} {r}: not ok: {res.error}")
                done.append((kind, r, k, res))
            except Exception as exc:   # noqa: BLE001 -- raised below
                failures.append(f"{type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=tenant, args=(t, mine))
               for t, mine in enumerate(tenants)]
    for th in threads:
        th.start()
    barrier.wait()                       # every request admitted
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.start()
    for th in threads:
        th.join()
    srv.drain()
    burst_s = time.perf_counter() - t0
    launches = read_counts()
    srv.stop()
    if failures:
        raise AssertionError("; ".join(failures))
    if len(done) != len(requests):
        raise AssertionError(f"{len(done)} of {len(requests)} served")
    burst_peak = torch.cuda.max_memory_allocated()
    for kind, r, k, res in done:
        for f, want in want_of(kind, k).items():
            got = host(getattr(res.value, f))
            if isinstance(want, torch.Tensor):
                equal = torch.equal(got, want)
            else:
                equal = (int(got) if isinstance(got, torch.Tensor)
                         else got) == want
            if not equal:
                raise AssertionError(f"served {kind} {r}: {f} differs "
                                     f"from phases 4 / 7 / 9")
        res.value = None               # the slot's tensors leave the card
    log(f"[16 serve] burst: {len(requests)} requests from 4 tenant threads "
        f"({n_td} top-down BFS, {n_dir} direction BFS (bitmap), "
        f"{len(vals['sssp_roots'][:2])} SSSP, 2 CC, 1 multi_bfs of "
        f"{len(sources)} sources "
        f"k=2), every result ok and equal to phases 4, 7, 9 field for "
        f"field; {burst_s:.2f} s wall, {len(requests) / burst_s:.4f} "
        f"queries/s")
    snap = srv.metrics_snapshot()
    rep["burst"] = {"s": burst_s, "qps": len(requests) / burst_s,
                    "launches": launches, "programs": {}}
    v9 = report["values"]
    # each slot's time as a direct session call in phases 4, 7 and 9
    direct_s = {"td": lambda r: td_s[td_roots.index(r)],
                "dir": lambda r: dir_s[dir_roots.index(r)],
                "sssp": lambda r: v9["sssp_s"][td_roots.index(r)],
                "cc": lambda r: v9["cc_s"], "mbfs": lambda r: v9["khop_s"]}
    for kind in ("td", "dir", "sssp", "cc", "mbfs"):
        mine = [(r, res) for kd, r, _, res in done if kd == kind]
        rs = [res for _, res in mine]
        # a batch's results share its exec_s; batches in execution order
        by_batch = {}
        for r, res in mine:
            by_batch.setdefault(res.exec_s, []).append((res.seq, r, res))
        batches = sorted(by_batch.values(),
                         key=lambda ms: min(m[2].queued_s for m in ms))
        cmp = []
        for members in batches:
            members.sort(key=lambda m: m[0])
            res0 = members[0][2]
            slots = [m[1] for m in members]
            if kind != "cc":            # pad slots repeat the first root
                slots += [slots[0]] * (res0.padded_to - len(slots))
            else:                       # the callers share one run
                slots = slots[:1]
            cmp.append((len(members), res0.padded_to, res0.exec_s,
                        sum(direct_s[kind](x) for x in slots),
                        direct_s[kind](slots[0])
                        if res0.padded_to > len(members) else 0.0))
        live = [c[0] for c in cmp]
        pads = sum(c[1] - c[0] for c in cmp if kind != "cc")
        row = {"n": len(rs), "qps": len(rs) / burst_s,
               "queued_s": [res.queued_s for res in rs],
               "exec_s": [res.exec_s for res in rs],
               "batches": cmp, "occupancy": sum(live) / len(live),
               "pad_slots": pads,
               "pad_s": sum(c[2] * (c[1] - c[0]) / c[1] for c in cmp
                            if kind != "cc"),
               "pad_direct_s": sum(c[4] for c in cmp)}
        rep["burst"]["programs"][kind] = row
        log(f"[16 serve] {kind}: {len(rs)} served, queued_s "
            f"{percentiles(row['queued_s'])}, exec_s "
            f"{percentiles(row['exec_s'])}, {row['qps']:.4f} queries/s, "
            f"occupancy {row['occupancy']:.2f}; pad slots {pads}: "
            f"{row['pad_s']:.3f} s of their batches' exec_s, the repeated "
            f"roots {row['pad_direct_s']:.3f} s as direct calls; batches "
            f"in order (live/padded: exec_s vs the same slots' direct "
            f"calls in phases 4 / 7 / 9) " + ", ".join(
                f"{a}/{b}: {e:.3f} vs {d:.3f} s ({e / d - 1:+.2%})"
                for a, b, e, d, _ in cmp))
    log(f"[16 serve] metrics_snapshot aot_cache {snap['aot_cache']}; "
        f"runners {snap['runners']}; mean occupancy "
        f"{snap['mean_occupancy']}, pad_waste_frac {snap['pad_waste_frac']}")
    log(f"[16 serve] launches over the burst {launches}")
    require_launched(launches, ("expand_chunk", "compact_rows", "pack_bits",
                                "unpack_bits", "bottomup_chunk",
                                "expand_chunk_values"),
                     "phase 16's burst")
    rep["aot_cache"] = snap["aot_cache"]
    del srv, sess

    # -- (c) serve-drain: an FT batch loses a device and drains ---------------
    rdir = os.path.join(HERE, "build", "serve_drain")
    shutil.rmtree(rdir, ignore_errors=True)
    ft_config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                          fault_tolerance=True, ckpt_every=2)
    dsrv = GraphServer({name: graph}, ServeConfig(
        max_batch=2, window_s=0.05, recovery_dir=rdir,
        retry=RetryPolicy(max_retries=0, backoff_s=0.0)))
    injector = DeviceLossInjector(3, fires=1)
    tickets = [dsrv.bfs(name, r, config=ft_config, tenant=f"t{i}",
                        injector=injector if i == 0 else None)
               for i, r in enumerate(td_roots[:2])]
    zero_counts()
    torch.cuda.synchronize()
    at_drain = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with dsrv:
        dsrv.drain()
        runners = dsrv.metrics_snapshot()["runners"][name]
    drain_s = time.perf_counter() - t0
    drain_peak = torch.cuda.max_memory_allocated()
    ckpt_bytes = dir_bytes(rdir)
    lost = []
    for k, tk in enumerate(tickets):
        res = tk.result(timeout=60)
        if not res.ok:
            lost.append(res.error)
            continue
        lv, pr, nl, es = scalar[k]
        v = res.value
        if not (torch.equal(v.level.cpu(), lv) and torch.equal(v.pred.cpu(),
                                                               pr)
                and int(v.n_levels) == nl and v.edges_scanned == es):
            raise AssertionError(f"drained bfs {td_roots[k]} differs from "
                                 f"phase 4")
        res.value = v = None
    if lost or runners["recovery_resumes"] != 1 or injector.count != 1:
        raise AssertionError(f"serve-drain: {len(lost)} lost {lost}, "
                             f"resumes {runners['recovery_resumes']}, fires "
                             f"{injector.count}; allocated "
                             f"{at_drain / 2**30:.2f} GiB before, peak "
                             f"{drain_peak / 2**30:.2f} GiB")
    drain_launches = read_counts()
    require_launched(drain_launches, ("expand_chunk", "compact_rows"),
                     "phase 16's serve-drain")
    log(f"[16 serve] serve-drain: 2 top-down roots in one FT batch "
        f"(ckpt_every=2), a device loss at level 3 with max_retries=0: "
        f"0 lost, recovery_resumes {runners['recovery_resumes']}, drained "
        f"{runners['recovery_drained']}, equal to phase 4 (preds "
        f"included); {drain_s:.2f} s; checkpoint directory {ckpt_bytes} B "
        f"({ckpt_bytes / 2**30:.2f} GiB); allocated {at_drain / 2**30:.2f} "
        f"GiB before, peak {drain_peak / 2**30:.2f} GiB; launches "
        f"{drain_launches}")
    shutil.rmtree(rdir, ignore_errors=True)
    rep["drain"] = {"s": drain_s, "ckpt_bytes": ckpt_bytes,
                    "peak_bytes": drain_peak,
                    "resumes": runners["recovery_resumes"],
                    "launches": drain_launches}
    del dsrv, tickets

    # -- (d) release_edges on the resident graph -------------------------------
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    graph.release_edges()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"[16 serve] release_edges(): allocated {before / 2**30:.2f} -> "
        f"{after / 2**30:.2f} GiB (ensure_csr dropped the graph's edges "
        f"in phase 7); peak memory of the warm-up and burst "
        f"{burst_peak / 2**30:.2f} GiB, of the serve-drain "
        f"{drain_peak / 2**30:.2f} GiB")
    rep["release_edges_bytes"] = [before, after]
    rep["peak_bytes"] = burst_peak
    rep["seconds"] = time.perf_counter() - t_phase
    report["serve"] = rep
    phases.end("16 serve")


def run_exchange_8x8(torch, graph, knobs, roots, report):
    """Phase 14b, on phase 11's 8x8 graph: exchange="auto" resolves to the
    butterfly (3 stages); BFS both ways, CC and multi-BFS under list and
    delta equal flat, their traces reading 3 messages a processor a level
    (multi-BFS 0, as in JAX)."""
    from repro_torch.api import BFSConfig

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    C = graph.grid.C
    rows = []
    for codec in ("list", "delta"):
        for direction in (False, True):
            cfg = dict(knobs, fold_codec=codec, direction=direction)
            auto = graph.session(BFSConfig(**cfg, exchange="auto",
                                           telemetry=True))
            flat = graph.session(BFSConfig(**cfg))
            strat = auto.engine.exchange
            if auto.config.exchange != "butterfly" or strat.name != \
                    "butterfly" or strat.msgs_per_exchange(C) != 3:
                raise AssertionError(f"exchange='auto' on 8x8 resolved to "
                                     f"{auto.config.exchange}")
            calls = [("bfs", lambda s: s.bfs(roots[0]), 3)]
            if not direction:
                calls += [("connected_components",
                           lambda s: s.connected_components(fold_codec=codec),
                           3),
                          ("multi_bfs",
                           lambda s: s.multi_bfs(roots, fold_codec=codec), 0)]
            for what, call, msgs in calls:
                a, a_s = timed(torch, lambda: call(auto))
                b, b_s = timed(torch, lambda: call(flat))
                fields = [f.name for f in dataclasses.fields(a)
                          if f.name != "trace" and getattr(a, f.name)
                          is not None]
                if not same(torch, [getattr(a, f) for f in fields],
                            [getattr(b, f) for f in fields]):
                    raise AssertionError(f"{what} ({codec}, direction "
                                         f"{direction}) under the butterfly "
                                         f"differs from flat")
                tr = check_trace(torch, f"8x8 {what} {codec}", a, graph.n,
                                 msgs=msgs)
                rows.append({"what": what, "codec": codec,
                             "direction": direction, "butterfly_s": a_s,
                             "flat_s": b_s, "msgs": tr.total_msgs,
                             "wire": tr.total_wire_bytes})
                log(f"[14b exch-8x8] {what} {codec} direction={direction}: "
                    f"auto -> butterfly equal to flat ({', '.join(fields)});"
                    f" trace {tr.n_levels} levels, {msgs} msgs a processor a"
                    f" level, wire {tr.total_wire_bytes} B; butterfly "
                    f"{a_s:.3f} s, flat {b_s:.3f} s")
    peak = torch.cuda.max_memory_allocated()
    secs = time.perf_counter() - t0
    log(f"[14b exch-8x8] {secs:.1f} s, peak memory {peak / 2**30:.2f} GiB")
    report["exch_8x8"] = {"rows": rows, "seconds": secs, "peak_bytes": peak}


DELTA_ROOTS = 2                  # phase 11 (4 until phase 20 came)


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
                                .manual_seed(args.seed))[:DELTA_ROOTS]]
    roots = roots.tolist()
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
    del gaps_tap, pos_tap
    phases.end("11 delta")
    run_exchange_8x8(torch, graph, knobs, roots, report)
    phases.end("14b exch-8x8")
    del graph, edges, weights, index
    torch.cuda.empty_cache()


def parity_random_stages(torch, dev, gen, F, S) -> None:
    """Phase 12a: B10 and B11 against their plain versions on random
    inputs, bit for bit, at tiles 64, 256, 512 and 1024."""
    tiles = (64, 256, 512, 1024)
    for n_seg, shift in ((100, 0), (100, 5), (1 << 20, 0)):
        deg = torch.randint(0, 9, (n_seg,), generator=gen, device=dev,
                            dtype=torch.int32)
        deg[n_seg // 4:n_seg // 2] = 0          # a zero-degree run
        cumul = F.exclusive_cumsum(deg) + shift  # shift: lanes < cumul[0]
        err, calls = 0, 0
        for ft in (0, n_seg // 3, n_seg):
            cc = S.clip_cumul(cumul, ft)
            total = int(cumul[ft])
            for tile in tiles:
                E = max(4 * tile, min(1 << 20, 64 * n_seg))
                E -= E % tile
                for start in (0, max(total - E // 2, 0)):   # straddles
                    gids = start + torch.arange(E, dtype=torch.int32,
                                                device=dev)
                    err += check_equal(
                        torch, "binsearch_map",
                        (S.binsearch_map(cc, gids, tile=tile),),
                        (S.map_workload(gids, cc),))
                    calls += 1
        log(f"[12 stages] binsearch_map random n_cumul {n_seg + 1} (cumul "
            f"+ {shift}, a zero-degree run), front_total 0 / n/3 / n, "
            f"tiles {tiles}, chunks from 0 and straddling the live total: "
            f"{calls} calls, max_abs_err {err}")
    SC = stage_cases()
    for name in SC.BINSEARCH_CASES:
        c = SC.binsearch_case(name)
        cc = S.clip_cumul(torch.from_numpy(c["cumul"]).to(dev),
                          c["front_total"])
        gids = torch.from_numpy(c["gids"]).to(dev)
        err = check_equal(torch, f"binsearch_map {name}",
                          (S.binsearch_map(cc, gids, tile=c["tile"]),),
                          (S.map_workload(gids, cc),))
        log(f"[12 stages] binsearch_map stage case {name} n_cumul "
            f"{cc.shape[0]} E={gids.shape[0]} tile {c['tile']}: max_abs_err "
            f"{err}")
    n_rows = (1 << 21) + 5                      # n_rows % 32 != 0
    nw = (n_rows + 31) // 32
    E = 1 << 20
    for words_kind in ("random", "all visited", "all clear"):
        if words_kind == "random":
            words = torch.randint(-2**31, 2**31 - 1, (nw,), generator=gen,
                                  device=dev, dtype=torch.int32)
        else:
            words = torch.full((nw,), -1 if words_kind == "all visited"
                               else 0, dtype=torch.int32, device=dev)
        err, calls = 0, 0
        for tile in tiles:
            for p_valid, span in ((0.7, n_rows), (0.7, 2 * tile // 3),
                                  (0.0, n_rows)):
                v = torch.randint(0, span, (E,), generator=gen, device=dev,
                                  dtype=torch.int32)
                valid = torch.rand(E, generator=gen, device=dev) < p_valid
                err += check_equal(
                    torch, "visited_filter",
                    (S.visited_filter(v, valid, words, tile=tile),),
                    (S.filter_tile(v, valid, words, tile),))
                calls += 1
        log(f"[12 stages] visited_filter random {words_kind} words, n_rows "
            f"{n_rows}, tiles {tiles}, valid 0.7 / all invalid, distinct / "
            f"duplicated vertices: {calls} calls, max_abs_err {err}")
    for name in SC.FILTER_CASES:
        err = 0
        for tile in SC.FILTER_TILES:
            args = SC.filter_args(SC.filter_case(name, tile), dev)
            err += check_equal(torch, f"visited_filter {name} tile {tile}",
                               (S.visited_filter(*args, tile=tile),),
                               (S.filter_tile(*args, tile),))
        log(f"[12 stages] visited_filter stage case {name}, tiles "
            f"{SC.FILTER_TILES}: max_abs_err {err}")
    torch.cuda.synchronize()


def run_stages(torch, args, graph, roots, scalar, chunk, b1, kernels,
               report, phases):
    """Phase 12: the kernel-stage surface on the resident SCALE 26 graph.
    chunk: the real chunk phase 3b held B1 to, (start, E, cumul, front,
    front_total, col_off, row_idx, words); b1: B1's (v, won, u) on it."""
    from repro_torch.api import BFSConfig
    from repro_torch.core import frontier as F
    from repro_torch.core.partition import global_from_row
    from repro_torch.kernels import expand as K
    from repro_torch.kernels import stages as S
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_kernel_bench

    dev = graph.device
    grid = graph.grid
    n = graph.n
    parity_random_stages(torch, dev, torch.Generator(device=dev).manual_seed(
        args.seed + 12), F, S)

    # -- the surface driven once, through its entry points ------------------
    zero_counts()
    start, E, cumul, front, ftot, col_off, row_idx, words = chunk
    v1, won1, u1 = b1
    ncl = front.shape[0]
    gids = start + torch.arange(E, dtype=torch.int32, device=dev)
    cc = S.clip_cumul(cumul, ftot)
    k = S.binsearch_map(cc, gids)
    valid = gids < cumul[ftot]
    won = S.visited_filter(v1, valid, words, tile=512)
    if not torch.equal(front.clamp(0, ncl - 1)[k.clamp(0, ncl - 1)], u1):
        raise AssertionError("front[binsearch_map] differs from B1's u on "
                             "the real chunk")
    if not torch.equal(won, won1):
        raise AssertionError("visited_filter differs from B1's won on the "
                             "real chunk")
    log(f"[12 stages] real chunk start={start} E={E} (SCALE {args.scale}): "
        f"front[binsearch_map] equals B1's u and visited_filter(tile=512) "
        f"equals B1's won on every lane ({int(won.sum())} winners)")

    # local_expand over block (0, 0) at the root's most populous level
    level = scalar[0][0][:n].to(dev)
    L = int(torch.bincount(level[level >= 0].long()).argmax())
    cols = torch.nonzero(level[:grid.n_cols_local] == L).flatten() \
        .to(torch.int32)
    lr = torch.arange(grid.n_rows_local, device=dev)
    row_level = level[global_from_row(lr, 0, grid)]
    visited = (row_level >= 0) & (row_level < L)
    csc = (graph.csc.col_off[0, 0], graph.csc.row_idx[0, 0])
    b1_before = K.expand_chunk.launches
    kout, k_s = timed(torch, lambda: K.local_expand(
        (cols, cols.numel()), csc, visited, path="kernel",
        edge_chunk=args.edge_chunk))
    b1_local = K.expand_chunk.launches - b1_before
    rout, r_s = timed(torch, lambda: K.local_expand(
        (cols, cols.numel()), csc, visited, path="reference",
        edge_chunk=args.edge_chunk))
    for f in ("verts", "parents", "count", "visited", "edges_scanned"):
        if not torch.equal(getattr(kout, f), getattr(rout, f)):
            raise AssertionError(f"local_expand kernel path differs from "
                                 f"reference on {f}")
    log(f"[12 stages] local_expand block (0, 0), root {roots[0]} level {L}: "
        f"{cols.numel()} frontier cols, {int(visited.sum())} rows visited "
        f"before, {int(kout.edges_scanned)} edges, {int(kout.count)} "
        f"discoveries; kernel path {k_s:.4f} s ({b1_local} B1 launches), "
        f"reference {r_s:.4f} s, equal on all five fields")
    del kout, rout, visited, row_level, lr, cols

    # the custom chunk hook (A17): one root through make_expand_fn
    hook_cfg = BFSConfig(grid=(grid.R, grid.C), edge_chunk=args.edge_chunk,
                         expand_fn=K.make_expand_fn(path="kernel"))
    hsess = graph.session(hook_cfg)
    assert hsess.engine.expand_path == "custom" \
        and hsess.engine.value_expand_fn is None
    b1_before = K.expand_chunk.launches
    out, hook_s = timed(torch, lambda: hsess.bfs(roots[0]))
    b1_hook = K.expand_chunk.launches - b1_before
    lv, pr, nl, es = scalar[0]
    if not same(torch, (out.level, out.pred, int(out.n_levels),
                        out.edges_scanned), (lv, pr, nl, es)):
        raise AssertionError("BFSConfig(expand_fn=make_expand_fn()) differs "
                             "from phase 4")
    if b1_hook <= 0:
        raise AssertionError("the custom hook launched no B1")
    log(f"[12 stages] BFSConfig(expand_fn=make_expand_fn(path='kernel')) "
        f"root {roots[0]}: equal to phase 4 (levels, preds, n_levels "
        f"{nl}, edges_scanned {es}), {hook_s:.3f} s, {b1_hook} B1 launches "
        f"through the hook")
    graph._engines.pop(hook_cfg.engine_key)
    del out, hsess

    bench_rows = torch_kernel_bench.run(dev)
    launches = read_counts()
    log(json.dumps({"kernel_bench": bench_rows}))
    log(f"[12 stages] launches over the surface's run {launches}")
    require_launched(launches, ("binsearch_map", "visited_filter",
                                "expand_chunk"), "the kernel-stage surface")
    report["stages"] = {"level": L, "local_expand_kernel_s": k_s,
                        "local_expand_reference_s": r_s,
                        "local_expand_b1_launches": b1_local,
                        "hook_bfs_s": hook_s, "hook_b1_launches": b1_hook,
                        "kernel_bench": bench_rows, "launches": launches}

    # -- B10 and B11 on the real chunk: parity, time, bound ------------------
    err = check_equal(torch, "binsearch_map on the real chunk", (k,),
                      (S.map_workload(gids, cc),))
    k_first, k_last = int(k[0]), int(k[-1])
    # gid in and k out per lane + each spanned cumul slot
    m_bytes = 8 * E + 4 * (k_last - k_first + 1)
    m_ms = cuda_ms_cold(torch, lambda: S.binsearch_map(cc, gids))
    m_warm = cuda_ms(torch, lambda: S.binsearch_map(cc, gids))
    m_plain = cuda_ms_cold(torch, lambda: S.map_workload(gids, cc), reps=3)
    m_lib = cuda_ms_cold(torch, lambda: torch.searchsorted(
        cc, gids, right=True, out_int32=True))
    kernels.append(kernel_row(
        "binsearch_map", "src/repro_torch/csrc/stages.cu",
        "src/repro/kernels/_binsearch_map.py:100",
        launches["binsearch_map"], err, m_ms, m_plain, m_bytes,
        library_ms=m_lib))
    log(f"[12 stages] binsearch_map real chunk E={E} cumul slots "
        f"{k_last - k_first + 1}: max_abs_err {err}; with the L2 flushed "
        f"before each call: kernel {m_ms:.4f} ms, plain {m_plain:.4f} ms, "
        f"torch.searchsorted (without the -1) {m_lib:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.5f} ms ({m_bytes} B), "
        f"{kernels[-1]['bound_ms'] / m_ms:.3f} of it; back to back from "
        f"L2: kernel {m_warm:.4f} ms")
    err = check_equal(torch, "visited_filter on the real chunk", (won,),
                      (S.filter_tile(v1, valid, words, 512),))
    n_words = int(torch.unique(v1[valid] >> 5).numel())
    # v, valid in and won out per lane + each distinct visited word
    f_bytes = 6 * E + 4 * n_words
    f_ms = cuda_ms(torch, lambda: S.visited_filter(v1, valid, words,
                                                   tile=512))
    f_plain = cuda_ms(torch, lambda: S.filter_tile(v1, valid, words, 512),
                      reps=3)
    kernels.append(kernel_row(
        "visited_filter", "src/repro_torch/csrc/stages.cu",
        "src/repro/kernels/_visited_filter.py:46",
        launches["visited_filter"], err, f_ms, f_plain, f_bytes))
    log(f"[12 stages] visited_filter real chunk E={E} tile 512, valid "
        f"{int(valid.sum())}, distinct words {n_words}: max_abs_err {err}; "
        f"kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms ({f_bytes} B)")
    report["stages"].update(binsearch_ms=m_ms, binsearch_warm_ms=m_warm,
                            binsearch_plain_ms=m_plain,
                            searchsorted_ms=m_lib, filter_ms=f_ms,
                            filter_plain_ms=f_plain)
    phases.end("12 stages")


# ----------------------------------------------------------------------------
# Phase 17: the process group on the card
# ----------------------------------------------------------------------------

GROUP_WORLD = 4                  # phase 17: gloo ranks sharing the card
GROUP_TIMEOUT_S = 900            # a leg's deadline (every rank killed after)
GROUP_PIECE = 1 << 26            # edges copied to the disk file at a time


def save_group_inputs(torch, gdir, edges, weights, n, refs) -> dict:
    """Phase 17's inputs on disk: the edge list and weights as .npy files
    every rank memory-maps, and the stacked outputs it is held to (each a
    .npy, their scalars in meta.json).  refs: {name: tensor or int}.
    Returns the meta dict (also written)."""
    import numpy as np

    os.makedirs(gdir, exist_ok=True)
    t0 = time.perf_counter()
    E = edges.shape[1]
    em = np.lib.format.open_memmap(os.path.join(gdir, "edges.npy"),
                                   mode="w+", dtype=np.int32, shape=(2, E))
    wm = np.lib.format.open_memmap(os.path.join(gdir, "weights.npy"),
                                   mode="w+", dtype=np.uint8, shape=(E,))
    for a in range(0, E, GROUP_PIECE):
        b = min(a + GROUP_PIECE, E)
        em[:, a:b] = edges[:, a:b].cpu().numpy()
        wm[a:b] = weights[a:b].cpu().numpy()
    em.flush()
    wm.flush()
    del em, wm
    meta = {"n": n, "edges": E, "ints": {}}
    for name, v in refs.items():
        if isinstance(v, torch.Tensor):
            np.save(os.path.join(gdir, f"ref_{name}.npy"), v.cpu().numpy())
        else:
            meta["ints"][name] = v
    with open(os.path.join(gdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    meta["write_s"] = time.perf_counter() - t0
    return meta


def add_group_refs(torch, gdir, meta, refs) -> None:
    """More stacked references for phase 17 under `gdir` (tensors as .npy,
    ints into meta.json), as `save_group_inputs` writes them."""
    import numpy as np
    for name, v in refs.items():
        if isinstance(v, torch.Tensor):
            np.save(os.path.join(gdir, f"ref_{name}.npy"), v.cpu().numpy())
        else:
            meta["ints"][name] = v
    with open(os.path.join(gdir, "meta.json"), "w") as f:
        json.dump({k: v for k, v in meta.items() if k != "write_s"}, f)


def save_group_features(torch, gdir, graph, args, root, meta) -> float:
    """Phase 17's stacked references of the search's contract, on the
    resident graph: the LevelTrace of a top-down `bfs(root)` with
    telemetry=True (ref_trace.npz) and the UnrecoverableLoss snapshots of
    a loss at level 3 (ckpt_every=2, no retry) of that `bfs` and of CC,
    written as checkpoint directories (ref_snap_bfs, ref_snap_cc).
    Returns the seconds taken."""
    import numpy as np

    from repro_torch.api import BFSConfig
    from repro_torch.runtime import (DeviceLossInjector,
                                     TraversalCheckpointer,
                                     UnrecoverableLoss)
    t0 = time.perf_counter()
    base = dict(grid=(graph.grid.R, graph.grid.C),
                edge_chunk=args.edge_chunk)
    out = graph.session(BFSConfig(**base, telemetry=True)).bfs(root)
    tr = out.trace
    np.savez(os.path.join(gdir, "ref_trace.npz"), **{
        f.name: np.asarray(getattr(tr, f.name))
        for f in dataclasses.fields(tr)})
    del out
    fs = graph.session(BFSConfig(**base, fault_tolerance=True,
                                 ckpt_every=2))
    for what, call in (("bfs", lambda p: fs.bfs(root, recovery=p)),
                       ("cc", lambda p: fs.connected_components(
                           recovery=p))):
        plan = ft_plan(torch, injector=DeviceLossInjector(3, fires=1),
                       retries=0)
        try:
            call(plan)
            raise AssertionError(f"phase 17's {what} loss did not fire")
        except UnrecoverableLoss as e:
            ck = TraversalCheckpointer(os.path.join(gdir, f"ref_snap_{what}"),
                                       what, async_write=False)
            ck.save(e.snapshot)
    meta["ints"]["feature_root"] = int(root)
    return time.perf_counter() - t0


class NpyFile:
    """A .npy array on disk that the partition streams a slice at a time:
    `x[row, a:b]` (2-D) or `x[a:b]` (1-D) reads just that run with one
    read() into a fresh array -- several times faster than copying the
    same run out of a memory map, page fault by page fault."""

    def __init__(self, path):
        import numpy as np
        mm = np.load(path, mmap_mode="r")
        self.path, self.shape, self.dtype = path, mm.shape, mm.dtype
        self.offset = mm.offset
        del mm

    def __getitem__(self, idx):
        import numpy as np
        row, sl = idx if len(self.shape) == 2 else (0, idx)
        a, b, _ = sl.indices(self.shape[-1])
        start = self.offset + (row * self.shape[-1] + a) * self.dtype.itemsize
        return np.fromfile(self.path, dtype=self.dtype, count=max(b - a, 0),
                           offset=start)


def launch_ranks(cmds, logs, timeout):
    """Start every rank (stdout and stderr to its log file), wait for all
    under one deadline, kill the rest when one fails or the deadline
    passes.  Returns the exit codes."""
    procs = []
    # the ranks share one card: growable segments keep one rank's freed
    # blocks from pinning memory the others need
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    for cmd, path in zip(cmds, logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f, env=env,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [p.returncode for p in procs]


def run_group_leg(torch, gdir, leg, world, backend, timeout):
    """One leg of phase 17: `world` ranks of this script on cuda:0 under
    `backend`.  Returns every rank's result dict; raises (with the ranks'
    logs' tails) unless every rank exits 0 in time."""
    store = os.path.join(gdir, f"store-{leg}")
    if os.path.exists(store):
        os.remove(store)
    cmds = [[sys.executable, os.path.abspath(__file__), "--group-rank",
             str(k), "--group-world", str(world), "--group-backend",
             backend, "--group-dir", gdir, "--group-leg", leg]
            for k in range(world)]
    logs = [os.path.join(gdir, f"{leg}-rank{k}.log") for k in range(world)]
    t0 = time.perf_counter()
    codes = launch_ranks(cmds, logs, timeout)
    wall = time.perf_counter() - t0
    if codes != [0] * world:
        tails = []
        for k, path in enumerate(logs):
            with open(path) as f:
                tails.append(f"--- {leg} rank {k} (exit {codes[k]}) ---\n"
                             + f.read()[-4000:])
        raise AssertionError(f"phase 17 leg {leg}: rank exit codes {codes} "
                             f"after {wall:.1f} s (deadline {timeout} s)\n"
                             + "\n".join(tails))
    results = []
    for k in range(world):
        with open(os.path.join(gdir, f"{leg}-rank{k}.json")) as f:
            results.append(json.load(f))
    return results, wall


def log_group_features(leg, res) -> None:
    """Print one rank's measurements of legs (a)-(d)."""
    k, f = res["rank"], res["features"]

    def secs(xs):
        return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"
    log(f"[17 group] {leg} rank {k} (a) trace of {f['trace_levels']} "
        f"levels equal to the stacked one; fetch s in its assembly "
        f"{secs(f['trace_fetch_s'])}")
    if "broken_s" in f:
        log(f"[17 group] {leg} rank {k} (b) validate=True and validate=edges"
            f" passed; leaf {f['broken_leaf']} cut off: "
            f"{f['broken_message']!r} in {f['broken_s']:.3f} s")
    log(f"[17 group] {leg} rank {k} (c) snapshot exports ms "
        f"{', '.join(f'{x * 1e3:.1f}' for x in f['export_s'])} (fetch s "
        f"{secs(f['export_fetch_s'])}); checkpoint s (rank 0 writes, all "
        f"wait) {secs(f['ckpt_s'])}")
    for q in f["ft"]:
        log(f"[17 group] {leg} rank {k} (c) FT {q['query']}: equal to the "
            f"stacked session after {q['retries']} retry, "
            f"{q['checkpoints']} checkpoints, the directory reloaded in "
            f"{q['load_s']:.3f} s; the loss snapshot ({q['snapshot_bytes']}"
            f" B, after level {q['levels_done']}) equal to the stacked one")
    if "elastic_plan_s" in f:
        grids = " -> ".join(f"{a}x{b}" for a, b in f["elastic_grids"])
        log(f"[17 group] {leg} rank {k} (d) elastic {grids}, resumed from "
            f"level {f['resumed_from']}: equal to phase 15 (e); plan s "
            f"{secs(f['elastic_plan_s'])}; time_to_first_resumed_level_s "
            f"{f['t_first_resumed_s']}")


def run_group(torch, gdir, meta, report, phases):
    """Phase 17, in the parent: the gloo leg (GROUP_WORLD ranks on the one
    card, one processor each) and the NCCL leg (one rank, the whole grid),
    every rank's outputs held to the stacked session's; each rank's wall
    time per query, collective time, launches and peak memory printed."""
    rep = {"write_s": meta["write_s"]}
    ints = meta["ints"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[17 group] this process holds {held:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved on the card the ranks share")
    for leg, world, backend in (("gloo", GROUP_WORLD, "gloo"),
                                ("nccl", 1, "nccl")):
        results, wall = run_group_leg(torch, gdir, leg, world, backend,
                                      GROUP_TIMEOUT_S)
        for res in results:
            k = res["rank"]
            log(f"[17 group] {leg} rank {k}/{world} block {res['block']}: "
                f"planned in {res['plan_s']:.1f} s (CSR twin "
                f"{res['csr_s']:.1f} s), "
                f"{res['resident_bytes'] / 2**30:.2f} GiB resident after "
                f"planning, peak memory {res['peak_bytes'] / 2**30:.2f} GiB")
            for q in res["queries"]:
                coll = ", ".join(f"{c} {s:.3f}" for c, s in
                                 q["collective_s"].items())
                log(f"[17 group] {leg} rank {k} {q['exchange']} "
                    f"{q['query']}: {q['s']:.3f} s wall, equal to the "
                    f"stacked session; in collectives {coll} s; launches "
                    f"{q['launches']}")
        for res in results:
            log_group_features(leg, res)
        if leg == "gloo":
            said = {r["features"]["broken_message"] for r in results}
            log(f"[17 group] gloo (b) the broken output failed on every "
                f"rank with one message: {sorted(said)}")
        # every rank's td scalar queries, slowest rank -> the group's time
        teps = []
        for key, m in (("bfs_r0", ints["m_r0"]), ("bfs_r1", ints["m_r1"])):
            ts = [q["s"] for r in results for q in r["queries"]
                  if q["query"] == key and q["exchange"] == "flat"]
            if ts:
                teps.append(m / max(ts))
        if teps:
            hm = len(teps) / sum(1 / t for t in teps)
            note = (f"{world} ranks sharing one card over host-staged gloo: "
                    "a correctness run, not a scaling figure") \
                if backend == "gloo" else \
                "one NCCL rank holding the whole grid on one card"
            log(f"[17 group] {leg} top-down TEPS of the group "
                f"{hm:.6e} ({note})")
            rep[f"{leg}_teps"] = hm
        rep[leg] = {"wall_s": wall, "ranks": results}
        log(f"[17 group] {leg} leg: {world} ranks done in {wall:.1f} s")
    report["group"] = rep
    phases.end("17 group")


def snapshot_equal(np, a, b, path=""):
    """Two snapshot trees equal: keys, dtypes, shapes and values; returns
    the first difference's path, or None."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) \
                or sorted(a) != sorted(b):
            return path or "/"
        for key in a:
            bad = snapshot_equal(np, a[key], b[key], f"{path}/{key}")
            if bad is not None:
                return bad
        return None
    a, b = np.asarray(a), np.asarray(b)
    same = a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return None if same else path


def group_features(torch, args, graph, edges, mesh, gdir, ints, n, run,
                   bfs_checks, ref, spent) -> dict:
    """Phase 17 (a)-(c) on one rank (see the module docstring): each
    query through `run` (held to the stacked outputs, timed, launches
    read), the trace, validation messages and snapshots checked here.
    Returns the rank's measurements."""
    import numpy as np

    from repro_torch.algos.engine import FrontierEngine
    from repro_torch.api import BFSConfig
    from repro_torch.obs import trace as T
    from repro_torch.runtime import (DeviceLossInjector,
                                     TraversalCheckpointer,
                                     UnrecoverableLoss)
    from repro_torch.runtime import recovery

    k, leg = mesh.rank, args.group_leg
    R, C = mesh.shape
    r0 = ints["feature_root"]
    base = dict(grid=(R, C), edge_chunk=args.edge_chunk)
    b1b2 = ("expand_chunk", "compact_rows")
    rep = {"trace_fetch_s": [], "export_s": [], "export_fetch_s": [],
           "ckpt_s": []}

    # host seconds (and fetch seconds) of the trace's assembly, a
    # snapshot's export and a checkpoint's write
    def timed(owner, name, secs, fetches=None):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            f0, t0 = spent["fetch"], time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if fetches is not None:
                fetches.append(spent["fetch"] - f0)
            return out
        setattr(owner, name, wrapper)
        return fn
    trace_sink = []
    orig = [(T, "assemble_traces", timed(T, "assemble_traces", trace_sink,
                                          rep["trace_fetch_s"])),
            (FrontierEngine, "export_carry",
             timed(FrontierEngine, "export_carry", rep["export_s"],
                   rep["export_fetch_s"])),
            # rank 0's write and every rank's wait for its outcome
            (recovery, "_save_together",
             timed(recovery, "_save_together", rep["ckpt_s"]))]

    # (a) a top-down search with telemetry=True: its trace == stacked
    want = dict(np.load(os.path.join(gdir, "ref_trace.npz")))
    ts = graph.session(BFSConfig(**base, telemetry=True))
    out = run("traced_bfs", "flat", lambda: ts.bfs(r0), bfs_checks("td0"),
              b1b2)
    for f, w in want.items():
        if not np.array_equal(np.asarray(getattr(out.trace, f)), w):
            raise AssertionError(f"rank {k}: trace field {f} differs "
                                 f"from the stacked session's")
    rep["trace_levels"] = int(out.trace.n_levels)

    # (b) Graph500 validation over every rank's share, passing, then one
    # output broken the same way on every rank failing together
    s = graph.session(BFSConfig(**base))
    if leg == "gloo":
        run("bfs_validate_true", "flat", lambda: s.bfs(r0, validate=True),
            bfs_checks("td0"), b1b2)
        run("bfs_validate_edges", "flat",
            lambda: s.bfs(r0, validate=edges), bfs_checks("td0"), b1b2)
        lv, pr = out.level.clone(), out.pred.clone()
        # a leaf (no vertex names it parent) cut off: only its edges, on
        # some ranks' shares, see a visited vertex next to an unvisited one
        kids = torch.bincount(pr[pr >= 0].long(), minlength=lv.numel())
        leaf = int(torch.nonzero((lv > 0) & (kids == 0))[0])
        lv[leaf] = pr[leaf] = -1
        bad = dataclasses.replace(out, level=lv, pred=pr, trace=None)
        t0 = time.perf_counter()
        try:
            s._validate(bad, np.asarray(r0), True)
            raise AssertionError(f"rank {k}: the broken output passed")
        except AssertionError as e:
            rep["broken_message"] = str(e)
        rep["broken_s"] = time.perf_counter() - t0
        if rep["broken_message"] != \
                "edge joins visited and unvisited (incomplete BFS)":
            raise AssertionError(f"rank {k}: the broken output failed "
                                 f"with {rep['broken_message']!r}")
        rep["broken_leaf"] = leaf
    del out

    # (c) fault tolerance: a transient loss at level 3 with a checkpoint
    # directory, the directory reloaded by every rank, and the snapshot of
    # a loss at level 3 == the stacked one
    fs = graph.session(BFSConfig(**base, fault_tolerance=True, ckpt_every=2))
    cc_checks = (lambda o: [("labels", ref("cc_labels")),
                            ("n_iters", np.asarray(ints["cc_iters"])),
                            ("edges_scanned", np.asarray(ints["cc_edges"]))])
    queries = [("bfs", lambda p: fs.bfs(r0, recovery=p), bfs_checks("td0"),
                b1b2)]
    if leg == "gloo":
        queries.append(("cc", lambda p: fs.connected_components(recovery=p),
                        cc_checks, ("expand_chunk_values",)))
    rep["ft"] = []
    for what, call, checks, need in queries:
        stacked = TraversalCheckpointer(
            os.path.join(gdir, f"ref_snap_{what}"), what).load()
        d = os.path.join(gdir, f"ckpt-{leg}-{what}")
        plan = ft_plan(torch, injector=DeviceLossInjector(
            3, transient=True), checkpointer=TraversalCheckpointer(
                d, what))
        n0 = len(rep["ckpt_s"])
        out = run(f"ft_{what}", "flat", lambda: call(plan), checks, need)
        check_retries(plan, f"rank {k}'s FT {what}")
        if plan.injector.count != 1:
            raise AssertionError(f"rank {k}: FT {what} fired "
                                 f"{plan.injector.count} times")
        retries = plan.stats["retries"]
        t0 = time.perf_counter()
        disk = TraversalCheckpointer(d, what).load()
        load_s = time.perf_counter() - t0
        st = disk["arrays"]["st"]
        st = st.get("b0", st)
        final = st["level"] if what == "bfs" else st["val"]
        want = ref("td0_level" if what == "bfs" else "cc_labels")[:n]
        if not np.array_equal(final, want):
            raise AssertionError(f"rank {k}: the checkpoint directory's "
                                 f"last {what} snapshot differs")
        del out, disk, st, final
        plan = ft_plan(torch, injector=DeviceLossInjector(3, fires=1),
                       retries=0)
        e0 = len(rep["export_s"])
        try:
            call(plan)
            raise AssertionError(f"rank {k}: the {what} loss did not "
                                 f"escalate")
        except UnrecoverableLoss as e:
            snap = e.snapshot
        bad = snapshot_equal(np, snap["arrays"], stacked["arrays"])
        if bad is not None or snap["meta"] != stacked["meta"]:
            raise AssertionError(f"rank {k}: the {what} loss snapshot "
                                 f"differs from the stacked one at "
                                 f"{bad or 'meta'}")
        rep["ft"].append({
            "query": what, "checkpoints": len(rep["ckpt_s"]) - n0,
            "retries": retries, "load_s": load_s,
            "snapshot_bytes": snapshot_bytes(snap["arrays"]),
            "loss_export_s": rep["export_s"][e0:],
            "levels_done": snap["meta"]["levels_done"]})
        del snap
    for owner, name, fn in orig:
        setattr(owner, name, fn)
    torch.cuda.empty_cache()
    return rep


def group_elastic(torch, args, edges, n, run, ref, ints) -> dict:
    """Phase 17 (d) on one rank: phase 15 (e)'s elastic BFS (a persistent
    loss at level 3, 2x2 -> 1x3) across the group, every rank's output
    equal to 15 (e)'s.  Returns the rank's measurements."""
    import numpy as np

    from repro_torch.api import BFSConfig
    from repro_torch.runtime import DeviceLossInjector, ElasticCoordinator

    R, C = (int(x) for x in args.grid.lower().split("x"))
    plans = []

    class Timed(ElasticCoordinator):
        """Times each plan of a grid (the first one, then the re-plan)."""

        def _plan(self, config, mesh=None):
            t0 = time.perf_counter()
            out = super()._plan(config, mesh)
            torch.cuda.synchronize()
            plans.append(time.perf_counter() - t0)
            return out

    config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                       fault_tolerance=True, ckpt_every=1)
    coord = Timed(edges, config, n=n)
    plan = ft_plan(torch, injector=DeviceLossInjector(3, fires=3))
    run("elastic_bfs", "flat", lambda: coord.run("bfs", ints["root0"],
                                                 plan=plan),
        lambda o: [("level", ref("el_level")), ("pred", ref("el_pred")),
                   ("n_levels", np.asarray(ints["el_n_levels"])),
                   ("edges_scanned", np.asarray(ints["el_edges"]))])
    if coord.grids != [(R, C), (1, 3)] or coord.shrinks != 1:
        raise AssertionError(f"elastic grids {coord.grids}")
    torch.cuda.empty_cache()
    return {"elastic_plan_s": plans, "elastic_grids": coord.grids,
            "t_first_resumed_s": plan.stats["time_to_first_resumed_level_s"],
            "resumed_from": plan.stats["resumed_from_level"]}


def group_rank_main(args) -> int:
    """A rank of phase 17 (`--group-rank`): join the leg's group on
    cuda:0, plan this rank's blocks from the memory-mapped edge list, run
    the leg's queries under each exchange, hold every output to the
    stacked session's (read from disk), write the rank's measurements."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.dist import multihost
    from repro_torch.dist.topology import GroupTopology

    gdir, leg, k = args.group_dir, args.group_leg, args.group_rank
    with open(os.path.join(gdir, "meta.json")) as f:
        meta = json.load(f)
    ints, n = meta["ints"], meta["n"]
    R, C = (int(x) for x in args.grid.lower().split("x"))
    multihost.initialize("file://" + os.path.join(gdir, f"store-{leg}"),
                         args.group_world, k, device="cuda:0",
                         backend=args.group_backend,
                         timeout_s=GROUP_TIMEOUT_S)
    mesh = multihost.global_mesh((R, C))
    torch.cuda.reset_peak_memory_stats()

    # the timer around the topology's three collectives (and the fetch of
    # the outputs), the card synchronised on both sides
    spent = {"row_gather": 0.0, "col_all_to_all": 0.0, "psum_all": 0.0,
             "fetch": 0.0}
    for name in spent:
        fn = getattr(GroupTopology, name)

        def timed_call(self, *a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(self, *a, **kw)
            torch.cuda.synchronize()
            spent[_name] += time.perf_counter() - t0
            return out
        setattr(GroupTopology, name, timed_call)

    edges = NpyFile(os.path.join(gdir, "edges.npy"))
    weights = NpyFile(os.path.join(gdir, "weights.npy"))
    t0 = time.perf_counter()
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk), mesh=mesh,
        n=n, weights=weights)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    # the ranks share the card: hand the partition's freed temporaries back
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()

    def ref(name):
        return np.load(os.path.join(gdir, f"ref_{name}.npy"), mmap_mode="r")

    def check(what, got, want):
        g = got.cpu().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        if g.shape != want.shape or not np.array_equal(g, want):
            raise AssertionError(f"rank {k} {what} differs from the stacked "
                                 f"session's")

    queries = []

    def run(name, exchange, fn, checks, need=()):
        zero_counts()
        for c in spent:
            spent[c] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for field, want in checks(out):
            check(f"{exchange} {name} {field}", field_of(out, field), want)
        counts = {c: v for c, v in read_counts().items() if v}
        require_launched(read_counts(), need, f"rank {k}'s {name}")
        queries.append({"query": name, "exchange": exchange, "s": dt,
                        "collective_s": dict(spent), "launches": counts})
        return out

    def field_of(out, field):
        if "[" in field:
            f, b = field[:-1].split("[")
            return getattr(out, f)[int(b)]
        return getattr(out, field)

    def bfs_checks(tag, b=None):
        def checks(out):
            sfx = "" if b is None else f"[{b}]"
            return [(f"level{sfx}", ref(f"{tag}_level")),
                    (f"pred{sfx}", ref(f"{tag}_pred")),
                    (f"n_levels{sfx}", np.asarray(ints[f"{tag}_n_levels"])),
                    (f"edges_scanned{sfx}",
                     np.asarray(ints[f"{tag}_edges"]))]
        return checks

    r0, r1 = ints["root0"], ints["root1"]
    b1b2 = ("expand_chunk", "compact_rows")
    exchanges = ("flat", "butterfly") if leg == "gloo" else ("flat",)
    csr_s = 0.0
    # the first search of a group pays for its transports' set-up (NCCL
    # builds a communicator a group at its first collective): a warm-up
    warm = graph.session(BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk))
    run("warm-up", "flat", lambda: warm.bfs(r1), bfs_checks("td1"), b1b2)
    # the contract's legs (a)-(c) while the graph holds its edge list (the
    # direction session below drops it), (d) last
    features = group_features(torch, args, graph, edges, mesh, gdir, ints,
                              n, run, bfs_checks, ref, spent)
    # cut for phase 20's time: every query runs once (the NCCL leg ran
    # each twice), r1 alone runs in the warm-up only, and the butterfly
    # pass runs no batch (its batch of r0 was the scalar search's B = 1
    # entry again)
    for ex in exchanges:
        cfg = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                        exchange=ex)
        s = graph.session(cfg)
        run("bfs_r0", ex, lambda: s.bfs(r0), bfs_checks("td0"), b1b2)
        if leg == "gloo" and ex == "flat":
            run("bfs_batch", ex, lambda: s.bfs([r0, r1]),
                lambda o: bfs_checks("td0", 0)(o)
                + bfs_checks("td1", 1)(o), b1b2)
        run("cc", ex, s.connected_components,
            lambda o: [("labels", ref("cc_labels")),
                       ("n_iters", np.asarray(ints["cc_iters"])),
                       ("edges_scanned", np.asarray(ints["cc_edges"]))])
        if leg != "gloo":
            continue
        run("sssp", ex, lambda: s.sssp(ints["sssp_root"]),
            lambda o: [("dist", ref("sssp_dist")),
                       ("n_iters", np.asarray(ints["sssp_iters"])),
                       ("edges_scanned", np.asarray(ints["sssp_edges"]))])
        t0 = time.perf_counter()
        ds = graph.session(dataclasses.replace(
            cfg, direction=True, fold_codec="bitmap"))
        torch.cuda.synchronize()
        csr_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        run("bfs_dir", ex, lambda: ds.bfs(ints["dir_root"]),
            lambda o: bfs_checks("dir")(o)
            + [("directions", ref("dir_directions"))],
            b1b2 + ("bottomup_chunk",))
    if leg == "gloo":
        # the rank's graph dropped: the elastic drill plans its own
        del graph, warm, s, ds
        gc.collect()
        torch.cuda.empty_cache()
        features.update(group_elastic(torch, args, edges, n, run, ref,
                                      ints))
    res = {"rank": k, "world": args.group_world, "backend":
           args.group_backend,
           "block": [mesh.i0, mesh.j0, mesh.Rl, mesh.Cl], "plan_s": plan_s,
           "resident_bytes": resident, "csr_s": csr_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "queries": queries, "features": features}
    with open(os.path.join(gdir, f"{leg}-rank{k}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()
    print(f"rank {k} done", flush=True)
    return 0


LAUNCH_TIMEOUT_S = 300           # phase 18: a launcher run's deadline
# phase 18: roots of a launcher run and of an analog (2 until phase 20
# came; cut to 1 for its time)
LAUNCH_ROOTS = 1
LAUNCH_RUNS = (                  # phase 18 (a): (tag, extra flags, kernels)
    ("top-down", (), ("expand_chunk", "compact_rows")),
    ("direction", ("--direction", "--fold", "bitmap"),
     ("expand_chunk", "compact_rows", "pack_bits", "unpack_bits",
      "bottomup_chunk")))
# the launcher's main, as `python3 -m repro_torch.launch.bfs_run` runs it,
# then the child's kernel launch counts and peak memory as one JSON line
LAUNCH_BOOT = """
import json, sys
import torch
from repro_torch.launch import bfs_run
bfs_run.main(sys.argv[1:])
import chip_smoke
print(json.dumps({"launches": chip_smoke.read_counts(),
                  "peak_bytes": torch.cuda.max_memory_allocated()}))
"""


def run_launcher(args, flags):
    """One launcher run in a child process: (its summary line, its launch
    counts and peak, seconds); raises unless it exits 0 in time."""
    cmd = [sys.executable, "-c", LAUNCH_BOOT, "--grid", args.grid,
           "--scale", str(args.scale), "--ef", str(args.edge_factor),
           "--roots", str(LAUNCH_ROOTS), "--validate", str(LAUNCH_ROOTS),
           "--edge-chunk",
           str(args.edge_chunk), *flags]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src"), HERE]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=LAUNCH_TIMEOUT_S, cwd=HERE)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"bfs_run {' '.join(cmd[3:])} exited "
                             f"{res.returncode} after {wall:.1f} s:\n"
                             f"{res.stdout[-2000:]}{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    return lines[-2], json.loads(lines[-1]), wall


def check_summary(line: str, direction: bool) -> float:
    """The JAX driver's summary line, every root validated; returns its
    harmonic TEPS (> 0)."""
    import re
    k = LAUNCH_ROOTS
    m = re.fullmatch(
        r"grid=\d+x\d+ scale=\d+ ef=\d+ fold=(\w+) dir=(True|False): "
        rf"harmonic TEPS (\S+) \({k} validated\) \| {k}-root sweep \S+s, "
        r"amortised (\S+) TEPS, harmonic (\S+) TEPS", line)
    if m is None or m.group(2) != str(direction):
        raise AssertionError(f"unexpected launcher summary: {line!r}")
    teps = [float(m.group(k)) for k in (3, 4, 5)]
    if min(teps) <= 0:
        raise AssertionError(f"launcher TEPS not positive: {line!r}")
    return teps[0]


def cuda_tensors_alive(torch, top: int = 5) -> list:
    """(shape, dtype, MiB) of the largest CUDA tensors the garbage
    collector sees alive: what pins this process's cached segments."""
    found = []
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                found.append((tuple(obj.shape), str(obj.dtype).split(".")[-1],
                              round(obj.untyped_storage().nbytes() / 2**20,
                                    1)))
        except Exception:   # objects that refuse inspection
            continue
    return sorted(found, key=lambda t: -t[2])[:top]


def run_launch(torch, args, report, phases):
    """Phase 18: the launcher and the graph-build / single-device path at
    full size (see the module docstring)."""
    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.core import bfs_single
    from repro_torch.core.validate import EdgeIndex, validate_bfs
    from repro_torch.graphgen import REALWORLD_SPECS, build_csc, degrees, \
        realworld_analog

    rep = {"launcher": []}
    gc.collect()
    torch.cuda.empty_cache()
    held = cuda_tensors_alive(torch)
    log(f"[18 launch] this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; its "
        f"largest live CUDA tensors {held}")
    # (a) the launcher, top-down and direction-optimised
    for tag, flags, need in LAUNCH_RUNS:
        line, child, wall = run_launcher(args, flags)
        teps = check_summary(line, bool(flags))
        require_launched(child["launches"], need, f"the {tag} launcher")
        log(f"[18 launch] (a) bfs_run {tag}: {line}")
        log(f"[18 launch] (a) bfs_run {tag}: exit 0 in {wall:.1f} s, peak "
            f"memory {child['peak_bytes'] / 2**30:.2f} GiB, launches "
            f"{child['launches']}")
        rep["launcher"].append({"run": tag, "line": line, "s": wall,
                                "harmonic_teps": teps, **child})

    # (b) the Table 3 analogs at the paper's scales, 2x2, two roots each
    dev = torch.device("cuda")
    R, C = (int(x) for x in args.grid.lower().split("x"))
    rep["analogs"] = []
    for k, name in enumerate(REALWORLD_SPECS):
        t0 = time.perf_counter()
        edges, n, meta = realworld_analog(
            name, torch.Generator(device=dev).manual_seed(args.seed + k),
            scale_reduction=0, device=dev)
        graph = DistGraph.from_edges(
            edges, BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk), n=n)
        index = EdgeIndex(edges, n)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        cand = torch.nonzero(degrees(edges[0], n) > 0).flatten()
        pick = torch.randperm(cand.numel(), device=dev, generator=torch
                              .Generator(device=dev).manual_seed(args.seed))
        roots = cand[pick[:LAUNCH_ROOTS]].tolist()
        del cand, pick
        sess = graph.session()
        zero_counts()
        searches = []
        for r in roots:
            out, dt = timed(torch, lambda: sess.bfs(r))
            validate_bfs(edges, out.level[:n], out.pred[:n], r, index=index)
            searches.append((r, out.level[:n].clone(), dt,
                             int(out.n_levels)))
        counts = read_counts()
        require_launched(counts, ("expand_chunk", "compact_rows"),
                         f"the {name} analog")
        log(f"[18 launch] (b) {name} analog: SCALE {meta['scale']} "
            f"edgefactor {meta['edge_factor']}, {edges.shape[1]} directed "
            f"edges, generated, planned {R}x{C} and indexed in "
            f"{plan_s:.1f} s; roots "
            + ", ".join(f"{r}: {lv} levels {dt:.3f} s" for r, _, dt, lv
                        in searches)
            + f", validated; launches B1 {counts['expand_chunk']}, B2 "
            f"{counts['compact_rows']}")
        rep["analogs"].append({**meta, "edges": int(edges.shape[1]),
                               "plan_s": plan_s, "roots": roots,
                               "search_s": [s[2] for s in searches],
                               "launches": counts})
        del graph, sess, out
        if name != "com-Friendster":
            del edges, index, searches
            torch.cuda.empty_cache()

    # (c) the Friendster analog's CSC on the card and the single-device BFS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (co, ri), csc_s = timed(torch, lambda: build_csc(edges, n))
    single = []
    for r, level, sess_s, _ in searches:
        (lv, pr), dt = timed(torch, lambda: bfs_single(co, ri, r))
        if not torch.equal(lv, level):
            raise AssertionError(f"bfs_single levels from root {r} differ "
                                 f"from the 2x2 session's")
        validate_bfs(edges, lv, pr, r, index=index)
        single.append(dt)
        log(f"[18 launch] (c) bfs_single root {r}: levels equal to the "
            f"session's (deepest {int(lv.max())}), preds validated; "
            f"{dt:.3f} s against the session's {sess_s:.3f} s")
    peak = torch.cuda.max_memory_allocated()
    log(f"[18 launch] (c) build_csc of the com-Friendster analog "
        f"({edges.shape[1]} edges) on the card in {csc_s:.2f} s; peak "
        f"memory {peak / 2**30:.2f} GiB (edge list, EdgeIndex, CSC and the "
        f"search's temporaries)")
    rep["single"] = {"csc_s": csc_s, "search_s": single,
                     "session_s": [s[2] for s in searches],
                     "peak_bytes": peak}
    del co, ri, edges, index, searches, lv, pr
    gc.collect()
    torch.cuda.empty_cache()
    report["launch"] = rep
    phases.end("18 launch")


MODELS_TIMEOUT_S = 300           # phase 19: the child's deadline
LM_TIMEOUT_S = 300               # phase 20: the child's deadline


def run_card_script(torch, args, phase: int, script: str,
                    timeout: int) -> dict:
    """`scripts/{script}` in a child process on the freed card; its lines
    print as they come, its report is returned."""
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(HERE, "build", f"phase{phase}.json")
    if os.path.exists(out):
        os.remove(out)
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", script),
         "--seed", str(args.seed), "--out", out], cwd=HERE, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"phase {phase} failed: the child exited "
                             f"{res.returncode}")
    with open(out) as f:
        rep = json.load(f)
    os.remove(out)
    return rep


def run_models(torch, args, report, phases):
    """Phase 19: `scripts/torch_models_card.py` in a child process (see the
    module docstring)."""
    report["models"] = run_card_script(torch, args, 19,
                                       "torch_models_card.py",
                                       MODELS_TIMEOUT_S)
    phases.end("19 models")


def run_lm(torch, args, report, phases):
    """Phase 20: `scripts/torch_lm_card.py` in a child process (see the
    module docstring)."""
    report["lm"] = run_card_script(torch, args, 20, "torch_lm_card.py",
                                   LM_TIMEOUT_S)
    phases.end("20 lm")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--roots", type=int, default=12,
                    help="timed roots of the direction-optimised path")
    ap.add_argument("--td-roots", type=int, default=11,
                    help="timed roots of the top-down path")
    ap.add_argument("--batch", type=int, default=4,
                    help="roots of the top-down batched search (its (B, n) "
                         "output must fit on the card beside the graph)")
    ap.add_argument("--dir-batch", type=int, default=4,
                    help="roots of the direction path's batched search")
    ap.add_argument("--sssp-roots", type=int, default=2,
                    help="phase-4 roots each run through sssp (phase 9)")
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--edge-chunk", type=int, default=1 << 22)
    ap.add_argument("--delta-scale", type=int, default=22,
                    help="R-MAT SCALE of the delta-codec phase (8x8 grid; "
                         "22 gives S = 65536, the codec's limit)")
    ap.add_argument("--delta-edge-chunk", type=int, default=1 << 20)
    ap.add_argument("--card-cpu-scale", type=int, default=10,
                    help="R-MAT SCALE of the card-against-CPU phase")
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    # phase 17's ranks: this script started again by the phase itself
    for opt in ("--group-rank", "--group-world"):
        ap.add_argument(opt, type=int, default=None, help=argparse.SUPPRESS)
    for opt in ("--group-backend", "--group-dir", "--group-leg"):
        ap.add_argument(opt, default=None, help=argparse.SUPPRESS)
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
    if args.group_rank is not None:
        return group_rank_main(args)

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
        log(f"[3 parity] compact_rows random N={N} S={S}: form "
            f"{KF.compact_rows.last_form}, max_abs_err {err}")
    del rnd, deg, col_off, row_idx, front, visited, cumul, words
    del kout, kcnt, pout, pcnt, total
    parity_compact_cases(torch, dev, KF)
    parity_stage_cases(torch, dev, K, KB)
    parity_random_dir(torch, dev, gen, KF, KB)
    parity_random_values(torch, dev, gen, F, K, KB, KF)
    phases.end("3 parity")

    # -- 13. the card against the CPU path -----------------------------------
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_card_vs_cpu
    report["card_vs_cpu"] = torch_card_vs_cpu.run(
        dev, scale=args.card_cpu_scale, seed=args.seed, quick=True,
        log=lambda m: log(f"[13 card-cpu] {m}"))
    phases.end("13 card-cpu")

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
    expand_hook = eng.expand_fn
    expand_tap = Tap(expand_hook, lambda k, a: a[0] > 0, copy=(7,))
    compact_tap = Tap(KF.compact_rows, lambda k, a: k == 2 * C + 1)

    class TappedFold:
        compact_rows = compact_tap

    eng.expand_fn, eng.fold_ops = expand_tap, TappedFold
    t0 = time.perf_counter()
    sess.bfs(roots[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    eng.expand_fn, eng.fold_ops = expand_hook, KF
    log(f"[4 run] warm-up search {warm_s:.2f} s (taps: {expand_tap.calls} "
        f"chunks, {compact_tap.calls} exchange rows)")

    # the top-down path: counts to 0, timed scalar searches, one batch
    K.expand_chunk.launches = 0
    KF.compact_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, teps, scalar, comp_edges = [], [], [], []
    keep = max(args.batch, TD_EQUAL_ROOTS, args.sssp_roots, SERVE_TD_ROOTS)
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
        comp_edges.append(m)
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
    b1_out = K.expand_chunk(start, E, *eargs, **ekw)
    err = check_equal(torch, "expand_chunk on the real chunk", b1_out,
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
    v = b1_out[0]
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
    b2 = time_compact(torch, "real exchange row (3b)", mask, arrays, fills)
    kernels.append(kernel_row(
        "compact_rows", "src/repro_torch/csrc/compact.cu",
        "src/repro/kernels/fold.py:112", launches["compact_rows"],
        b2["err"], b2["ms"], b2["plain_ms"], b2["bytes"]))
    report["compact_rows"] = [b2]
    # TappedFold holds the tap as a class attribute: drop both
    del expand_tap, compact_tap, TappedFold, v, mask, arrays, fills, ekw
    phases.end("3b parity")

    # -- 12. the kernel-stage surface on the real chunk and graph ------------
    run_stages(torch, args, graph, roots, scalar, (start, E, *eargs), b1_out,
               kernels, report, phases)
    del eargs, b1_out

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
    before_csr = torch.cuda.memory_allocated()
    # what the graph drops once the CSR exists; the script keeps its own
    # references (validation and phase 15 (e) re-plan from them)
    dropped = (graph.edges.numel() * graph.edges.element_size()
               + graph.edge_weights.numel()
               + sum(k.numel() * k.element_size()
                     for k in graph.edge_index().keys))
    t0 = time.perf_counter()
    graph.ensure_csr()
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    csr_peak = torch.cuda.max_memory_allocated()
    if graph.edges is not None or graph._edge_index is not None:
        raise AssertionError("ensure_csr kept the graph's edge list")
    log(f"[7 dir-run] ensure_csr: CSR twin nnz per block "
        f"{graph.csr['nnz'].flatten().tolist()} in {csr_s:.1f} s; peak "
        f"memory {csr_peak / 2**30:.2f} GiB, allocated "
        f"{before_csr / 2**30:.2f} GiB before, resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after; the graph "
        f"dropped its edge list, weights and EdgeIndex "
        f"({dropped / 2**30:.2f} GiB, held on by this script)")
    dir_config = BFSConfig(grid=(R, C), edge_chunk=args.edge_chunk,
                           direction=True, fold_codec="bitmap")
    dsess = graph.session(dir_config)
    deng = dsess.engine
    assert deng.bottomup_path == "kernel" and deng.codec.name == "bitmap"

    bu_hook = deng.bottomup_fn
    bu_tap = Tap(bu_hook, lambda k, a: a[0] > 0)
    pack_tap = Tap(KF.pack_bits, lambda k, a: k == 3)
    unpack_tap = Tap(KF.unpack_bits, lambda k, a: k == 3)
    # the bitmap decode's compaction (the slot-offset channel over the N = 8
    # unpacked rows) of a fold past the first few
    decode_tap = Tap(KF.compact_rows, lambda k, a: k >= 5 and a[0].shape[0]
                     == 8 and a[1][0] is KF.SLOT_OFFSETS)

    class TappedBits:
        compact_rows = decode_tap
        pack_bits = pack_tap
        unpack_bits = unpack_tap

    deng.bottomup_fn = bu_tap
    deng.fold_ops = deng.codec.ops = TappedBits
    t0 = time.perf_counter()
    dsess.bfs(roots[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    deng.bottomup_fn = bu_hook
    deng.fold_ops = deng.codec.ops = KF
    log(f"[7 dir-run] warm-up search {warm_s:.2f} s (taps: {bu_tap.calls} "
        f"bottom-up chunks, {pack_tap.calls} packs, {unpack_tap.calls} "
        f"unpacks, {decode_tap.calls} compactions)")

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
        f"{int(mask.sum())}: max_abs_err {err}; form "
        f"{KF.pack_bits.last_form}, kernel {p_ms:.4f} ms, plain "
        f"{p_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.5f} ms, "
        f"{kernels[-1]['bound_ms'] / p_ms:.3f} of the bound")

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
        f"{int(kern.sum())}: max_abs_err {err}; form "
        f"{KF.unpack_bits.last_form}, kernel {u_ms:.4f} ms, plain "
        f"{u_plain:.4f} ms, bound {kernels[-1]['bound_ms']:.5f} ms, "
        f"{kernels[-1]['bound_ms'] / u_ms:.3f} of the bound")

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
    span = block_spans(torch, start, E, bcumul, btotal)
    log(f"[7b spans] bottomup_chunk real chunk: {E} lanes ({live} live) in "
        f"{span['blocks']} blocks of {BU_BLOCK_LANES}, rows {rows}; row slots"
        f" a block spans mean {span['mean']:.1f} max {span['max']}; "
        f"{span['search_blocks']} blocks search by lane, the rest walk "
        f"{span['walked_slots']} slots ({4 * span['walked_slots']} B of cumul"
        f" beside the bound)")
    report["b7_spans"] = dict(span, rows=rows, live=live, lanes=E)
    (dmask, darrays, dfills), _ = decode_tap.saved
    if darrays[0] is not KF.SLOT_OFFSETS:
        raise AssertionError("phase 7 kept no bitmap decode's compaction")
    report["compact_rows"].append(time_compact(
        torch, "real bitmap decode (7b)", dmask, darrays, dfills))
    del pack_tap, unpack_tap, bu_tap, decode_tap, TappedBits, mask, \
        uwords, bargs, kern, r_out, c_out, bcumul, btotal, bwords, dmask, \
        darrays, dfills, bkw, live_mask, c_live, wid
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
    del ref, ref_sess, reng
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
    run_exchange_obs(torch, args, graph, td_roots, scalar, dscalar, vals,
                     report, phases)
    run_ft(torch, args, graph, td_roots, scalar, dscalar, vals, report,
           phases)
    run_serve(torch, args, graph, td_roots, roots, scalar, dscalar, times,
              dtimes, dir_config, vals, report, phases)
    del expand_hook, bu_hook
    # phase 17's inputs to disk while the edge list and weights are here
    gdir = os.path.join(HERE, "build", "phase17")
    (td0, td1), dref = scalar[:2], dscalar[0]
    cc_ref, sssp_ref = vals["cc"], vals["sssp"][0]
    group_meta = save_group_inputs(torch, gdir, edges, weights, n, {
        "td0_level": td0[0], "td0_pred": td0[1], "td0_n_levels": td0[2],
        "td0_edges": td0[3], "td1_level": td1[0], "td1_pred": td1[1],
        "td1_n_levels": td1[2], "td1_edges": td1[3],
        "dir_level": dref[0], "dir_pred": dref[1], "dir_n_levels": dref[2],
        "dir_edges": dref[3], "dir_directions": dref[4],
        "cc_labels": cc_ref[0], "cc_iters": cc_ref[1],
        "cc_edges": cc_ref[2], "sssp_dist": sssp_ref[0],
        "sssp_iters": sssp_ref[1], "sssp_edges": sssp_ref[2],
        "root0": td_roots[0], "root1": td_roots[1], "dir_root": roots[0],
        "sssp_root": vals["sssp_roots"][0], "m_r0": comp_edges[0],
        "m_r1": comp_edges[1]})
    del td0, td1, dref, cc_ref, sssp_ref
    log(f"[17 group] the edge list, weights and the stacked outputs phase "
        f"17 is held to written under build/phase17 in "
        f"{group_meta['write_s']:.1f} s")
    feat_s = save_group_features(torch, gdir, graph, args, td_roots[0],
                                 group_meta)
    log(f"[17 group] the stacked trace and loss snapshots (BFS, CC) of "
        f"phase 17's legs (a) and (c) written in {feat_s:.1f} s")
    # phase 3b's arguments are views of the graph's CSC: drop them with it
    del graph, weights, sess, dsess, eng, deng, cumul, front, ftot, \
        col_off, row_idx, words
    gc.collect()
    torch.cuda.empty_cache()
    el = run_ft_elastic(torch, args, edges, index, n, td_roots, scalar, vals,
                        report, phases)
    add_group_refs(torch, gdir, group_meta, {
        "el_level": el[0], "el_pred": el[1], "el_n_levels": el[2],
        "el_edges": el[3]})
    del el
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    del edges, index, vals
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    log(f"[15 ft] the script's edge list and EdgeIndex dropped: "
        f"{freed / 2**30:.2f} GiB freed")
    report["edges_index_bytes"] = freed
    torch.cuda.empty_cache()
    run_delta(torch, dev, args, kernels, report, phases)
    # -- 17. the process group: the card's memory and the script's host
    # copies of the outputs dropped, only the references on disk kept
    del scalar, dscalar
    gc.collect()
    torch.cuda.empty_cache()
    try:
        run_group(torch, gdir, group_meta, report, phases)
    finally:
        shutil.rmtree(gdir, ignore_errors=True)
    run_launch(torch, args, report, phases)
    run_models(torch, args, report, phases)
    run_lm(torch, args, report, phases)
    report["kernels"] = kernels
    report["phase_s"] = phases.seconds
    report["script_s"] = time.perf_counter() - t_script

    # -- 6. report ------------------------------------------------------------
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"[6 report] peak memory by phase (GiB): " + ", ".join(
        f"{k} {v / 2**30:.2f}" for k, v in peaks(report)))
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
