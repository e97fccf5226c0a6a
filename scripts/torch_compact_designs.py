#!/usr/bin/env python3
"""Designs of B2 `compact_rows` and B10 `binsearch_map` timed at the main
path's shapes, on an NVIDIA GPU.

    python3 scripts/torch_compact_designs.py [--against DIR] [--seed 1]
        [--out FILE.json]

Makes inputs on the card from --seed at B2's three real shapes and B10's
two, then builds variants of `src/repro_torch/csrc/compact.cu` and
`stages.cu` into build/designs_compact/, each made by replacing lines of
the source (the package has no such option):

  B2, at the exchange row (N = 1, S = 2^25: two prefix-masked blocks of
  2^24 holding 576,523 entries, as the top-down search's), the bitmap
  decode (N = 8, S = 2^24, the slot-offset channel, density 0.1725) and
  the values row (N = 2, S = 2^25, ids and labels, 2 prefix-masked blocks
  a row at random counts):
    committed      the source as it is: form (b), reduce then scan (a
                   counting pass, a scan of the tile counts, a compaction
                   pass that also writes its tile's fills), 256 threads a
                   tile with 4 groups of 16 slots each (16384 slots),
                   __launch_bounds__ asking for 3 blocks an SM, source
                   slots read only where kept, 16-byte fills
    vecs_1         1 group a thread, no occupancy asked (form (b) as
                   first written)
    vecs_2_min_blocks_4   2 groups a thread, 4 blocks an SM
    vecs_4_min_blocks_1 / _4   1 / 4 blocks an SM asked for
    look_back      form (a), inserted as text: one pass, each tile's
                   offset by a decoupled look-back over its row's earlier
                   tiles (tile ids from an atomicAdd ticket), and a second
                   launch for the fills
    look_back_vecs_1   form (a) with 1 group a thread, no occupancy asked
                   (as first written)
    dense_reads    every source slot read (16-byte loads), kept or not
    scalar_fills   the fills written 4 bytes a thread
    ldg_mask       the mask read through the read-only cache (__ldg), not
                   streamed (__ldcs), in the pass that stages the runs
    parent         DIR's compact.cu (e.g. a parent checkout) as DIR's
                   wrapper drove it: a torch.cumsum row prefix, one launch
                   a channel, and for the decode the (N, S) offsets built
                   by `t.expand(N, S).contiguous()`; with --against
  B10, on a search's chunk (2^22 consecutive gids over a cumul whose slots
  average ~560 edges, so the chunk spans ~5800 slots) and on sparse gids
  (2^20 sorted gids drawn from 2^25 edges over 2^22 slots, a block of
  2048 lanes spanning ~8000 slots):
    committed      256 threads x 8 lanes a block, the span searched in
                   shared memory up to 512 slots
    lanes_4        4 lanes a thread
    lanes_4_smem_2048   4 lanes a thread, 2048 slots (as first written)
    smem_0 / smem_2048   the shared-memory budget at 0 (every spanned
                   block searches in global memory) / 2048 slots
    threads_128    128 threads a block
    parent         DIR's stages.cu: a binary search per lane over the
                   whole cumul; with --against

Each variant must equal the plain version before it is timed.  B2 is timed
with chip_smoke.py's `cuda_ms` (ten calls queued behind a device sleep),
B10 with `cuda_ms_cold` (the L2 flushed before each call, since its inputs
fit the 50 MB L2), the variants in turns, forward then backward; each
printed beside its bytes bound and the share of it reached.
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
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

# name -> (file, edits: (old, new, copies of old))
VECS = "constexpr int kVecs = 4;"
MIN_BLOCKS = "constexpr int kMinBlocks = 3;"
LOOK_BACK_KERNELS = r"""
// The count of a tile's kept slots, summed over its packed groups.
__device__ __forceinline__ int tile_count(unsigned long long total) {
  int agg = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) agg += field(total, j);
  return agg;
}

// Tile status words of the look-back: flag << 32 | value.
constexpr unsigned long long kAggregate = 1ull << 32;  // value: tile count
constexpr unsigned long long kPrefix = 2ull << 32;     // value: inclusive

// The exclusive prefix of tile `tile` > 0 within its row, by warp 0: lane
// i reads the status of tile k - i (k the nearest tile not yet summed),
// waiting until all 32 have published; the lanes up to the nearest
// published prefix add their values, and the walk stops there.  Tiles
// before the row's first read as a prefix of 0.
__device__ __forceinline__ int look_back(
    const volatile unsigned long long* st, int tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int k = tile - 1;; k -= 32) {
    const int p = k - lane;
    unsigned long long w;
    do {
      w = p >= 0 ? st[p] : kPrefix;
    } while (__any_sync(0xffffffffu, (w >> 32) == 0));
    const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    int v = lane <= stop ? (int)(unsigned)w : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (done) return excl;
  }
}

// Form (a), one pass: a ticket, the tile's count, the look-back, the runs.
// The last tile of a row writes the row's count.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    compact_lookback_kernel(const unsigned char* __restrict__ mask,
                            Channels ch, long long S, int T,
                            unsigned long long* status, unsigned* ticket,
                            int* __restrict__ counts) {
  __shared__ int stage[kSub];
  __shared__ int s_id, s_excl;
  if (threadIdx.x == 0) s_id = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const long long row = s_id / T;
  const int tile = s_id % T;
  const long long ts = (long long)tile * kTile;
  unsigned bits[kVecs];
  load_bits<kVec, true>(mask + row * S, S, ts, bits);
  unsigned long long total;
  const unsigned long long rank =
      block_excl_scan<kThreads>(pack_counts(bits), total);
  const int agg = tile_count(total);
  volatile unsigned long long* st = status + row * T;
  if (threadIdx.x < 32) {
    int excl = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) st[tile] = kAggregate | (unsigned)agg;
      excl = look_back(st, tile);
    }
    if (threadIdx.x == 0) {
      st[tile] = kPrefix | (unsigned)(excl + agg);
      if (tile == T - 1) counts[row] = excl + agg;
      s_excl = excl;
    }
  }
  __syncthreads();
  write_runs<kVec>(ch, row, S, ts, bits, rank, total, s_excl, stage);
}

// Form (a)'s second launch: the fills over [counts[row], S).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    compact_fill_kernel(Channels ch, long long S, int T,
                        const int* __restrict__ counts) {
  const long long row = blockIdx.x / T;
  const long long ts = (long long)(blockIdx.x % T) * kTile;
  const long long lo = max(ts, (long long)counts[row]);
  const long long hi = min(ts + kTile, S);
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < ch.n) fill_range<kVec>(ch.out[c] + row * S, lo, hi, ch.fill[c]);
  }
}

"""
SCAN_LAUNCH = """\
  int* tile_counts = static_cast<int*>(scratch);
  int* tile_off = tile_counts + blocks;
  compact_count_kernel<kVec><<<blocks, kThreads, 0, st>>>(mask, S, T,
                                                          tile_counts);
  compact_scan_kernel<<<N, kScanThreads, 0, st>>>(tile_counts, T, tile_off,
                                                  counts);
  compact_scatter_kernel<kVec><<<blocks, kThreads, 0, st>>>(
      mask, ch, S, T, tile_off, counts);
"""
LOOK_BACK_LAUNCH = """\
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned*>(status + blocks);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, ((size_t)blocks + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  compact_lookback_kernel<kVec><<<blocks, kThreads, 0, st>>>(
      mask, ch, S, T, status, ticket, counts);
  if (ch.n > 0) {
    compact_fill_kernel<kVec><<<blocks, kThreads, 0, st>>>(ch, S, T, counts);
  }
"""
LOOK_BACK = (
    ("bool aligned16(const void* p) {",
     LOOK_BACK_KERNELS + "bool aligned16(const void* p) {", 1),
    (SCAN_LAUNCH, LOOK_BACK_LAUNCH, 1),
    ("return tiles * 2 * sizeof(int);", "return (tiles + 1) * 8;", 1))


def _vecs(n):
    return (VECS, f"constexpr int kVecs = {n};", 1)


def _min_blocks(n):
    return (MIN_BLOCKS, f"constexpr int kMinBlocks = {n};", 1)


B2_DESIGNS = {
    "committed": ("compact.cu", ()),
    "vecs_1": ("compact.cu", (_vecs(1), _min_blocks(1))),
    "vecs_2_min_blocks_4": ("compact.cu", (_vecs(2), _min_blocks(4))),
    "vecs_4_min_blocks_1": ("compact.cu", (_min_blocks(1),)),
    "vecs_4_min_blocks_4": ("compact.cu", (_min_blocks(4),)),
    "look_back": ("compact.cu", LOOK_BACK),
    "look_back_vecs_1": ("compact.cu", LOOK_BACK + (_vecs(1),
                                                    _min_blocks(1))),
    "dense_reads": ("compact.cu", (
        ("if (src != nullptr && bits[j]) {", "if (src != nullptr) {", 1),
        ("if ((bits[j] >> (4 * g)) & 0xFu) {", "{", 1))),
    "scalar_fills": ("compact.cu", (
        ("  if (!kVec) {\n    for (long long s = lo + t;",
         "  if (true) {\n    for (long long s = lo + t;", 1),)),
    "ldg_mask": ("compact.cu", (
        ("load_bits<kVec, true>", "load_bits<kVec, false>", 1),)),
}
LANES_4 = ("constexpr int kMapPerThread = 8;",
           "constexpr int kMapPerThread = 4;", 1)


def _smem(n):
    return ("constexpr int kMapSmemSlots = 512;",
            f"constexpr int kMapSmemSlots = {n};", 1)


B10_DESIGNS = {
    "committed": ("stages.cu", ()),
    "lanes_4": ("stages.cu", (LANES_4,)),
    "lanes_4_smem_2048": ("stages.cu", (LANES_4, _smem(2048))),
    "smem_0": ("stages.cu", (_smem(0),)),
    "smem_2048": ("stages.cu", (_smem(2048),)),
    "threads_128": ("stages.cu", (
        ("constexpr int kMapThreads = 256;",
         "constexpr int kMapThreads = 128;", 1),)),
}


def design_source(name: str, file: str, edits) -> str:
    with open(os.path.join(CSRC, file)) as f:
        text = f.read()
    for old, new, copies in edits:
        n = text.count(old)
        if n != copies:
            raise RuntimeError(f"design {name}: {file} holds {n} copies of "
                               f"{old!r}, not {copies}")
        text = text.replace(old, new)
    return text


def build_designs(against) -> dict:
    """{(kernel, name): path of its built library}, all nvcc runs in
    parallel; the sources go beside a copy of the shared headers."""
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", "designs_compact")
    os.makedirs(out, exist_ok=True)
    jobs = []
    for kernel, designs in (("compact", B2_DESIGNS), ("stages", B10_DESIGNS)):
        for name, (file, edits) in designs.items():
            jobs.append((kernel, name, design_source(name, file, edits)))
    if against:
        for kernel in ("compact", "stages"):
            with open(os.path.join(against, "src", "repro_torch", "csrc",
                                   f"{kernel}.cu")) as f:
                jobs.append((kernel, "parent", f.read()))
    for header in os.listdir(CSRC):
        if header.endswith(".cuh"):
            with open(os.path.join(CSRC, header)) as src, \
                    open(os.path.join(out, header), "w") as dst:
                dst.write(src.read())
    parent_dir = os.path.join(out, "parent")
    if against:
        os.makedirs(parent_dir, exist_ok=True)
        pcsrc = os.path.join(against, "src", "repro_torch", "csrc")
        for header in os.listdir(pcsrc):
            if header.endswith(".cuh"):
                with open(os.path.join(pcsrc, header)) as src, \
                        open(os.path.join(parent_dir, header), "w") as dst:
                    dst.write(src.read())
    running = []
    for kernel, name, text in jobs:
        where = parent_dir if name == "parent" else out
        src = os.path.join(where, f"{kernel}_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(where, f"lib{kernel}_{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src]
        running.append((kernel, name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for kernel, name, lib, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} design {name}:\n"
                               f"{log}")
        clean = "0 bytes stack frame, 0 bytes spill stores"
        regs = [ln.strip().split(": ", 1)[-1] for ln in log.splitlines()
                if "registers" in ln
                or ("spill" in ln and not ln.strip().startswith(clean))]
        print(f"  {kernel}:{name}: {' | '.join(regs)}", flush=True)
        libs[(kernel, name)] = lib
    return libs


def parent_compact(torch, lib, mask, arrays, fills):
    """The parent's B2 as its wrapper drove it: the row prefix by one flat
    torch.cumsum, then one launch a channel; a SLOT_OFFSETS channel built
    as an (N, S) tensor first, as its `compact_offsets` did."""
    from repro_torch.kernels import fold as KF
    fn = lib.compact_rows_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    N, S = mask.shape
    dev = mask.device
    inc = torch.cumsum(mask.reshape(-1), 0, dtype=torch.int32).view(N, S)
    if N > 1:
        base = inc[:-1, -1].clone()
        inc[1:] -= base[:, None]
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for a, f in zip(arrays, fills):
        if a is KF.SLOT_OFFSETS:
            a = torch.arange(S, dtype=torch.int32, device=dev) \
                .expand(N, S).contiguous()
        out = torch.empty((N, S), dtype=torch.int32, device=dev)
        rc = fn(mask.data_ptr(), inc.data_ptr(), a.data_ptr(),
                out.data_ptr(), N, S, int(f), stream)
        if rc:
            raise RuntimeError(f"parent compact_rows: cudaError {rc}")
        outs.append(out)
    return tuple(outs), inc[:, -1].contiguous()


def prefix_rows(torch, gen, n_rows, blocks, block, counts=None):
    """(n_rows, blocks * block) rows of prefix-masked blocks, as the
    exchanges build them; counts (n_rows, blocks) drawn at random unless
    given."""
    dev = gen.device
    if counts is None:
        counts = torch.randint(0, block, (n_rows, blocks), generator=gen,
                               device=dev)
    t = torch.arange(block, device=dev)
    return (t[None, None, :] < counts[..., None]).reshape(n_rows, -1)


def b2_shapes(torch, KF, gen):
    """name -> (mask, arrays, fills) at B2's three shapes."""
    dev = gen.device
    ex_mask = prefix_rows(torch, gen, 1, 2, 1 << 24,
                          torch.tensor([[300_000, 276_523]], device=dev))
    ex_vals = torch.randint(0, 1 << 30, ex_mask.shape, generator=gen,
                            device=dev, dtype=torch.int32)
    dec_mask = torch.rand((8, 1 << 24), generator=gen, device=dev) < 0.1725
    val_mask = prefix_rows(torch, gen, 2, 2, 1 << 24)
    ids = torch.randint(0, 1 << 26, val_mask.shape, generator=gen,
                        device=dev, dtype=torch.int32)
    labels = torch.randint(0, 1 << 26, val_mask.shape, generator=gen,
                           device=dev, dtype=torch.int32)
    return {"exchange_row": (ex_mask, (ex_vals,), (-1,)),
            "bitmap_decode": (dec_mask, (KF.SLOT_OFFSETS,), (-1,)),
            "values_row": (val_mask, (ids, labels), (-1, 2**31 - 1))}


def b10_shapes(torch, gen):
    """name -> (clipped cumul, gids) at B10's two shapes."""
    from repro_torch.kernels import stages as S
    dev = gen.device
    deg = torch.empty(16_000, device=dev).log_normal_(5.5, 1.5,
                                                      generator=gen)
    cumul = torch.zeros(deg.numel() + 1, dtype=torch.int32, device=dev)
    cumul[1:] = torch.cumsum(deg.to(torch.int32).clamp(max=1 << 16), 0)
    chunk = (1 << 22) + torch.arange(1 << 22, dtype=torch.int32, device=dev)
    sdeg = torch.randint(0, 17, (1 << 22,), generator=gen, device=dev)
    scumul = torch.zeros((1 << 22) + 1, dtype=torch.int32, device=dev)
    scumul[1:] = torch.cumsum(sdeg, 0)
    sparse = torch.sort(torch.randint(0, int(scumul[-1]), (1 << 20,),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)).values
    return {"search_chunk": (S.clip_cumul(cumul, cumul.numel() - 1), chunk),
            "sparse_gids": (S.clip_cumul(scumul, scumul.numel() - 1),
                            sparse)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import fold as KF
    from repro_torch.kernels import stages as S

    smi = chip_smoke.nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = build_designs(args.against)
    print(f"built {len(libs)} designs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {"device": smi, "b2": {}, "b10": {}}

    # -- B2 -----------------------------------------------------------------
    names = [n for (k, n) in libs if k == "compact"]
    for shape, (mask, arrays, fills) in b2_shapes(torch, KF, gen).items():
        want = KF.plain_compact_rows(mask, arrays, fills)
        need, dense = chip_smoke.compact_bytes(mask, arrays)
        bound = need / chip_smoke.HBM_BYTES_PER_S * 1e3
        calls = {}
        for name in names:
            lib = ctypes.CDLL(libs[("compact", name)])
            if name == "parent":
                calls[name] = (lambda lib=lib: parent_compact(
                    torch, lib, mask, arrays, fills))
            else:
                def call(lib=lib):
                    build._libs["compact"] = lib
                    return KF.compact_rows(mask, arrays, fills)
                calls[name] = call
            got = calls[name]()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in
                       zip(got[0] + (got[1],), want[0] + (want[1],))):
                raise AssertionError(f"compact_rows design {name} differs "
                                     f"from the plain version at {shape}")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(chip_smoke.cuda_ms(torch, calls[name]))
        N, S_ = mask.shape
        print(f"B2 {shape} N={N} S={S_} kept {int(want[1].sum())}: bound "
              f"{bound:.5f} ms ({need} B; a dense read of the sources "
              f"{dense / chip_smoke.HBM_BYTES_PER_S * 1e3:.5f} ms); ms a "
              f"call (two turns), share of the bound", flush=True)
        for name, ms in times.items():
            mean = sum(ms) / len(ms)
            print(f"  {name:13s} {ms[0]:.4f} / {ms[1]:.4f} ms, "
                  f"{bound / mean:.3f} of the bound; equal to the plain "
                  f"version", flush=True)
        report["b2"][shape] = {"N": N, "S": S_, "bytes": need,
                               "dense_bytes": dense, "bound_ms": bound,
                               "ms": times}
        del mask, arrays, want, calls
        torch.cuda.empty_cache()
    build._libs.pop("compact", None)

    # -- B10 ----------------------------------------------------------------
    names = [n for (k, n) in libs if k == "stages"]
    for shape, (cc, gids) in b10_shapes(torch, gen).items():
        want = S.map_workload(gids, cc)
        span = int(want[-1]) - int(want[0]) + 1
        need = 8 * gids.numel() + 4 * span
        bound = need / chip_smoke.HBM_BYTES_PER_S * 1e3

        def call():
            return S.binsearch_map(cc, gids)
        for name in names:
            build._libs["stages"] = ctypes.CDLL(libs[("stages", name)])
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"binsearch_map design {name} differs "
                                     f"from the plain version at {shape}")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            build._libs["stages"] = ctypes.CDLL(libs[("stages", name)])
            times[name].append(chip_smoke.cuda_ms_cold(torch, call))
        lib_ms = chip_smoke.cuda_ms_cold(torch, lambda: torch.searchsorted(
            cc, gids, right=True, out_int32=True))
        print(f"B10 {shape} lanes {gids.numel()} cumul {cc.numel()} slots "
              f"spanned {span}: bound {bound:.5f} ms ({need} B); ms a call "
              f"with the L2 flushed (two turns), share of the bound; "
              f"torch.searchsorted {lib_ms:.4f} ms", flush=True)
        for name, ms in times.items():
            mean = sum(ms) / len(ms)
            print(f"  {name:13s} {ms[0]:.4f} / {ms[1]:.4f} ms, "
                  f"{bound / mean:.3f} of the bound; equal to the plain "
                  f"version", flush=True)
        report["b10"][shape] = {"lanes": gids.numel(), "span": span,
                                "bytes": need, "bound_ms": bound,
                                "searchsorted_ms": lib_ms, "ms": times}
    build._libs.pop("stages", None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
