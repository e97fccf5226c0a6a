// Row compaction: front-pack each row's masked entries in order, pad with
// a fill value (the argsort replacement of DESIGN.md sec. 10).
//
// Replaces: the Pallas kernel src/repro/kernels/fold.py:compact_rows
// (`_compact_kernel`).  For every row r of an (N, S) mask and every channel
// c: out_c[r, i] = src_c[r, s_i] for the i-th masked slot s_i of the row,
// out_c[r, i] = fill_c for i >= counts[r] = the row's masked slots.  The
// result equals a stable argsort of ~mask bit for bit.  A channel may be
// the slot's own offset t (no source: the kernel writes t and reads
// nothing), as the bitmap decode and the value programs' `compact_offsets`
// ask.
//
// The Pallas grid is (N,), one program per row: the JAX wrapper computes
// the row's count prefix with jnp.cumsum outside the kernel, and each
// output slot finds its source by a binary search over that prefix (the
// TPU has no scatter).  Here rows are cut into tiles of kTile slots that
// never cross rows, on a flat 1-D grid over every (row, tile) pair, and
// three launches do the work, all channels of a call together:
//  1. count: each tile's kept slots.  A thread takes kVecs groups of 16
//     slots, kSub slots apart so that a warp's loads of a group are
//     contiguous; a group is one 16-byte mask load where the rows are
//     aligned, counted with __vcmpne4 and __popc;
//  2. scan: one block a row turns its tiles' counts into their offsets
//     and the row's count;
//  3. scatter: each tile reads its mask again, ranks its kept slots with
//     one block scan (the groups' counts packed 16 bits a group), stages
//     each channel's kept entries in shared memory in order, group by
//     group, and writes them as contiguous runs out_c[r, offset ..); only
//     the kept slots of a source channel are read (16 bytes where any of
//     4 slots is kept).  It also writes the fills over the part of its own
//     slot range at or past the row's count, 16 bytes a store, so every
//     output slot has one writer.
//
// What bounds it on an H100: bytes.  1 B of mask a slot, 4 B out a slot
// per channel, 4 B in per kept slot of a source channel, 4 B a row of
// counts; this form reads the mask twice.  A full (N, S) int32 count
// prefix from torch.cumsum, read by one launch per channel, moves 8 B a
// slot more and took 3x to 9x this kernel's time.  On a 2^25-slot exchange
// row, the bitmap decode's 8 rows of 2^24 and a values row of 2 x 2^25
// slots with two channels this takes 0.083, 0.290 and 0.399 ms, 61 %, 69 %
// and 71 % of the bound (an NVIDIA H100 80GB HBM3 at 700 W,
// scripts/torch_compact_designs.py).  The design came from that sweep: a
// tile must keep many bytes in flight, so 4 groups a thread (16384-slot
// tiles) beat 1 by 30 %, and __launch_bounds__ asking for 3 blocks an SM
// keeps the registers down.  A one-pass form that finds each tile's offset
// by a decoupled look-back over the row's earlier tiles (Merrill & Garland
// 2016), with a second launch for the fills, reads the mask once but waits
// on its chain: 7-11 % slower at its best.  Reading every source slot
// rather than the kept ones cost 13-66 % on the rows that have a source
// channel.
//
// The form that ran is reported: "vector" (16-byte mask loads, 16-byte
// source loads and fill stores) where S % 16 == 0 and every row of every
// array starts 16-byte aligned, else "general" (the same tiles, a byte
// and a word at a time).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                      // 16-slot groups a thread
constexpr int kGroup = 16;                    // slots of a group: 16 mask bytes
constexpr int kSub = kThreads * kGroup;       // a group of every thread
constexpr int kTile = kSub * kVecs;           // slots a tile
constexpr int kMinBlocks = 3;                 // __launch_bounds__ occupancy
constexpr int kMaxChannels = 4;
static_assert(kVecs <= 4 && kSub < 65536, "counts pack 16 bits a group");

// Indexed only with unrolled constants, so it stays in the parameter space.
struct Channels {
  const int* src[kMaxChannels];  // nullptr: the channel is the slot offset t
  int* out[kMaxChannels];
  int fill[kMaxChannels];
  int n;
};

// Bit k of the result = (byte k of x != 0): a 0/1 per byte, the multiply
// gathers the four into bits 28..31 (no two partial products overlap).
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// Slot offset (within its row) of the first slot of group j of this
// thread in the tile starting at ts: groups are kSub apart, so a warp's
// loads of one group are contiguous.
__device__ __forceinline__ long long group_start(long long ts, int j) {
  return ts + (long long)j * kSub + threadIdx.x * kGroup;
}

// bits[j] bit i = mask_row[s0 + i] != 0 for group j's slots from s0 (0
// past S).  kVec: S % 16 == 0 and the row 16-byte aligned, so a group is
// one 16-byte load, wholly inside or past S.  All loads are issued before
// any is used.
template <bool kVec, bool kStream>
__device__ __forceinline__ void load_bits(
    const unsigned char* __restrict__ mask_row, long long S, long long ts,
    unsigned (&bits)[kVecs]) {
  if (kVec) {
    uint4 m[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long s0 = group_start(ts, j);
      const uint4* p = reinterpret_cast<const uint4*>(mask_row + s0);
      m[j] = s0 < S ? (kStream ? __ldcs(p) : __ldg(p))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      bits[j] = nibble(m[j].x) | nibble(m[j].y) << 4 |
                nibble(m[j].z) << 8 | nibble(m[j].w) << 12;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long s0 = group_start(ts, j);
    bits[j] = 0u;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (s0 + i < S && mask_row[s0 + i]) bits[j] |= 1u << i;
    }
  }
}

// The groups' counts packed 16 bits a group (a group holds <= 16).
__device__ __forceinline__ unsigned long long pack_counts(
    const unsigned (&bits)[kVecs]) {
  unsigned long long packed = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    packed |= (unsigned long long)__popc(bits[j]) << (16 * j);
  }
  return packed;
}

__device__ __forceinline__ int field(unsigned long long packed, int j) {
  return (int)((packed >> (16 * j)) & 0xFFFFu);
}

// Exclusive scan of x over the block's threads; `total` gets the sum.  On
// packed counts each 16-bit field scans by itself: no field's block total
// reaches 2^16 (static_assert above), so no carry crosses a field.
// Synchronises the block, and reuses its shared words without a barrier
// before them: callers that scan twice synchronise in between.
template <int kBlock, typename T>
__device__ __forceinline__ T block_excl_scan(T x, T& total) {
  __shared__ T warp_sum[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  T before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    const T s = warp_sum[w];
    before += w < warp ? s : 0;
    total += s;
  }
  return before + inc - x;
}

// Writes `fill` over row_out[lo, hi), the block's threads together
// (16-byte stores in the vector form, whose rows are 16-byte aligned).
template <bool kVec>
__device__ __forceinline__ void fill_range(int* __restrict__ row_out,
                                           long long lo, long long hi,
                                           int fill) {
  if (lo >= hi) return;
  const int t = threadIdx.x;
  if (!kVec) {
    for (long long s = lo + t; s < hi; s += kThreads) row_out[s] = fill;
    return;
  }
  const long long a = min(hi, (lo + 3) & ~3LL);
  const long long b = max(a, hi & ~3LL);
  for (long long s = lo + t; s < a; s += kThreads) row_out[s] = fill;
  const int4 f = make_int4(fill, fill, fill, fill);
  int4* q = reinterpret_cast<int4*>(row_out);
  for (long long i = a / 4 + t; i < b / 4; i += kThreads) q[i] = f;
  for (long long s = b + t; s < hi; s += kThreads) row_out[s] = fill;
}

// The tile's kept entries of every channel, in order, written as one run
// at out_c[row, excl ..): group by group, each thread stages its kept
// slots at their rank in shared memory (`rank`: the thread's packed
// exclusive counts, `total`: the block's), then the block copies the
// group's run out.  Only the kept slots of a source channel are read.
template <bool kVec>
__device__ __forceinline__ void write_runs(
    const Channels& ch, long long row, long long S, long long ts,
    const unsigned (&bits)[kVecs], unsigned long long rank,
    unsigned long long total, int excl, int* stage) {
  bool first = true;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c >= ch.n) break;
    const int* src = ch.src[c];
    int* dst = ch.out[c] + row * S + excl;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long s0 = group_start(ts, j);
      int v[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) v[i] = (int)(s0 + i);
      if (src != nullptr && bits[j]) {
        const int* row_src = src + row * S + s0;
        if (kVec) {
#pragma unroll
          for (int g = 0; g < kGroup / 4; ++g) {
            if ((bits[j] >> (4 * g)) & 0xFu) {
              const int4 q =
                  __ldcs(reinterpret_cast<const int4*>(row_src) + g);
              v[4 * g] = q.x;
              v[4 * g + 1] = q.y;
              v[4 * g + 2] = q.z;
              v[4 * g + 3] = q.w;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            if ((bits[j] >> i) & 1u) v[i] = row_src[i];
          }
        }
      }
      if (!first) __syncthreads();       // the previous run is copied out
      first = false;
      int p = field(rank, j);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if ((bits[j] >> i) & 1u) stage[p++] = v[i];
      }
      __syncthreads();
      const int n = field(total, j);
      for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = stage[i];
      dst += n;
    }
  }
}

// Pass 1: each tile's count of kept slots.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    compact_count_kernel(const unsigned char* __restrict__ mask, long long S,
                         int T, int* __restrict__ tile_counts) {
  const long long row = blockIdx.x / T;
  unsigned bits[kVecs];
  load_bits<kVec, false>(mask + row * S, S,
                         (long long)(blockIdx.x % T) * kTile, bits);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) c += __popc(bits[j]);
  int agg;
  block_excl_scan<kThreads>(c, agg);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = agg;
}

// Pass 2: one block a row scans its tiles' counts into their offsets and
// the row's count.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
    compact_scan_kernel(const int* __restrict__ tile_counts, int T,
                        int* __restrict__ tile_off, int* __restrict__ counts) {
  const long long base = (long long)blockIdx.x * T;
  int carry = 0;
  for (int i0 = 0; i0 < T; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    int total;
    const int excl = block_excl_scan<kScanThreads>(
        i < T ? tile_counts[base + i] : 0, total);
    if (i < T) tile_off[base + i] = carry + excl;
    carry += total;
    __syncthreads();                   // warp_sum is reused next round
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

// Pass 3: the runs at the scanned offsets, and the fills of the tile's own
// slot range past the row's count, so each output slot has one writer.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    compact_scatter_kernel(const unsigned char* __restrict__ mask,
                           Channels ch, long long S, int T,
                           const int* __restrict__ tile_off,
                           const int* __restrict__ counts) {
  __shared__ int stage[kSub];
  const long long row = blockIdx.x / T;
  const long long ts = (long long)(blockIdx.x % T) * kTile;
  const int excl = tile_off[blockIdx.x];
  const long long lo = max(ts, (long long)counts[row]);
  unsigned bits[kVecs];
  load_bits<kVec, true>(mask + row * S, S, ts, bits);
  unsigned long long total;
  const unsigned long long rank =
      block_excl_scan<kThreads>(pack_counts(bits), total);
  write_runs<kVec>(ch, row, S, ts, bits, rank, total, excl, stage);
  const long long hi = min(ts + kTile, S);
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < ch.n) fill_range<kVec>(ch.out[c] + row * S, lo, hi, ch.fill[c]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec>
cudaError_t launch(const unsigned char* mask, const Channels& ch, int N,
                   long long S, int T, int* counts, void* scratch,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)((long long)N * T);
  int* tile_counts = static_cast<int*>(scratch);
  int* tile_off = tile_counts + blocks;
  compact_count_kernel<kVec><<<blocks, kThreads, 0, st>>>(mask, S, T,
                                                          tile_counts);
  compact_scan_kernel<<<N, kScanThreads, 0, st>>>(tile_counts, T, tile_off,
                                                  counts);
  compact_scatter_kernel<kVec><<<blocks, kThreads, 0, st>>>(
      mask, ch, S, T, tile_off, counts);
  return cudaGetLastError();
}

}  // namespace

// Channels a launch takes; the wrapper groups more than this.
extern "C" int compact_rows_max_channels() { return kMaxChannels; }

// Bytes of device scratch a launch over (N, S) needs.
extern "C" long long compact_rows_scratch_bytes(int n_rows, long long S) {
  const long long tiles = (long long)n_rows * ((S + kTile - 1) / kTile);
  return tiles * 2 * sizeof(int);
}

// src[c] == 0: channel c is the slot offset.  *vector gets 1 where the
// vector form ran, else 0.  N >= 1, S >= 1, n_channels <= kMaxChannels.
extern "C" int compact_rows_launch(const unsigned char* mask, int n_rows,
                                   long long S, int n_channels,
                                   const long long* src, const long long* out,
                                   const int* fills, int* counts,
                                   void* scratch, void* stream, int* vector) {
  if (n_channels < 0 || n_channels > kMaxChannels) {
    return (int)cudaErrorInvalidValue;
  }
  Channels ch{};
  ch.n = n_channels;
  bool vec = S % 16 == 0 && aligned16(mask);
  for (int c = 0; c < n_channels; ++c) {
    ch.src[c] = reinterpret_cast<const int*>(src[c]);
    ch.out[c] = reinterpret_cast<int*>(out[c]);
    ch.fill[c] = fills[c];
    vec = vec && aligned16(ch.out[c]) &&
          (ch.src[c] == nullptr || aligned16(ch.src[c]));
  }
  *vector = vec ? 1 : 0;
  const long long T = (S + kTile - 1) / kTile;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(mask, ch, n_rows, S, (int)T, counts,
                                  scratch, st)
                   : launch<false>(mask, ch, n_rows, S, (int)T, counts,
                                   scratch, st));
}
