// The stages the chunk kernels share (paper sec. 3.4, Alg. 3 lines 2 and
// 5-8), one copy of each: expand.cu (B1, B8) and bottomup.cu (B7, B9) run
// them fused, stages.cu (B10, B11) runs them as standalone ops.
//
// Stage 1 is block-cooperative: a warp finds the cumul slots of a block's
// smallest and largest gid (`warp_map2`), and the block's lanes map inside
// that span.  `workload_map_block` takes a block of consecutive gids (B1,
// B8 over the frontier's cumsum; B7, B9 over the value-capped cumsum of
// every local row) and walks the slots it spans, or, where that span is
// many times the block's lanes, has each lane search inside it
// (`search_lanes`); B10's kernel (stages.cu) takes any gids and searches
// by lane, in shared memory where the span is short.  Stage 3,
// `filter_tile`, claims into a hash table in shared memory (B1, B11).  The
// block forms give each thread kLanes lanes.
//
// The words are the uint32 visited bitmap as int32 bit patterns; the
// kernels read them as unsigned, so the test shifts them as unsigned.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace stage {

// `_clip_by_value` of the bottom-up kernels: an entry at or past `cap`
// reads as INT32_MAX.
__device__ __forceinline__ int clip_by_value(int x, int cap) {
  return x < cap ? x : INT_MAX;
}

// Stage 1, the workload map:
//   max{l in [0, n) : clip_by_value(cumul[l], cap) <= gid}, 0 where none,
// over a non-decreasing cumul; the default cap reads cumul as it is.  One
// binary search by one thread, log2(n) dependent loads: `warp_map2`'s
// form for a warp of one lane.
__device__ __forceinline__ int workload_map(const int* __restrict__ cumul,
                                            int n, int gid,
                                            int cap = INT_MAX) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (clip_by_value(cumul[mid], cap) <= gid) lo = mid; else hi = mid;
  }
  return lo;
}

// The two searches of `workload_map_block`, run by the first `nl` lanes
// of warp 0 together (mask: those lanes), each `workload_map` with the
// same cap.  Each round every lane probes one point of each range, lane 0
// the range's low end, and a ballot keeps the last point whose clipped
// value is <= the target: ceil(log_nl(n)) rounds of dependent loads in
// place of log2(n), 5 for a 2^25-slot cumul.  The points that pass form a
// prefix of the lanes, because the clipped cumul does not decrease either
// (once an entry reaches the cap, every later one does).
__device__ __forceinline__ void warp_map2(const int* __restrict__ cumul,
                                          int n, int ga, int gb, int nl,
                                          unsigned mask, int& ka, int& kb,
                                          int cap = INT_MAX) {
  if (nl == 1) {
    ka = workload_map(cumul, n, ga, cap);
    kb = workload_map(cumul, n, gb, cap);
    return;
  }
  const int lane = threadIdx.x & 31;
  int lo_a = 0, hi_a = n, lo_b = 0, hi_b = n;
  while (hi_a - lo_a > 1 || hi_b - lo_b > 1) {
    const int sa = (hi_a - lo_a + nl - 1) / nl;
    const int sb = (hi_b - lo_b + nl - 1) / nl;
    const long long pa = lo_a + (long long)lane * sa;
    const long long pb = lo_b + (long long)lane * sb;
    const bool ta =
        lane == 0 || (pa < hi_a && clip_by_value(cumul[pa], cap) <= ga);
    const bool tb =
        lane == 0 || (pb < hi_b && clip_by_value(cumul[pb], cap) <= gb);
    lo_a += (31 - __clz(__ballot_sync(mask, ta))) * sa;
    lo_b += (31 - __clz(__ballot_sync(mask, tb))) * sb;
    hi_a = min(lo_a + sa, hi_a);
    hi_b = min(lo_b + sb, hi_b);
  }
  ka = lo_a;
  kb = lo_b;
}

// Lanes a thread carries in the block forms (`workload_map_block`,
// `filter_tile`): a block takes kLanes * blockDim.x consecutive lanes,
// thread t the lanes j * blockDim.x + t, so one search and one set of
// barriers serve kLanes lanes a thread, and each thread has kLanes
// independent loads in flight.
constexpr int kLanes = 4;

// Each lane's max{l in [0, len) : base[l] <= gid[j]}, 0 where none, over a
// non-decreasing base (global or shared memory): log2(len) dependent
// probes a lane, the N searches of a thread taking the same steps (they
// depend on len alone), so their probes are in flight together.
template <int N>
__device__ __forceinline__ void search_lanes(const int* __restrict__ base,
                                             int len, const int (&gid)[N],
                                             int (&k)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) k[j] = 0;
  // the answer lies in [k[j], k[j] + len - 1]
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (base[k[j] + half] <= gid[j]) k[j] += half;
    }
    len -= half;
  }
}

// Dynamic shared memory that `workload_map_block` needs for a block of
// `threads` threads: one int a lane.
__host__ __device__ constexpr size_t workload_map_block_shmem(int threads) {
  return (size_t)kLanes * threads * sizeof(int);
}

// Spanned slots a lane of the block that `workload_map_block` walks
// before its lanes search by themselves instead (65536 slots for 1024
// lanes): past it, span / blockDim.x walk rounds cost more than log2(span)
// dependent probes a lane.  64 was the fastest of 0 (always search), 8,
// 16, 32, 64, 128 and no limit on the bottom-up BFS calls of an R-MAT
// SCALE 26 graph (scripts/torch_bottomup_designs.py, PERF.md).
constexpr int kWalkSlotsPerLane = 64;

// Stage 1 for a block whose lane i = j * blockDim.x + t carries gid =
// g0 + i, i < n_live (1 <= n_live <= kLanes * blockDim.x); k[j] is lane
// i's
//   max{l in [0, n) : clip_by_value(cumul[l], cap) <= gid}, 0 where none,
// equal to `workload_map` with the same cap on every such lane (a lane
// past n_live gets some slot in [0, n)).  The gids are consecutive, so
// their k form one non-decreasing run from k_first = k(g0) to k_last =
// k(g0 + n_live - 1).  Warp 0 finds both (`warp_map2`); then, by the span
// k_last - k_first:
//  - 0: one slot holds every lane, or the block lies wholly at or past
//    the cap: every lane takes k_first, with no walk;
//  - up to kWalkSlotsPerLane slots a lane: the block walks the slots l in
//    (k_first, k_last] with coalesced loads, kLanes slots a thread a
//    round, and the last slot of each run of equal values writes l at
//    cumul[l] - g0 in `kmap` (shared, kLanes * blockDim.x ints).  A run
//    of zero-width slots shares one value and the map takes its last
//    slot; only that slot writes the entry, so a plain store does, where
//    an atomicMax from every slot of the run would serialise on one
//    address.  An inclusive max-scan over the block seeded with k_first
//    gives each lane its k: each thread scans kLanes consecutive entries,
//    the threads' maxima are scanned with warp shuffles and one pass
//    across warps;
//  - wider (most slots zero-width, as late in a bottom-up search, where one
//    block can span millions of slots): each lane runs a binary search of
//    its own over [k_first, k_last], log2(span) dependent probes, all
//    lanes in the same steps.
// Work per block is O(lanes + span) while the block walks; over a chunk at
// most one read of the cumul slots it spans.
// Why the cap leaves all of this exact: the clipped cumul still does not
// decrease (once an entry reaches the cap, every later one does); every
// slot l in (k_first, k_last] has clip_by_value(cumul[l], cap) <=
// g0 + n_live - 1 < INT_MAX (the wrappers keep every gid below
// INT32_MAX), so there cumul[l] is below the cap and equals its clipped
// value: the walk and the lane searches read cumul as it is, and the kmap
// index cumul[l] - g0 stays in [1, n_live - 1].  A lane at or past the cap
// inside the block finds every such slot <= its gid and takes k_last.
// Every thread of the block must call it: it synchronises the block.
__device__ __forceinline__ void workload_map_block(
    const int* __restrict__ cumul, int n, int g0, int n_live, int* kmap,
    int (&k)[kLanes], int cap = INT_MAX) {
  __shared__ int k_ends[2];
  __shared__ int warp_max[32];
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  // lanes of this thread's warp that exist (a block may be < 32 or ragged)
  const int in_warp = min(32, threads - (warp << 5));
  const unsigned wmask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) kmap[j * threads + t] = -1;
  if (warp == 0) {
    int ka, kb;
    warp_map2(cumul, n, g0, g0 + (n_live - 1), in_warp, wmask, ka, kb, cap);
    if (lane == 0) {
      k_ends[0] = ka;
      k_ends[1] = kb;
    }
  }
  __syncthreads();
  const int k_first = k_ends[0], k_last = k_ends[1];
  if (k_first == k_last) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) k[j] = k_first;
    return;
  }
  if (k_last - k_first > kWalkSlotsPerLane * kLanes * threads) {
    int gid[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      gid[j] = g0 + min(j * threads + t, n_live - 1);
    }
    search_lanes(cumul + k_first, k_last - k_first + 1, gid, k);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) k[j] += k_first;
    return;
  }
  for (int l0 = k_first + 1 + t; l0 <= k_last; l0 += kLanes * threads) {
    int v[kLanes], next[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = l0 + j * threads;
      v[j] = l <= k_last ? cumul[l] : 0;
      next[j] = l < k_last ? cumul[l + 1] : INT_MIN;
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = l0 + j * threads;
      if (l <= k_last && next[j] != v[j]) kmap[v[j] - g0] = l;
    }
  }
  __syncthreads();
  int part[kLanes];
  int m = k_first;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    m = max(m, kmap[t * kLanes + j]);
    part[j] = m;
  }
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(wmask, m, d);
    if (lane >= d) m = max(m, o);
  }
  if (lane == in_warp - 1) warp_max[warp] = m;
  __syncthreads();
  int before = k_first;             // max over the entries of lower threads
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
  const int up = __shfl_up_sync(wmask, m, 1);
  if (lane > 0) before = max(before, up);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    kmap[t * kLanes + j] = max(part[j], before);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLanes; ++j) k[j] = kmap[j * threads + t];
}

// Slots of one tile's hash table in `filter_tile` for a tile of `tile`
// lanes: the next power of two >= 2 * tile, so at most half of it is
// ever full (1024 slots, 8 KiB, at tile 512; 16 KiB at 1024).
__host__ __device__ constexpr int filter_table_slots(int tile) {
  int slots = 2;
  while (slots < 2 * tile) slots <<= 1;
  return slots;
}

// Dynamic shared memory that `filter_tile` needs for blocks of `tile`
// threads: the kLanes tiles' hash tables (32 KiB at tile 512).  A kernel
// that needs more places it after this much.
__host__ __device__ constexpr size_t filter_tile_shmem(int tile) {
  return (size_t)kLanes * filter_table_slots(tile) *
         sizeof(unsigned long long);
}

constexpr unsigned long long kEmptySlot = ~0ull;

// Stage 3, the visited filter over kLanes tiles of blockDim.x lanes each
// (tile j is the lanes j * blockDim.x + t, thread t carrying x[j]):
//   won = live & bit x of `words` unset
//         & no earlier live lane of the tile carries x,
// with the word index clamp(x >> 5, 0, nw - 1) in 64 bits.  Only live,
// unvisited lanes claim (whether x is visited depends on x alone, so a
// visited x loses on every lane that carries it).  A claim is the 64-bit
// word (uint32)x << 32 | t in its tile's open-addressing table in shared
// memory, the first slot by a multiplicative hash of x, then linear
// probing: atomicCAS into an empty slot (all ones; no claim can be, as a
// lane id is < 1024), atomicMin into the slot already holding x.  Keys
// never move, so every lane with x ends on the same slot, and after the
// barrier that slot holds x's smallest lane: a lane wins iff it reads its
// own claim back.  Exact for every int32 x.  O(1) expected work a lane
// in place of a scan of the tile.  Every thread of the block must call
// it: it synchronises the block.
__device__ __forceinline__ void filter_tile(const int (&x)[kLanes],
                                            const bool (&live)[kLanes],
                                            const unsigned* __restrict__ words,
                                            long long nw,
                                            bool (&won)[kLanes]) {
  extern __shared__ unsigned long long filter_table[];
  const int slots = filter_table_slots(blockDim.x);
  const int shift = 32 - (31 - __clz(slots));
  const unsigned t = threadIdx.x;
  for (int i = t; i < kLanes * slots; i += blockDim.x) {
    filter_table[i] = kEmptySlot;
  }
  bool claims[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const long long w = min(max((long long)(x[j] >> 5), 0LL), nw - 1);
    claims[j] = live[j] && ((words[w] >> (x[j] & 31)) & 1u) == 0;
  }
  __syncthreads();
  unsigned slot[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    unsigned long long* table = filter_table + j * slots;
    const unsigned long long mine =
        (unsigned long long)(unsigned)x[j] << 32 | t;
    unsigned h = ((unsigned)x[j] * 0x9E3779B1u) >> shift;
    if (claims[j]) {
      for (;;) {
        const unsigned long long old = atomicCAS(&table[h], kEmptySlot, mine);
        if (old == kEmptySlot) break;
        if ((unsigned)(old >> 32) == (unsigned)x[j]) {
          if ((unsigned)old > t) atomicMin(&table[h], mine);
          break;
        }
        h = (h + 1) & (slots - 1);
      }
    }
    slot[j] = h;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    won[j] = claims[j] &&
             filter_table[j * slots + slot[j]] ==
                 ((unsigned long long)(unsigned)x[j] << 32 | t);
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory, past the 48 KiB a
// launch gets unasked (tiles of 1024 lanes).
template <typename Kernel>
inline cudaError_t allow_shmem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace stage
