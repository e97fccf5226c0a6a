// The stages the chunk kernels share (paper sec. 3.4, Alg. 3 lines 2 and
// 5-8), one copy of each: expand.cu (B1, B8) and bottomup.cu (B7, B9) run
// them fused, stages.cu (B10, B11) runs them as standalone ops.
//
// The words are the uint32 visited bitmap as int32 bit patterns; the
// kernels read them as unsigned, so the test shifts them as unsigned.
#pragma once

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
// independent binary search per thread: the TPU kernels' windowed
// broadcast-compare existed because the VPU has no cheap scalar gathers,
// and a GPU thread gathers natively.  Neighbouring lanes share most of
// their probes, so after the first probes they hit in L1/L2.
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

// Dynamic shared memory that `filter_tile` needs for a tile of `tile`
// lanes: the tile's values and live flags.
constexpr size_t filter_tile_shmem(int tile) {
  return (size_t)tile * (sizeof(int) + 1);
}

// Stage 3, the visited filter over one tile = one block (blockDim.x lanes):
//   won = live & bit x of `words` unset
//         & no earlier live lane of the tile carries x,
// with the word index clamp(x >> 5, 0, nw - 1) in 64 bits.  The tile's
// values and live flags are staged in shared memory and each lane scans
// the lanes before it (a broadcast read per step: every lane of a warp
// reads the same word).  That is O(tile) work per lane, the simple exact
// form; a shared-memory hash claim table is the faster later form.  Every
// thread of the block must call it: it synchronises the block.
__device__ __forceinline__ bool filter_tile(int x, bool live,
                                            const unsigned* __restrict__ words,
                                            long long nw) {
  extern __shared__ int tile_shared[];
  int* tile_v = tile_shared;
  unsigned char* tile_live =
      reinterpret_cast<unsigned char*>(tile_shared + blockDim.x);

  const int lane = threadIdx.x;
  const long long w = min(max((long long)(x >> 5), 0LL), nw - 1);
  const bool unvisited = live && ((words[w] >> (x & 31)) & 1u) == 0;
  tile_v[lane] = x;
  tile_live[lane] = live;
  __syncthreads();
  bool dup = false;
  for (int q = 0; q < lane && !dup; ++q) {
    dup = tile_live[q] && tile_v[q] == x;
  }
  return unvisited && !dup;
}

}  // namespace stage
