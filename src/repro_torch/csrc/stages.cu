// The two stages of the fused expand as standalone ops (paper sec. 3.4,
// Alg. 3 lines 2 and 5-8): the workload map and the visited filter.  They
// share stages.cuh with the fused kernels: B1 runs the same `filter_tile`,
// so B11 measures B1's stage 3; B10 maps its lanes with `warp_map2` and
// `search_lanes`, as `workload_map_block` does for B1, B7, B8 and B9, but
// without the walk, since its gids need not be consecutive.
//
// binsearch_map_kernel
//   Replaces: the Pallas kernel src/repro/kernels/_binsearch_map.py:
//   binsearch_map (`map_workload_tile`).  For lane t:
//     k[t] = max{l in [0, n_cumul) : cumul[l] <= gids[t]}, 0 where none,
//   over a non-decreasing `cumul` clipped by the caller (entries past the
//   live frontier are INT32_MAX, `clip_cumul`).  On gids sorted within each
//   Pallas tile this equals the Pallas kernel on every lane: a masked lane
//   (gid >= cumul[ft]) gets k = ft, and a lane below cumul[0] gets 0 (the
//   oracle's searchsorted gives -1 there).
//   A block takes kMapLanes = 2048 consecutive lanes (8 a thread, 256
//   threads).  Since k does not decrease with the gid, every lane's k lies
//   between the k of the block's smallest gid and the k of its largest: a
//   block reduction finds both gids and warp 0 both slots (`warp_map2`,
//   32-ary: 5 rounds of dependent loads for a 2^25-slot cumul).  The bounds
//   hold for any gids, so a block may straddle the Pallas tiles, sorted or
//   not.  Then, by the span k_last - k_first:
//    - 0 (the common case on a search's chunk, where 2^22 consecutive gids
//      span a few thousand slots): every lane takes k_first, with no
//      further load;
//    - below kMapSmemSlots: the block loads cumul[k_first .. k_last] once,
//      coalesced, into shared memory, and each lane binary-searches it
//      there;
//    - wider: each lane binary-searches [k_first, k_last] in global
//      memory, the 8 searches of a thread in flight together.
//   A search per lane over the whole cumul takes log2(n_cumul) dependent
//   loads a lane, 13 on a search's chunk.  A block's time is a chain of
//   dependent loads (its gids, the warp's 3-5 rounds, the span), so a
//   block must carry many lanes: 8 lanes a thread beat 4 by 12 % on a
//   search's chunk (0.0203 against 0.0232 ms with the L2 flushed, bound
//   0.0100; a search per lane 0.0495, torch.searchsorted 0.0695), but are
//   32 % slower on sparse gids whose blocks span thousands of slots, past
//   the shared budget; the budget itself moves either case by < 2 % from
//   512 to 2048 slots (scripts/torch_compact_designs.py, an NVIDIA H100
//   80GB HBM3 at 700 W).
//   What bounds it on an H100: bytes -- 4 B gid in and 4 B k out per lane,
//   plus the cumul slots the chunk's lanes span.
//
// visited_filter_kernel
//   Replaces: the Pallas kernel src/repro/kernels/_visited_filter.py:
//   visited_filter (`filter_tile`).  For lane t of a tile:
//     won[t] = valid[t] & bit v[t] of `words` unset
//              & no earlier valid lane of the same tile carries v[t],
//   with the word index clamp(v >> 5, 0, nw - 1) in 64 bits.  A block of
//   tile <= 1024 threads takes stage::kLanes consecutive tiles, its lanes
//   claiming into one hash table in shared memory per tile (16 KiB at
//   tile 1024): O(1) expected work a lane.  This is B1's stage 3
//   (expand.cu), the same code.
//   What bounds it on an H100: bytes -- 4 B v, 1 B valid and 1 B won per
//   lane, plus the distinct visited words read.
#include <cuda_runtime.h>

#include "stages.cuh"

namespace {

constexpr int kMapThreads = 256;
constexpr int kMapPerThread = 8;                         // lanes a thread
constexpr int kMapLanes = kMapPerThread * kMapThreads;   // lanes a block
// Cumul slots a block's span may have for its lanes to search in shared
// memory (2 KiB).
constexpr int kMapSmemSlots = 512;

__global__ void __launch_bounds__(kMapThreads)
    binsearch_map_kernel(const int* __restrict__ cumul, int n_cumul,
                         const int* __restrict__ gids, long long e,
                         int* __restrict__ k_out) {
  constexpr int kWarps = kMapThreads / 32;
  __shared__ int s_cumul[kMapSmemSlots > 0 ? kMapSmemSlots : 1];
  __shared__ int s_lo[kWarps], s_hi[kWarps], s_ends[3];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long b0 = (long long)blockIdx.x * kMapLanes;
  const int n_live = (int)min((long long)kMapLanes, e - b0);
  int g[kMapPerThread];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < kMapPerThread; ++j) {
    const int i = j * kMapThreads + t;
    g[j] = i < n_live ? gids[b0 + i] : INT_MIN;
    if (i < n_live) {
      lo = min(lo, g[j]);
      hi = max(hi, g[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? s_lo[lane] : INT_MAX;
    hi = lane < kWarps ? s_hi[lane] : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    int ka, kb;
    stage::warp_map2(cumul, n_cumul, lo, hi, 32, 0xffffffffu, ka, kb);
    if (lane == 0) {
      s_ends[0] = ka;
      s_ends[1] = kb;
      s_ends[2] = lo;
    }
  }
  __syncthreads();
  const int k_first = s_ends[0], k_last = s_ends[1];
  int k[kMapPerThread];
  if (k_first == k_last) {
#pragma unroll
    for (int j = 0; j < kMapPerThread; ++j) k[j] = k_first;
  } else {
    const int len = k_last - k_first + 1;
#pragma unroll
    for (int j = 0; j < kMapPerThread; ++j) {
      if (j * kMapThreads + t >= n_live) g[j] = s_ends[2];  // an in-span gid
    }
    if (len <= kMapSmemSlots) {
      for (int i = t; i < len; i += kMapThreads) {
        s_cumul[i] = cumul[k_first + i];
      }
      __syncthreads();
      stage::search_lanes(s_cumul, len, g, k);
    } else {
      stage::search_lanes(cumul + k_first, len, g, k);
    }
#pragma unroll
    for (int j = 0; j < kMapPerThread; ++j) k[j] += k_first;
  }
#pragma unroll
  for (int j = 0; j < kMapPerThread; ++j) {
    const int i = j * kMapThreads + t;
    if (i < n_live) k_out[b0 + i] = k[j];
  }
}

__global__ void visited_filter_kernel(const int* __restrict__ v,
                                      const unsigned char* __restrict__ valid,
                                      const unsigned* __restrict__ words,
                                      long long nw, long long e,
                                      unsigned char* __restrict__ won) {
  const int tile = blockDim.x, t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * stage::kLanes * tile;
  const int n_live = (int)min((long long)stage::kLanes * tile, e - b0);
  int x[stage::kLanes];
  bool live[stage::kLanes], out[stage::kLanes];
#pragma unroll
  for (int j = 0; j < stage::kLanes; ++j) {
    const int i = j * tile + t;
    x[j] = i < n_live ? v[b0 + i] : 0;
    live[j] = i < n_live && valid[b0 + i] != 0;
  }
  stage::filter_tile(x, live, words, nw, out);
#pragma unroll
  for (int j = 0; j < stage::kLanes; ++j) {
    const int i = j * tile + t;
    if (i < n_live) won[b0 + i] = out[j];
  }
}

}  // namespace

extern "C" int binsearch_map_launch(const int* cumul, int n_cumul,
                                    const int* gids, long long e, int* k_out,
                                    void* stream) {
  const unsigned blocks = (unsigned)((e + kMapLanes - 1) / kMapLanes);
  binsearch_map_kernel<<<blocks, kMapThreads, 0, (cudaStream_t)stream>>>(
      cumul, n_cumul, gids, e, k_out);
  return (int)cudaGetLastError();
}

extern "C" int visited_filter_launch(const int* v, const unsigned char* valid,
                                     const int* words, long long nw,
                                     long long e, int tile,
                                     unsigned char* won, void* stream) {
  const size_t shmem = stage::filter_tile_shmem(tile);
  const cudaError_t err = stage::allow_shmem(visited_filter_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = e / tile;
  visited_filter_kernel<<<(unsigned)((n_tiles + stage::kLanes - 1) /
                                     stage::kLanes),
                          tile, shmem, (cudaStream_t)stream>>>(
      v, valid, reinterpret_cast<const unsigned*>(words), nw, e, won);
  return (int)cudaGetLastError();
}
