// The two stages of the fused expand as standalone ops (paper sec. 3.4,
// Alg. 3 lines 2 and 5-8): the workload map and the visited filter.  Their
// bodies are `stage::workload_map` and `stage::filter_tile` of
// stages.cuh.  B1 runs the same `filter_tile` fused, so B11 measures B1's
// stage 3; B1 and B8 map their consecutive gids with the block form
// `stage::workload_map_block`, which this op cannot use.
//
// binsearch_map_kernel
//   Replaces: the Pallas kernel src/repro/kernels/_binsearch_map.py:
//   binsearch_map (`map_workload_tile`).  For lane t:
//     k[t] = max{l in [0, n_cumul) : cumul[l] <= gids[t]}, 0 where none,
//   over a non-decreasing `cumul` clipped by the caller (entries past the
//   live frontier are INT32_MAX, `clip_cumul`).  On sorted gids this equals
//   the Pallas kernel on every lane: a masked lane (gid >= cumul[ft]) gets
//   k = ft, and a lane below cumul[0] gets 0 (the oracle's searchsorted
//   gives -1 there).  One thread per lane, each with its own binary
//   search: the op's gids need only be sorted, not consecutive, so the
//   block-cooperative form of B1 and B8 does not apply.  B7 and B9 run
//   this per-thread search too, with their value cap.
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

__global__ void binsearch_map_kernel(const int* __restrict__ cumul,
                                     int n_cumul,
                                     const int* __restrict__ gids,
                                     long long e, int* __restrict__ k_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= e) return;
  k_out[t] = stage::workload_map(cumul, n_cumul, gids[t]);
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
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  binsearch_map_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
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
