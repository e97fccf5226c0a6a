// Fused top-down expand over one chunk of consecutive edge ids (paper
// sec. 3.4, Alg. 3 lines 2-8).
//
// Replaces: the Pallas kernel src/repro/kernels/expand.py:expand_chunk
// (stages _binsearch_map.map_workload_tile and _visited_filter.filter_tile).
// Computes, for lane t of the chunk with gid = start + t, exactly what the
// Pallas kernel computes lane for lane:
//   k    = min(max{l <= front_total : cumul[l] <= gid}, ncl - 1)
//   u    = clip(front[k], 0, ncl - 1)
//   v    = gid < cumul[front_total] ? row_idx[clip(col_off[u] + gid - cumul[k])]
//                                   : 0
//   won  = live & bit v of `words` unset & no earlier live lane of the same
//          tile carries v
// with tile = blockDim.x (the Python wrapper picks the largest divisor of
// the chunk length <= 512, as `_pick_tile` does), one CUDA block per tile.
//
// What bounds it on an H100: bytes.  Per lane it reads one row_idx word (a
// gather, 4 B) and one visited word, and writes 9 B (v, u, won); per
// frontier slot the chunk spans it reads cumul, front and col_off once.
// The TPU kernel mapped lanes to slots with windowed broadcast-compares
// because the VPU has no cheap scalar gathers.  Here a block takes
// stage::kLanes consecutive tiles, thread t lane t of each, and maps its
// gids with `stage::workload_map_block`: two searches by one warp, a
// coalesced walk over the slots the block spans and a max-scan (a search
// per lane where the span is many times the lanes), in place of a binary
// search per thread.  Stage 3 claims into a hash table in
// shared memory per tile (`stage::filter_tile`), O(1) expected work a lane
// in place of a scan of the tile.  The kLanes lanes of a thread share the
// block's search and barriers and keep their loads in flight together.  A
// block wholly past the live total skips both stages: every lane there has
// v = 0, won = 0 and the same u.  front_total and the live total are read
// from device memory, so a launch needs no host synchronisation.
//
// Stages 1 and 3 are `stage::workload_map_block` and `stage::filter_tile`
// of stages.cuh; B11 (stages.cu) runs the same `filter_tile` alone.
#include <cuda_runtime.h>

#include "stages.cuh"

namespace {

using stage::kLanes;

constexpr int kValueThreads = 256;

__device__ __forceinline__ int clip_col(int x, int ncl) {
  return min(max(x, 0), ncl - 1);
}

__global__ void expand_chunk_kernel(
    int start, int n_lanes, const int* __restrict__ cumul,
    const int* __restrict__ front, int ncl,
    const int* __restrict__ front_total, const int* __restrict__ col_off,
    const int* __restrict__ row_idx, long long nnz_cap,
    const unsigned* __restrict__ words, long long nw, int* __restrict__ v_out,
    unsigned char* __restrict__ won_out, int* __restrict__ u_out) {
  // the kLanes hash tables of stage 3, then stage 1's map
  extern __shared__ unsigned long long expand_shared[];
  const int tile = blockDim.x, t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * kLanes * tile;
  const int n_live = (int)min((long long)kLanes * tile, n_lanes - b0);
  const int g0 = start + (int)b0;
  const int ft = *front_total;
  const int total = cumul[ft];

  if (g0 >= total) {          // every lane masked: k = front_total
    const int u = clip_col(front[min(ft, ncl - 1)], ncl);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int i = j * tile + t;
      if (i < n_live) {
        v_out[b0 + i] = 0;
        u_out[b0 + i] = u;
        won_out[b0 + i] = 0;
      }
    }
    return;
  }

  // stage 1: workload map, k = max{l in [0, ft] : cumul[l] <= gid}
  int k[kLanes];
  stage::workload_map_block(
      cumul, ft + 1, g0, n_live,
      reinterpret_cast<int*>(expand_shared + kLanes *
                             stage::filter_table_slots(tile)), k);

  // stage 2: neighbour gather through the CSC offsets; the address wraps
  // as int32 exactly as the JAX formula does before it is clipped
  int v[kLanes], u[kLanes];
  bool live[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = j * tile + t;
    const int kj = min(k[j], ncl - 1);
    const int gid = g0 + min(i, n_live - 1);
    u[j] = clip_col(front[kj], ncl);
    const int addr =
        (int)((unsigned)col_off[u[j]] + (unsigned)gid - (unsigned)cumul[kj]);
    live[j] = i < n_live && gid < total;
    const long long a = min(max((long long)addr, 0LL), nnz_cap - 1);
    v[j] = live[j] ? row_idx[a] : 0;
  }

  // stage 3: visited-bitmap test + first occurrence within each tile
  bool won[kLanes];
  stage::filter_tile(v, live, words, nw, won);

#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = j * tile + t;
    if (i < n_live) {
      v_out[b0 + i] = v[j];
      u_out[b0 + i] = u[j];
      won_out[b0 + i] = won[j];
    }
  }
}


// Value-carrying twin (CC / SSSP / multi-source BFS).
//
// Replaces: the Pallas kernel src/repro/kernels/expand.py:
// expand_chunk_values (`_value_expand_kernel`).  Stages 1 and 2 as above,
// no visited filter; per lane it writes
//   v    as above,
//   pay  = payload[k]                  (the frontier value carried along)
//   addr = clip(col_off[u] + gid - cumul[k], 0, nnz_cap - 1)
//                                      (the CSC address, for edge values)
//   valid = gid < cumul[front_total].
// 256 threads and kLanes * 256 lanes to a block, the last block ragged
// (n_lanes need not divide into anything: there is no tile stage).  Stage
// 1 is `stage::workload_map_block` over the block's lanes; a block wholly
// past the live total takes k = front_total without it.  What bounds it:
// bytes, as for expand_chunk (one row_idx gather and 13 B written per
// lane).
__global__ void expand_chunk_values_kernel(
    int start, int n_lanes, const int* __restrict__ cumul,
    const int* __restrict__ front, const int* __restrict__ payload, int ncl,
    const int* __restrict__ front_total, const int* __restrict__ col_off,
    const int* __restrict__ row_idx, long long nnz_cap,
    int* __restrict__ v_out, int* __restrict__ pay_out,
    int* __restrict__ addr_out, unsigned char* __restrict__ valid_out) {
  __shared__ int kmap[kLanes * kValueThreads];
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * kLanes * kValueThreads;
  const int n_live =
      (int)min((long long)kLanes * kValueThreads, n_lanes - b0);
  const int g0 = start + (int)b0;
  const int ft = *front_total;
  const int total = cumul[ft];

  int k[kLanes];
  if (g0 >= total) {          // every lane masked: k = front_total
#pragma unroll
    for (int j = 0; j < kLanes; ++j) k[j] = ft;
  } else {
    stage::workload_map_block(cumul, ft + 1, g0, n_live, kmap, k);
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = j * kValueThreads + t;
    if (i < n_live) {
      const int gid = g0 + i;
      const int kj = min(k[j], ncl - 1);
      const int u = clip_col(front[kj], ncl);
      const int addr =
          (int)((unsigned)col_off[u] + (unsigned)gid - (unsigned)cumul[kj]);
      const bool live = gid < total;
      const long long a = min(max((long long)addr, 0LL), nnz_cap - 1);
      v_out[b0 + i] = live ? row_idx[a] : 0;
      pay_out[b0 + i] = payload[kj];
      addr_out[b0 + i] = (int)a;
      valid_out[b0 + i] = live;
    }
  }
}

}  // namespace

extern "C" int expand_chunk_values_launch(
    int start, int n_lanes, const int* cumul, const int* front,
    const int* payload, int ncl, const int* front_total, const int* col_off,
    const int* row_idx, long long nnz_cap, int* v_out, int* pay_out,
    int* addr_out, unsigned char* valid_out, void* stream) {
  constexpr int kBlockLanes = kLanes * kValueThreads;
  const unsigned blocks =
      (unsigned)((n_lanes + kBlockLanes - 1) / kBlockLanes);
  expand_chunk_values_kernel<<<blocks, kValueThreads, 0,
                               (cudaStream_t)stream>>>(
      start, n_lanes, cumul, front, payload, ncl, front_total, col_off,
      row_idx, nnz_cap, v_out, pay_out, addr_out, valid_out);
  return (int)cudaGetLastError();
}

extern "C" int expand_chunk_launch(
    int start, int n_lanes, int tile, const int* cumul, const int* front,
    int ncl, const int* front_total, const int* col_off, const int* row_idx,
    long long nnz_cap, const int* words, long long nw, int* v_out,
    unsigned char* won_out, int* u_out, void* stream) {
  const size_t shmem =
      stage::filter_tile_shmem(tile) + stage::workload_map_block_shmem(tile);
  const cudaError_t err = stage::allow_shmem(expand_chunk_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = n_lanes / tile;
  expand_chunk_kernel<<<(n_tiles + kLanes - 1) / kLanes, tile, shmem,
                        (cudaStream_t)stream>>>(
      start, n_lanes, cumul, front, ncl, front_total, col_off, row_idx,
      nnz_cap, reinterpret_cast<const unsigned*>(words), nw, v_out, won_out,
      u_out);
  return (int)cudaGetLastError();
}
