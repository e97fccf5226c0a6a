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
// gather, 4 B) and one visited word, and writes 9 B (v, u, won); the
// binary search reads log2(front) cumul words per lane, but neighbouring
// lanes share most of their probes, so they hit in L1/L2.  The TPU kernel
// replaced the per-lane binary search by windowed broadcast-compares because
// the VPU has no cheap scalar gathers; a GPU thread gathers natively, so the
// search is back to one independent binary search per thread, as in the
// paper's Kepler code.  front_total and the live total are read from device
// memory, so a launch needs no host synchronisation.
//
// Stages 1 and 3 are `stage::workload_map` and `stage::filter_tile` of
// stages.cuh, shared with the standalone ops B10 and B11 (stages.cu).
#include <cuda_runtime.h>

#include "stages.cuh"

namespace {

__global__ void expand_chunk_kernel(
    int start, const int* __restrict__ cumul, const int* __restrict__ front,
    int ncl, const int* __restrict__ front_total,
    const int* __restrict__ col_off, const int* __restrict__ row_idx,
    long long nnz_cap, const unsigned* __restrict__ words, long long nw,
    int* __restrict__ v_out, unsigned char* __restrict__ won_out,
    int* __restrict__ u_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int gid = start + (int)t;
  const int ft = *front_total;
  const int total = cumul[ft];

  // stage 1: workload map, k = max{l in [0, ft] : cumul[l] <= gid}
  const int k = min(stage::workload_map(cumul, ft + 1, gid), ncl - 1);

  // stage 2: neighbour gather through the CSC offsets; the address wraps
  // as int32 exactly as the JAX formula does before it is clipped
  const int u = min(max(front[k], 0), ncl - 1);
  const int addr =
      (int)((unsigned)col_off[u] + (unsigned)gid - (unsigned)cumul[k]);
  const bool live = gid < total;
  const long long a = min(max((long long)addr, 0LL), nnz_cap - 1);
  const int v = live ? row_idx[a] : 0;

  // stage 3: visited-bitmap test + first occurrence within the tile
  const bool won = stage::filter_tile(v, live, words, nw);

  v_out[t] = v;
  u_out[t] = u;
  won_out[t] = won;
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
// One thread per lane, 256 to a block: there is no tile stage, so the chunk
// length need not divide into tiles.  What bounds it: bytes, as for
// expand_chunk (one row_idx gather and 13 B written per lane).
__global__ void expand_chunk_values_kernel(
    int start, int n_lanes, const int* __restrict__ cumul,
    const int* __restrict__ front, const int* __restrict__ payload, int ncl,
    const int* __restrict__ front_total, const int* __restrict__ col_off,
    const int* __restrict__ row_idx, long long nnz_cap,
    int* __restrict__ v_out, int* __restrict__ pay_out,
    int* __restrict__ addr_out, unsigned char* __restrict__ valid_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int gid = start + (int)t;
  const int ft = *front_total;
  const int total = cumul[ft];

  const int k = min(stage::workload_map(cumul, ft + 1, gid), ncl - 1);
  const int u = min(max(front[k], 0), ncl - 1);
  const int addr =
      (int)((unsigned)col_off[u] + (unsigned)gid - (unsigned)cumul[k]);
  const bool live = gid < total;
  const long long a = min(max((long long)addr, 0LL), nnz_cap - 1);

  v_out[t] = live ? row_idx[a] : 0;
  pay_out[t] = payload[k];
  addr_out[t] = (int)a;
  valid_out[t] = live;
}

}  // namespace

extern "C" int expand_chunk_values_launch(
    int start, int n_lanes, const int* cumul, const int* front,
    const int* payload, int ncl, const int* front_total, const int* col_off,
    const int* row_idx, long long nnz_cap, int* v_out, int* pay_out,
    int* addr_out, unsigned char* valid_out, void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n_lanes + kThreads - 1) / kThreads);
  expand_chunk_values_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      start, n_lanes, cumul, front, payload, ncl, front_total, col_off,
      row_idx, nnz_cap, v_out, pay_out, addr_out, valid_out);
  return (int)cudaGetLastError();
}

extern "C" int expand_chunk_launch(
    int start, int n_lanes, int tile, const int* cumul, const int* front,
    int ncl, const int* front_total, const int* col_off, const int* row_idx,
    long long nnz_cap, const int* words, long long nw, int* v_out,
    unsigned char* won_out, int* u_out, void* stream) {
  expand_chunk_kernel<<<n_lanes / tile, tile, stage::filter_tile_shmem(tile),
                        (cudaStream_t)stream>>>(
      start, cumul, front, ncl, front_total, col_off, row_idx, nnz_cap,
      reinterpret_cast<const unsigned*>(words), nw, v_out, won_out, u_out);
  return (int)cudaGetLastError();
}
