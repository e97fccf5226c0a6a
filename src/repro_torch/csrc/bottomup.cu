// Fused bottom-up parent search over one chunk of consecutive edge ids
// (direction-optimised BFS, DESIGN.md sec. 11).
//
// Replaces: the Pallas kernel src/repro/kernels/bottomup.py:bottomup_chunk
// (`_bottomup_kernel`).  For lane t of the chunk with gid = start + t it
// computes exactly what the Pallas kernel computes lane for lane:
//   cc[l] = cumul[l] < total ? cumul[l] : INT32_MAX   (`_clip_by_value`)
//   r     = clip(max{l in [0, nrl] : cc[l] <= gid} (0 if none), 0, nrl - 1)
//   addr  = clip(row_off[r] + gid - cc[r], 0, nnz_cap - 1)   (int32 wrap)
//   c     = gid < total ? col_idx[addr] : 0
//   hit   = gid < total && bit c of the blocked frontier bitmap
// where the bitmap holds R blocks of W = ceil(block / 32) words and local
// col c sits in block c / block at bit c % block (`test_bit_blocks`).
//
// What bounds it on an H100: bytes.  Per live lane it reads one col_idx
// word (a gather, 4 B) and one frontier word, and every lane writes 9 B
// (r, c, hit); per row slot the chunk spans it reads cumul (and, for a row
// that owns a live lane, row_off) once.  The TPU kernel mapped lanes to
// rows with windowed broadcast-compares because the VPU has no cheap
// scalar gathers.  Here a block takes stage::kLanes * 256 consecutive
// lanes, thread t the lanes j * 256 + t (so the stores coalesce), and maps
// them with `stage::workload_map_block` over the value-clipped cumsum (cap
// = total): two searches by one warp, then a coalesced walk over the row
// slots the block spans and a max-scan, or a search per lane inside the
// span where it is wide, in place of ~25 dependent probes a lane over the
// 2^25-slot cumul.  The last block is ragged: there is no tile stage.
// `total` is read from device memory, so a launch needs no host
// synchronisation.  There is no dedup stage: the caller's scatter-min per
// row is order-independent.
//
// Unlike the top-down map (one slot per frontier entry), the bottom-up
// cumsum has a slot for every local row, and each visited row is a
// zero-width slot, so a block's span covers the visited rows between its
// live rows too; when most rows are visited, one block can span
// millions of slots.  `workload_map_block` writes only the last slot
// of a zero-width run (no atomic contention) and switches to the lane
// searches past its walk limit.  A block wholly past the live total needs
// no walk: every lane there maps to max{l : cumul[l] < total} (0 where
// none), which the block's one search finds, and still gets the Pallas
// kernel's r and, for B9, its clipped address and dense_pay[0].
#include <cuda_runtime.h>

#include "stages.cuh"

namespace {

using stage::clip_by_value;
using stage::kLanes;

constexpr int kThreads = 256;
constexpr int kBlockLanes = kLanes * kThreads;

// Stages 1 and 2 for the kLanes lanes of this thread in a block of
// consecutive gids from g0 (n_live of them): r, the clipped CSR address a,
// the neighbour col c (0 on masked lanes) and whether the lane is live.
__device__ __forceinline__ void map_and_gather(
    int g0, int n_live, const int* __restrict__ cumul, int nrl, int total,
    const int* __restrict__ row_off, const int* __restrict__ col_idx,
    long long nnz_cap, int* kmap, int (&r)[kLanes], long long (&a)[kLanes],
    int (&c)[kLanes], bool (&live)[kLanes]) {
  // stage 1: workload map over the value-clipped masked cumsum
  int k[kLanes];
  stage::workload_map_block(cumul, nrl + 1, g0, n_live, kmap, k, total);
  // stage 2: in-neighbour gather through the CSR offsets; the address wraps
  // as int32 exactly as the JAX formula does before it is clipped
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int gid = g0 + min(i, n_live - 1);
    r[j] = min(k[j], nrl - 1);
    const int addr = (int)((unsigned)row_off[r[j]] + (unsigned)gid -
                           (unsigned)clip_by_value(cumul[r[j]], total));
    live[j] = i < n_live && gid < total;
    a[j] = min(max((long long)addr, 0LL), nnz_cap - 1);
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) c[j] = live[j] ? col_idx[a[j]] : 0;
}

// Stage 3: blocked frontier-bitmap membership of c on a live lane.
__device__ __forceinline__ bool test_bit(const unsigned* __restrict__ words,
                                         long long nw, int block, int c,
                                         bool live) {
  if (!live) return false;
  const int n_words = (block + 31) / 32;
  const int off = c % block;
  const long long w = min(max((long long)(c / block) * n_words + (off >> 5),
                              0LL), nw - 1);
  return (words[w] >> (off & 31)) & 1u;
}

__global__ void bottomup_chunk_kernel(
    int start, int n_lanes, const int* __restrict__ cumul, int nrl,
    const int* __restrict__ total_p, const int* __restrict__ row_off,
    const int* __restrict__ col_idx, long long nnz_cap,
    const unsigned* __restrict__ words, long long nw, int block,
    int* __restrict__ r_out, int* __restrict__ c_out,
    unsigned char* __restrict__ hit_out) {
  __shared__ int kmap[kBlockLanes];
  const long long b0 = (long long)blockIdx.x * kBlockLanes;
  const int n_live = (int)min((long long)kBlockLanes, n_lanes - b0);
  int r[kLanes], c[kLanes];
  long long a[kLanes];
  bool live[kLanes];
  map_and_gather(start + (int)b0, n_live, cumul, nrl, *total_p, row_off,
                 col_idx, nnz_cap, kmap, r, a, c, live);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const bool hit = test_bit(words, nw, block, c[j], live[j]);
    if (i < n_live) {
      r_out[b0 + i] = r[j];
      c_out[b0 + i] = c[j];
      hit_out[b0 + i] = hit;
    }
  }
}

// Value-pulling twin (CC / SSSP / multi-source BFS in bottom-up levels).
//
// Replaces: the Pallas kernel src/repro/kernels/bottomup.py:
// bottomup_chunk_values (`_value_bottomup_kernel`).  Stages 1 to 3 as
// above; per lane it writes r and hit as above and
//   pay  = dense_pay[c]   (the frontier neighbour's value; c = 0 on masked
//                          lanes, as in the Pallas kernel)
//   addr = clip(row_off[r] + gid - cc[r], 0, nnz_cap - 1)
//                         (the CSR address, for edge values).
// What bounds it: bytes, as for bottomup_chunk, plus one dense_pay gather
// and 4 B more written per lane.
__global__ void bottomup_chunk_values_kernel(
    int start, int n_lanes, const int* __restrict__ cumul, int nrl,
    const int* __restrict__ total_p, const int* __restrict__ row_off,
    const int* __restrict__ col_idx, long long nnz_cap,
    const unsigned* __restrict__ words, long long nw, int block,
    const int* __restrict__ dense_pay, int ncl, int* __restrict__ r_out,
    int* __restrict__ pay_out, int* __restrict__ addr_out,
    unsigned char* __restrict__ hit_out) {
  __shared__ int kmap[kBlockLanes];
  const long long b0 = (long long)blockIdx.x * kBlockLanes;
  const int n_live = (int)min((long long)kBlockLanes, n_lanes - b0);
  int r[kLanes], c[kLanes];
  long long a[kLanes];
  bool live[kLanes];
  map_and_gather(start + (int)b0, n_live, cumul, nrl, *total_p, row_off,
                 col_idx, nnz_cap, kmap, r, a, c, live);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const bool hit = test_bit(words, nw, block, c[j], live[j]);
    const int pay = dense_pay[min(max(c[j], 0), ncl - 1)];
    if (i < n_live) {
      r_out[b0 + i] = r[j];
      pay_out[b0 + i] = pay;
      addr_out[b0 + i] = (int)a[j];
      hit_out[b0 + i] = hit;
    }
  }
}

}  // namespace

extern "C" int bottomup_chunk_launch(
    int start, int n_lanes, const int* cumul, int nrl, const int* total,
    const int* row_off, const int* col_idx, long long nnz_cap,
    const int* words, long long nw, int block, int* r_out, int* c_out,
    unsigned char* hit_out, void* stream) {
  const unsigned blocks =
      (unsigned)(((long long)n_lanes + kBlockLanes - 1) / kBlockLanes);
  bottomup_chunk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      start, n_lanes, cumul, nrl, total, row_off, col_idx, nnz_cap,
      reinterpret_cast<const unsigned*>(words), nw, block, r_out, c_out,
      hit_out);
  return (int)cudaGetLastError();
}

extern "C" int bottomup_chunk_values_launch(
    int start, int n_lanes, const int* cumul, int nrl, const int* total,
    const int* row_off, const int* col_idx, long long nnz_cap,
    const int* words, long long nw, int block, const int* dense_pay, int ncl,
    int* r_out, int* pay_out, int* addr_out, unsigned char* hit_out,
    void* stream) {
  const unsigned blocks =
      (unsigned)(((long long)n_lanes + kBlockLanes - 1) / kBlockLanes);
  bottomup_chunk_values_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      start, n_lanes, cumul, nrl, total, row_off, col_idx, nnz_cap,
      reinterpret_cast<const unsigned*>(words), nw, block, dense_pay, ncl,
      r_out, pay_out, addr_out, hit_out);
  return (int)cudaGetLastError();
}
