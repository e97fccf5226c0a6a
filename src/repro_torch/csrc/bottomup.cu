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
// (r, c, hit); the binary search reads log2(nrl) cumul words per lane, but
// neighbouring lanes share most of their probes (they hit in L1/L2).  The
// TPU kernel replaced the per-lane binary search by windowed broadcast-
// compares; a GPU thread gathers natively, so each thread runs its own
// search, as B1 does.  `total` is read from device memory, so a launch
// needs no host synchronisation.  There is no dedup stage: the caller's
// scatter-min per row is order-independent.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clip_by_value(int x, int total) {
  return x < total ? x : INT_MAX;
}

__global__ void bottomup_chunk_kernel(
    int start, int n_lanes, const int* __restrict__ cumul, int nrl,
    const int* __restrict__ total_p, const int* __restrict__ row_off,
    const int* __restrict__ col_idx, long long nnz_cap,
    const unsigned* __restrict__ words, long long nw, int block,
    int* __restrict__ r_out, int* __restrict__ c_out,
    unsigned char* __restrict__ hit_out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_lanes) return;
  const int gid = start + (int)t;
  const int total = *total_p;

  // stage 1: workload map over the value-clipped masked cumsum
  int lo = 0, hi = nrl + 1;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (clip_by_value(cumul[mid], total) <= gid) lo = mid; else hi = mid;
  }
  const int r = min(lo, nrl - 1);

  // stage 2: in-neighbour gather through the CSR offsets; the address wraps
  // as int32 exactly as the JAX formula does before it is clipped
  const int addr = (int)((unsigned)row_off[r] + (unsigned)gid -
                         (unsigned)clip_by_value(cumul[r], total));
  const bool live = gid < total;
  const long long a = min(max((long long)addr, 0LL), nnz_cap - 1);
  const int c = live ? col_idx[a] : 0;

  // stage 3: blocked frontier-bitmap membership
  bool hit = false;
  if (live) {
    const int n_words = (block + 31) / 32;
    const int off = c % block;
    const long long w = min(max((long long)(c / block) * n_words + (off >> 5),
                                0LL), nw - 1);
    hit = (words[w] >> (off & 31)) & 1u;
  }
  r_out[t] = r;
  c_out[t] = c;
  hit_out[t] = hit;
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
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_lanes) return;
  const int gid = start + (int)t;
  const int total = *total_p;

  int lo = 0, hi = nrl + 1;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (clip_by_value(cumul[mid], total) <= gid) lo = mid; else hi = mid;
  }
  const int r = min(lo, nrl - 1);
  const int addr = (int)((unsigned)row_off[r] + (unsigned)gid -
                         (unsigned)clip_by_value(cumul[r], total));
  const bool live = gid < total;
  const long long a = min(max((long long)addr, 0LL), nnz_cap - 1);
  const int c = live ? col_idx[a] : 0;

  bool hit = false;
  if (live) {
    const int n_words = (block + 31) / 32;
    const int off = c % block;
    const long long w = min(max((long long)(c / block) * n_words + (off >> 5),
                                0LL), nw - 1);
    hit = (words[w] >> (off & 31)) & 1u;
  }
  r_out[t] = r;
  pay_out[t] = dense_pay[min(max(c, 0), ncl - 1)];
  addr_out[t] = (int)a;
  hit_out[t] = hit;
}

}  // namespace

extern "C" int bottomup_chunk_launch(
    int start, int n_lanes, const int* cumul, int nrl, const int* total,
    const int* row_off, const int* col_idx, long long nnz_cap,
    const int* words, long long nw, int block, int* r_out, int* c_out,
    unsigned char* hit_out, void* stream) {
  const unsigned blocks = (unsigned)((n_lanes + kThreads - 1) / kThreads);
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
  const unsigned blocks = (unsigned)((n_lanes + kThreads - 1) / kThreads);
  bottomup_chunk_values_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      start, n_lanes, cumul, nrl, total, row_off, col_idx, nnz_cap,
      reinterpret_cast<const unsigned*>(words), nw, block, dense_pay, ncl,
      r_out, pay_out, addr_out, hit_out);
  return (int)cudaGetLastError();
}
