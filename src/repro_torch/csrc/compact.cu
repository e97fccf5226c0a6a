// Prefix-sum row compaction: front-pack each row's masked entries in order,
// pad with a fill value (the argsort replacement of DESIGN.md sec. 10).
//
// Replaces: the Pallas kernel src/repro/kernels/fold.py:compact_rows
// (`_compact_kernel`).  The Python wrapper computes the inclusive count
// prefix `inc` of the mask with torch.cumsum, as the JAX package computes
// it with jnp.cumsum outside its kernel; this kernel then places every
// masked entry at its rank, out[r, inc[r, s] - 1] = src[r, s], and writes
// the fill into every slot at or past the row's count inc[r, S - 1].  The
// two writes never meet, so one pass over the row does both.  The result
// equals a stable argsort of ~mask bit for bit.
//
// The Pallas grid is (N,), one program per row, answering each output slot
// with a per-lane binary search over the prefix (the TPU has no scatter).
// On the main path a row is 2^25 slots, so here one row spreads over a
// (ceil(S / 256), N) grid, and the binary search becomes a scatter by rank:
// one read of mask, prefix and source per slot, one write per slot.
//
// What bounds it on an H100: bytes.  9 B per slot cross the bus for the
// function's own inputs and output (1 B mask, 4 B source, 4 B result), and
// the prefix adds 4 B written by cumsum plus 4 B read here.  Reads are
// coalesced; the scatter writes are coalesced too, since consecutive masked
// slots go to consecutive ranks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void compact_rows_kernel(const unsigned char* __restrict__ mask,
                                    const int* __restrict__ inc,
                                    const int* __restrict__ src,
                                    int* __restrict__ out, long long S,
                                    int fill) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const long long base = (long long)blockIdx.y * S;
  const int count = inc[base + S - 1];
  if (mask[base + s]) out[base + inc[base + s] - 1] = src[base + s];
  if (s >= count) out[base + s] = fill;
}

}  // namespace

extern "C" int compact_rows_launch(const unsigned char* mask, const int* inc,
                                   const int* src, int* out, int n_rows,
                                   long long S, int fill, void* stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), n_rows);
  compact_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      mask, inc, src, out, S, fill);
  return (int)cudaGetLastError();
}
