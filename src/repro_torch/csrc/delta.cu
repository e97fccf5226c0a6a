// Gap encode and cumsum decode of the delta fold codec (DESIGN.md sec. 10).
//
// Replaces: the Pallas kernels src/repro/kernels/fold.py:delta_gaps
// (`_gaps_kernel`) and fold.py:delta_positions (`_positions_kernel`).
//
// delta_gaps:      (N, S) sorted int32 offsets + (N, S) bool valid ->
//                  (N, S) 16-bit gaps, gap[s] = valid[s] ? ts[s] - ts[s - 1]
//                  : 0 with ts[-1] = 0 (slot 0 absolute), kept mod 2^16 as
//                  the JAX kernel's astype(uint16) does.
// delta_positions: (N, S) 16-bit gaps -> (N, S) int32 inclusive cumsum of
//                  each row, the gaps read as unsigned; the sum wraps as
//                  int32, as JAX's does.
// The 16-bit arrays are int16 tensors holding the uint16 bit pattern.
//
// delta_gaps gives each slot one thread on a (ceil(S / 256), N) grid: two
// reads (the slot and its left neighbour, which the next thread reads too)
// and one 2-byte write.  delta_positions gives each row one block of 1024
// threads (the Pallas grid's one row per step, but the rows run side by
// side).  The block walks its row in tiles of 1024 x 8 gaps: each thread
// sums its 8 consecutive gaps, the block scans the 1024 thread sums (warp
// shuffles, then one warp over the 32 warp totals), and the tile's total
// carries into the next tile.  A row of S = 65536 is 8 tiles; the delta
// codec's folds have R * C * C rows, enough blocks to fill the card.  When
// S % 8 == 0 and both arrays are 16-byte aligned, a thread reads its 8 gaps
// with one 16-byte load and writes its 8 positions with two 16-byte
// stores, so a warp moves whole contiguous lines; otherwise it reads and
// writes element by element, 32 bytes apart across a warp.
//
// What bounds them on an H100: bytes.  delta_gaps moves 7 B per slot (4 B
// offset, 1 B valid in; 2 B out), delta_positions 6 B (2 B in, 4 B out).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kItems = 8;

__global__ void delta_gaps_kernel(const int* __restrict__ ts,
                                  const unsigned char* __restrict__ valid,
                                  unsigned short* __restrict__ gaps,
                                  long long S) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const long long i = (long long)blockIdx.y * S + s;
  unsigned g = 0;
  if (valid[i]) g = (unsigned)ts[i] - (s > 0 ? (unsigned)ts[i - 1] : 0u);
  gaps[i] = (unsigned short)g;
}

__global__ void __launch_bounds__(kScanThreads) delta_positions_kernel(
    const unsigned short* __restrict__ gaps, int* __restrict__ pos,
    long long S, bool vec) {
  __shared__ unsigned warp_sums[kScanThreads / 32];
  const unsigned short* g = gaps + (long long)blockIdx.x * S;
  int* out = pos + (long long)blockIdx.x * S;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  unsigned carry = 0;
  for (long long base = 0; base < S; base += kScanThreads * kItems) {
    const long long first = base + (long long)threadIdx.x * kItems;
    unsigned run[kItems];
    if (vec && first < S) {            // one 16-byte load of 8 gaps
      const uint4 raw = *reinterpret_cast<const uint4*>(g + first);
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        run[2 * q] = w[q] & 0xffffu;
        run[2 * q + 1] = w[q] >> 16;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        run[q] = first + q < S ? (unsigned)g[first + q] : 0u;
      }
    }
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      sum += run[q];
      run[q] = sum;
    }
    // inclusive scan of the thread sums within the warp
    unsigned x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const unsigned before =
        carry + (x - sum) + (warp > 0 ? warp_sums[warp - 1] : 0u);
    if (vec && first < S) {            // two 16-byte stores
      int4* dst = reinterpret_cast<int4*>(out + first);
      dst[0] = make_int4((int)(before + run[0]), (int)(before + run[1]),
                         (int)(before + run[2]), (int)(before + run[3]));
      dst[1] = make_int4((int)(before + run[4]), (int)(before + run[5]),
                         (int)(before + run[6]), (int)(before + run[7]));
    } else {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (first + q < S) out[first + q] = (int)(before + run[q]);
      }
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();                   // warp_sums is rewritten next tile
  }
}

}  // namespace

extern "C" int delta_gaps_launch(const int* ts, const unsigned char* valid,
                                 short* gaps, long long N, long long S,
                                 void* stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)N);
  delta_gaps_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ts, valid, reinterpret_cast<unsigned short*>(gaps), S);
  return (int)cudaGetLastError();
}

extern "C" int delta_positions_launch(const short* gaps, int* pos,
                                      long long N, long long S,
                                      void* stream) {
  // whole 16-byte vectors per thread when every row starts aligned
  const bool vec = S % kItems == 0 &&
                   reinterpret_cast<uintptr_t>(gaps) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pos) % 16 == 0;
  delta_positions_kernel<<<(unsigned)N, kScanThreads, 0,
                           (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned short*>(gaps), pos, S, vec);
  return (int)cudaGetLastError();
}
