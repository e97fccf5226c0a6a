// Bitmap pack and unpack of the bitmap fold codec (DESIGN.md sec. 10).
//
// Replaces: the Pallas kernels src/repro/kernels/fold.py:pack_bits
// (`_pack_kernel`) and fold.py:unpack_bits (`_unpack_kernel`).
//
// pack_bits:   (N, S) bool -> (N, W = ceil(S / 32)) words, bit b of word w
//              = mask[n, 32 w + b] (little-endian), pad bits past S = 0.
// unpack_bits: (N, W) words -> (N, S) bool; the row tail past S is not
//              written (the JAX kernel slices [:, :S]).
// Words are int32 holding the JAX uint32 bit pattern.
//
// The Pallas kernels take one row per grid step and multiply-sum a (W, 32)
// tile by the bit weights.  Here the grid's y axis is the row and x walks
// along it, so no thread divides a 64-bit index.  pack_bits gives each
// output word one warp: lane b loads mask byte 32 w + b (32 consecutive
// bytes per warp) and __ballot_sync assembles the word in one instruction.
// unpack_bits gives each output bit one thread, which reads its word (a
// broadcast among the 32 threads of a warp) and writes one byte, coalesced.
//
// What bounds them on an H100: bytes.  pack_bits moves S bytes in and S / 8
// bytes out per row, unpack_bits the reverse; neither does arithmetic worth
// counting.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = kThreads / 32;

__global__ void pack_bits_kernel(const unsigned char* __restrict__ mask,
                                 unsigned* __restrict__ words, long long S,
                                 long long W) {
  const long long w =
      (long long)blockIdx.x * kWordsPerBlock + threadIdx.x / 32;
  if (w >= W) return;                  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const long long row = blockIdx.y;
  const long long s = w * 32 + lane;
  const bool bit = s < S && mask[row * S + s];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) words[row * W + w] = word;
}

__global__ void unpack_bits_kernel(const unsigned* __restrict__ words,
                                   unsigned char* __restrict__ bits,
                                   long long S, long long W) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const long long row = blockIdx.y;
  bits[row * S + s] = (words[row * W + (s >> 5)] >> (s & 31)) & 1u;
}

}  // namespace

extern "C" int pack_bits_launch(const unsigned char* mask, int* words,
                                long long N, long long S, void* stream) {
  const long long W = (S + 31) / 32;
  const dim3 grid((unsigned)((W + kWordsPerBlock - 1) / kWordsPerBlock),
                  (unsigned)N);
  pack_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      mask, reinterpret_cast<unsigned*>(words), S, W);
  return (int)cudaGetLastError();
}

extern "C" int unpack_bits_launch(const int* words, unsigned char* bits,
                                  long long N, long long S, long long W,
                                  void* stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)N);
  unpack_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned*>(words), bits, S, W);
  return (int)cudaGetLastError();
}
