// Bitmap pack and unpack of the bitmap fold codec (DESIGN.md sec. 10).
//
// Replaces: the Pallas kernels src/repro/kernels/fold.py:pack_bits
// (`_pack_kernel`) and fold.py:unpack_bits (`_unpack_kernel`).
//
// pack_bits:   (N, S) bool -> (N, W = ceil(S / 32)) words, bit b of word w
//              = (mask[n, 32 w + b] != 0) (little-endian), pad bits past S
//              = 0.
// unpack_bits: (N, W) words -> (N, S) bool, 0/1 bytes; nothing is written
//              past a row's S bytes (the JAX kernel slices [:, :S]).
// Words are int32 holding the JAX uint32 bit pattern.
//
// What bounds them on an H100: bytes.  pack_bits moves S bytes in and S / 8
// bytes out per row, unpack_bits the reverse, with a few integer operations
// per 4 bytes.  The bitmap fold calls both at N = 8, S = 2^24: 151 MB a
// call, 0.0451 ms at 3.35 TB/s.
//
// The Pallas kernels take one row per grid step and multiply-sum a (W, 32)
// tile by the bit weights.  Here the grid's y axis is the row and x walks
// along it, so no thread divides a 64-bit index.  The first CUDA versions,
// kept as the general form below, give each mask byte a thread: pack_bits
// a warp per word (lane b loads byte 32 w + b, __ballot_sync assembles the
// word), unpack_bits a thread per byte.  That is 32 B per warp memory
// instruction, about 270 KB in flight over the card, and 0.3398 / 0.3267 ms
// a call on an NVIDIA H100 80GB HBM3 at 700 W, 13-14 % of the bound
// (chip_smoke.py phase 7b).
//
// The vector form moves 16 bytes a thread access.  pack_bits gives each
// thread a word: it reads the word's 32 mask bytes as two 16-byte streaming
// loads (__ldcs: nothing reads the mask again) and turns each 4-byte lane
// into 4 bits with __vcmpne4 and one multiply; a warp stores 128 B of
// consecutive words.  unpack_bits gives each thread 16 bytes of output: it
// reads the word they come from (a pair of threads shares it) and writes
// one 16-byte store, each nibble spread to 4 bytes by one multiply, so a
// warp stores 512 consecutive bytes in one instruction (plain stores: the
// fold's decode reads the bits next).  A word a thread with two 16-byte
// stores left each store instruction half a sector a thread and reached 54
// % of the bound where this reaches 82 %; 2 or 4 words or halves a thread
// were no faster for either kernel, and __ldcs is 3 % faster than __ldg
// (scripts/torch_bits_designs.py, same card).  The form needs 16-byte
// aligned rows of bytes: S % 16 == 0 and a base pointer aligned to 16, as
// the fold's fresh tensors are; a row whose last word holds 16 bits (S % 32
// == 16) loads or stores one 16-byte half there.  Any other shape or view
// takes the general form.  The launchers report which form ran.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = kThreads / 32;  // general pack: a warp a word

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

// Bit k of the result = (byte k of x != 0): a 0/1 per byte, the multiply
// gathers the four into bits 28..31 (no two partial products overlap).
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned pack16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

// Byte k of the result = bit k of n's low nibble.
__device__ __forceinline__ unsigned spread(unsigned n) {
  return ((n & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint4 unpack16(unsigned h) {
  return make_uint4(spread(h), spread(h >> 4), spread(h >> 8),
                    spread(h >> 12));
}

__global__ void pack_bits_vector_kernel(const uint4* __restrict__ mask,
                                        unsigned* __restrict__ words,
                                        long long S, long long W) {
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const uint4* m = mask + row * (S / 16) + 2 * w;
  const uint4 lo = __ldcs(m);
  const uint4 hi = 32 * w + 16 < S ? __ldcs(m + 1) : make_uint4(0, 0, 0, 0);
  words[row * W + w] = pack16(lo) | pack16(hi) << 16;
}

__global__ void unpack_bits_vector_kernel(const unsigned* __restrict__ words,
                                          uint4* __restrict__ bits,
                                          long long S, long long W) {
  const long long h = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (h >= S / 16) return;             // h: the row's 16-byte half h
  const long long row = blockIdx.y;
  const unsigned x = __ldg(words + row * W + h / 2);
  bits[row * (S / 16) + h] = unpack16(x >> (16 * (h & 1)));
}

}  // namespace

// `vector` is set to 1 when the vector form ran, 0 for the general form.
extern "C" int pack_bits_launch(const unsigned char* mask, int* words,
                                long long N, long long S, void* stream,
                                int* vector) {
  const long long W = (S + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  *vector = S % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  if (*vector) {
    const dim3 grid((unsigned)((W + kThreads - 1) / kThreads), (unsigned)N);
    pack_bits_vector_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const uint4*>(mask),
        reinterpret_cast<unsigned*>(words), S, W);
  } else {
    const dim3 grid((unsigned)((W + kWordsPerBlock - 1) / kWordsPerBlock),
                    (unsigned)N);
    pack_bits_kernel<<<grid, kThreads, 0, st>>>(
        mask, reinterpret_cast<unsigned*>(words), S, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int unpack_bits_launch(const int* words, unsigned char* bits,
                                  long long N, long long S, long long W,
                                  void* stream, int* vector) {
  const cudaStream_t st = (cudaStream_t)stream;
  *vector = S % 16 == 0 && reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  if (*vector) {
    const dim3 grid((unsigned)((S / 16 + kThreads - 1) / kThreads),
                    (unsigned)N);
    unpack_bits_vector_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const unsigned*>(words),
        reinterpret_cast<uint4*>(bits), S, W);
  } else {
    const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)N);
    unpack_bits_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const unsigned*>(words), bits, S, W);
  }
  return (int)cudaGetLastError();
}
