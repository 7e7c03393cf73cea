// Zero-init bzip2 CRC register of a block, for Hopper (sm_90a).
//
// Replaces the XLA-compiled device op lbzip2_tpu/ops/crc.py::
// crc32_device: positional byte tables give the zero-init CRC of each
// 32-byte leaf, and a tree of "advance by L zero bytes" operators, each
// a 4 x 256 byte table, folds the leaves:
//
//   crc(A || B) = S^|B|(crc(A)) ^ crc(B)           (zero-init CRCs)
//
// Leading zero bytes never change a zero-init CRC, so the kernel reads
// block[:n] as the tail of a stream of C * 32768 bytes whose front is
// zeros (the JAX form shifts the bytes to the end of its buffer instead:
// the same register).
//
//   1. crc_leaves: one CTA a 32 KB segment of that stream, one thread a
//      leaf (32 positional lookups in shared memory), a shuffle tree in
//      each warp (levels 0..4: the right half is 32 << s bytes long),
//      then the 32 warp sums by warp 0 (levels 5..9).
//   2. crc_combine: one CTA folds the C segment sums (levels 10..17),
//      the count padded with zero segments in front to a power of two.
//
// What bounds it on the card: a 900 kB block is 0.27 us of device
// memory, less than a launch; the positional tables (32 KB a CTA) are
// staged in shared memory, the level tables (18 x 4 x 256 words) read
// through L1 and L2.  The design keeps it to two launches and reads
// each byte once.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;       // bytes a leaf
constexpr int kThreads = 1024;   // leaves a CTA
constexpr int kMaxSegs = 256;    // 8 MiB / 32 KiB
constexpr int kSegLevel = 10;    // a CTA's segment: 32 << 10 bytes
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned advance(const unsigned* __restrict__ t,
                                            unsigned x) {
  return __ldg(t + (x & 0xFF)) ^ __ldg(t + 256 + ((x >> 8) & 0xFF)) ^
         __ldg(t + 512 + ((x >> 16) & 0xFF)) ^ __ldg(t + 768 + (x >> 24));
}

// fold 32 lane values, lane i the segment after lane i - 1's; level
// base + s advances the left half by the right half's length
__device__ __forceinline__ unsigned warp_fold(unsigned v,
                                              const unsigned* __restrict__ lvl,
                                              int base) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const unsigned right = __shfl_down_sync(kFull, v, 1 << s);
    if ((lane & ((2 << s) - 1)) == 0)
      v = advance(lvl + (base + s) * 1024, v) ^ right;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    crc_leaves(const unsigned char* __restrict__ block, long long n,
               long long shift, const unsigned* __restrict__ pos,
               const unsigned* __restrict__ lvl, unsigned* __restrict__ seg) {
  __shared__ unsigned tab[kChunk * 256];
  __shared__ unsigned warps[kThreads / 32];
  for (int i = threadIdx.x; i < kChunk * 256; i += kThreads)
    tab[i] = pos[i];
  __syncthreads();
  // virtual byte q of this leaf is block[q - shift], zero before 0
  const long long q0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kChunk - shift;
  unsigned v = 0;
#pragma unroll 8
  for (int k = 0; k < kChunk; ++k) {
    const long long r = q0 + k;
    const unsigned b = r >= 0 && r < n ? __ldg(block + r) : 0u;
    v ^= tab[k * 256 + b];
  }
  v = warp_fold(v, lvl, 0);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_fold(warps[threadIdx.x], lvl, 5);
    if (threadIdx.x == 0) seg[blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kMaxSegs)
    crc_combine(const unsigned* __restrict__ seg, int C, int Cpad,
                const unsigned* __restrict__ lvl,
                unsigned long long* __restrict__ out) {
  __shared__ unsigned acc[kMaxSegs];
  const int t = threadIdx.x;
  const int i = t - (Cpad - C);  // zero segments in front
  acc[t] = t < Cpad && i >= 0 ? seg[i] : 0u;
  __syncthreads();
  int level = kSegLevel;
  for (int w = 1; w < Cpad; w <<= 1, ++level) {
    if ((t & (2 * w - 1)) == 0 && t + w < Cpad)
      acc[t] = advance(lvl + level * 1024, acc[t]) ^ acc[t + w];
    __syncthreads();
  }
  if (t == 0) *out = acc[0];
}

}  // namespace

// block (>= n bytes) uint8; pos (32, 256) and lvl (18, 4, 256) uint32
// tables; seg (ceil(n / 32768) or 1) uint32 scratch; out one uint64
// (the register, zero-extended); all device pointers.  n <= 8 MiB.
extern "C" int lbz2t_crc32(const void* block, long long n, const void* pos,
                           const void* lvl, void* seg, void* out,
                           void* stream) {
  const long long seg_bytes = (long long)kThreads * kChunk;
  const int C = n > 0 ? (int)((n + seg_bytes - 1) / seg_bytes) : 1;
  if (n < 0 || C > kMaxSegs) return (int)cudaErrorInvalidValue;
  int Cpad = 1;
  while (Cpad < C) Cpad <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* lv = static_cast<const unsigned*>(lvl);
  unsigned* sg = static_cast<unsigned*>(seg);
  crc_leaves<<<C, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(block), n, C * seg_bytes - n,
      static_cast<const unsigned*>(pos), lv, sg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  crc_combine<<<1, kMaxSegs, 0, s>>>(sg, C, Cpad, lv,
                                     static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
