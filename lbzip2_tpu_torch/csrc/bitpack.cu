// MSB-first bit packer for Hopper (sm_90a): N (value, nbits) fields
// into big-endian 32-bit words.
//
// Replaces the XLA-compiled device op lbzip2_tpu/ops/bitpack.py::
// pack_bits_device, which finds every output bit's field by merging
// the field starts with the output-bit grid in two sorts over 33N lanes
// (a TPU has no scatter to speak of).  Here each field knows where it
// starts from a prefix sum and writes itself:
//
//   1. scan_blocks: an inclusive scan of the lengths (0 past nf) in each
//      CTA of 1024 fields (warp shuffles, then the 32 warp totals), and
//      each CTA's total.
//   2. scan_totals: one CTA turns the totals into exclusive offsets and
//      writes the whole length, total_bits.
//   3. place_fields: a thread a field puts the low nbits of its value
//      at bit start..start+nbits-1 of the stream: the one or two words
//      it spans take it by atomicOr into the zeroed output.  Fields
//      never overlap, so the words come out the same whatever the order
//      of the atomics.
//
// The words are int64 slots holding the u32 in their low half (the
// port's convention for a JAX uint32), values int64 the same way,
// lengths int32 in 0..32.
//
// What bounds it on the card: bytes (12 N in, 8 N out) against a few
// dozen instructions a field; at the sizes a block's payload has (tens
// of thousands of fields) three launches take longer than either.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int field_len(const int* __restrict__ lens,
                                         int i, int N, int nf) {
  return i < N && i < nf ? __ldg(lens + i) : 0;
}

// inclusive scan of v over the CTA; the CTA's total to *total
__device__ __forceinline__ int cta_scan(int v, int* total) {
  __shared__ int warps[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warps[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warps[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += u;
    }
    warps[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warps[warp - 1];
  *total = warps[31];
  return v;
}

__global__ void __launch_bounds__(kThreads)
    scan_blocks(const int* __restrict__ lens, int N, int nf,
                int* __restrict__ incl, int* __restrict__ sums) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int total;
  const int v = cta_scan(field_len(lens, i, N, nf), &total);
  if (i < N) incl[i] = v;
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    scan_totals(int* __restrict__ sums, int nblocks,
                int* __restrict__ total_bits) {
  int carry = 0;
  for (int base = 0; base < nblocks; base += kThreads) {
    const int i = base + threadIdx.x;
    const int own = i < nblocks ? sums[i] : 0;
    int total;
    const int v = cta_scan(own, &total);
    __syncthreads();  // every thread has read the warp totals
    if (i < nblocks) sums[i] = carry + v - own;  // exclusive offset
    carry += total;
  }
  if (threadIdx.x == 0) *total_bits = carry;
}

__global__ void __launch_bounds__(kThreads)
    place_fields(const long long* __restrict__ values,
                 const int* __restrict__ lens, int N, int nf,
                 const int* __restrict__ incl, const int* __restrict__ sums,
                 unsigned long long* __restrict__ words) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int len = field_len(lens, i, N, nf);
  if (len <= 0) return;
  const int start = sums[blockIdx.x] + incl[i] - len;
  const unsigned long long v =
      (unsigned long long)__ldg(values + i) &
      (len == 32 ? 0xFFFFFFFFull : ((1ull << len) - 1));
  const int o = start & 31;
  const unsigned long long window = v << (64 - o - len);  // MSB-first
  const int w = start >> 5;
  atomicOr(words + w, window >> 32);
  if (o + len > 32) atomicOr(words + w + 1, window & 0xFFFFFFFFull);
}

}  // namespace

// values (N,) int64, lens (N,) int32, words (N,) int64 zeroed, total (1,)
// int32, scratch incl (N,) and sums (ceil(N / 1024),) int32; all device
// pointers.
extern "C" int lbz2t_pack_bits(const void* values, const void* lens, int N,
                               int nf, void* words, void* total, void* incl,
                               void* sums, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = (N + kThreads - 1) / kThreads;
  const int* ln = static_cast<const int*>(lens);
  int* in = static_cast<int*>(incl);
  int* sm = static_cast<int*>(sums);
  scan_blocks<<<nblocks, kThreads, 0, s>>>(ln, N, nf, in, sm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, kThreads, 0, s>>>(sm, nblocks, static_cast<int*>(total));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  place_fields<<<nblocks, kThreads, 0, s>>>(
      static_cast<const long long*>(values), ln, N, nf, in, sm,
      static_cast<unsigned long long*>(words));
  return (int)cudaGetLastError();
}
