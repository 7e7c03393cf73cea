// MTF ranks of compacted symbols, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lbzip2_tpu/ops/mtf_pallas.py::
// mtf_ranks_pallas (body _kernel/_sub_chunk), which walks each row's
// chunks in grid order carrying a 256-entry last-occurrence vector in
// VMEM.  Same function:
//
//   rank_i = #{t : last[t] > last[s]}               (s seen before i)
//          = #{t : seen(t)} + #{t < s : !seen(t)}   (first occurrence)
//
// where s = syms[i] and last[t] is t's latest position before i; lanes
// >= n are 0.  The rank at i depends only on last[] before i, so a row
// need not be one sequential walk:
//
//   1. chunk_last: each (chunk, row) block finds its chunk's per-symbol
//      last position (shared-memory atomicMax).
//   2. carry_scan: an exclusive running max over a row's chunks gives
//      every chunk its incoming last[256].
//   3. rank: one warp per (chunk, row) walks its symbols in order with
//      last[] in registers (lane l holds t = l + 32 j, j < 8); each
//      symbol's count is 8 compares per lane and one warp reduction.
//
// What bounds it on the card: the dependent chain of shuffles and
// reductions per symbol inside a warp (~29 M symbols per (32, 901120)
// batch, ~115 MB of int32 read and written).  The chunking spreads that
// chain over B * N / CHUNK warps so the SMs stay full.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kAlpha = 256;
constexpr int kWarps = 4;  // chunks per block in the rank pass
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void chunk_last(const int* __restrict__ syms,
                           const int* __restrict__ ns,
                           int* __restrict__ lastc, int N, int chunk,
                           int nch) {
  __shared__ int sl[kAlpha];
  const int c = blockIdx.x, b = blockIdx.y;
  sl[threadIdx.x] = -1;  // blockDim.x == kAlpha
  __syncthreads();
  const int n = max(0, min(ns[b], N));
  const int lo = c * chunk;
  const int hi = min(lo + chunk, n);
  const int* row = syms + (size_t)b * N;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    atomicMax(&sl[row[i] & (kAlpha - 1)], i);
  __syncthreads();
  lastc[((size_t)b * nch + c) * kAlpha + threadIdx.x] = sl[threadIdx.x];
}

__global__ void carry_scan(int* __restrict__ lastc, int nch) {
  int* p = lastc + (size_t)blockIdx.x * nch * kAlpha + threadIdx.x;
  int carry = -1;
  for (int c = 0; c < nch; ++c) {
    const int v = p[(size_t)c * kAlpha];
    p[(size_t)c * kAlpha] = carry;
    carry = max(carry, v);
  }
}

__global__ void rank_pass(const int* __restrict__ syms,
                          const int* __restrict__ ns,
                          const int* __restrict__ lastc,
                          int* __restrict__ out, int N, int chunk,
                          int nch) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (c >= nch) return;  // whole warp leaves together
  const int n = max(0, min(ns[b], N));
  const int lo = c * chunk;
  const int end = min(lo + chunk, N);
  const int lim = min(end, n);  // [lo, lim) ranked, [lim, end) zeroed
  const int* row = syms + (size_t)b * N;
  int* orow = out + (size_t)b * N;
  const int* lc = lastc + ((size_t)b * nch + c) * kAlpha;

  int r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = lc[lane + 32 * j];

  for (int base = lo; base < end; base += 32) {
    const int i = base + lane;
    const int sym = (i < lim) ? (row[i] & (kAlpha - 1)) : 0;
    const int cnt_here = min(32, lim - base);  // warp-uniform
    int mine = 0;
    for (int k = 0; k < cnt_here; ++k) {
      const int s = __shfl_sync(kFull, sym, k);
      const int owner = s & 31, slot = s >> 5;
      int v = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j == slot) v = r[j];
      const int prev = __shfl_sync(kFull, v, owner);
      int cnt = 0;
      if (prev >= 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) cnt += r[j] > prev;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cnt += (r[j] >= 0) | (lane + 32 * j < s);
      }
      const int rank = __reduce_add_sync(kFull, cnt);
      if (lane == k) mine = rank;
      if (lane == owner) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j == slot) r[j] = base + k;
      }
    }
    if (i < end) orow[i] = (i < lim) ? mine : 0;
  }
}

}  // namespace

// syms (B, N) int32 in [0, 256), ns (B,) int32, out (B, N) int32,
// lastc (B, ceil(N / chunk), 256) int32 scratch; all device pointers.
extern "C" int lbz2t_mtf_ranks(const void* syms, const void* ns, void* out,
                               void* lastc, int B, int N, int chunk,
                               void* stream) {
  if (B <= 0 || N <= 0 || chunk <= 0) return (int)cudaGetLastError();
  const int nch = (N + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sy = static_cast<const int*>(syms);
  const int* nn = static_cast<const int*>(ns);
  int* lc = static_cast<int*>(lastc);
  chunk_last<<<dim3(nch, B), kAlpha, 0, s>>>(sy, nn, lc, N, chunk, nch);
  carry_scan<<<B, kAlpha, 0, s>>>(lc, nch);
  rank_pass<<<dim3((nch + kWarps - 1) / kWarps, B), 32 * kWarps, 0, s>>>(
      sy, nn, lc, static_cast<int*>(out), N, chunk, nch);
  return (int)cudaGetLastError();
}
