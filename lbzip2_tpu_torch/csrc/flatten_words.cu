// The flat payload download's compaction for Hopper (sm_90a): every row's
// payload words, back to back, in flat slots [base, base + F).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/chain.py::_flatten_words
// (:362), which finds each slot's row by a searchsorted over the rows'
// inclusive word-count sums and gathers.  Here a thread takes a slot f:
// the sums (B values) sit in shared memory, a binary search finds the
// first row r whose sum exceeds f (searchsorted's side="right": rows of
// no words are stepped over), and the thread copies word f - start_r of
// row r, clamped to the row's width; a slot past the last sum gets 0.
//
// What bounds it: bytes.  It reads the payload words it copies once and
// writes F words; a chain batch's payload is some 5.6 MB.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
    flatten(const int* __restrict__ words, const int* __restrict__ ends,
            int B, int W, int F, int base, int* __restrict__ out) {
  extern __shared__ int se[];
  for (int i = threadIdx.x; i < B; i += kThreads) se[i] = ends[i];
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= F) return;
  const int f = base + j;
  int lo = 0, hi = B;  // the first row whose sum exceeds f
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (se[mid] <= f)
      lo = mid + 1;
    else
      hi = mid;
  }
  int v = 0;
  if (lo < B) {
    const int start = lo ? se[lo - 1] : 0;
    v = words[(size_t)lo * W + min(max(f - start, 0), W - 1)];
  }
  out[j] = v;
}

}  // namespace

// words (B, W) int32, ends (B,) int32 inclusive sums of the rows' word
// counts in; out (F,) int32 out; all device pointers.  The sums of at
// most kMaxRows rows fit the 48 KB of shared memory a launch may take.
extern "C" int lbz2t_flatten_words(const void* words, const void* ends,
                                   void* out, int B, int W, int F, int base,
                                   void* stream) {
  if (B <= 0 || W <= 0 || F <= 0 || B > kMaxRows)
    return (int)cudaErrorInvalidValue;
  flatten<<<(F + kThreads - 1) / kThreads, kThreads, B * sizeof(int),
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), static_cast<const int*>(ends), B, W, F,
      base, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
