// Huffman code lengths of the EM M-step, one tree per row, for Hopper
// (sm_90a): the stand-alone entry.  The algorithm, its contract and what
// bounds it are in code_lengths.cuh (a warp a tree: register bitonic
// sort, the two-queue merge and the depth sweep in one lane, the rank
// profile by the warp); the EM loop on the card (em_chain.cu) runs the
// same device function between its E-steps, so the main path launches
// this kernel only where a caller wants one M-step of its own.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include "code_lengths.cuh"

namespace {

using namespace lbz2t;

__global__ void __launch_bounds__(32 * kTreesPerCta)
code_lengths(const int* __restrict__ freqs, const int* __restrict__ as_arr,
             int* __restrict__ lengths, int R) {
  __shared__ TreeScratch scratch[kTreesPerCta];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kTreesPerCta + warp;
  if (row >= R) return;  // a whole warp: no barrier follows
  int f[kLoads];
  load_counts(freqs + (size_t)row * kW, lane, f);
  code_lengths_tree(f, as_arr[row], lengths + (size_t)row * kW,
                    scratch[warp], lane);
}

}  // namespace

// freqs (R, 259) int32, as_arr (R,) int32 (alphabet sizes, clamped to
// 0..258), lengths (R, 259) int32 output; all device pointers.
extern "C" int lbz2t_code_lengths(const void* freqs, const void* as_arr,
                                  void* lengths, int R, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = (R + kTreesPerCta - 1) / kTreesPerCta;
  code_lengths<<<ctas, 32 * kTreesPerCta, 0, s>>>(
      static_cast<const int*>(freqs), static_cast<const int*>(as_arr),
      static_cast<int*>(lengths), R);
  return (int)cudaGetLastError();
}
