// Huffman group decode of one bzip2 block, for Hopper (sm_90a).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/huffdec.py::decode_groups,
// a 50-step lax.scan over all groups of a block.  The host has already
// walked the code lengths (native retrieve_boundaries), so every
// group's start bit is known and the groups are independent: one thread
// decodes one group's 50 symbols.  Per symbol:
//
//   v    = the 20 bits at the cursor (two words, big-endian bit order)
//   k    = 1 + #{kk in 1..20 : v >= base[kk + 1]}      (code length)
//   slot = count[k] + (int32(v - base[k]) >> (20 - k))  (wraps, signed)
//   sym  = perm[tree][clip(slot, 0, 257)];  cursor += k
//
// exactly as the JAX scan computes it, lanes past a group's EOB
// included: a cursor past the window reads the last word (JAX's
// mode="clip" gathers) and offset 0 takes the first word alone (C++
// leaves w1 >> 32 undefined, JAX selects with a where).
//
// What bounds it on the card: a block has at most ~18,000 groups, so
// one launch is ~18,000 threads, each a dependent chain of 50 steps of
// 2 word loads (L1/L2 hits: neighbouring groups read neighbouring
// words), 20 shared-memory compares and one perm lookup.  The six
// trees' base, count and perm tables (~7 KB) live in shared memory.
// The output is 50 ints a group, staged through shared memory so each
// block writes its rows with coalesced stores.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 50;
constexpr int kMaxLen = 20;
constexpr int kTrees = 6;
constexpr int kBase = 22;
constexpr int kPerm = 258;
constexpr int kThreads = 64;  // groups per block

__global__ void __launch_bounds__(kThreads)
huffdec(const unsigned* __restrict__ words,
        const int* __restrict__ group_start,
        const int* __restrict__ group_tree,
        const unsigned* __restrict__ base, const int* __restrict__ count,
        const int* __restrict__ perm, int* __restrict__ syms,
        int* __restrict__ end, int G, int W, int nt) {
  __shared__ unsigned s_base[kTrees * kBase];
  __shared__ int s_count[kTrees * kBase];
  __shared__ int s_perm[kTrees * kPerm];
  __shared__ int s_out[kThreads * kGroup];
  for (int i = threadIdx.x; i < nt * kBase; i += kThreads) {
    s_base[i] = base[i];
    s_count[i] = count[i];
  }
  for (int i = threadIdx.x; i < nt * kPerm; i += kThreads)
    s_perm[i] = perm[i];
  __syncthreads();

  const int g0 = blockIdx.x * kThreads;
  const int g = g0 + threadIdx.x;
  if (g < G) {
    const int t = min(max(group_tree[g], 0), nt - 1);
    const unsigned* tb = s_base + t * kBase;
    const int* tc = s_count + t * kBase;
    const int* tp = s_perm + t * kPerm;
    int p = group_start[g];
    for (int s = 0; s < kGroup; ++s) {
      const int w = min(max(p >> 5, 0), W - 1);
      const int o = p & 31;
      const unsigned w0 = words[w];
      unsigned v = w0;
      if (o != 0) v = (w0 << o) | (words[min(w + 1, W - 1)] >> (32 - o));
      v >>= 32 - kMaxLen;
      int k = 1;
#pragma unroll
      for (int kk = 1; kk <= kMaxLen; ++kk) k += v >= tb[kk + 1];
      // JAX shifts (v - base) as int32 (u32 >> int32 promotes to int32
      // with x64 off): on a garbage lane with v < base the wrapped
      // difference is negative and the shift is arithmetic
      const int slot = tc[k] + ((int)(v - tb[k]) >> (kMaxLen - k));
      s_out[threadIdx.x * kGroup + s] = tp[min(max(slot, 0), kPerm - 1)];
      p += k;
    }
    end[g] = p;
  }
  __syncthreads();
  // coalesced copy-out of this block's rows of syms
  const int rows = min(kThreads, G - g0);
  int* out = syms + (size_t)g0 * kGroup;
  for (int i = threadIdx.x; i < rows * kGroup; i += kThreads)
    out[i] = s_out[i];
}

}  // namespace

// words (W,) u32 bits; group_start, group_tree (G,) int32; base, count
// (nt, 22) and perm (nt, 258) int32; syms (G, 50) and end (G,) int32
// outputs; all device pointers.
extern "C" int lbz2t_huffdec(const void* words, const void* group_start,
                             const void* group_tree, const void* base,
                             const void* count, const void* perm,
                             void* syms, void* end, int G, int W, int nt,
                             void* stream) {
  if (G <= 0 || W <= 0 || nt <= 0 || nt > kTrees)
    return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  huffdec<<<(G + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const unsigned*>(words),
      static_cast<const int*>(group_start),
      static_cast<const int*>(group_tree),
      static_cast<const unsigned*>(base), static_cast<const int*>(count),
      static_cast<const int*>(perm), static_cast<int*>(syms),
      static_cast<int*>(end), G, W, nt);
  return (int)cudaGetLastError();
}
