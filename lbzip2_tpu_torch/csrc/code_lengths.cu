// Huffman code lengths of the EM M-step, one tree per row, for Hopper
// (sm_90a).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/huffenc.py::
// _make_code_lengths_rows, which runs a 257-step lax.fori_loop
// vectorised over the B * 6 rows of a batch.  Bit for bit the contract
// of native/huffman2.c make_code_lengths2: node order is the key
// (freq, height << 17 | (nleaf & 255) << 9 | tag), tag = 258 - symbol
// for a leaf, the j-th merge carrying the tag of the j-th smallest
// leaf; the two-queue merge prefers leaves on ties; lengths are
// re-assigned by rank profile (the d-th smallest leaf gets the d-th
// largest depth), clamped at 30.
//
// On this card a row is one CTA's private problem, all of it in ~10 KB
// of shared memory:
//
//   1. leaf sort: 512-slot bitonic sort by 256 threads on the packed
//      key (max(f, 1) << 9) | tag, dead lanes 0x7FFFFFFF (live keys are
//      distinct, so stability is not at issue);
//   2. the two-queue merge, as - 1 dependent steps by one thread (not
//      the 257 masked steps of the vectorised form); every queue read
//      is guarded by the queue's fill, so nothing is read past an end;
//   3. depths by one reverse sweep over the merges, by the same thread;
//   4. rank profile from a 31-bin count of the clamped depths (no
//      second sort), scatter to symbol = 258 - tag, lanes >= as zero.
//
// What bounds it: not bytes (1 KB in, 1 KB out a row) but the
// dependent chain of steps 2 and 3, a few shared-memory round trips a
// step.  Rows run side by side on the SMs, so a batch costs one row's
// chain plus the launch.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kW = 259;        // lanes: symbols 0..257 + dummy
constexpr int kNLeaf = 258;    // leaf slots (as <= 258)
constexpr int kNMerge = 257;
constexpr int kNN = kNLeaf + kNMerge;
constexpr int kHLim = 30;
constexpr int kSort = 512;
constexpr int kThreads = 256;
constexpr int kInf = 0x7FFFFFFF;

__device__ __forceinline__ bool key_lt(int fa, int ta, int fb, int tb) {
  return fa < fb || (fa == fb && ta < tb);
}

__global__ void __launch_bounds__(kThreads)
code_lengths(const int* __restrict__ freqs, const int* __restrict__ as_arr,
             int* __restrict__ lengths) {
  __shared__ int s_key[kSort];
  __shared__ int s_nf[kNN];
  __shared__ int s_nt[kNN];
  __shared__ int s_depth[kNN];
  __shared__ unsigned short s_c0[kNMerge];
  __shared__ unsigned short s_c1[kNMerge];
  __shared__ int s_cnt[kHLim + 1];
  __shared__ int s_out[kW];

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int as = min(max(as_arr[row], 0), kNLeaf);
  const int* f_row = freqs + (size_t)row * kW;

  // 1. keys; int32 arithmetic that wraps as the plain version's does
  for (int i = tid; i < kSort; i += kThreads) {
    int key = kInf;
    if (i < as)
      key = (int)(((unsigned)max(f_row[i], 1) << 9) | (unsigned)(kNLeaf - i));
    s_key[i] = key;
  }
  __syncthreads();
  for (int k = 2; k <= kSort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = ((tid & ~(j - 1)) << 1) | (tid & (j - 1));
      const int l = i | j;
      const int a = s_key[i], b = s_key[l];
      if ((a > b) == ((i & k) == 0)) {
        s_key[i] = b;
        s_key[l] = a;
      }
      __syncthreads();
    }
  }

  // node planes: slots 0..257 sorted leaves (t = 1 << 9 | tag), then
  // the merges in creation order
  for (int i = tid; i < kNN; i += kThreads) {
    int f = kInf, t = kInf;
    if (i < kW && s_key[i] != kInf) {
      f = s_key[i] >> 9;
      t = (1 << 9) | (s_key[i] & 511);
    }
    s_nf[i] = f;
    s_nt[i] = t;
    s_depth[i] = 0;
  }
  for (int i = tid; i < kW; i += kThreads) s_out[i] = 0;
  if (tid <= kHLim) s_cnt[tid] = 0;
  __syncthreads();

  const int nmerge = max(as - 1, 0);
  if (tid == 0) {
    // 2. two-queue merge; li leaves and ii merges consumed so far
    int li = 0, ii = 0;
    for (int s = 1; s <= nmerge; ++s) {
      const int nleaf = as - li;
      const int nint = (s - 1) - ii;
      const int in0 = kNLeaf + ii;
      // huff_pick_pair: ties prefer leaves
      bool pick_ii = nleaf == 0;
      if (!pick_ii && nint >= 2)
        pick_ii = key_lt(s_nf[in0 + 1], s_nt[in0 + 1], s_nf[li], s_nt[li]);
      bool pick_ll = false;
      if (!pick_ii) {
        pick_ll = nint == 0;
        if (!pick_ll && nleaf >= 2)
          pick_ll = !key_lt(s_nf[in0], s_nt[in0], s_nf[li + 1],
                            s_nt[li + 1]);
      }
      const int c0 = pick_ll ? li : in0;
      const int c1 = pick_ii ? in0 + 1 : (pick_ll ? li + 1 : li);
      li += pick_ii ? 0 : (pick_ll ? 2 : 1);
      ii += pick_ii ? 2 : (pick_ll ? 0 : 1);
      const int t0 = s_nt[c0], t1 = s_nt[c1];
      const int height = max(t0 >> 17, t1 >> 17) + 1;
      const int nl = (((t0 >> 9) & 255) + ((t1 >> 9) & 255)) & 255;
      const int slot = kNLeaf + s - 1;
      s_nf[slot] = (int)((unsigned)s_nf[c0] + (unsigned)s_nf[c1]);
      s_nt[slot] = (height << 17) | (nl << 9) | (s_key[s - 1] & 511);
      s_c0[s - 1] = (unsigned short)c0;
      s_c1[s - 1] = (unsigned short)c1;
    }
    // 3. children of merge j have ids < kNLeaf + j: one reverse sweep
    for (int j = nmerge - 1; j >= 0; --j) {
      const int d = s_depth[kNLeaf + j] + 1;
      s_depth[s_c0[j]] = d;
      s_depth[s_c1[j]] = d;
    }
  }
  __syncthreads();

  // 4. rank profile: rank r (ascending key) takes the r-th largest depth
  for (int r = tid; r < as; r += kThreads)
    atomicAdd(&s_cnt[min(s_depth[r], kHLim)], 1);
  __syncthreads();
  for (int r = tid; r < as; r += kThreads) {
    int d = kHLim, above = 0;
    while (d > 0 && r >= above + s_cnt[d]) above += s_cnt[d--];
    s_out[kNLeaf - (s_key[r] & 511)] = d;
  }
  __syncthreads();
  int* o_row = lengths + (size_t)row * kW;
  for (int i = tid; i < kW; i += kThreads)
    o_row[i] = i < kNLeaf ? s_out[i] : 0;  // symbol 258 is never real
}

}  // namespace

// freqs (R, 259) int32, as_arr (R,) int32 (alphabet sizes, clamped to
// 0..258), lengths (R, 259) int32 output; all device pointers.
extern "C" int lbz2t_code_lengths(const void* freqs, const void* as_arr,
                                  void* lengths, int R, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  code_lengths<<<R, kThreads, 0, s>>>(static_cast<const int*>(freqs),
                                      static_cast<const int*>(as_arr),
                                      static_cast<int*>(lengths));
  return (int)cudaGetLastError();
}
