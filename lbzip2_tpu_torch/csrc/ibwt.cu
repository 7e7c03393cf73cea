// Batched inverse BWT by pointer doubling, for Hopper (sm_90a).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/ibwt.py::ibwt_masked (and
// its vmap ibwt_batched): the successor permutation ptr by a stable
// sort of the row's bytes with their positions (pad lanes >= n under
// key 256), then Wyllie pointer doubling for ceil(log2 N) steps:
//
//   seq[0] = ptr[idx];  jump = ptr;  L = 1
//   each step: seq[L + k] = jump[seq[k]]  (k < L, jump = ptr^L)
//              jump = jump[jump]           (ptr^2L)
//              L = 2L
//   out[k] = k < n ? bwt[seq[k]] : 0
//
// The sort is a stable counting sort, not a comparison sort:
//   1. hist_chunks: a 257-bin histogram per 4096-position chunk
//      (shared-memory atomics).
//   2. scan_chunks: per row and key, an exclusive sum over chunks plus
//      the count of smaller keys: each chunk's first slot per key.
//   3. rank_chunks: one warp per chunk walks it in order, 32 positions
//      at a time; __match_any_sync groups equal keys, a lane's rank
//      among them is the popcount of its lower peers, and the group's
//      lowest lane advances the key's counter (shared memory).
//      ptr[slot] = position.
// The doubling runs one launch per step on the stream, ping-ponging two
// jump buffers (jump = jump[jump] cannot run in place); the extension
// reads the old jump before the composition replaces it, and the last
// step skips the composition, which nothing reads.
//
// What bounds it on the card: dependent 4-byte gathers.  At (8, 901120)
// each step composes 7.2 M pointers (two gathers each) into a 28.8 MB
// buffer; the two jump buffers (57.7 MB) are about the 50 MB L2, so the
// random reads are served mostly from L2.  ~20 steps, ~290 M gathers.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns the first launch error (cudaGetLastError()).

#include <cuda_runtime.h>

namespace {

constexpr int kKeys = 257;  // 256 byte values + the pad key
constexpr int kPad = 256;
constexpr int kWarps = 4;   // chunks per block in rank_chunks
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int row_n(const int* ns, int b, int N) {
  return min(max(ns[b], 0), N);
}

__global__ void hist_chunks(const unsigned char* __restrict__ bwt,
                            const int* __restrict__ ns,
                            int* __restrict__ hist, int N, int chunk,
                            int nch) {
  __shared__ int h[kKeys];
  const int c = blockIdx.x, b = blockIdx.y;
  for (int k = threadIdx.x; k < kKeys; k += blockDim.x) h[k] = 0;
  __syncthreads();
  const int n = row_n(ns, b, N);
  const int lo = c * chunk, hi = min(lo + chunk, N);
  const unsigned char* row = bwt + (size_t)b * N;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    atomicAdd(&h[i < n ? row[i] : kPad], 1);
  __syncthreads();
  int* out = hist + ((size_t)b * nch + c) * kKeys;
  for (int k = threadIdx.x; k < kKeys; k += blockDim.x) out[k] = h[k];
}

__global__ void scan_chunks(int* __restrict__ hist, int nch) {
  __shared__ int first[kKeys];
  const int k = threadIdx.x;  // blockDim.x >= kKeys
  int* row = hist + (size_t)blockIdx.x * nch * kKeys;
  int run = 0;
  if (k < kKeys) {
    for (int c = 0; c < nch; ++c) {
      const int h = row[(size_t)c * kKeys + k];
      row[(size_t)c * kKeys + k] = run;
      run += h;
    }
    first[k] = run;  // the key's total for now
  }
  __syncthreads();
  if (k == 0) {  // exclusive scan of the totals over keys
    int acc = 0;
    for (int j = 0; j < kKeys; ++j) {
      const int t = first[j];
      first[j] = acc;
      acc += t;
    }
  }
  __syncthreads();
  if (k < kKeys)
    for (int c = 0; c < nch; ++c) row[(size_t)c * kKeys + k] += first[k];
}

__global__ void rank_chunks(const unsigned char* __restrict__ bwt,
                            const int* __restrict__ ns,
                            const int* __restrict__ hist,
                            int* __restrict__ ptr, int N, int chunk,
                            int nch) {
  __shared__ int cnt[kWarps][kKeys];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + wid, b = blockIdx.y;
  if (c >= nch) return;  // whole warp leaves together
  int* my = cnt[wid];
  const int* first = hist + ((size_t)b * nch + c) * kKeys;
  for (int k = lane; k < kKeys; k += 32) my[k] = first[k];
  __syncwarp();
  const int n = row_n(ns, b, N);
  const int lo = c * chunk, hi = min(lo + chunk, N);
  const unsigned char* row = bwt + (size_t)b * N;
  int* prow = ptr + (size_t)b * N;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int key = i < hi ? (i < n ? row[i] : kPad) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int rank = __popc(peers & lower);
    const int slot = key >= 0 ? my[key] + rank : 0;
    __syncwarp();
    if (key >= 0 && rank == 0) my[key] += __popc(peers);
    __syncwarp();
    if (key >= 0) prow[slot] = i;
  }
}

__global__ void init_seq(const int* __restrict__ ptr,
                         const int* __restrict__ idxs,
                         int* __restrict__ seq, int B, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int idx = min(max(idxs[b], 0), N - 1);
  seq[(size_t)b * N] = ptr[(size_t)b * N + idx];
}

__global__ void double_step(const int* __restrict__ jin,
                            int* __restrict__ jout, int* __restrict__ seq,
                            int N, int L, int compose) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const size_t off = (size_t)blockIdx.y * N;
  const int* j = jin + off;
  // seq[p - L] (p - L < L) is not written in this step: no race
  if (p >= L && p - L < L) seq[off + p] = j[seq[off + p - L]];
  if (compose) jout[off + p] = j[j[p]];
}

__global__ void gather_out(const unsigned char* __restrict__ bwt,
                           const int* __restrict__ ns,
                           const int* __restrict__ seq,
                           unsigned char* __restrict__ out, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int b = blockIdx.y;
  const size_t off = (size_t)b * N;
  out[off + p] = p < row_n(ns, b, N) ? bwt[off + seq[off + p]] : 0;
}

}  // namespace

#define LBZ2T_CHECK()                                \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return (int)e;             \
  } while (0)

// bwt (B, N) uint8, ns and idxs (B,) int32, out (B, N) uint8; scratch:
// hist (B, ceil(N / chunk), 257), jump_a, jump_b, seq (B, N) int32;
// all device pointers.  steps = ceil(log2 N), at least 1.
extern "C" int lbz2t_ibwt(const void* bwt, const void* ns, const void* idxs,
                          void* out, void* hist, void* jump_a, void* jump_b,
                          void* seq, int B, int N, int chunk, int steps,
                          void* stream) {
  if (B <= 0 || N <= 0 || chunk <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* bw = static_cast<const unsigned char*>(bwt);
  const int* nn = static_cast<const int*>(ns);
  int* h = static_cast<int*>(hist);
  int* ja = static_cast<int*>(jump_a);
  int* jb = static_cast<int*>(jump_b);
  int* sq = static_cast<int*>(seq);
  const int nch = (N + chunk - 1) / chunk;
  hist_chunks<<<dim3(nch, B), kThreads, 0, s>>>(bw, nn, h, N, chunk, nch);
  LBZ2T_CHECK();
  scan_chunks<<<B, 288, 0, s>>>(h, nch);
  LBZ2T_CHECK();
  rank_chunks<<<dim3((nch + kWarps - 1) / kWarps, B), 32 * kWarps, 0, s>>>(
      bw, nn, h, ja, N, chunk, nch);
  LBZ2T_CHECK();
  init_seq<<<(B + 127) / 128, 128, 0, s>>>(
      ja, static_cast<const int*>(idxs), sq, B, N);
  LBZ2T_CHECK();
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  int L = 1;
  for (int st = 0; st < steps; ++st, L *= 2) {
    int* jin = (st & 1) ? jb : ja;
    int* jout = (st & 1) ? ja : jb;
    double_step<<<grid, kThreads, 0, s>>>(jin, jout, sq, N, L,
                                          st + 1 < steps);
    LBZ2T_CHECK();
  }
  gather_out<<<grid, kThreads, 0, s>>>(bw, nn, sq,
                                       static_cast<unsigned char*>(out), N);
  LBZ2T_CHECK();
  return 0;
}
