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
// >= n are 0.  That is the position of s in a move-to-front list that
// starts as 0, 1, ..., 255.  The list before position i depends only on
// last[] before i, so a row need not be one sequential walk:
//
//   1. chunk_last: each (chunk, row) block finds its chunk's per-symbol
//      last position (shared-memory atomicMax, done only where a run
//      of equal symbols ends).
//   2. carry_scan: an exclusive running max over a row's chunks gives
//      every chunk its incoming last[256].
//   3. rank_pass: one warp per (chunk, row) holds the whole list in
//      registers, 8 entries a lane: level j of lane l is list position
//      32 j + l, so level 0 is the 32 most recent symbols.  The list is
//      rebuilt at the chunk's start from the incoming last[] (seen
//      symbols by last position, latest first, then the unseen ones in
//      order).  Of each 32 symbols loaded, those equal to their
//      predecessor are rank 0 and leave the list alone: one ballot
//      finds them and the loop steps over the others only.  For such a
//      symbol the warp goes down the levels: one ballot looks for it,
//      one rotate shifts the level by a lane (the level's last entry
//      carries into lane 0 of the next), and the level that holds it
//      ends the walk.  Work grows with the rank: text after a BWT hits
//      level 0 nearly always.
//
// The byte entry (lbz2t_mtf_ranks_bytes) takes the BWT rows as uint8 and
// the row's used-byte map: it fuses lbzip2_tpu/ops/chain.py::_compact_syms
// (:48), the XLA op that maps each byte to the number of used byte values
// below it, into both launches that read the symbols.  One warp of each
// CTA builds the row's 256-entry table tab[v] = #used bytes below v from
// cmaps by a scan in shared memory, and the load maps each byte through
// it: the (B, N) int32 symbols never reach device memory.
//
// What bounds it on the card: instruction throughput.  A symbol that
// is no run continuation costs some 20 warp instructions at level 0 and
// 6 more a level (measured: 0.5 ms of rank_pass for 28.8 M text
// symbols, 1.9 ms for uniform ones, whose ranks average 128); the bytes
// (int32 symbols in, ranks out) would take a tenth of the text time.
// The kernel it replaces counted last[t] > last[s] over all 256 t for
// every symbol, some 60 warp instructions whatever the rank, and was
// bound by instruction throughput too, not by its dependent chain.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kAlpha = 256;
constexpr int kWarps = 4;  // chunks per block in the rank pass
constexpr int kSlabs = 4;  // parts of a row's chunks in carry_scan
constexpr int kAhead = 4;  // 32-symbol loads in flight a warp in chunk_last
constexpr unsigned kFull = 0xFFFFFFFFu;

// The row's symbol table, by warp 0 of the CTA: tab[v] = the used byte
// values below v (cmaps[v] != 0 marks v used), lane l summing bytes
// 8 l .. 8 l + 7 and a warp scan giving each lane the ones below them.
// The caller synchronises the CTA before the table is read.
__device__ __forceinline__ void build_table(
    const unsigned char* __restrict__ cmap, int* tab) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int c[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[k] = cmap[8 * lane + k];
    sum += c[k];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int below = incl - sum;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    tab[8 * lane + k] = below;
    below += c[k];
  }
}

// A row's symbols as the kernels read them: int32 symbols masked to the
// alphabet, or bytes mapped through the row's table in shared memory.
template <typename T>
struct Syms {
  const T* row;
  const int* tab;
  __device__ __forceinline__ int operator()(int i) const {
    if constexpr (sizeof(T) == 1)
      return tab[row[i]] & (kAlpha - 1);
    else
      return row[i] & (kAlpha - 1);
  }
};

template <typename T>
__global__ void chunk_last(const T* __restrict__ syms,
                           const unsigned char* __restrict__ cmaps,
                           const int* __restrict__ ns,
                           int* __restrict__ lastc, int N, int chunk,
                           int nch) {
  __shared__ int sl[kAlpha];
  __shared__ int tab[kAlpha];
  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  sl[threadIdx.x] = -1;  // blockDim.x == kAlpha
  if constexpr (sizeof(T) == 1) build_table(cmaps + (size_t)b * kAlpha, tab);
  __syncthreads();
  const int n = max(0, min(ns[b], N));
  const int lo = c * chunk;
  const int hi = min(lo + chunk, n);
  const Syms<T> row{syms + (size_t)b * N, tab};
  // a warp takes kAhead loads of 32 consecutive positions at a time;
  // inside a run only its last position (or the load's) can be the
  // chunk's last
  for (int base = lo + (threadIdx.x >> 5) * 32 * kAhead; base < hi;
       base += kAlpha * kAhead) {
    int s[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + 32 * u + lane;
      s[u] = i < hi ? row(i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int next = __shfl_down_sync(kFull, s[u], 1);
      if (s[u] >= 0 && (lane == 31 || next != s[u]))
        atomicMax(&sl[s[u]], base + 32 * u + lane);
    }
  }
  __syncthreads();
  lastc[((size_t)b * nch + c) * kAlpha + threadIdx.x] = sl[threadIdx.x];
}

// One block per row: thread (slab, t) takes symbol t over a quarter of
// the row's chunks.  First each slab's maximum (loads only, so they
// overlap), then the slabs before it through shared memory, then the
// exclusive running max written back.
__global__ void __launch_bounds__(kSlabs * kAlpha)
    carry_scan(int* __restrict__ lastc, int nch) {
  __shared__ int top[kSlabs][kAlpha];
  const int t = threadIdx.x & (kAlpha - 1), slab = threadIdx.x / kAlpha;
  const int per = (nch + kSlabs - 1) / kSlabs;
  const int lo = slab * per, hi = min(lo + per, nch);
  int* col = lastc + (size_t)blockIdx.x * nch * kAlpha + t;
  int m = -1;
  for (int c = lo; c < hi; ++c) m = max(m, col[(size_t)c * kAlpha]);
  top[slab][t] = m;
  __syncthreads();
  int carry = -1;
  for (int k = 0; k < slab; ++k) carry = max(carry, top[k][t]);
  for (int c = lo; c < hi; ++c) {
    const int v = col[(size_t)c * kAlpha];
    col[(size_t)c * kAlpha] = carry;
    carry = max(carry, v);
  }
}

// Look for s in level J of the list and below, shifting what lies in
// front of it back by one entry; carry (lane 0's) enters the level at
// lane 0.  Returns the position s was found at.  A template, so that
// every index into L is a constant and L stays in registers.
template <int J>
__device__ __forceinline__ int descend(int (&L)[8], int s, int carry,
                                       int lane, int behind) {
  const unsigned found = __ballot_sync(kFull, L[J] == s);
  const int rot = __shfl_sync(kFull, L[J], behind);
  const int shifted = lane == 0 ? carry : rot;
  if (found) {
    const int hit = __ffs(found) - 1;
    if (lane <= hit) L[J] = shifted;
    return 32 * J + hit;
  }
  L[J] = shifted;
  if constexpr (J + 1 < 8)
    return descend<J + 1>(L, s, rot, lane, behind);  // rot: lane 0 holds
  else                                               // the level's last
    return 0;  // not reached: the list holds every symbol
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    rank_pass(const T* __restrict__ syms,
              const unsigned char* __restrict__ cmaps,
              const int* __restrict__ ns, const int* __restrict__ lastc,
              int* __restrict__ out, int N, int chunk, int nch) {
  __shared__ __align__(16) int sm[kWarps][kAlpha];
  __shared__ int tab[kAlpha];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + wid;
  const int b = blockIdx.y;
  if constexpr (sizeof(T) == 1) {
    build_table(cmaps + (size_t)b * kAlpha, tab);
    __syncthreads();
  }
  if (c >= nch) return;  // whole warp leaves together
  const int n = max(0, min(ns[b], N));
  const int lo = c * chunk;
  const int end = min(lo + chunk, N);
  const int lim = min(end, n);  // [lo, lim) ranked, [lim, end) zeroed
  const Syms<T> row{syms + (size_t)b * N, tab};
  int* orow = out + (size_t)b * N;
  if (lo >= lim) {
    for (int i = lo + lane; i < end; i += 32) orow[i] = 0;
    return;
  }

  // The list at the chunk's start: symbol t sits behind every symbol
  // with a larger key (seen: its last position; unseen: below all seen,
  // smaller symbols first).
  int* my = sm[wid];
  const int* lc = lastc + ((size_t)b * nch + c) * kAlpha;
  int key[8], pos[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = lane + 32 * j;
    const int v = lc[t];
    key[j] = v >= 0 ? v : -1 - t;
    my[t] = key[j];
    pos[j] = 0;
  }
  __syncwarp();
  const int4* my4 = reinterpret_cast<const int4*>(my);
  for (int u = 0; u < kAlpha / 4; ++u) {
    const int4 k = my4[u];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pos[j] += (k.x > key[j]) + (k.y > key[j]) + (k.z > key[j]) +
                (k.w > key[j]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) my[pos[j]] = lane + 32 * j;
  __syncwarp();
  int L[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) L[j] = my[32 * j + lane];

  const int behind = (lane + 31) & 31;  // a rotate by one lane reads it
  int tail = -1;                        // the symbol before this load
  int ahead = lo + lane < lim ? row(lo + lane) : -1;
  for (int base = lo; base < end; base += 32) {
    const int i = base + lane;
    const int sym = ahead;  // -1 at lanes >= lim
    ahead = i + 32 < lim ? row(i + 32) : -1;
    int prev = __shfl_up_sync(kFull, sym, 1);
    if (lane == 0) prev = tail;
    tail = __shfl_sync(kFull, sym, 31);
    // a symbol equal to its predecessor is at the front already
    unsigned todo = __ballot_sync(kFull, sym >= 0 && sym != prev);
    int mine = 0;
    while (todo) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      const int s = __shfl_sync(kFull, sym, k);
      const int rank = descend<0>(L, s, s, lane, behind);
      if (lane == k) mine = rank;
    }
    if (i < end) orow[i] = mine;
  }
}

template <typename T>
int launch(const T* syms, const unsigned char* cmaps, const int* ns,
           int* out, int* lastc, int B, int N, int chunk,
           cudaStream_t s) {
  if (B <= 0 || N <= 0 || chunk <= 0) return (int)cudaGetLastError();
  const int nch = (N + chunk - 1) / chunk;
  chunk_last<T><<<dim3(nch, B), kAlpha, 0, s>>>(syms, cmaps, ns, lastc, N,
                                                chunk, nch);
  carry_scan<<<B, kSlabs * kAlpha, 0, s>>>(lastc, nch);
  rank_pass<T><<<dim3((nch + kWarps - 1) / kWarps, B), 32 * kWarps, 0, s>>>(
      syms, cmaps, ns, lastc, out, N, chunk, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// syms (B, N) int32 in [0, 256), ns (B,) int32, out (B, N) int32,
// lastc (B, ceil(N / chunk), 256) int32 scratch; all device pointers.
extern "C" int lbz2t_mtf_ranks(const void* syms, const void* ns, void* out,
                               void* lastc, int B, int N, int chunk,
                               void* stream) {
  return launch(static_cast<const int*>(syms), nullptr,
                static_cast<const int*>(ns), static_cast<int*>(out),
                static_cast<int*>(lastc), B, N, chunk,
                static_cast<cudaStream_t>(stream));
}

// bwt (B, N) uint8 and cmaps (B, 256) uint8 (the row's used bytes), ns
// (B,) int32; out and lastc as lbz2t_mtf_ranks; all device pointers.
extern "C" int lbz2t_mtf_ranks_bytes(const void* bwt, const void* cmaps,
                                     const void* ns, void* out, void* lastc,
                                     int B, int N, int chunk, void* stream) {
  return launch(static_cast<const unsigned char*>(bwt),
                static_cast<const unsigned char*>(cmaps),
                static_cast<const int*>(ns), static_cast<int*>(out),
                static_cast<int*>(lastc), B, N, chunk,
                static_cast<cudaStream_t>(stream));
}
