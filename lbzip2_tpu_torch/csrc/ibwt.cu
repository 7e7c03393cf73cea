// Batched inverse BWT by list ranking over sublists, for Hopper (sm_90a).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/ibwt.py::ibwt_masked (and
// its vmap ibwt_batched).  The function: ptr is the successor
// permutation, the stable sort of the row's bytes carrying their
// positions (pad lanes >= n sort last, so ptr[i] = i there);
//
//   seq[k] = ptr^(k+1)(idx);   out[k] = k < n ? bwt[seq[k]] : 0
//
// The JAX op finds seq by Wyllie pointer doubling over all N lanes,
// N log N work, because its compiler wants one dense program.  Here the
// work is proportional to the live lanes, sum of n over the rows
// (Helman and JaJa's list ranking):
//
//   1. hist_chunks / scan_chunks / rank_chunks: a stable counting sort
//      of [0, n) only.  A 256-bin histogram per 4096-position chunk,
//      a warp scan over chunks per key, then one warp per chunk walks
//      it 32 positions at a time (__match_any_sync groups equal keys)
//      and zeroes its share of the output's lanes at and past n.  The
//      entry written is ptr << 8 | byte: one gather later yields both
//      the successor and its byte.
//   2. walk_sublists: the positions that are multiples of K = 2^shift
//      and the start h = ptr[idx] are splitters.  One thread per
//      splitter follows ptr to the next splitter and records it and
//      the distance: all B * n / K walks are in flight at once, which
//      hides the gather latency a single chase could not.
//   3. rank_splitters: the splitter list (n / K + 1 entries a row)
//      goes into one block's shared memory, up to 160 KB of the SM's
//      227, and is ranked there by the same scheme once more (super
//      splitters, walks, a doubling over the at most 2561 of them,
//      second walks): a splitter's offset is n minus its distance to
//      the end.
//   4. emit_sublists: each thread walks its sublist again and writes
//      out[offset + k] directly, whole words where it can.
//
// A row that is no single cycle (corrupt input, a row of equal bytes),
// whose idx is at or past n, or in which a walk overruns its cap,
// cannot be ranked this way: the distances from the start do not add
// up to n.  Such a row is flagged; the wrapper reads the flags and
// redoes those rows with the doubling kernels below
// (lbz2t_ibwt_doubling), which define seq for any permutation.
//
// What bounds it on the card: two dependent 4-byte gathers for each
// byte (one a walk), each a 32-byte sector from L2, and the longest
// sublist of a batch, some K ln(n B / K) steps that one thread takes
// one after the other; the bytes the function must move (N in, N out)
// are far below that.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns the first launch error (cudaGetLastError()).

#include <cuda_runtime.h>

namespace {

constexpr int kKeys = 256;
constexpr int kWarps = 4;    // chunks per block in rank_chunks
constexpr int kAhead = 4;    // 32-position steps loaded ahead there
constexpr int kThreads = 256;
constexpr int kRankThreads = 1024;  // rank_splitters, one block a row
constexpr int kFill = 8;     // loads in flight a thread filling its table
constexpr int kSuper = 16;   // a super splitter every kSuper splitters
constexpr int kSuperCap = 64 * kSuper;  // the longest walk between two
constexpr int kMaxSplitters = 40960;    // 160 KB of entries a row
constexpr int kEnd = -1;     // link of the last super sublist
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int row_n(const int* ns, int b, int N) {
  return min(max(ns[b], 0), N);
}

__global__ void hist_chunks(const unsigned char* __restrict__ bwt,
                            const int* __restrict__ ns,
                            int* __restrict__ hist, int* __restrict__ redo,
                            int N, int chunk, int nch) {
  __shared__ int h[kKeys];
  const int c = blockIdx.x, b = blockIdx.y;
  if (c == 0 && threadIdx.x == 0) redo[b] = 0;
  const int n = row_n(ns, b, N);
  const int lo = c * chunk, hi = min(lo + chunk, n);
  if (lo >= hi) return;  // nothing reads a chunk at or past n
  h[threadIdx.x] = 0;    // blockDim.x == kKeys
  __syncthreads();
  const unsigned char* row = bwt + (size_t)b * N;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    atomicAdd(&h[row[i]], 1);
  __syncthreads();
  hist[((size_t)b * nch + c) * kKeys + threadIdx.x] = h[threadIdx.x];
}

// One warp per (row, key): an exclusive sum over the row's live chunks
// in place, the key's total to tot.
__global__ void scan_chunks(int* __restrict__ hist, int* __restrict__ tot,
                            const int* __restrict__ ns, int N, int chunk,
                            int nch) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int live = (row_n(ns, b, N) + chunk - 1) / chunk;
  int* col = hist + (size_t)b * nch * kKeys + k;
  int carry = 0;
  for (int c0 = 0; c0 < live; c0 += 32) {
    const int c = c0 + lane;
    const int v = c < live ? col[(size_t)c * kKeys] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    if (c < live) col[(size_t)c * kKeys] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) tot[b * kKeys + k] = carry;
}

__global__ void rank_chunks(const unsigned char* __restrict__ bwt,
                            const int* __restrict__ ns,
                            const int* __restrict__ hist,
                            const int* __restrict__ tot,
                            int* __restrict__ ptr,
                            unsigned char* __restrict__ out, int N,
                            int chunk, int nch) {
  __shared__ int cnt[kWarps][kKeys];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + wid, b = blockIdx.y;
  if (c >= nch) return;  // whole warp leaves together
  const int n = row_n(ns, b, N);
  const int lo = c * chunk, hi = min(lo + chunk, n);
  // the output's lanes at and past n are 0: this chunk's share of them
  for (int i = max(lo, n) + lane; i < min(lo + chunk, N); i += 32)
    out[(size_t)b * N + i] = 0;
  if (lo >= hi) return;
  // each key's first slot in this chunk: the smaller keys' totals
  // (lane l sums keys 8 l .. 8 l + 7, a warp scan joins the lanes)
  // plus the key's count in the chunks before
  int* my = cnt[wid];
  const int* first = hist + ((size_t)b * nch + c) * kKeys;
  const int* total = tot + b * kKeys;
  int t[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j] = total[lane * 8 + j];
    sum += t[j];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  int run = incl - sum;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    my[lane * 8 + j] = run + first[lane * 8 + j];
    run += t[j];
  }
  __syncwarp();
  const unsigned char* row = bwt + (size_t)b * N;
  int* prow = ptr + (size_t)b * N;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32 * kAhead) {
    int keys[kAhead];  // the loads of kAhead steps in flight at once
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + 32 * u + lane;
      keys[u] = i < hi ? row[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int key = keys[u];  // all -1 past hi: nothing happens
      const unsigned peers = __match_any_sync(kFull, key);
      const int rank = __popc(peers & lower);
      const int slot = key >= 0 ? my[key] + rank : 0;
      __syncwarp();
      if (key >= 0 && rank == 0) my[key] += __popc(peers);
      __syncwarp();
      if (key >= 0) prow[slot] = ((base + 32 * u + lane) << 8) | key;
    }
  }
}

// What every sublist kernel needs of its row.  live is false for a row
// with nothing to rank: n = 0 (all zeros) or idx at or past n (redone).
struct Row {
  int n, h, mask, regular, head;  // head: the start's splitter index
  bool live;
};

__device__ __forceinline__ Row row_of(const int* __restrict__ ptr,
                                      const int* __restrict__ ns,
                                      const int* __restrict__ idxs, int b,
                                      int N, int shift) {
  Row r;
  r.n = row_n(ns, b, N);
  r.mask = (1 << shift) - 1;
  r.regular = (r.n + r.mask) >> shift;  // splitters at multiples of K
  const int idx = min(max(idxs[b], 0), N - 1);
  r.live = r.n > 0 && idx < r.n;
  r.h = r.live ? ptr[(size_t)b * N + idx] >> 8 : 0;
  // the start has a slot of its own unless it is a multiple of K
  r.head = (r.h & r.mask) ? r.regular : r.h >> shift;
  return r;
}

__device__ __forceinline__ bool is_splitter(const Row& r, int v) {
  return (v & r.mask) == 0 || v == r.h;
}

// A splitter's entry: the index of the splitter that ends its sublist
// in the high half, the sublist's length in the low half (both below
// 2^16: the entry point refuses a shift that gives more splitters, and
// cap bounds the length).
__device__ __forceinline__ unsigned entry(int link, int len) {
  return (unsigned)link << 16 | (unsigned)len;
}

__global__ void walk_sublists(const int* __restrict__ ptr,
                              const int* __restrict__ ns,
                              const int* __restrict__ idxs,
                              unsigned* __restrict__ lnk,
                              int* __restrict__ redo, int N, int shift,
                              int cap, int S) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  const Row r = row_of(ptr, ns, idxs, b, N, shift);
  if (!r.live) {
    if (j == 0 && r.n > 0) redo[b] = 1;  // idx at or past n
    return;
  }
  if (j > r.regular) return;
  unsigned* mine = lnk + (size_t)b * S + j;
  const bool extra = j == r.regular;
  if (extra && r.head != r.regular) {  // the start is a regular splitter
    *mine = entry(j, 0);
    return;
  }
  const int* p = ptr + (size_t)b * N;
  int v = extra ? r.h : j << shift, len = 0;
  bool hit;
  do {
    v = p[v] >> 8;
    ++len;
    hit = is_splitter(r, v);
  } while (!hit && len < cap);
  if (!hit) {
    redo[b] = 1;
    *mine = entry(j, 0);
    return;
  }
  *mine = entry(v == r.h ? r.head : v >> shift, len);
}

// Rank the splitter list of a row, one block per row, the list in
// shared memory, where a dependent load costs tens of cycles: the same
// scheme once more.  Every kSuper-th splitter and the start are super
// splitters; a thread each walks the list to the next one, the super
// list (at most 2561 entries) is cut at the start and ranked by
// doubling, and a second walk hands every splitter its offset: n minus
// the distance from it to the end of the list.
__global__ void __launch_bounds__(kRankThreads)
    rank_splitters(const int* __restrict__ ptr, const int* __restrict__ ns,
                   const int* __restrict__ idxs,
                   const unsigned* __restrict__ lnk, int* __restrict__ off,
                   int* __restrict__ redo, int N, int shift, int S,
                   int S2) {
  extern __shared__ unsigned shared[];
  __shared__ int bad;
  const int b = blockIdx.x, tid = threadIdx.x;
  const Row r = row_of(ptr, ns, idxs, b, N, shift);
  if (!r.live || redo[b]) return;  // the whole block: no barrier skipped
  unsigned* ent = shared;                               // S entries
  int* link = reinterpret_cast<int*>(shared + S);       // 2 x S2
  unsigned* dist = shared + S + 2 * S2;                 // 2 x S2
  const int cnt = r.regular + 1;
  const int regular2 = (cnt + kSuper - 1) / kSuper;
  const int head2 = r.head % kSuper ? regular2 : r.head / kSuper;
  const int cnt2 = regular2 + 1;
  if (tid == 0) bad = 0;
  const unsigned* mine = lnk + (size_t)b * S;
  for (int j0 = tid; j0 < cnt; j0 += kFill * kRankThreads) {
    unsigned e[kFill];  // kFill loads in flight a thread
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int j = j0 + u * kRankThreads;
      e[u] = j < cnt ? mine[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int j = j0 + u * kRankThreads;
      if (j < cnt) ent[j] = e[u];
    }
  }
  __syncthreads();
  for (int j = tid; j < cnt2; j += kRankThreads) {
    const bool extra = j == regular2;
    if (extra && head2 != regular2) {  // the start is a regular one
      link[j] = j;
      dist[j] = 0;
      continue;
    }
    int v = extra ? r.head : j * kSuper, steps = 0;
    unsigned d = 0;
    bool hit;
    do {
      const unsigned e = ent[v];
      d += e & 0xFFFFu;
      v = (int)(e >> 16);
      ++steps;
      hit = v % kSuper == 0 || v == r.head;
    } while (!hit && steps < kSuperCap);
    if (!hit) bad = 1;
    // the super list is cut where it comes back to the start
    link[j] = !hit ? j : v == r.head ? kEnd : v / kSuper;
    dist[j] = d;
  }
  __syncthreads();
  if (bad) {
    if (tid == 0) redo[b] = 1;
    return;
  }
  // after t steps a link spans 2^t sublists; the list has at most cnt2,
  // and cnt2 is 2 or more
  int cur = 0;
  for (int t = 32 - __clz(cnt2 - 1); t > 0; --t, cur ^= 1) {
    for (int j = tid; j < cnt2; j += kRankThreads) {
      int to = link[cur * S2 + j];
      unsigned d = dist[cur * S2 + j];
      if (to != kEnd) {
        d += dist[cur * S2 + to];
        to = link[cur * S2 + to];
      }
      link[(cur ^ 1) * S2 + j] = to;
      dist[(cur ^ 1) * S2 + j] = d;
    }
    __syncthreads();
  }
  link += cur * S2;
  dist += cur * S2;
  if (link[head2] != kEnd || dist[head2] != (unsigned)r.n) {
    if (tid == 0) redo[b] = 1;  // no single cycle over [0, n)
    return;
  }
  // each entry is read once more, by the one walk that owns it, and
  // gives way to its offset; the offsets leave in whole lines
  for (int j = tid; j < cnt2; j += kRankThreads) {
    const bool extra = j == regular2;
    if (extra && head2 != regular2) continue;
    int v = extra ? r.head : j * kSuper;
    int o = r.n - (int)dist[j];
    do {
      const unsigned e = ent[v];
      ent[v] = (unsigned)o;
      o += (int)(e & 0xFFFFu);
      v = (int)(e >> 16);
    } while (v % kSuper != 0 && v != r.head);
  }
  __syncthreads();
  for (int j = tid; j < cnt; j += kRankThreads)
    off[(size_t)b * S + j] = (int)ent[j];
}

// The last `have` bytes before out[end], held in acc at the byte lanes
// of their addresses.
__device__ __forceinline__ void store_bytes(unsigned char* out, size_t end,
                                            unsigned acc, int have) {
  for (size_t q = end - have; q < end; ++q)
    out[q] = (unsigned char)(acc >> (8 * (int)(q & 3)));
}

__global__ void emit_sublists(const unsigned char* __restrict__ bwt,
                              const int* __restrict__ ptr,
                              const int* __restrict__ ns,
                              const int* __restrict__ idxs,
                              const int* __restrict__ off,
                              const int* __restrict__ redo,
                              unsigned char* __restrict__ out, int N,
                              int shift, int S) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  const Row r = row_of(ptr, ns, idxs, b, N, shift);
  if (!r.live || redo[b] || j > r.regular) return;
  const bool extra = j == r.regular;
  if (extra && r.head != r.regular) return;
  const int* p = ptr + (size_t)b * N;
  int v = extra ? r.h : j << shift;
  int o = off[(size_t)b * S + j];
  if (o < 0) return;
  int byte = bwt[(size_t)b * N + v];
  // bytes gather into a word; a word that this sublist fills whole is
  // one aligned store, the ragged ends go out byte by byte
  const size_t g0 = (size_t)b * N;
  unsigned acc = 0;
  int have = 0;
  while (o < r.n) {
    const int at = (int)((g0 + o) & 3);
    acc |= (unsigned)byte << (8 * at);
    ++have;
    ++o;
    if (at == 3) {
      if (have == 4)
        *reinterpret_cast<unsigned*>(out + g0 + o - 4) = acc;
      else
        store_bytes(out, g0 + o, acc, have);
      acc = 0;
      have = 0;
    }
    const int e = p[v];
    v = e >> 8;
    byte = e & 255;
    if (is_splitter(r, v)) break;
  }
  store_bytes(out, g0 + o, acc, have);
}

// The doubling kernels: seq for any permutation, on the rows listed in
// rows (scratch is indexed by the position in that list).
__global__ void unpack_ptr(const int* __restrict__ ptr,
                           const int* __restrict__ ns,
                           const int* __restrict__ rows,
                           int* __restrict__ jump, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int b = rows[blockIdx.y];
  jump[(size_t)blockIdx.y * N + p] =
      p < row_n(ns, b, N) ? ptr[(size_t)b * N + p] >> 8 : p;
}

__global__ void init_seq(const int* __restrict__ jump,
                         const int* __restrict__ idxs,
                         const int* __restrict__ rows,
                         int* __restrict__ seq, int R, int N) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int idx = min(max(idxs[rows[r]], 0), N - 1);
  seq[(size_t)r * N] = jump[(size_t)r * N + idx];
}

//   seq[L + k] = jump[seq[k]]  (k < L, jump = ptr^L);  jump = jump[jump]
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
                           const int* __restrict__ rows,
                           const int* __restrict__ seq,
                           unsigned char* __restrict__ out, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int b = rows[blockIdx.y];
  const size_t off = (size_t)b * N;
  out[off + p] = p < row_n(ns, b, N)
                     ? bwt[off + seq[(size_t)blockIdx.y * N + p]]
                     : 0;
}

}  // namespace

#define LBZ2T_CHECK()                                \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return (int)e;             \
  } while (0)

// bwt (B, N) uint8, ns and idxs (B,) int32, out (B, N) uint8; scratch,
// int32 words in this order: ptr (B, N) (kept for lbz2t_ibwt_doubling),
// lnk (B, S) with S = ceil(N / 2^shift) + 1, off (B, S), hist
// (B, ceil(N / chunk), 256), tot (B, 256), redo (B,).  All device
// pointers but redo_host, (B,) int32 in pinned host memory: the last
// thing queued is the copy of redo into it, nonzero for the rows
// lbz2t_ibwt_doubling must redo (their out lanes below n are not
// written).  N below 2^23, S at most 40960, cap below 2^16.
extern "C" int lbz2t_ibwt(const void* bwt, const void* ns, const void* idxs,
                          void* out, void* scratch, void* redo_host, int B,
                          int N, int chunk, int shift, int cap,
                          void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (chunk <= 0 || shift < 0 || shift > 22 || N >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  const int nch = (N + chunk - 1) / chunk;
  const int S = ((N + (1 << shift) - 1) >> shift) + 1;
  const int S2 = (S + kSuper - 1) / kSuper + 1;
  if (S > kMaxSplitters || cap <= 0 || cap >= (1 << 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* bw = static_cast<const unsigned char*>(bwt);
  const int* nn = static_cast<const int*>(ns);
  const int* ii = static_cast<const int*>(idxs);
  int* pp = static_cast<int*>(scratch);
  unsigned* ln = reinterpret_cast<unsigned*>(pp + (size_t)B * N);
  int* of = reinterpret_cast<int*>(ln + (size_t)B * S);
  int* h = of + (size_t)B * S;
  int* tt = h + (size_t)B * nch * kKeys;
  int* rd = tt + (size_t)B * kKeys;
  const size_t smem = ((size_t)S + 4 * (size_t)S2) * sizeof(unsigned);
  // the attribute is the device's own: set it once for each, to what
  // the longest list takes
  static bool allowed[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    constexpr int kMaxS2 = (kMaxSplitters + kSuper - 1) / kSuper + 1;
    e = cudaFuncSetAttribute(
        rank_splitters, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kMaxSplitters + 4 * kMaxS2) * (int)sizeof(unsigned));
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = true;
  }
  hist_chunks<<<dim3(nch, B), kKeys, 0, s>>>(bw, nn, h, rd, N, chunk, nch);
  LBZ2T_CHECK();
  scan_chunks<<<dim3(kKeys / (kThreads / 32), B), kThreads, 0, s>>>(
      h, tt, nn, N, chunk, nch);
  LBZ2T_CHECK();
  rank_chunks<<<dim3((nch + kWarps - 1) / kWarps, B), 32 * kWarps, 0, s>>>(
      bw, nn, h, tt, pp, static_cast<unsigned char*>(out), N, chunk, nch);
  LBZ2T_CHECK();
  const dim3 walkers((S + kThreads - 1) / kThreads, B);
  walk_sublists<<<walkers, kThreads, 0, s>>>(pp, nn, ii, ln, rd, N, shift,
                                             cap, S);
  LBZ2T_CHECK();
  rank_splitters<<<B, kRankThreads, smem, s>>>(pp, nn, ii, ln, of, rd, N,
                                               shift, S, S2);
  LBZ2T_CHECK();
  emit_sublists<<<walkers, kThreads, 0, s>>>(
      bw, pp, nn, ii, of, rd, static_cast<unsigned char*>(out), N, shift, S);
  LBZ2T_CHECK();
  return (int)cudaMemcpyAsync(redo_host, rd, (size_t)B * sizeof(int),
                              cudaMemcpyDeviceToHost, s);
}

// Redo the R rows listed in rows (R,) int32 by pointer doubling, from
// the ptr that lbz2t_ibwt left; scratch jump_a, jump_b, seq (R, N)
// int32.  steps = ceil(log2 N), at least 1.
extern "C" int lbz2t_ibwt_doubling(const void* bwt, const void* ns,
                                   const void* idxs, void* out,
                                   const void* ptr, const void* rows,
                                   void* jump_a, void* jump_b, void* seq,
                                   int R, int N, int steps, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nn = static_cast<const int*>(ns);
  const int* rr = static_cast<const int*>(rows);
  int* ja = static_cast<int*>(jump_a);
  int* jb = static_cast<int*>(jump_b);
  int* sq = static_cast<int*>(seq);
  const dim3 grid((N + kThreads - 1) / kThreads, R);
  unpack_ptr<<<grid, kThreads, 0, s>>>(static_cast<const int*>(ptr), nn, rr,
                                       ja, N);
  LBZ2T_CHECK();
  init_seq<<<(R + 127) / 128, 128, 0, s>>>(
      ja, static_cast<const int*>(idxs), rr, sq, R, N);
  LBZ2T_CHECK();
  int L = 1;
  for (int st = 0; st < steps; ++st, L *= 2) {
    int* jin = (st & 1) ? jb : ja;
    int* jout = (st & 1) ? ja : jb;
    double_step<<<grid, kThreads, 0, s>>>(jin, jout, sq, N, L,
                                          st + 1 < steps);
    LBZ2T_CHECK();
  }
  gather_out<<<grid, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(bwt), nn, rr, sq,
      static_cast<unsigned char*>(out), N);
  LBZ2T_CHECK();
  return 0;
}
