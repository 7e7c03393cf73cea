// The BWT's two emits for Hopper (sm_90a): the BWT bytes and the primary
// index from a resolved ISA (chain mode), and the run tokens of token mode.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/bwt2.py::_emit_bytes (:218) and
// ::_emit2 (:166).  The TPU form sorts the lanes by their ISA with the
// previous byte as payload (a TPU's scatters are slow), then, for the
// tokens, sorts the run starts to the front of the row.  Here:
//
//   emit_bytes   the ISA the resolve loop hands over is a permutation of
//                [0, n) on the lanes < n (it comes after at least one
//                pass), so the sorted order is a scatter:
//                bwt[ISA[p]] = prev[p], prev[p] = blocks[p - 1] and
//                prev[0] = blocks[n - 1].  Scattered straight, that is
//                one random one-byte store a lane, which L2 has to merge
//                into sectors: it runs at the store rate, as scatter_
//                does, whatever the bytes.  So the destinations are
//                bucketed first, in two launches:
//     emit_bin   a CTA takes kBinTile lanes of one row, reads their ISA
//                and previous byte coalesced and sorts them in shared
//                memory by bucket ISA >> kBucketLog (a count by shared
//                atomics, a scan, a scatter into the CTA's staging);
//                for each non-empty bucket one global atomicAdd on the
//                (row, bucket) cursor reserves a run in the bucket's
//                region [k S, min((k + 1) S, n)) of a (B, N) uint32
//                scratch, and the run is stored contiguously as
//                (ISA & (S - 1)) << 8 | byte.  The ISA being a
//                permutation, each bucket receives exactly its region;
//                an entry past it (no permutation) is dropped.  The
//                primary index ISA[m ? n - m : 0] in the same launch.
//     emit_place a CTA a (row, bucket): zero an S-byte buffer in shared
//                memory, read the bucket's entries coalesced up to its
//                cursor, put each byte at its offset, store the buffer
//                whole as 16-byte vectors.  Lanes >= n are 0.
//                The order of a bucket's entries follows the atomics
//                and differs from run to run; the output does not, as
//                every destination is written once.
//   emit_tokens  three launches over tiles of kTile lanes, a CTA a tile.
//                A lane p < n starts a token where the byte changes (p = 0
//                always) or where (p - runstart) % 255 == 0 and
//                p != runstart, runstart the last change at or before p.
//                tok_last: each tile's last change.  tok_count: the last
//                change before the tile (a max over the tiles before it),
//                then each thread's (an exclusive max-scan of the CTA's
//                threads) give every lane its runstart; the tile counts
//                its starts.  tok_emit: the same starts, their token
//                index from the counts of the tiles before and a CTA sum
//                scan; a token's length min(next change, p + 255, n) - p
//                from an exclusive min-scan of the threads' first changes
//                from the right and a halo of 255 lanes past the tile;
//                the u16 byte << 8 | len stored at its index when it is
//                below the capacity; the slots from the row's count up to
//                the capacity zeroed, a share a tile.
//
// What bounds them: bytes.  At (32, 901120) emit_bytes must read the ISA
// below n (115.2 MB) and the blocks (28.8 MB) and write the rows
// (28.8 MB); the buckets add the scratch's 115.2 MB written and read
// again, 403 MB in all.  emit_tokens reads the rows and writes 14.4 MB of
// tokens.  The token launches read the rows three times, from L2 where
// they were just written.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBucketLog = 14;  // S = 16384 destinations a bucket
constexpr int kBucket = 1 << kBucketLog;
constexpr int kMaxBuckets = 512;  // rows below 2^23 lanes
constexpr int kBinThreads = 512;
constexpr int kBinPer = 16;  // lanes a thread in emit_bin
constexpr int kBinTile = kBinThreads * kBinPer;
constexpr int kPlaceThreads = 256;
constexpr unsigned kEntry = (1u << (kBucketLog + 8)) - 1u;  // an entry's bits
constexpr int kThreads = 256;
constexpr int kPer = 16;  // consecutive lanes a thread in the token launches
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLen = 255;  // a token's 8-bit length
constexpr int kNone = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// exclusive sum over s[0, count) in place, count <= kBinThreads; returns
// the total to every thread
__device__ int bin_scan(int* s, int count) {
  __shared__ int warps[kBinThreads / 32];
  __shared__ int total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x = tid < count ? s[tid] : 0;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBinThreads / 32 ? warps[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kBinThreads / 32) warps[lane] = w;
    if (lane == kBinThreads / 32 - 1) total = w;
  }
  __syncthreads();
  if (tid < count) s[tid] = incl - x + (warp ? warps[warp - 1] : 0);
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kBinThreads, 2)
    emit_bin(const uint8_t* __restrict__ blocks, const int* __restrict__ isa,
             const int* __restrict__ ns, const int* __restrict__ ms,
             unsigned* __restrict__ entries, int* __restrict__ cursors,
             int* __restrict__ primary, int N, int nb) {
  __shared__ unsigned s_ent[kBinTile];
  __shared__ int s_cnt[kMaxBuckets], s_off[kMaxBuckets], s_base[kMaxBuckets];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), N);
  const int* irow = isa + (size_t)b * N;
  if (blockIdx.x == 0 && tid == 0) {
    const int m = ms[b];
    primary[b] = irow[min(max(m == 0 ? 0 : n - m, 0), N - 1)];
  }
  const int lo = blockIdx.x * kBinTile;
  if (lo >= n) return;  // the whole CTA
  for (int k = tid; k < nb; k += kBinThreads) s_cnt[k] = 0;
  __syncthreads();
  // a lane's staged value ISA << 8 | byte (31 bits), its bucket in the
  // top bits, and its rank among the CTA's lanes of that bucket.  Every
  // load is issued before the first atomic: a load cannot be moved past
  // one, and a load, an atomic, a load... waits for memory at each lane
  const uint8_t* row = blocks + (size_t)b * N;
  unsigned v[kBinPer];
  int r[kBinPer];
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    const int p = lo + j * kBinThreads + tid;
    v[j] = p < n ? (unsigned)irow[p] : 0xFFFFFFFFu;
    r[j] = p < n ? row[p ? p - 1 : n - 1] : 0;
  }
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    const unsigned d = v[j];
    v[j] = d << 8 | (unsigned)r[j];
    r[j] = d < (unsigned)n ? atomicAdd(&s_cnt[d >> kBucketLog], 1) : -1;
  }
  __syncthreads();
  for (int k = tid; k < nb; k += kBinThreads) s_off[k] = s_cnt[k];
  const int total = bin_scan(s_off, nb);
#pragma unroll
  for (int j = 0; j < kBinPer; ++j)
    if (r[j] >= 0) s_ent[s_off[v[j] >> (kBucketLog + 8)] + r[j]] = v[j];
  for (int k = tid; k < nb; k += kBinThreads)
    if (s_cnt[k])
      s_base[k] = atomicAdd(&cursors[(size_t)b * nb + k], s_cnt[k]);
  __syncthreads();
  unsigned* erow = entries + (size_t)b * N;
  for (int i = tid; i < total; i += kBinThreads) {
    const unsigned e = s_ent[i];
    const int k = (int)(e >> (kBucketLog + 8));
    const int dst = k * kBucket + s_base[k] + (i - s_off[k]);
    if (dst < min((k + 1) * kBucket, n)) erow[dst] = e & kEntry;
  }
}

__global__ void __launch_bounds__(kPlaceThreads)
    emit_place(const unsigned* __restrict__ entries,
               const int* __restrict__ cursors, const int* __restrict__ ns,
               uint8_t* __restrict__ out, int N, int nb) {
  __shared__ __align__(16) uint8_t buf[kBucket];
  const int k = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), N);
  const int lo = k * kBucket;
  const int len = min(kBucket, N - lo);  // the bucket's lanes of the row
  const int cnt = min(cursors[(size_t)b * nb + k],
                      max(min(kBucket, n - lo), 0));
  uint4* b4 = reinterpret_cast<uint4*>(buf);
  for (int i = tid; i < kBucket / 16; i += kPlaceThreads)
    b4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const unsigned* e = entries + (size_t)b * N + lo;
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(e) & 15) == 0) {
    const uint4* e4 = reinterpret_cast<const uint4*>(e);
    for (int i = tid; i < cnt / 4; i += kPlaceThreads) {
      const uint4 x = e4[i];
      buf[x.x >> 8] = (uint8_t)x.x;
      buf[x.y >> 8] = (uint8_t)x.y;
      buf[x.z >> 8] = (uint8_t)x.z;
      buf[x.w >> 8] = (uint8_t)x.w;
    }
    i0 = cnt & ~3;
  }
  for (int i = i0 + tid; i < cnt; i += kPlaceThreads) {
    const unsigned x = e[i];
    buf[x >> 8] = (uint8_t)x;
  }
  __syncthreads();
  uint8_t* o = out + (size_t)b * N + lo;
  for (int i = tid * 16; i < len; i += kPlaceThreads * 16) {
    if (i + 16 <= len && (reinterpret_cast<uintptr_t>(o + i) & 15) == 0) {
      *reinterpret_cast<uint4*>(o + i) = b4[i / 16];
    } else {
      for (int q = i; q < min(i + 16, len); ++q) o[q] = buf[q];
    }
  }
}

struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};

template <class Op>
__device__ __forceinline__ int warp_inclusive(int x, int lane, Op op) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = op(y, x);
  }
  return x;
}

// exclusive scan of the CTA's values in thread order (id: the identity);
// every thread gets the CTA's total in *total.  Reentrant: the shared
// words are free again when it returns.
template <class Op>
__device__ int cta_exclusive(int x, int id, Op op, int* total) {
  __shared__ int warps[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive(x, lane, op);
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warps[lane] : id;
    w = warp_inclusive(w, lane, op);
    if (lane < kWarps) warps[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warps[warp - 1] : id;
  const int prev = __shfl_up_sync(kFull, incl, 1);
  *total = warps[kWarps - 1];
  __syncthreads();
  return lane ? op(before, prev) : before;
}

// op over the values of a row's tiles j in [0, upto) (id if none)
template <class Op>
__device__ int tiles_before(const int* __restrict__ v, int upto, int id,
                            Op op) {
  int x = id;
  for (int j = threadIdx.x; j < upto; j += kThreads) x = op(x, v[j]);
  int all;
  cta_exclusive(x, id, op, &all);
  return all;
}

// A thread's kPer lanes first .. first + kPer - 1 of the tile at lo:
// the bytes staged in shared memory, bit q of the change mask set where
// lane first + q < hi holds another byte than the lane before it (or is
// lane 0).
struct Lanes {
  unsigned w[kPer / 4];
  unsigned change;
  int first;
  __device__ int byte(int q) const { return (w[q >> 2] >> (8 * (q & 3))) & 255; }
};

__device__ __forceinline__ Lanes load_lanes(const uint8_t* __restrict__ row,
                                            int lo, int hi, uint8_t* sb) {
  __shared__ int s_pre;
  // coalesced: thread i stages lanes i, i + kThreads, ...
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kThreads + threadIdx.x;
    sb[i] = lo + i < hi ? row[lo + i] : 0;
  }
  if (threadIdx.x == 0) s_pre = lo > 0 ? row[lo - 1] : -1;
  __syncthreads();
  Lanes L;
  const uint4 v = reinterpret_cast<const uint4*>(sb)[threadIdx.x];
  L.w[0] = v.x, L.w[1] = v.y, L.w[2] = v.z, L.w[3] = v.w;
  L.first = lo + threadIdx.x * kPer;
  int prev = threadIdx.x ? sb[threadIdx.x * kPer - 1] : s_pre;
  L.change = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int c = L.byte(q);
    if (L.first + q < hi && (L.first + q == 0 || c != prev))
      L.change |= 1u << q;
    prev = c;
  }
  __syncthreads();  // sb and s_pre are free for the caller
  return L;
}

// the lanes' token starts, given the runstart open at the thread's left
__device__ __forceinline__ unsigned start_mask(const Lanes& L, int hi,
                                               int rs) {
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = L.first + q;
    if (p < hi) {
      if (L.change >> q & 1u) {
        rs = p;
        m |= 1u << q;
      } else if ((p - rs) % kMaxLen == 0) {
        m |= 1u << q;
      }
    }
  }
  return m;
}

__device__ __forceinline__ int last_change(const Lanes& L) {
  return L.change ? L.first + 31 - __clz(L.change) : -1;
}

// the runstart open at this thread's left: the last change before the
// tile (from the tiles before it) or before the thread in it
__device__ __forceinline__ int open_run(const int* __restrict__ last_row,
                                        int t, const Lanes& L) {
  const int before = tiles_before(last_row, t, -1, Max());
  int all;
  return max(before, cta_exclusive(last_change(L), -1, Max(), &all));
}

__global__ void __launch_bounds__(kThreads)
    tok_last(const uint8_t* __restrict__ bwt, const int* __restrict__ ns,
             int N, int tiles, int* __restrict__ last) {
  __shared__ __align__(16) uint8_t sb[kTile];
  const int b = blockIdx.y, t = blockIdx.x;
  const int n = min(max(ns[b], 0), N);
  const int lo = t * kTile, hi = min(lo + kTile, n);
  int m = -1;
  if (lo < hi) {  // the whole CTA
    const Lanes L = load_lanes(bwt + (size_t)b * N, lo, hi, sb);
    cta_exclusive(last_change(L), -1, Max(), &m);
  }
  if (threadIdx.x == 0) last[(size_t)b * tiles + t] = m;
}

__global__ void __launch_bounds__(kThreads)
    tok_count(const uint8_t* __restrict__ bwt, const int* __restrict__ ns,
              int N, int tiles, const int* __restrict__ last,
              int* __restrict__ cnt) {
  __shared__ __align__(16) uint8_t sb[kTile];
  const int b = blockIdx.y, t = blockIdx.x;
  const int n = min(max(ns[b], 0), N);
  const int lo = t * kTile, hi = min(lo + kTile, n);
  int c = 0;
  if (lo < hi) {  // the whole CTA
    const Lanes L = load_lanes(bwt + (size_t)b * N, lo, hi, sb);
    const int rs = open_run(last + (size_t)b * tiles, t, L);
    cta_exclusive(__popc(start_mask(L, hi, rs)), 0, Sum(), &c);
  }
  if (threadIdx.x == 0) cnt[(size_t)b * tiles + t] = c;
}

__global__ void __launch_bounds__(kThreads)
    tok_emit(const uint8_t* __restrict__ bwt, const int* __restrict__ ns,
             int N, int tiles, const int* __restrict__ last,
             const int* __restrict__ cnt, uint16_t* __restrict__ tokens,
             int cap, int* __restrict__ run_counts) {
  __shared__ __align__(16) uint8_t sb[kTile];
  __shared__ int s_after;
  const int b = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int n = min(max(ns[b], 0), N);
  const int lo = t * kTile, hi = min(lo + kTile, n);
  const uint8_t* row = bwt + (size_t)b * N;
  const int* crow = cnt + (size_t)b * tiles;
  uint16_t* trow = tokens + (size_t)b * cap;
  const int total = tiles_before(crow, tiles, 0, Sum());
  if (t == 0 && tid == 0) run_counts[b] = total;
  if (lo < hi) {  // the whole CTA
    const int off = tiles_before(crow, t, 0, Sum());
    if (tid == 0) s_after = kNone;
    // the halo: the first change in the kMaxLen lanes past the tile
    const int q = lo + kTile + tid;
    __syncthreads();
    if (tid < kMaxLen && q < n && row[q] != row[q - 1]) atomicMin(&s_after, q);
    const Lanes L = load_lanes(row, lo, hi, sb);  // syncs: s_after is set
    const int rs = open_run(last + (size_t)b * tiles, t, L);
    const unsigned starts = start_mask(L, hi, rs);
    int dummy;
    const int idx0 =
        off + cta_exclusive(__popc(starts), 0, Sum(), &dummy);
    // the first change right of this thread: an exclusive min-scan from
    // the right, thread kThreads - 1 - tid scanning in tid's place
    int* right = reinterpret_cast<int*>(sb);  // sb is free again
    right[kThreads - 1 - tid] =
        L.change ? L.first + __ffs(L.change) - 1 : kNone;
    __syncthreads();
    const int mirrored = right[tid];
    __syncthreads();
    right[kThreads - 1 - tid] =
        min(s_after, cta_exclusive(mirrored, kNone, Min(), &dummy));
    __syncthreads();
    int next = right[tid];  // the first change past this thread's lanes
#pragma unroll
    for (int k = kPer - 1; k >= 0; --k) {
      const int p = L.first + k;
      if (starts >> k & 1u) {
        const int i = idx0 + __popc(starts & ((1u << k) - 1u));
        const int len = min(min(next, p + kMaxLen), n) - p;
        if (i < cap) trow[i] = (uint16_t)(L.byte(k) << 8 | len);
      }
      if (L.change >> k & 1u) next = p;
    }
  }
  // the slots past the row's tokens: a share of [total, cap) a tile
  const int rest = max(cap - total, 0);
  const int share = (rest + tiles - 1) / tiles;
  const int z0 = total + t * share, z1 = min(z0 + share, cap);
  for (int i = z0 + tid; i < z1; i += kThreads) trow[i] = 0;
}

int tiles_of(int N) { return (N + kTile - 1) / kTile; }

}  // namespace

int buckets_of(int N) { return (N + kBucket - 1) / kBucket; }

// the (row, bucket) cursors emit_bytes needs for rows of N lanes, or -1
// where it does not take them
extern "C" int lbz2t_emit_buckets(int N) {
  return N > 0 && buckets_of(N) <= kMaxBuckets ? buckets_of(N) : -1;
}

// blocks (B, N) uint8, isa (B, N) int32 (a permutation of [0, n) on the
// lanes < n), ns and ms (B,) int32 in; out (B, N) uint8 and primary (B,)
// int32 out; entries (B, N) uint32 scratch and cursors (B,
// lbz2t_emit_buckets(N)) int32, zero in; all device pointers.
extern "C" int lbz2t_emit_bytes(const void* blocks, const void* isa,
                                const void* ns, const void* ms, void* out,
                                void* primary, void* entries, void* cursors,
                                int B, int N, void* stream) {
  const int nb = lbz2t_emit_buckets(N);
  if (B <= 0 || nb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nn = static_cast<const int*>(ns);
  int* cur = static_cast<int*>(cursors);
  unsigned* ent = static_cast<unsigned*>(entries);
  emit_bin<<<dim3((N + kBinTile - 1) / kBinTile, B), kBinThreads, 0, s>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int*>(isa), nn,
      static_cast<const int*>(ms), ent, cur, static_cast<int*>(primary), N,
      nb);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  emit_place<<<dim3(nb, B), kPlaceThreads, 0, s>>>(
      ent, cur, nn, static_cast<uint8_t*>(out), N, nb);
  return (int)cudaGetLastError();
}

// int32 words of the token launches' scratch for (B, N) rows
extern "C" long long lbz2t_emit_tokens_scratch_ints(int B, int N) {
  return 2ll * B * tiles_of(N);
}

// bwt (B, N) uint8 and ns (B,) int32 in; tokens (B, cap) u16 and
// run_counts (B,) int32 out; scratch of lbz2t_emit_tokens_scratch_ints
// int32; all device pointers.
extern "C" int lbz2t_emit_tokens(const void* bwt, const void* ns,
                                 void* tokens, void* run_counts,
                                 void* scratch, int B, int N, int cap,
                                 void* stream) {
  if (B <= 0 || N <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(N);
  const dim3 grid(tiles, B);
  const uint8_t* rows = static_cast<const uint8_t*>(bwt);
  const int* nn = static_cast<const int*>(ns);
  int* last = static_cast<int*>(scratch);
  int* cnt = last + (size_t)B * tiles;
  tok_last<<<grid, kThreads, 0, s>>>(rows, nn, N, tiles, last);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tok_count<<<grid, kThreads, 0, s>>>(rows, nn, N, tiles, last, cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tok_emit<<<grid, kThreads, 0, s>>>(rows, nn, N, tiles, last, cnt,
                                     static_cast<uint16_t*>(tokens), cap,
                                     static_cast<int*>(run_counts));
  return (int)cudaGetLastError();
}
