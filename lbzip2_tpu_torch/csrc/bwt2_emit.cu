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
//   emit_tokens  a lane p < n starts a token where the byte changes (p = 0
//                always) or where (p - runstart) % 255 == 0 and
//                p != runstart, runstart the last change at or before p;
//                the token is the u16 byte << 8 | len, len the distance
//                to the next start (or to n).  One pass over the rows, a
//                single-pass chained scan with decoupled look-back
//                (Merrill and Garland, "Single-pass Parallel Prefix Scan
//                with Decoupled Look-back", NVIDIA NVR-2016-002), as in
//                csrc/rle2.cu:
//     tok_scan   a CTA draws a ticket (tiles tile-major across the rows),
//                stages its kTile lanes and kHalo lanes past them with
//                16-byte loads and sums each thread's kPer lanes up as a
//                Seg (below); an ordered CTA scan gives the tile's Seg,
//                published as its aggregate before warp 0 looks back
//                over the row's earlier tiles to the first inclusive Seg.
//                The only part of a tile that depends on what is before
//                it is the splits of the run open at its left in its
//                leading stretch [lo, fc); with rs the last change before
//                the tile they are the lanes with (p - rs) % 255 == 0,
//                counted in closed form.  Each start then has its index
//                (the starts before the thread, its rank in the thread);
//                its position goes to shared memory, and a second walk,
//                a thread a token, takes each length from the next
//                start's position (the tile's last one from the first
//                change in the halo, p + 255 or n) and stores the tokens
//                coalesced at their indices below the capacity.  The
//                CTA of lane n - 1 writes the row's count.
//     tok_tail   zeroes the slots from the row's count up to the
//                capacity, launched behind tok_scan by programmatic
//                dependent launch (a tile does not know the count until
//                the row's last tile has looked back).
//
// The combine.  A Seg sums up a span [lo, hi) of a row's lanes below n:
// fc and lc its first and last change (-1: none), cnt the starts in
// [fc, hi).  With splits(r, x, y) the lanes p in [x, y) with
// (p - r) % 255 == 0 for a run that starts at r < x,
// (y - 1 - r) / 255 - (x - 1 - r) / 255, two adjacent spans combine as
//   a none:      b                       (a's lanes are b's leading stretch)
//   b none:      {a.fc, a.lc, a.cnt + splits(a.lc, a.hi, b.hi), b.hi}
//   both:        {a.fc, b.lc, a.cnt + splits(a.lc, a.hi, b.fc) + b.cnt,
//                 b.hi}
// with the empty span (hi = -1) as identity on both sides.  It is
// associative: each case counts the starts of [fc, hi) of the joined
// span, whatever the grouping.  A span from lane 0 has fc = 0, so its
// cnt is every start in it and its lc the run start open at its end.
//
// Per-call state on the card, no host read and no reset launch: the
// descriptors' status words carry the call's epoch and the CTA that
// draws the last ticket zeroes the counter (ops/lookback.py keeps the
// scratch per thread and device and advances the epoch).
//
// What bounds them: bytes.  At (32, 901120) emit_bytes must read the ISA
// below n (115.2 MB) and the blocks (28.8 MB) and write the rows
// (28.8 MB); the buckets add the scratch's 115.2 MB written and read
// again, 403 MB in all.  emit_tokens reads the rows below n once (28.8
// MB, from L2 where emit_place just wrote them) and writes 14.4 MB of
// tokens, 0.0129 ms at 3.35 TB/s; the halo adds kHalo / kTile of the
// rows.  What holds the scan above that is each CTA's chain of waits
// (the staging, the scan, the look-back, the two walks), paid once a
// tile and hidden by the CTAs an SM runs at once.  On the smoke's text
// batch (chip_smoke.py --kernels --profile, NVIDIA H100 80GB HBM3,
// 700 W, device time of tok_scan): tiles of 8192 lanes, 32 a thread,
// 52 us at eight CTAs an SM (32 registers), 58 at six (40 registers);
// tiles of 4096 lanes, 16 a thread, 89.
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
constexpr int kPer = 32;  // consecutive lanes a thread in tok_scan
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLen = 255;  // a token's 8-bit length
constexpr int kHalo = 256;    // lanes staged past the tile
constexpr int kStaged = kTile + kHalo;
constexpr int kCtasPerSm = 8;  // 32 registers a thread, 200 KB of shared
constexpr int kTailSlots = 8192;  // token slots a CTA of tok_tail
constexpr int kNone = 0x7FFFFFFF;
constexpr int kAgg = 1, kIncl = 2;  // a descriptor's kinds
constexpr unsigned kFull = 0xFFFFFFFFu;

// the tile's last start is within kMaxLen of its end, so the next start
// after it is in the halo or at n
static_assert(kHalo >= kMaxLen && kHalo % 16 == 0, "the halo");
// a thread's lanes hold no split of a run that starts in them, and fit
// the bits of a mask and whole 16-byte words of the staging
static_assert(kPer < kMaxLen && kPer <= 32 && kPer % 16 == 0,
              "a thread's lanes");

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


// A span of a row's lanes below n, summed up for the token starts (see
// the combine above); hi = -1 is the empty span
struct Seg {
  int fc, lc, cnt, hi;
};

// a tile's descriptor: the status word (epoch << 2 | kind, 0 while
// unpublished), the aggregate and the inclusive Seg in slots of their own
// (a reader that saw A never meets a half-written P)
struct Desc {
  int status, pad[3];
  Seg agg, incl;
};
constexpr int kDescInts = sizeof(Desc) / sizeof(int);

__device__ __forceinline__ Seg empty_seg() { return {-1, -1, 0, -1}; }

// the lanes p in [x, y) with (p - r) % kMaxLen == 0, r < x
__device__ __forceinline__ int splits(int r, int x, int y) {
  return y > x ? (y - 1 - r) / kMaxLen - (x - 1 - r) / kMaxLen : 0;
}

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.hi < 0) return a;
  if (a.hi < 0 || a.fc < 0) return b;
  if (b.fc < 0) return {a.fc, a.lc, a.cnt + splits(a.lc, a.hi, b.hi), b.hi};
  return {a.fc, b.lc, a.cnt + splits(a.lc, a.hi, b.fc) + b.cnt, b.hi};
}

__device__ __forceinline__ Seg shfl_up(const Seg& x, int d) {
  return {__shfl_up_sync(kFull, x.fc, d), __shfl_up_sync(kFull, x.lc, d),
          __shfl_up_sync(kFull, x.cnt, d), __shfl_up_sync(kFull, x.hi, d)};
}

__device__ __forceinline__ Seg shfl_down(const Seg& x, int d) {
  return {__shfl_down_sync(kFull, x.fc, d),
          __shfl_down_sync(kFull, x.lc, d),
          __shfl_down_sync(kFull, x.cnt, d),
          __shfl_down_sync(kFull, x.hi, d)};
}

__device__ __forceinline__ Seg shfl(const Seg& x, int src) {
  return {__shfl_sync(kFull, x.fc, src), __shfl_sync(kFull, x.lc, src),
          __shfl_sync(kFull, x.cnt, src), __shfl_sync(kFull, x.hi, src)};
}

// inclusive scan of the warp's Segs in lane order
__device__ __forceinline__ Seg warp_scan(Seg x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// exclusive scan of the CTA's Segs in thread order; the CTA's to *total
__device__ Seg cta_exclusive(const Seg& x, Seg* total) {
  __shared__ Seg warps[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Seg incl = warp_scan(x, lane);
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Seg w = lane < kWarps ? warps[lane] : empty_seg();
    w = warp_scan(w, lane);
    if (lane < kWarps) warps[lane] = w;
  }
  __syncthreads();
  const Seg before = warp ? warps[warp - 1] : empty_seg();
  const Seg prev = shfl_up(incl, 1);
  *total = warps[kWarps - 1];
  __syncthreads();  // warps[] is free for the next scan
  return lane ? combine(before, prev) : before;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// a Seg into its slot, then the status word that releases it
__device__ __forceinline__ void publish(Desc* d, int kind, const Seg& s,
                                        int epoch) {
  __stcg(reinterpret_cast<int4*>(kind == kIncl ? &d->incl : &d->agg),
         make_int4(s.fc, s.lc, s.cnt, s.hi));
  st_release(&d->status, epoch << 2 | kind);
}

// warp 0: the Seg of the row's tiles before tile t, right to left, 32
// descriptors at a time: each lane waits for its tile's status, the lanes
// up to the first inclusive Seg are combined in position order (lane i
// holds tile top - i, so a higher lane is further left), and the window
// moves left until it meets one (a lane left of tile 0 holds the empty
// span as inclusive)
__device__ Seg look_back(const Desc* rd, int t, int epoch, int lane) {
  Seg acc = empty_seg();
  for (int top = t - 1;; top -= 32) {
    const int j = top - lane;
    int kind = kIncl;
    Seg v = empty_seg();
    if (j >= 0) {
      int s;
      do {
        s = ld_acquire(&rd[j].status);
      } while ((s >> 2) != epoch);
      kind = s & 3;
      const int4 w = __ldcg(reinterpret_cast<const int4*>(
          kind == kIncl ? &rd[j].incl : &rd[j].agg));
      v = {w.x, w.y, w.z, w.w};
    }
    const unsigned incl = __ballot_sync(kFull, kind == kIncl);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    Seg x = lane <= stop ? v : empty_seg();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg y = shfl_down(x, d);
      if (lane + d < 32) x = combine(y, x);
    }
    acc = combine(shfl(x, 0), acc);
    if (incl) return acc;
  }
}

// the tile's lanes below n and the halo past it into shared memory,
// coalesced, 16 bytes a load (vec 16: rows 16-byte aligned; vec 8: two
// 8-byte loads); the rest of the staging is 0
__device__ __forceinline__ void stage(const uint8_t* __restrict__ row,
                                      int lo, int n, int vec, uint8_t* sb) {
  const int live = min(n - lo, kStaged);
  for (int i = threadIdx.x; i < kStaged / 16; i += kThreads) {
    const int o = 16 * i;
    if (vec && o + 16 <= live) {
      uint4 v;
      if (vec == 16) {
        v = *reinterpret_cast<const uint4*>(row + lo + o);
      } else {
        const uint2 a = *reinterpret_cast<const uint2*>(row + lo + o);
        const uint2 c = *reinterpret_cast<const uint2*>(row + lo + o + 8);
        v = make_uint4(a.x, a.y, c.x, c.y);
      }
      *reinterpret_cast<uint4*>(sb + o) = v;
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        sb[o + q] = o + q < live ? row[lo + o + q] : 0;
    }
  }
}

// occupancy hides each CTA's chain of waits (the staging, the look-back,
// the two walks), as in rle2_scan: eight CTAs an SM
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    tok_scan(const uint8_t* __restrict__ bwt, const int* __restrict__ ns,
             int B, int N, int tiles, int cap, int vec, int epoch,
             uint16_t* __restrict__ tokens, int* __restrict__ run_counts,
             Desc* __restrict__ desc, int* __restrict__ state) {
  __shared__ __align__(16) uint8_t sb[kStaged];
  __shared__ uint16_t sp[kTile];  // a start's lane in the tile, by index
  __shared__ int s_ticket, s_pre, s_halo;
  __shared__ Seg s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* ticket = state;
  if (tid == 0) {
    const int k = atomicAdd(ticket, 1);
    if (k == B * tiles - 1) atomicExch(ticket, 0);  // the last one drawn
    s_ticket = k;
    s_halo = kNone;
  }
  // the tail launch may start once every CTA has drawn its ticket
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();
  const int t = s_ticket / B, b = s_ticket % B;
  const int n = min(max(ns[b], 0), N);
  const int tc = (n ? n - 1 : 0) / kTile;  // the tile of lane n - 1
  if (t > tc) return;  // lanes >= n only: the tail zeroes their slots
  const int lo = t * kTile;
  const uint8_t* row = bwt + (size_t)b * N;
  Desc* rd = desc + (size_t)b * tiles;

  if (lo < n) stage(row, lo, n, vec, sb);
  if (tid == 0) s_pre = lo > 0 ? row[lo - 1] : -1;
  __syncthreads();
  // the first change in the halo: lanes lo + kTile .. + kMaxLen - 1
  {
    const int i = kTile + tid, q = lo + i;
    const bool hit = tid < kMaxLen && q < n && sb[i] != sb[i - 1];
    const unsigned m = __ballot_sync(kFull, hit);
    if (lane == 0 && m) atomicMin(&s_halo, q + __ffs(m) - 1);
  }
  // a thread's kPer lanes: bit q of change where lane first + q < n holds
  // another byte than the lane before it (or is lane 0)
  const int first = lo + tid * kPer;
  unsigned w[kPer / 4];
#pragma unroll
  for (int k = 0; k < kPer / 16; ++k) {
    const uint4 v = reinterpret_cast<const uint4*>(sb)[tid * kPer / 16 + k];
    w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
  }
  unsigned change = 0;
  {
    int prev = tid ? sb[tid * kPer - 1] : s_pre;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int c = (w[q >> 2] >> (8 * (q & 3))) & 255;
      if (first + q < n && (first + q == 0 || c != prev)) change |= 1u << q;
      prev = c;
    }
  }
  // its Seg: a run that starts in its lanes has no split in them
  const int hi = min(first + kPer, n);
  const Seg mine =
      change ? Seg{first + __ffs(change) - 1, first + 31 - __clz(change),
                   __popc(change), hi}
             : Seg{-1, -1, 0, hi};
  Seg tile;
  const Seg excl = cta_exclusive(mine, &tile);  // syncs

  if (warp == 0) {
    Seg before = empty_seg();
    if (t == 0) {
      if (lane == 0) publish(rd, kIncl, tile, epoch);
    } else {
      if (lane == 0) publish(rd + t, kAgg, tile, epoch);
      before = look_back(rd, t, epoch, lane);
      if (lane == 0) publish(rd + t, kIncl, combine(before, tile), epoch);
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  const Seg before = s_before;
  const Seg row_seg = combine(before, tile);
  const int out0 = before.cnt;  // the tile's first token index
  const int count = row_seg.cnt - out0;
  if (t == tc && tid == 0) run_counts[b] = row_seg.cnt;

  // this thread's starts: its changes, and the split of the run open at
  // its left in its leading stretch (one at most: kPer < kMaxLen)
  const Seg open = combine(before, excl);  // the lanes before its first
  unsigned starts = change;
  if (open.hi >= 0 && first < hi) {
    const int lead = change ? __ffs(change) - 1 : hi - first;
    const int d = (first - open.lc) % kMaxLen;
    const int q = d ? kMaxLen - d : 0;
    if (q < lead) starts |= 1u << q;
  }
  int k = open.cnt - out0;
  for (unsigned m = starts; m; m &= m - 1)
    sp[k++] = (uint16_t)(tid * kPer + __ffs(m) - 1);
  __syncthreads();
  // a thread a token: its length from the next start's lane, the tile's
  // last one from the first change in the halo, p + kMaxLen or n
  uint16_t* trow = tokens + (size_t)b * cap;
  const int upto = min(count, cap - out0);
  for (int i = tid; i < upto; i += kThreads) {
    const int p = sp[i];
    const int next = i + 1 < count
                         ? sp[i + 1]
                         : min(min(s_halo, lo + p + kMaxLen), n) - lo;
    trow[out0 + i] = (uint16_t)(sb[p] << 8 | (next - p));
  }
}

__global__ void __launch_bounds__(kThreads)
    tok_tail(const int* __restrict__ counts, int cap,
             uint16_t* __restrict__ tokens) {
  // launched early behind tok_scan: wait until its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.y, slot0 = blockIdx.x * kTailSlots;
  uint16_t* out = tokens + (size_t)b * cap;
  const int lo = max(slot0, __ldcg(counts + b));
  const int hi = min(slot0 + kTailSlots, cap);
  if (lo >= hi) return;
  // 16-byte stores from the first slot on a 16-byte boundary (a row starts
  // on a 4-byte one), 2-byte ones at the two ends
  const int a =
      min(hi, lo + (int)((16 - ((size_t)(out + lo) & 15)) & 15) / 2);
  const int z = max(a, hi - (hi - a) % 8);
  if ((int)threadIdx.x < a - lo) out[lo + threadIdx.x] = 0;
  if ((int)threadIdx.x < hi - z) out[z + threadIdx.x] = 0;
  uint4* v = reinterpret_cast<uint4*>(out + a);
  for (int i = threadIdx.x; i < (z - a) / 8; i += kThreads)
    v[i] = make_uint4(0, 0, 0, 0);
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


// int32 words of the token scan's tile descriptors for (B, N) rows (their
// status words tagged with the call's epoch: any content is safe), and of
// the state it leaves 0 (zeroed once when made): the ticket counter
extern "C" long long lbz2t_emit_tokens_desc_ints(int B, int N) {
  return (long long)kDescInts * B * tiles_of(N > 0 ? N : 1);
}
extern "C" long long lbz2t_emit_tokens_state_ints() { return 1; }

// bwt (B, N) uint8 and ns (B,) int32 in; tokens (B, cap) u16 and
// run_counts (B,) int32 out; desc and state as above, epoch in
// 1 .. 2^29 - 1 and not the previous call's on this desc; all device
// pointers.
extern "C" int lbz2t_emit_tokens(const void* bwt, const void* ns,
                                 void* tokens, void* run_counts, void* desc,
                                 void* state, int B, int N, int cap,
                                 int epoch, void* stream) {
  if (B <= 0 || N <= 0 || cap < 0 || epoch <= 0 || epoch >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(N);
  const unsigned long long at = reinterpret_cast<unsigned long long>(bwt);
  const int vec = N % 16 == 0 && at % 16 == 0 ? 16
                  : N % 8 == 0 && at % 8 == 0 ? 8
                                              : 0;
  uint16_t* tok = static_cast<uint16_t*>(tokens);
  int* counts = static_cast<int*>(run_counts);
  tok_scan<<<B * tiles, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(bwt), static_cast<const int*>(ns), B, N,
      tiles, cap, vec, epoch, tok, counts, static_cast<Desc*>(desc),
      static_cast<int*>(state));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || cap == 0) return (int)e;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t tc = {};
  tc.gridDim = dim3((cap + kTailSlots - 1) / kTailSlots, B);
  tc.blockDim = dim3(kThreads);
  tc.stream = s;
  tc.attrs = pdl;
  tc.numAttrs = 1;
  cudaLaunchKernelEx(&tc, tok_tail, static_cast<const int*>(counts), cap,
                     tok);
  return (int)cudaGetLastError();
}
