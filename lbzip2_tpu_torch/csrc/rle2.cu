// RLE2 of the entropy chain with its flat histogram, for Hopper (sm_90a):
// MTF ranks -> the zero-run-coded MTF values compacted to the front of
// each row, their count nm and the flat symbol histogram of the padded
// groups.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/rle2.py::_rle2_batch (:25) and
// the flat histogram of lbzip2_tpu/ops/chain.py::_chain_mtf2 (:335-347,
// `_group_hist(...)` summed over the groups).  The TPU form gives every
// lane its run's extent by two cumulative maxima over the row and
// compacts the kept lanes by one sort (a TPU's scatters are slow), and
// counts the histogram per 50-symbol group before it sums the groups.
// Here a row is cut into tiles of kTile lanes, a CTA a tile:
//
//   rle2_tiles  each CTA stages its tile's ranks in shared memory (lanes
//               at and past n are never read), a thread walks kPer
//               consecutive lanes and sums them up as a Run: nonzeros,
//               the zero run before the first of them (lead), the one
//               after the last (trail) and the RUNA/RUNB digits of the
//               runs between them (inner).  Two Runs combine
//               associatively (combine below: a run that crosses the
//               border is closed only when the right side holds a
//               nonzero), so an ordered CTA scan gives the tile's Run.
//               The CTA of tile 0 zeroes the row's histogram.
//   rle2_emit   each CTA scans the row's tile Runs in warp 0 (at most
//               221 at 901120 lanes), so it knows the values the tiles
//               before it emit, the zero run open at its left edge and
//               the row's nm.  A thread emits, in position order, the
//               digits of every run a nonzero of its lanes closes, then
//               that nonzero's r + 1: the tile in which a run ends writes
//               its digits, and a run that touches n is closed by the
//               thread of lane n - 1, which writes the EOB after it.
//               The values go to shared memory (a tile emits at most
//               kTile + 32), then out in one coalesced copy; the
//               histogram is counted from them by __match_any_sync (a
//               text row is mostly values 0, 1 and 2) into shared
//               counts, flushed with one global atomic a non-zero count;
//               the lanes at and past nm of the tile's own range are
//               zeroed, and the CTA of lane n - 1 writes nm and the pad
//               count G * 50 - nm at lane min(ninuse + 2, 258).
//
// What bounds it: bytes.  On the smoke's (32, 901120) text batch (n =
// 900,000 a row) the function reads 115.2 MB of ranks below n and writes
// 115.3 MB of values, 0.069 ms at 3.35 TB/s (chip_smoke.py, phase 20);
// the two
// launches read the ranks twice (the second read is the price of not
// carrying a run across CTAs by a look-back), the operations are a few
// dozen a lane.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                    // lanes a thread walks
constexpr int kTile = kThreads * kPer;      // lanes a CTA
constexpr int kStaged = kTile + kTile / 32; // a word of padding every 32
constexpr int kSlack = 64;                  // a tile emits <= kTile + 32
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 259;                 // symbols 0..257 and `as`
constexpr int kGroup = 50;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The lanes of a span of a row: nonzeros, the zero runs before the first
// and after the last nonzero (both the span's length when it has no
// nonzero), and the digits of the runs between two of its nonzeros.
struct Run {
  int nz, lead, trail, inner;
};

__device__ __forceinline__ Run identity() { return {0, 0, 0, 0}; }

// RUNA/RUNB digits of a zero run of k: floor(log2(k + 1))
__device__ __forceinline__ int digits(int k) { return 31 - __clz(k + 1); }

__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  Run r;
  r.nz = a.nz + b.nz;
  r.lead = a.nz ? a.lead : a.lead + b.lead;
  r.trail = b.nz ? b.trail : a.trail + b.trail;
  r.inner = a.inner + b.inner +
            (a.nz && b.nz ? digits(a.trail + b.lead) : 0);
  return r;
}

// values the lanes of a row's prefix emit: its nonzeros and the digits of
// every run a nonzero of it closes (the trailing run is still open)
__device__ __forceinline__ int emitted(const Run& p) {
  return p.nz + p.inner + (p.nz ? digits(p.lead) : 0);
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d) {
  return {__shfl_up_sync(kFull, x.nz, d), __shfl_up_sync(kFull, x.lead, d),
          __shfl_up_sync(kFull, x.trail, d),
          __shfl_up_sync(kFull, x.inner, d)};
}

__device__ __forceinline__ Run shfl(const Run& x, int src) {
  return {__shfl_sync(kFull, x.nz, src), __shfl_sync(kFull, x.lead, src),
          __shfl_sync(kFull, x.trail, src),
          __shfl_sync(kFull, x.inner, src)};
}

// inclusive scan of the warp's Runs in lane order
__device__ __forceinline__ Run warp_scan(Run x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Run y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// exclusive scan of the CTA's Runs in thread order; the CTA's to *total
__device__ Run cta_exclusive(const Run& x, Run* total) {
  __shared__ Run warps[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Run incl = warp_scan(x, lane);
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Run w = lane < kWarps ? warps[lane] : identity();
    w = warp_scan(w, lane);
    if (lane < kWarps) warps[lane] = w;
  }
  __syncthreads();
  const Run before = warp ? warps[warp - 1] : identity();
  const Run prev = shfl_up(incl, 1);
  *total = warps[kWarps - 1];
  __syncthreads();  // warps[] is free for the next scan
  return lane ? combine(before, prev) : before;
}

__device__ __forceinline__ int staged(int i) { return i + (i >> 5); }

// the tile's ranks at lanes < n into shared memory, coalesced; a thread
// later reads its kPer lanes from it without bank conflicts
__device__ __forceinline__ void stage(const int* __restrict__ row, int lane0,
                                      int n, int* sr) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int p = lane0 + i;
    sr[staged(i)] = p < n ? __ldg(row + p) : 0;
  }
}

// the Run of this thread's lanes first .. first + kPer - 1 (those < n)
__device__ __forceinline__ Run chunk_run(const int* sr, int first, int n) {
  Run s = identity();
  int run = 0;
  const int base = threadIdx.x * kPer;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (first + q < n) {
      if (sr[staged(base + q)] > 0) {
        if (s.nz)
          s.inner += digits(run);
        else
          s.lead = run;
        ++s.nz;
        run = 0;
      } else {
        ++run;
      }
    }
  }
  s.trail = run;
  if (!s.nz) s.lead = run;
  return s;
}

// the digits of a zero run of k: bit j of k + 1 for j < floor(log2(k+1))
__device__ __forceinline__ int put_run(int* buf, int o, int k) {
  const unsigned v = (unsigned)k + 1u;
  const int m = 31 - __clz(v);
  for (int j = 0; j < m; ++j) buf[o + j] = (v >> j) & 1u;
  return o + m;
}

__global__ void __launch_bounds__(kThreads)
    rle2_tiles(const int* __restrict__ ranks, const int* __restrict__ ns,
               int N, int tiles, Run* __restrict__ tsum,
               int* __restrict__ hist) {
  __shared__ int sr[kStaged];
  const int b = blockIdx.y, t = blockIdx.x;
  const int n = min(max(ns[b], 0), N);
  if (t == 0)
    for (int v = threadIdx.x; v < kWidth; v += kThreads)
      hist[b * kWidth + v] = 0;
  const int lane0 = t * kTile;
  Run total = identity();
  if (lane0 < n) {  // the whole CTA
    stage(ranks + (size_t)b * N, lane0, n, sr);
    __syncthreads();
    cta_exclusive(chunk_run(sr, lane0 + threadIdx.x * kPer, n), &total);
  }
  if (threadIdx.x == 0) tsum[(size_t)b * tiles + t] = total;
}

__global__ void __launch_bounds__(kThreads)
    rle2_emit(const int* __restrict__ ranks, const int* __restrict__ ns,
              const int* __restrict__ ninuse, int N, int tiles,
              const Run* __restrict__ tsum, int* __restrict__ mtfv,
              int* __restrict__ nm_out, int* __restrict__ hist) {
  __shared__ int sr[kStaged];
  __shared__ int buf[kTile + kSlack];
  __shared__ int counts[kWidth];
  __shared__ Run s_before, s_row;
  const int b = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = min(max(ns[b], 0), N);
  const int lane0 = t * kTile;
  const bool live = lane0 < n;
  const int last = n ? n - 1 : 0;  // its thread closes the row (EOB)
  const bool closes = lane0 <= last && last < lane0 + kTile;
  for (int v = tid; v < kWidth; v += kThreads) counts[v] = 0;
  if (live) stage(ranks + (size_t)b * N, lane0, n, sr);
  if (warp == 0) {  // the tiles before this one, and the whole row
    Run carry = identity();
    for (int base = 0; base < tiles; base += 32) {
      const int j = base + lane;
      Run x = j < tiles ? tsum[(size_t)b * tiles + j] : identity();
      x = combine(carry, warp_scan(x, lane));
      if (j == t - 1) s_before = x;
      carry = shfl(x, 31);
    }
    if (lane == 0) {
      s_row = carry;
      if (t == 0) s_before = identity();
    }
  }
  __syncthreads();
  const Run before = s_before, row = s_row;
  const int nm = emitted(row) + digits(row.trail) + 1;
  const int out0 = emitted(before);  // the tile's first output lane
  int count = 0;
  if (live || closes) {  // the whole CTA
    Run tile;
    const int first = lane0 + tid * kPer;
    const Run mine =
        combine(before, cta_exclusive(chunk_run(sr, first, n), &tile));
    count = emitted(combine(before, tile)) - out0;
    if (closes) count += digits(row.trail) + 1;
    int o = emitted(mine) - out0;
    int run = mine.trail;  // the zero run open at this thread's left
    const int base = tid * kPer;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (first + q < n) {
        const int r = sr[staged(base + q)];
        if (r > 0) {
          o = put_run(buf, o, run);
          buf[o++] = (int)((unsigned)r + 1u);
          run = 0;
        } else {
          ++run;
        }
      }
    }
    if (closes && first <= last && last < first + kPer) {
      o = put_run(buf, o, run);
      buf[o] = ninuse[b] + 1;  // EOB
    }
  }
  __syncthreads();
  int* out = mtfv + (size_t)b * (N + 1);
  for (int i = tid; i < count; i += kThreads) out[out0 + i] = buf[i];
  for (int base = 0; base < count; base += kThreads) {  // CTA-uniform
    const int i = base + tid;
    const int v = i < count ? (int)min((unsigned)buf[i], kWidth - 1u) : -1;
    const unsigned same = __match_any_sync(kFull, v);
    if (v >= 0 && lane == __ffs(same) - 1) atomicAdd(&counts[v], __popc(same));
  }
  const int end = min(lane0 + kTile, N + 1);
  for (int p = max(lane0, nm) + tid; p < end; p += kThreads) out[p] = 0;
  __syncthreads();
  for (int v = tid; v < kWidth; v += kThreads)
    if (counts[v]) atomicAdd(&hist[b * kWidth + v], counts[v]);
  if (closes && tid == 0) {
    nm_out[b] = nm;
    const int G = (N + 1 + kGroup - 1) / kGroup;
    atomicAdd(&hist[b * kWidth + min(ninuse[b] + 2, kWidth - 1)],
              G * kGroup - nm);
  }
}

int tiles_of(int N) { return (N + 1 + kTile - 1) / kTile; }

}  // namespace

// int32 words of the scratch for (B, N) ranks: a Run a tile
extern "C" long long lbz2t_rle2_scratch_ints(int B, int N) {
  return 4ll * B * tiles_of(N);
}

// ranks (B, N), ns and ninuse (B,) int32 in; mtfv (B, N + 1), nm (B,) and
// hist (B, 259) int32 out; scratch of lbz2t_rle2_scratch_ints int32; all
// device pointers.
extern "C" int lbz2t_rle2(const void* ranks, const void* ns,
                          const void* ninuse, void* mtfv, void* nm,
                          void* hist, void* scratch, int B, int N,
                          void* stream) {
  if (B <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(N);
  const dim3 grid(tiles, B);
  Run* tsum = static_cast<Run*>(scratch);
  rle2_tiles<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(ranks), static_cast<const int*>(ns), N, tiles,
      tsum, static_cast<int*>(hist));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rle2_emit<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(ranks), static_cast<const int*>(ns),
      static_cast<const int*>(ninuse), N, tiles, tsum,
      static_cast<int*>(mtfv), static_cast<int*>(nm),
      static_cast<int*>(hist));
  return (int)cudaGetLastError();
}
