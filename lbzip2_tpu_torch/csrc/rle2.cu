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
// Here a row is cut into tiles of kTile lanes and the ranks are read
// once, in one pass: a single-pass chained scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002).
//
//   rle2_scan   a CTA draws a ticket (an atomic counter, not blockIdx:
//               every tile it waits on has then started, so it always
//               makes progress); tickets go tile-major across the rows
//               (tile = ticket / B, row = ticket % B), so the rows'
//               chains advance side by side.  It stages its tile's ranks
//               below n in shared memory with 16-byte loads (lanes at
//               and past n are never read), a thread takes kPer
//               consecutive lanes into registers and sums them up as a
//               Run: nonzeros, the zero run before the first of them
//               (lead), the one after the last (trail) and the RUNA/RUNB
//               digits of the runs between them (inner).  Two Runs
//               combine associatively but not commutatively (combine
//               below: a run that crosses the border is closed only when
//               the right side holds a nonzero), so an ordered CTA scan
//               gives the tile's Run.  The CTA publishes it as the tile's
//               aggregate (status A), then warp 0 looks back over the
//               row's earlier tiles, 32 descriptors at a time, right to
//               left, until the first inclusive Run (status P): the
//               prefix is combine(earlier, acc).  It publishes its own
//               inclusive Run (P) and emits from its registers, in
//               position order, the digits of every run a nonzero of its
//               lanes closes, then that nonzero's r + 1: the tile in
//               which a run ends writes its digits, and a run that
//               touches n is closed by the thread of lane n - 1, which
//               writes the EOB after it.  The values go to shared memory
//               (the staging buffer again: a tile emits at most
//               kTile + 32), then out in one coalesced copy; the
//               histogram is counted as they are written (a text row is
//               mostly the digits 0 and 1 and the value 2: those in
//               registers summed over the warp, any other value by a
//               shared atomic), flushed with one atomic a non-zero count
//               into a row histogram in the scratch, then one
//               acquire-release atomic on the row's counter.  The CTA of
//               lane n - 1 knows the row's Run: it writes nm and adds the
//               pad count G * 50 - nm at lane min(ninuse + 2, 258) (with
//               `pads` 0 it adds none: the histogram of mtfv[:nm] alone,
//               lbzip2_tpu/ops/chain.py::chain_mtf's).  The
//               row's last CTA to finish (a counter a row) moves the
//               row's histogram to the output and leaves the scratch's
//               zero.  Tiles past lane n - 1's write nothing.
//   rle2_tail   zeroes the lanes at and past nm, a CTA kTailLanes of a
//               row, launched behind rle2_scan by programmatic dependent
//               launch.  A tile of the scan does not know nm until the
//               row's last tile has looked back, and a tile that zeroed
//               its own lanes past its output would race with the later
//               tiles that write there (a value's output lane is at most
//               its rank's lane), so this write-only second launch does
//               it (70 MB on the smoke's text batch).
//
// Per-call state on the card, no host read and no reset launch: the
// descriptors' status words carry the call's epoch (a call never reads an
// earlier call's descriptor as its own), the ticket counter is zeroed by
// the CTA that draws the last ticket, and each row's histogram and
// counter by the row's last CTA.  The wrapper keeps the scratch per
// thread and device and advances the epoch (ops/lookback.py).
//
// What bounds it: bytes.  On the smoke's (32, 901120) text batch (n =
// 900,000 a row) the function reads 115.2 MB of ranks below n and writes
// 115.3 MB of values, 0.069 ms at 3.35 TB/s (chip_smoke.py, phase 20);
// the operations are a few dozen a lane.  The design reads each rank
// once; the look-back adds a few descriptor reads a tile from L2.  What
// holds it above the bound is each CTA's chain of waits (the staging,
// the look-back, the emit): six CTAs an SM hide part of it.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                    // lanes a thread walks
constexpr int kTile = kThreads * kPer;      // lanes a CTA
constexpr int kStaged = kTile + kTile / 4;  // 4 words of padding every 16
constexpr int kCtasPerSm = 6;               // 40 registers a thread
constexpr int kSlack = 64;                  // a tile emits <= kTile + 32
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 259;                 // symbols 0..257 and `as`
constexpr int kGroup = 50;
constexpr int kTailLanes = 8192;            // lanes a CTA of rle2_tail
constexpr int kRowState = kWidth + 1;       // a row's histogram, counter
constexpr int kAgg = 1, kIncl = 2;          // a descriptor's kinds
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kStaged >= kTile + kSlack, "the emit reuses the staging");

// The lanes of a span of a row: nonzeros, the zero runs before the first
// and after the last nonzero (both the span's length when it has no
// nonzero), and the digits of the runs between two of its nonzeros.
struct Run {
  int nz, lead, trail, inner;
};

// A tile's descriptor: the status word (epoch << 2 | kind, kind 0 while
// unpublished), the aggregate and the inclusive Run in slots of their own
// (a reader that saw A never meets a half-written P)
struct Desc {
  int status, pad[3];
  Run agg, incl;
};
constexpr int kDescInts = sizeof(Desc) / sizeof(int);

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

__device__ __forceinline__ Run shfl_down(const Run& x, int d) {
  return {__shfl_down_sync(kFull, x.nz, d),
          __shfl_down_sync(kFull, x.lead, d),
          __shfl_down_sync(kFull, x.trail, d),
          __shfl_down_sync(kFull, x.inner, d)};
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

// a lane's word in the staging buffer: 4 words of padding every 16, so a
// thread's 16 lanes are four 16-byte words, each read by a quarter-warp
// from distinct banks
__device__ __forceinline__ int staged(int i) { return i + ((i >> 4) << 2); }

// the tile's ranks at lanes < n into shared memory, coalesced, 16 bytes a
// load where the row allows it (vec: rows 16-byte aligned); lanes at and
// past n are never read and stage as 0
__device__ __forceinline__ void stage(const int* __restrict__ row, int lane0,
                                      int n, bool vec, int* sm) {
  const int live = min(n - lane0, kTile);
  if (vec) {
    const int4* src = reinterpret_cast<const int4*>(row + lane0);
    int4 v[kPer / 4];
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {  // every load issued first
      const int i = 4 * (k * kThreads + threadIdx.x);
      if (i + 4 <= live) {
        v[k] = __ldcs(src + (i >> 2));
      } else {
        v[k].x = i < live ? __ldcs(row + lane0 + i) : 0;
        v[k].y = i + 1 < live ? __ldcs(row + lane0 + i + 1) : 0;
        v[k].z = i + 2 < live ? __ldcs(row + lane0 + i + 2) : 0;
        v[k].w = 0;  // i + 3 >= live
      }
    }
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k)
      *reinterpret_cast<int4*>(sm + staged(4 * (k * kThreads + threadIdx.x))) =
          v[k];
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kThreads + threadIdx.x;
      sm[staged(i)] = i < live ? __ldcs(row + lane0 + i) : 0;
    }
  }
}

// the Run of this thread's lanes first .. first + kPer - 1 (those < n)
__device__ __forceinline__ Run chunk_run(const int (&r)[kPer], int first,
                                         int n) {
  Run s = identity();
  int run = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (first + q < n) {
      if (r[q] > 0) {
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

// the digits of a zero run of k: bit j of k + 1 for j < floor(log2(k+1));
// the zeros and ones among them counted
__device__ __forceinline__ int put_run(int* buf, int o, int k, int* zeros,
                                       int* ones) {
  const unsigned v = (unsigned)k + 1u;
  const int m = 31 - __clz(v);
  for (int j = 0; j < m; ++j) buf[o + j] = (v >> j) & 1u;
  const int one = __popc(v & ((1u << m) - 1u));
  *ones += one;
  *zeros += m - one;
  return o + m;
}

// a value's histogram lane: the value clamped to 258 (as unsigned)
__device__ __forceinline__ int hist_lane(int v) {
  return (int)min((unsigned)v, kWidth - 1u);
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
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

// a Run into its slot, then the status word that releases it
__device__ __forceinline__ void publish(Desc* d, int kind, const Run& r,
                                        int epoch) {
  __stcg(reinterpret_cast<int4*>(kind == kIncl ? &d->incl : &d->agg),
         make_int4(r.nz, r.lead, r.trail, r.inner));
  st_release(&d->status, epoch << 2 | kind);
}

// warp 0: the Run of the row's tiles before tile t, right to left, 32
// descriptors at a time: each lane waits for its tile's status, the lanes
// up to the first inclusive Run are combined in position order (lane i
// holds tile top - i, so a higher lane is further left), and the window
// moves left until it meets one (a lane left of tile 0 holds the identity
// as inclusive)
__device__ Run look_back(const Desc* rd, int t, int epoch, int lane) {
  Run acc = identity();
  for (int top = t - 1;; top -= 32) {
    const int j = top - lane;
    int kind = kIncl;
    Run v = identity();
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
    Run x = lane <= stop ? v : identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run y = shfl_down(x, d);
      if (lane + d < 32) x = combine(y, x);
    }
    acc = combine(shfl(x, 0), acc);
    if (incl) return acc;
  }
}

// occupancy hides the CTA's chain of waits (the staging, the look-back,
// the emit): capped at 40 registers, six CTAs an SM; 62 uncapped left
// four, 0.201 against 0.174 ms on the smoke's text batch
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    rle2_scan(const int* __restrict__ ranks, const int* __restrict__ ns,
              const int* __restrict__ ninuse, int B, int N, int tiles,
              int vec, int pads, int epoch, int* __restrict__ mtfv,
              int* __restrict__ nm_out, int* __restrict__ hist,
              Desc* __restrict__ desc, int* __restrict__ state) {
  __shared__ __align__(16) int sm[kStaged];  // ranks, then the values
  __shared__ int counts[kWidth];
  __shared__ int s_ticket, s_last;
  __shared__ Run s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* ticket = state;  // then a row's histogram and counter a row
  if (tid == 0) {
    const int k = atomicAdd(ticket, 1);
    if (k == B * tiles - 1) atomicExch(ticket, 0);  // the last one drawn
    s_ticket = k;
  }
  // the tail launch may start once every CTA has drawn its ticket
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int v = tid; v < kWidth; v += kThreads) counts[v] = 0;
  __syncthreads();
  const int t = s_ticket / B, b = s_ticket % B;
  const int n = min(max(ns[b], 0), N);
  const int last = n ? n - 1 : 0;  // its thread closes the row (EOB)
  const int tc = last / kTile;     // the tile that holds it
  if (t > tc) return;              // lanes >= n only: the tail zeroes them
  const int lane0 = t * kTile;
  const bool closes = t == tc;
  Desc* rd = desc + (size_t)b * tiles;
  int* rstate = state + 1 + (size_t)b * kRowState;

  if (lane0 < n) stage(ranks + (size_t)b * N, lane0, n, vec, sm);
  __syncthreads();
  int r[kPer];
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) {
    const int4 w =
        *reinterpret_cast<const int4*>(sm + staged(tid * kPer + 4 * k));
    r[4 * k] = w.x;
    r[4 * k + 1] = w.y;
    r[4 * k + 2] = w.z;
    r[4 * k + 3] = w.w;
  }
  const int first = lane0 + tid * kPer;
  Run tile;
  const Run excl = cta_exclusive(chunk_run(r, first, n), &tile);  // syncs

  if (warp == 0) {
    Run before = identity();
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
  const Run before = s_before;
  const Run row = combine(before, tile);  // the whole row in the closer
  const int nm = emitted(row) + digits(row.trail) + 1;
  const int out0 = emitted(before);  // the tile's first output lane
  int count = emitted(row) - out0;
  if (closes) count += digits(row.trail) + 1;
  {
    // the values in position order, counted as they go: the digits (0
    // and 1) and the value 2 (rank 1, most of a text row) in registers,
    // any other value in the shared counts
    const Run mine = combine(before, excl);
    int o = emitted(mine) - out0;
    int run = mine.trail;  // the zero run open at this thread's left
    int zeros = 0, ones = 0, twos = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (first + q < n) {
        if (r[q] > 0) {
          o = put_run(sm, o, run, &zeros, &ones);
          const int v = (int)((unsigned)r[q] + 1u);
          sm[o++] = v;
          if (v == 2)
            ++twos;
          else
            atomicAdd(&counts[hist_lane(v)], 1);
          run = 0;
        } else {
          ++run;
        }
      }
    }
    if (closes && first <= last && last < first + kPer) {
      o = put_run(sm, o, run, &zeros, &ones);
      sm[o] = ninuse[b] + 1;  // EOB
      atomicAdd(&counts[hist_lane(ninuse[b] + 1)], 1);
    }
    zeros = __reduce_add_sync(kFull, zeros);
    ones = __reduce_add_sync(kFull, ones);
    twos = __reduce_add_sync(kFull, twos);
    if (lane == 0) {
      if (zeros) atomicAdd(&counts[0], zeros);
      if (ones) atomicAdd(&counts[1], ones);
      if (twos) atomicAdd(&counts[2], twos);
    }
  }
  __syncthreads();
  for (int v = tid; v < kWidth; v += kThreads)
    if (counts[v]) atomicAdd(&rstate[v], counts[v]);
  if (closes && tid == 0) {
    nm_out[b] = nm;
    const int G = (N + 1 + kGroup - 1) / kGroup;
    if (pads)
      atomicAdd(&rstate[min(ninuse[b] + 2, kWidth - 1)], G * kGroup - nm);
  }
  // the row's last CTA to get here moves its histogram to the output:
  // the CTA's atomics, then one release of the row's counter (and its
  // acquire, for the last CTA); the values' copy goes out after it, so
  // the release does not wait for those stores
  __syncthreads();
  if (tid == 0) s_last = atom_add_acq_rel(&rstate[kWidth], 1) == tc;
  int* out = mtfv + (size_t)b * (N + 1);
  for (int i = tid; i < count; i += kThreads) out[out0 + i] = sm[i];
  __syncthreads();
  if (s_last) {
    for (int v = tid; v < kWidth; v += kThreads)
      hist[(size_t)b * kWidth + v] = atomicExch(&rstate[v], 0);
    if (tid == 0) rstate[kWidth] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    rle2_tail(const int* __restrict__ nm, int N, int* __restrict__ mtfv) {
  // launched early behind rle2_scan: wait until its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.y, lane0 = blockIdx.x * kTailLanes;
  int* out = mtfv + (size_t)b * (N + 1);
  const int lo = max(lane0, __ldcg(nm + b));
  const int hi = min(lane0 + kTailLanes, N + 1);
  if (lo >= hi) return;
  // 16-byte stores from the first lane on a 16-byte boundary (a row
  // starts on a 4-byte one), 4-byte ones at the two ends
  const int a = min(hi, lo + (int)((16 - ((size_t)(out + lo) & 15)) & 15) / 4);
  const int z = max(a, hi - (hi - a) % 4);
  if ((int)threadIdx.x < a - lo) out[lo + threadIdx.x] = 0;
  if ((int)threadIdx.x < hi - z) out[z + threadIdx.x] = 0;
  int4* v = reinterpret_cast<int4*>(out + a);
  for (int i = threadIdx.x; i < (z - a) / 4; i += kThreads)
    v[i] = make_int4(0, 0, 0, 0);
}

int tiles_of(int N) { return (N + kTile - 1) / kTile; }

}  // namespace

// int32 words of the tile descriptors for (B, N) ranks (their status words
// tagged with the call's epoch: any content is safe), and of the state the
// kernels leave 0 (zeroed once when made): a ticket counter, then a row's
// histogram and counter a row
extern "C" long long lbz2t_rle2_desc_ints(int B, int N) {
  return (long long)kDescInts * B * tiles_of(N > 0 ? N : 1);
}
extern "C" long long lbz2t_rle2_state_ints(int B) {
  return 1 + (long long)kRowState * B;
}

// ranks (B, N), ns and ninuse (B,) int32 in; mtfv (B, N + 1), nm (B,) and
// hist (B, 259) int32 out (with pads non-zero the padded groups' count
// too); desc and state as above, epoch in 1 .. 2^29 - 1 and not the
// previous call's on this desc; all device pointers.
extern "C" int lbz2t_rle2(const void* ranks, const void* ns,
                          const void* ninuse, void* mtfv, void* nm,
                          void* hist, void* desc, void* state, int B, int N,
                          int pads, int epoch, void* stream) {
  if (B <= 0 || N < 0 || epoch <= 0 || epoch >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(N > 0 ? N : 1);
  const int vec = N % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(ranks) % 16 == 0;
  rle2_scan<<<B * tiles, kThreads, 0, s>>>(
      static_cast<const int*>(ranks), static_cast<const int*>(ns),
      static_cast<const int*>(ninuse), B, N, tiles, vec, pads, epoch,
      static_cast<int*>(mtfv), static_cast<int*>(nm),
      static_cast<int*>(hist), static_cast<Desc*>(desc),
      static_cast<int*>(state));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t tc = {};
  tc.gridDim = dim3((N + 1 + kTailLanes - 1) / kTailLanes, B);
  tc.blockDim = dim3(kThreads);
  tc.stream = s;
  tc.attrs = pdl;
  tc.numAttrs = 1;
  cudaLaunchKernelEx(&tc, rle2_tail, static_cast<const int*>(nm), N,
                     static_cast<int*>(mtfv));
  return (int)cudaGetLastError();
}
