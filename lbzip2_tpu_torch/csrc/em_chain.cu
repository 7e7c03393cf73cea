// The EM loop of the entropy chain on the card, for Hopper (sm_90a): the
// E-step from the symbols, the M-step of code_lengths.cuh, and the loop
// control in device memory.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/chain.py::_em_estep_hist
// (:147) and lbzip2_tpu/ops/huffenc.py::_em_chain (:184).  The TPU form
// builds a (B, G, 259) float32 histogram of every 50-symbol group so
// that each E-step is two matrix products; this card has no use for the
// matrix unit here, and the histogram is five times the symbols it is
// made from.  So the E-step reads the symbols themselves:
//
//   em_estep  a persistent grid: each row has the same P CTAs (as many
//             as fit on the card at once over the batch), and CTA c takes
//             the c-th of P equal shares of the row's live groups, read
//             from nm on the card.  The row's 6 x 259 code lengths sit
//             in shared memory as two packed words a symbol, a 10-bit
//             lane a tree (trees 0-2, trees 3-5): the spec's own
//             accumulator, so a group's six costs are two wrapping 32-bit
//             sums over its 50 symbols and the lane overflow past 1023
//             comes out as the spec has it.  The CTA copies tiles of
//             kTileGroups groups' symbols into shared memory with
//             cp.async, double-buffered (16-byte copies, 4-byte ones at
//             a tile's ragged ends), and a pair of lanes takes a
//             group, 25 symbols each: two shared loads and two adds a
//             symbol, one shuffle to join the halves, no warp reduction;
//             the 50-word strides of a warp's 16 groups and the 25-word
//             offset of the halves fall in 32 distinct banks.  Then the
//             lane-2 carry into the high word and the first minimum over
//             the live trees.  The frequencies go through shared-memory
//             atomics, a lane's 25 symbols each (a warp's lanes hold 16
//             groups of other trees: few lanes meet on a word), and are
//             flushed with one global atomic a non-zero count a CTA.
//             Positions at and past nm hold the dummy symbol `as`, so a
//             group past the row's last one costs 50 times the dummy's
//             word whatever the group: one selector, which the row's P
//             CTAs write over an equal share of those groups each.  The
//             selectors of all G groups are compared with the previous
//             iteration's in place and written only where they differ (a
//             store behind a load of the same word, for every group, took
//             30 us of an E-step's 72).
//   em_mstep  a warp a tree (code_lengths_tree), trees t < nt only,
//             lengths written in place; every tree's frequencies are
//             zeroed for the next E-step.
//
// The loop is cluster_factor rounds of the two kernels, enqueued back to
// back by one host call that reads nothing, each launch with programmatic
// dependent launch so that it is scheduled while the one before it
// drains, which hides most of the gap between launches.  A kernel
// boundary is the grid-wide barrier both steps need, and the two steps
// want different grids (the E-step's CTAs of 512 threads against B * 6
// warps), which one persistent cooperative kernel would have to size for
// one and idle for the other; what the rounds cost is an empty launch, a
// few microseconds, for each round after convergence.  The control words:
// ctl[0] done, ctl[1] E-steps executed, ctl[2 + it] "some selector
// changed in E-step it".  em_mstep of round `it` sets `done` when no
// selector of the whole batch changed (it > 0); every later kernel
// returns at once.  The last round has no M-step.  So `lengths` ends as
// the input of the last executed E-step, `sel` and `freqs` as its
// outputs, as the plain loop returns them.
//
// What bounds it: bytes, the nm live symbols a row an iteration (4 bytes
// each); six additions a symbol are two packed adds.  The persistent
// grid builds the tables and flushes the counts once a CTA, not once
// every few thousand symbols, and no CTA of a row past its last group
// is launched only to exit.

// Plain C interface (lbzip2_tpu_torch/_build.py); launches on the
// caller's stream and returns cudaGetLastError().

#include <stdint.h>

#include "code_lengths.cuh"

namespace {

using namespace lbz2t;

constexpr int kTrees = 6;
constexpr int kGroup = 50;
constexpr int kEThreads = 512;
constexpr int kTileGroups = kEThreads / 2;  // a pair of lanes a group
constexpr int kHalf = kGroup / 2;           // symbols a lane
constexpr int kTileWords = kTileGroups * kGroup;
constexpr int kBufWords = kTileWords + 8;  // the 16-byte phase, rounded
constexpr int kEDynBytes = 2 * kBufWords * 4;  // two tile buffers
constexpr int kDone = 0, kIters = 1, kChanged = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;

// First minimum over the live trees of the six 10-bit cost lanes of
// (glo, ghi), lane 2's overflow carried into ghi first.
__device__ __forceinline__ int select_tree(unsigned glo, unsigned ghi,
                                           int nt) {
  ghi += glo >> 30;
  int best = 0x400, bt = 0;
#pragma unroll
  for (int t = 0; t < kTrees; ++t) {
    const int c = (int)(((t < 3 ? glo : ghi) >> (10 * (t % 3))) & 0x3FFu);
    const bool better = t < nt && (t == 0 || c < best);
    if (better) {
      best = c;
      bt = t;
    }
  }
  return bt;
}

__device__ __forceinline__ unsigned pack3(const int* __restrict__ len,
                                          int sym) {
  return (unsigned)len[sym] + ((unsigned)len[kW + sym] << 10) +
         ((unsigned)len[2 * kW + sym] << 20);
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// the 16-byte phase of word w of a row: a tile's word w0 lands at
// buf[phase(row + w0)], so 16-byte global chunks meet 16-byte shared ones
__device__ __forceinline__ int phase(const int* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Start the copy of the row's words [w0, w1) into buf (16-byte aligned),
// word w to buf[w - w0 + phase(row + w0)]; one commit group.
__device__ __forceinline__ void stage_tile(const int* __restrict__ row,
                                           int w0, int w1, int* buf) {
  const int cw = w0 - phase(row + w0);  // the first chunk's first word
  const int chunks = (w1 - cw + 3) >> 2;
  for (int q = threadIdx.x; q < chunks; q += kEThreads) {
    const int lo = cw + 4 * q;
    if (lo >= w0 && lo + 4 <= w1) {
      cp_async16(buf + 4 * q, row + lo);
    } else {
      for (int w = max(lo, w0); w < min(lo + 4, w1); ++w)
        cp_async4(buf + (w - cw), row + w);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kEThreads)
em_estep(const int* __restrict__ mtfv, const int* __restrict__ nm_arr,
         const int* __restrict__ ninuse, const int* __restrict__ nt_arr,
         const int* __restrict__ lengths, int* __restrict__ sel,
         int* __restrict__ freqs, int* __restrict__ ctl, int NP, int G,
         int it) {
  // launched early behind the kernel before it (programmatic dependent
  // launch): wait here until that one's writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (ctl[kDone]) return;
  extern __shared__ __align__(16) int s_tiles[];  // two of kBufWords
  __shared__ unsigned s_lo[kW];
  __shared__ unsigned s_hi[kW];
  __shared__ int s_freq[kTrees * kW];

  const int tid = threadIdx.x;
  const int b = blockIdx.y, c = blockIdx.x, P = gridDim.x;
  if (c == 0 && b == 0 && tid == 0) ctl[kIters] = it + 1;
  const int dummy = min(max(ninuse[b] + 2, 0), kW - 1);
  const int nm = min(max(nm_arr[b], 0), NP);
  const int ngroups = (nm + kGroup - 1) / kGroup;
  const int nt = nt_arr[b];
  const int* len = lengths + (size_t)b * kTrees * kW;
  const int* row = mtfv + (size_t)b * NP;
  int* sel_row = sel + (size_t)b * G;
  // this CTA's share of the row's live groups: [g0, g1)
  const int share = (ngroups + P - 1) / P;
  const int g0 = min(c * share, ngroups), g1 = min(g0 + share, ngroups);
  int changed = 0;

  if (g0 < g1) {  // the whole CTA
    for (int i = tid; i < kW; i += kEThreads) {
      s_lo[i] = pack3(len, i);
      s_hi[i] = pack3(len + 3 * kW, i);
    }
    for (int i = tid; i < kTrees * kW; i += kEThreads) s_freq[i] = 0;
    const int ntiles = (g1 - g0 + kTileGroups - 1) / kTileGroups;
    // lanes 2i and 2i + 1 take group i of a tile, symbols [0, 25) and
    // [25, 50): a warp's 32 words of a step lie in 32 distinct banks
    const int half = tid & 1, gi = tid >> 1;
    stage_tile(row, g0 * kGroup, min(min(g0 + kTileGroups, g1) * kGroup, nm),
               s_tiles);
    for (int t = 0; t < ntiles; ++t) {
      const int tg0 = g0 + t * kTileGroups;
      if (t + 1 < ntiles) {  // the next tile's copy runs beside this one
        const int ng0 = tg0 + kTileGroups;
        stage_tile(row, ng0 * kGroup,
                   min(min(ng0 + kTileGroups, g1) * kGroup, nm),
                   s_tiles + ((t + 1) & 1) * kBufWords);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();  // the tile, the tables and the counts are there
      const int g = tg0 + gi;
      const bool live = g < g1;
      const int* gs = s_tiles + (t & 1) * kBufWords +
                      phase(row + tg0 * kGroup) + gi * kGroup + half * kHalf;
      const int p0 = g * kGroup + half * kHalf;
      const int was = live && half == 0 && it > 0 ? sel_row[g] : -1;
      // the lane's 25 symbols, two to a register: the counts below take
      // them from there (a shared load behind each atomic would wait for
      // it)
      unsigned lo = 0, hi = 0, sym[(kHalf + 1) / 2];
      if (live) {
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int s = p0 + j < nm ? min(max(gs[j], 0), kW - 1) : dummy;
          if (j & 1)
            sym[j >> 1] |= (unsigned)s << 16;
          else
            sym[j >> 1] = (unsigned)s;
          lo += s_lo[s];
          hi += s_hi[s];
        }
      }
      lo += __shfl_xor_sync(kFull, lo, 1);
      hi += __shfl_xor_sync(kFull, hi, 1);
      if (live) {
        const int bt = select_tree(lo, hi, nt);
        if (half == 0 && (it == 0 || was != bt)) {
          changed |= it > 0;
          sel_row[g] = bt;
        }
        int* f = s_freq + bt * kW;
#pragma unroll
        for (int j = 0; j < kHalf; ++j)
          atomicAdd(&f[(sym[j >> 1] >> (16 * (j & 1))) & 0xFFFFu], 1);
      }
      __syncthreads();  // this tile's buffer is free again
    }
  }
  // the groups past the row's last are all dummy symbols and share one
  // selector; the row's P CTAs take an equal run of them each
  const int tail = select_tree((unsigned)kGroup * pack3(len, dummy),
                               (unsigned)kGroup * pack3(len + 3 * kW, dummy),
                               nt);
  const int tshare = (G - ngroups + P - 1) / P;
  const int t0 = ngroups + c * tshare;
  const int t1 = min(t0 + tshare, G);
  for (int g = t0 + tid; g < t1; g += kEThreads) {
    if (it == 0) {
      sel_row[g] = tail;
    } else if (sel_row[g] != tail) {
      changed = 1;
      sel_row[g] = tail;
    }
  }
  if (__syncthreads_or(changed) && tid == 0) atomicOr(&ctl[kChanged + it], 1);
  if (g0 < g1) {
    int* f_row = freqs + (size_t)b * kTrees * kW;
    for (int i = tid; i < kTrees * kW; i += kEThreads)
      if (s_freq[i]) atomicAdd(&f_row[i], s_freq[i]);
  }
}

__global__ void __launch_bounds__(32 * kTreesPerCta)
em_mstep(int* __restrict__ freqs, const int* __restrict__ ninuse,
         const int* __restrict__ nt_arr, int* __restrict__ lengths,
         int* __restrict__ ctl, int R, int it) {
  __shared__ TreeScratch scratch[kTreesPerCta];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = min((int)blockIdx.x * kTreesPerCta + warp, R - 1);
  const int b = r / kTrees, t = r % kTrees;
  int* f_row = freqs + (size_t)r * kW;
  // every load the warp needs, started together: one wait for device
  // memory, not one for each decision below
  const int done = ctl[kDone], moved = ctl[kChanged + it];
  const int nt = nt_arr[b], as = ninuse[b] + 2;
  int f[kLoads];
  load_counts(f_row, lane, f);
  if (done) return;
  if (it > 0 && moved == 0) {
    // converged: every CTA reads the same words and leaves; one says so
    if (blockIdx.x == 0 && threadIdx.x == 0) ctl[kDone] = 1;
    return;
  }
  if ((int)blockIdx.x * kTreesPerCta + warp >= R) return;  // a whole warp
  if (t < nt) code_lengths_tree(f, as, lengths + (size_t)r * kW,
                                scratch[warp], lane);
  for (int i = lane; i < kW; i += 32) f_row[i] = 0;
}

}  // namespace

// The E-step's CTAs a row, P, for B rows of G groups on the current
// device: as many as fit on the card at once over the batch (one wave),
// no more than a full row has tiles, at least 1.
extern "C" int lbz2t_em_ctas(int B, int G) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncSetAttribute(em_estep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kEDynBytes);
  cudaFuncSetAttribute(em_estep,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, em_estep, kEThreads,
                                                kEDynBytes);
  const int full = (G + kTileGroups - 1) / kTileGroups;
  int P = B > 0 ? per_sm * sms / B : 1;
  P = P < full ? P : full;
  return P > 1 ? P : 1;
}

// mtfv (B, NP) int32 symbols, nm / ninuse / nt (B,) int32; lengths
// (B, 6, 259) int32, the initial trees in, the last E-step's trees out;
// sel (B, G) int32 out, G = ceil(NP / 50); freqs (B, 6, 259) int32,
// zero in, the last E-step's counts out; ctl (2 + cluster_factor) int32,
// zero in, ctl[1] the E-steps executed out.  All device pointers.
// cluster_factor 1 is one E-step alone: a single em_estep launch on the
// given lengths, no M-step, nothing read of the control words but done
// = 0 (ops/chain.py::em_estep_batch).
extern "C" int lbz2t_em_chain(const void* mtfv, const void* nm,
                              const void* ninuse, const void* nt,
                              void* lengths, void* sel, void* freqs,
                              void* ctl, int B, int NP, int G,
                              int cluster_factor, void* stream) {
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 egrid(lbz2t_em_ctas(B, G), B);  // sets em_estep's shared size
  const int R = B * kTrees;
  const int mgrid = (R + kTreesPerCta - 1) / kTreesPerCta;
  // every launch may start while the one before it drains (programmatic
  // dependent launch); each kernel waits for it before its first read
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t ec = {};
  ec.gridDim = egrid;
  ec.blockDim = dim3(kEThreads);
  ec.dynamicSmemBytes = kEDynBytes;
  ec.stream = s;
  ec.attrs = pdl;
  ec.numAttrs = 1;
  cudaLaunchConfig_t mc = ec;
  mc.gridDim = dim3(mgrid);
  mc.blockDim = dim3(32 * kTreesPerCta);
  mc.dynamicSmemBytes = 0;
  for (int it = 0; it < cluster_factor; ++it) {
    cudaLaunchKernelEx(&ec, em_estep, static_cast<const int*>(mtfv),
                       static_cast<const int*>(nm),
                       static_cast<const int*>(ninuse),
                       static_cast<const int*>(nt),
                       static_cast<const int*>(lengths),
                       static_cast<int*>(sel), static_cast<int*>(freqs),
                       static_cast<int*>(ctl), NP, G, it);
    if (it + 1 < cluster_factor)
      cudaLaunchKernelEx(&mc, em_mstep, static_cast<int*>(freqs),
                         static_cast<const int*>(ninuse),
                         static_cast<const int*>(nt),
                         static_cast<int*>(lengths), static_cast<int*>(ctl),
                         R, it);
  }
  return (int)cudaGetLastError();
}
