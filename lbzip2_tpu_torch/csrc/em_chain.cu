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
//   em_estep  a CTA takes kGroupsPerCta groups of one row.  The row's
//             6 x 259 code lengths sit in shared memory as two packed
//             words a symbol, a 10-bit lane a tree (trees 0-2, trees
//             3-5): the spec's own accumulator, so a group's six costs
//             are two wrapping 32-bit sums over its 50 symbols and the
//             lane overflow past 1023 comes out as the spec has it.  A
//             warp takes a group: two coalesced loads (50 symbols), two
//             __reduce_add_sync, the lane-2 carry into the high word,
//             the first minimum over the live trees; its groups lie in
//             a row, so their selectors are one load and one store.
//             Positions at and
//             past nm hold the dummy symbol `as`, so a group past the
//             row's last one costs 50 times the dummy's word whatever
//             the group: one selector, which the row's live CTAs write
//             over an equal share of those groups each.  The
//             selectors of all G groups are compared with the previous
//             iteration's in place and written only where they differ
//             (a store behind a load of the same word, for every group,
//             took 30 us of an E-step's 72); the frequencies of the
//             valid groups go through shared-memory atomics, flushed
//             with one global atomic a non-zero count a CTA.
//   em_mstep  a warp a tree (code_lengths_tree), trees t < nt only,
//             lengths written in place; every tree's frequencies are
//             zeroed for the next E-step.
//
// The loop is cluster_factor rounds of the two kernels, enqueued back to
// back by one host call that reads nothing.  A kernel boundary is the
// grid-wide barrier both steps need, and the two steps want different
// grids (thousands of group CTAs against B * 6 warps), which one
// persistent cooperative kernel would have to size for one and idle for
// the other; what the rounds cost is an empty launch, a few
// microseconds, for each round after convergence.  The control words:
// ctl[0] done, ctl[1] E-steps executed, ctl[2 + it] "some selector
// changed in E-step it".  em_mstep of round `it` sets `done` when no
// selector of the whole batch changed (it > 0); every later kernel
// returns at once.  The last round has no M-step.  So `lengths` ends as
// the input of the last executed E-step, `sel` and `freqs` as its
// outputs, as the plain loop returns them.
//
// What bounds it: bytes, the nm live symbols a row an iteration (4 bytes
// each); six additions a symbol are two packed adds.
//
// Plain C interface (lbzip2_tpu_torch/_build.py); launches on the
// caller's stream and returns cudaGetLastError().

#include "code_lengths.cuh"

namespace {

using namespace lbz2t;

constexpr int kTrees = 6;
constexpr int kGroup = 50;
constexpr int kEThreads = 256;
constexpr int kEWarps = kEThreads / 32;
constexpr int kGroupsPerCta = 128;
constexpr int kGroupsPerWarp = kGroupsPerCta / kEWarps;  // at most 32
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

__global__ void __launch_bounds__(kEThreads)
em_estep(const int* __restrict__ mtfv, const int* __restrict__ nm_arr,
         const int* __restrict__ ninuse, const int* __restrict__ nt_arr,
         const int* __restrict__ lengths, int* __restrict__ sel,
         int* __restrict__ freqs, int* __restrict__ ctl, int NP, int G,
         int it) {
  if (ctl[kDone]) return;
  __shared__ unsigned s_lo[kW];
  __shared__ unsigned s_hi[kW];
  __shared__ int s_freq[kTrees * kW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  if (blockIdx.x == 0 && b == 0 && tid == 0) ctl[kIters] = it + 1;
  const int dummy = min(max(ninuse[b] + 2, 0), kW - 1);
  const int nm = min(max(nm_arr[b], 0), NP);
  const int ngroups = (nm + kGroup - 1) / kGroup;
  const int nt = nt_arr[b];
  const int* len = lengths + (size_t)b * kTrees * kW;
  const int* row = mtfv + (size_t)b * NP;
  int* sel_row = sel + (size_t)b * G;
  // the row's first nlive CTAs hold its symbols; the others have nothing
  // to do (the grid is sized for a row that is all symbols)
  const int nlive = max((ngroups + kGroupsPerCta - 1) / kGroupsPerCta, 1);
  if ((int)blockIdx.x >= nlive) return;
  const int g0 = blockIdx.x * kGroupsPerCta;
  const int live1 = min(g0 + kGroupsPerCta, ngroups);  // [g0, live1) live
  int changed = 0;

  for (int i = tid; i < kW; i += kEThreads) {
    s_lo[i] = pack3(len, i);
    s_hi[i] = pack3(len + 3 * kW, i);
  }
  for (int i = tid; i < kTrees * kW; i += kEThreads) s_freq[i] = 0;
  __syncthreads();

  // a warp takes kGroupsPerWarp groups in a row.  Their old selectors
  // are read and the new ones written by one load and one store of the
  // warp, lane k keeping group k's, and the next group's symbols are
  // loaded before this one's are used: no step of the loop waits for
  // device memory
  const int wg0 = g0 + warp * kGroupsPerWarp;
  const int wg1 = min(wg0 + kGroupsPerWarp, live1);
  const bool keeps = lane < kGroupsPerWarp && wg0 + lane < wg1;
  const bool two = lane < kGroup - 32;
  int was = -1, now = -1;
  if (keeps && it > 0) was = sel_row[wg0 + lane];
  int n0 = dummy, n1 = dummy;
  if (wg0 < wg1) {
    const int p0 = wg0 * kGroup + lane;
    if (p0 < nm) n0 = row[p0];
    if (two && p0 + 32 < nm) n1 = row[p0 + 32];
  }
  for (int g = wg0; g < wg1; ++g) {
    const int s0 = min(max(n0, 0), kW - 1), s1 = min(max(n1, 0), kW - 1);
    n0 = n1 = dummy;
    if (g + 1 < wg1) {
      const int p0 = (g + 1) * kGroup + lane;
      if (p0 < nm) n0 = row[p0];
      if (two && p0 + 32 < nm) n1 = row[p0 + 32];
    }
    unsigned lo = s_lo[s0], hi = s_hi[s0];
    if (two) {
      lo += s_lo[s1];
      hi += s_hi[s1];
    }
    const int bt = select_tree(__reduce_add_sync(kFull, lo),
                               __reduce_add_sync(kFull, hi), nt);
    atomicAdd(&s_freq[bt * kW + s0], 1);
    if (two) atomicAdd(&s_freq[bt * kW + s1], 1);
    if (lane == g - wg0) now = bt;
  }
  if (keeps && (it == 0 || was != now)) {
    changed = it > 0;
    sel_row[wg0 + lane] = now;
  }
  // the groups past the row's last are all dummy symbols and share one
  // selector; the row's live CTAs take an equal run of them each
  const int tail = select_tree((unsigned)kGroup * s_lo[dummy],
                               (unsigned)kGroup * s_hi[dummy], nt);
  const int share = (G - ngroups + nlive - 1) / nlive;
  const int t0 = ngroups + blockIdx.x * share;
  const int t1 = min(t0 + share, G);
  for (int g = t0 + tid; g < t1; g += kEThreads) {
    if (it == 0) {
      sel_row[g] = tail;
    } else if (sel_row[g] != tail) {
      changed = 1;
      sel_row[g] = tail;
    }
  }
  if (__syncthreads_or(changed) && tid == 0) atomicOr(&ctl[kChanged + it], 1);
  int* f_row = freqs + (size_t)b * kTrees * kW;
  for (int i = tid; i < kTrees * kW; i += kEThreads)
    if (s_freq[i]) atomicAdd(&f_row[i], s_freq[i]);
}

__global__ void __launch_bounds__(32 * kTreesPerCta)
em_mstep(int* __restrict__ freqs, const int* __restrict__ ninuse,
         const int* __restrict__ nt_arr, int* __restrict__ lengths,
         int* __restrict__ ctl, int R, int it) {
  __shared__ TreeScratch scratch[kTreesPerCta];
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

// mtfv (B, NP) int32 symbols, nm / ninuse / nt (B,) int32; lengths
// (B, 6, 259) int32, the initial trees in, the last E-step's trees out;
// sel (B, G) int32 out, G = ceil(NP / 50); freqs (B, 6, 259) int32,
// zero in, the last E-step's counts out; ctl (2 + cluster_factor) int32,
// zero in, ctl[1] the E-steps executed out.  All device pointers.
extern "C" int lbz2t_em_chain(const void* mtfv, const void* nm,
                              const void* ninuse, const void* nt,
                              void* lengths, void* sel, void* freqs,
                              void* ctl, int B, int NP, int G,
                              int cluster_factor, void* stream) {
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 egrid((G + kGroupsPerCta - 1) / kGroupsPerCta, B);
  const int R = B * kTrees;
  const int mgrid = (R + kTreesPerCta - 1) / kTreesPerCta;
  for (int it = 0; it < cluster_factor; ++it) {
    em_estep<<<egrid, kEThreads, 0, s>>>(
        static_cast<const int*>(mtfv), static_cast<const int*>(nm),
        static_cast<const int*>(ninuse), static_cast<const int*>(nt),
        static_cast<const int*>(lengths), static_cast<int*>(sel),
        static_cast<int*>(freqs), static_cast<int*>(ctl), NP, G, it);
    if (it + 1 < cluster_factor)
      em_mstep<<<mgrid, 32 * kTreesPerCta, 0, s>>>(
          static_cast<int*>(freqs), static_cast<const int*>(ninuse),
          static_cast<const int*>(nt), static_cast<int*>(lengths),
          static_cast<int*>(ctl), R, it);
  }
  return (int)cudaGetLastError();
}
