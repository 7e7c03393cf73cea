// Huffman code lengths of one tree of the EM M-step, a warp a tree, for
// Hopper (sm_90a).  Included by code_lengths.cu (the stand-alone entry)
// and by em_chain.cu (the M-step of the EM loop on the card).
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
// What bounds a tree is not bytes (1 KB in, 1 KB out) but dependent
// chains, so the design spends nothing on block-wide barriers, keeps the
// one chain that is serial by nature short, and gives the others to the
// whole warp:
//
//   1. leaf sort: a bitonic network over the warp's registers, K keys a
//      lane (K = 4, 8 or 16 by the alphabet: 128, 256 or 512 slots),
//      __shfl_xor_sync between lanes, no shared memory and no barrier
//      (live keys are distinct, so stability does not matter);
//   2. the two-queue merge, as - 1 dependent steps in lane 0: a node is
//      one 64-bit word (freq in the high half, so the key order is one
//      signed compare), both heads of both queues stay in registers,
//      and the queues' ends hold a largest key, so a step is two
//      compares and no count of what is left.  The refill (two leaves
//      and two merges past the heads) is read from shared memory before
//      the pick is known and chosen from afterwards, and the node a
//      step makes enters from its register, so no step waits for a
//      load that depends on it; every node stores its parent;
//   3. depths by pointer jumping over the parents, all lanes, log2(as)
//      rounds between two buffers (the reverse sweep over the merges is
//      as - 1 more dependent steps through shared memory);
//   4. rank profile by all lanes: a 31-bin count of the clamped depths,
//      its suffix sums by shuffles, and rank r takes the largest depth
//      whose suffix sum exceeds r; scatter to symbol = 258 - tag, lanes
//      >= as zero.
//
// A tree needs a warp and 9.3 KB of shared memory, so a CTA holds
// kTreesPerCta trees and a (192, 259) call is 48 CTAs.

#pragma once

#include <cuda_runtime.h>

namespace lbz2t {

constexpr int kW = 259;        // lanes: symbols 0..257 + dummy
constexpr int kNLeaf = 258;    // leaf slots (as <= 258)
constexpr int kNMerge = 257;
constexpr int kNN = kNLeaf + kNMerge;
constexpr int kHLim = 30;
constexpr int kInf = 0x7FFFFFFF;
constexpr int kTreesPerCta = 4;
constexpr int kLeafSlots = 264;   // as sorted leaves, then largest keys
constexpr int kMergeSlots = 260;  // the heads read merges ii and ii + 1

typedef long long node_t;  // freq << 32 | t; t >= 0, so one signed compare
constexpr node_t kInfNode = ((node_t)kInf << 32) | (node_t)kInf;

struct TreeScratch {
  node_t leaf[kLeafSlots];
  node_t merge[kMergeSlots];
  unsigned short par[2][kNN + 1];   // pointer jumping: parent, two buffers
  unsigned short dist[2][kNN + 1];  // and the distance summed so far
  int cnt[32];
  int out[kW + 1];
};

// Ascending bitonic sort of the warp's 32 * K keys, key i = lane * K + r
// in register r of the lane; every index is a constant after unrolling.
template <int K>
__device__ __forceinline__ void warp_sort(int (&key)[K], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= K) {  // partner in lane ^ (j / K), same register
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int i = lane * K + r;
          const int other = __shfl_xor_sync(0xFFFFFFFFu, key[r], j / K);
          const bool up = (i & k) == 0;
          const bool lower = (i & j) == 0;
          key[r] = (lower == up) ? min(key[r], other) : max(key[r], other);
        }
      } else {  // partner in this lane, register r | j
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & j) == 0) {
            const bool up = ((lane * K + r) & k) == 0;
            const int a = key[r], b = key[r | j];
            if ((a > b) == up) {
              key[r] = b;
              key[r | j] = a;
            }
          }
        }
      }
    }
  }
}

constexpr int kLoads = (kW + 31) / 32;  // a row is 9 loads of the warp

// The row's counts into the warp's registers, count lane + 32 * r in
// register r: addresses that depend on nothing, so a caller starts them
// beside its other loads and waits for device memory once.
__device__ __forceinline__ void load_counts(const int* __restrict__ f_row,
                                            int lane, int (&f)[kLoads]) {
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int i = lane + 32 * r;
    f[r] = i < kW ? f_row[i] : 0;
  }
}

// Sort the row's `as` leaves by (max(f, 1) << 9) | tag and write them as
// nodes (t = 1 << 9 | tag) into leaf[0, as); slots from as on hold the
// largest key.  Which slot a key starts in does not matter to a sort, so
// symbol lane + 32 * r starts in register r.  int32 arithmetic that
// wraps as the plain version's does.
template <int K>
__device__ __forceinline__ void sort_leaves(const int (&f)[kLoads], int as,
                                            int lane, node_t* leaf) {
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = lane + 32 * r;
    key[r] = kInf;
    if (r < kLoads && i < as)
      key[r] = (int)(((unsigned)max(f[r < kLoads ? r : 0], 1) << 9) |
                     (unsigned)(kNLeaf - i));
  }
  warp_sort<K>(key, lane);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = lane * K + r;
    if (i < kLeafSlots)
      leaf[i] = key[r] == kInf
                    ? kInfNode
                    : ((node_t)(key[r] >> 9) << 32) |
                          (node_t)((1 << 9) | (key[r] & 511));
  }
  for (int i = 32 * K + lane; i < kLeafSlots; i += 32) leaf[i] = kInfNode;
}

// Steps 2 to 4 for a tree whose sorted leaves are in s.leaf; NL leaves
// a lane at most in step 4 (leaf r in lane r % 32).
template <int NL>
__device__ __forceinline__ void tree_from_leaves(int as, int* __restrict__
                                                 o_row, TreeScratch& s,
                                                 int lane) {
  const int nmerge = max(as - 1, 0);
  const int root = nmerge > 0 ? kNLeaf + nmerge - 1 : 0;
  if (lane == 0) {
    // li leaves and ii merges consumed so far; L0, L1 and I0, I1 the two
    // smallest of each queue, the largest key past a queue's end
    int li = 0, ii = 0;
    node_t L0 = s.leaf[0], L1 = s.leaf[1], I0 = kInfNode, I1 = kInfNode;
    for (int m = 0; m < nmerge; ++m) {
      const node_t X2 = s.leaf[li + 2], X3 = s.leaf[li + 3];
      const node_t Y2 = s.merge[ii + 2], Y3 = s.merge[ii + 3];
      const int tag = (int)s.leaf[m] & 511;
      // huff_pick_pair: ties prefer leaves
      const bool pick_ii = I1 < L0;
      const bool pick_ll = !pick_ii && !(I0 < L1);
      const node_t a = pick_ll ? L0 : I0;
      const node_t b = pick_ii ? I1 : (pick_ll ? L1 : L0);
      const int c0 = pick_ll ? li : kNLeaf + ii;
      const int c1 = pick_ii ? kNLeaf + ii + 1 : (pick_ll ? li + 1 : li);
      const int t0 = (int)a, t1 = (int)b;
      const int f = (int)((unsigned)(a >> 32) + (unsigned)(b >> 32));
      const int height = max(t0 >> 17, t1 >> 17) + 1;
      const int nl = (((t0 >> 9) & 255) + ((t1 >> 9) & 255)) & 255;
      const node_t made = ((node_t)f << 32) |
                          (node_t)((height << 17) | (nl << 9) | tag);
      s.merge[m] = made;
      s.par[0][c0] = (unsigned short)(kNLeaf + m);
      s.par[0][c1] = (unsigned short)(kNLeaf + m);
      // the merge just made is the queue's entry m, wherever that falls
      const node_t v0 = ii == m ? made : I0;
      const node_t v1 = ii + 1 == m ? made : I1;
      const node_t v2 = ii + 2 == m ? made : Y2;
      const node_t v3 = ii + 3 == m ? made : Y3;
      if (pick_ii) {  // two merges leave
        I0 = v2; I1 = v3; ii += 2;
      } else if (pick_ll) {  // two leaves leave
        L0 = X2; L1 = X3; I0 = v0; I1 = v1; li += 2;
      } else {  // one of each
        L0 = L1; L1 = X2; I0 = v1; I1 = v2; li += 1; ii += 1;
      }
    }
    s.par[0][root] = (unsigned short)root;
  }
  __syncwarp();

  // 3. node n of the 2 as - 1: leaf n, or merge n - as
  const int nn = as + nmerge;
  for (int n = lane; n < nn; n += 32) {
    const int id = n < as ? n : kNLeaf + n - as;
    s.dist[0][id] = id == root ? 0 : 1;
  }
  __syncwarp();
  // a lane's nodes go through registers, all their loads before any
  // store, so a round is two trips to shared memory and not two a node
  constexpr int NJ = (2 * 32 * NL + 31) / 32;  // nodes a lane, at most
  int cur = 0;
  for (int reach = 1; reach < nmerge; reach <<= 1) {
    int id[NJ], p[NJ], d[NJ];
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int n = lane + 32 * q;
      id[q] = n < as ? n : kNLeaf + n - as;
      p[q] = n < nn ? s.par[cur][id[q]] : 0;
      d[q] = n < nn ? s.dist[cur][id[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int n = lane + 32 * q;
      d[q] += n < nn ? s.dist[cur][p[q]] : 0;
      p[q] = n < nn ? s.par[cur][p[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      if (lane + 32 * q < nn) {
        s.dist[cur ^ 1][id[q]] = (unsigned short)d[q];
        s.par[cur ^ 1][id[q]] = (unsigned short)p[q];
      }
    }
    cur ^= 1;
    __syncwarp();
  }

  // 4. rank r (ascending key) takes the r-th largest depth
  for (int r = lane; r < as; r += 32)
    atomicAdd(&s.cnt[min((int)s.dist[cur][r], kHLim)], 1);
  __syncwarp();
  int above = s.cnt[lane];  // leaves at depth >= lane, once summed
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_down_sync(0xFFFFFFFFu, above, off);
    if (lane + off < 32) above += t;
  }
  int depth[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) depth[k] = 0;
  for (int d = 1; d <= kHLim; ++d) {
    const int at_least = __shfl_sync(0xFFFFFFFFu, above, d);
#pragma unroll
    for (int k = 0; k < NL; ++k)
      if (at_least > lane + 32 * k) depth[k] = d;
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int r = lane + 32 * k;
    if (r < as) s.out[kNLeaf - ((int)s.leaf[r] & 511)] = depth[k];
  }
  __syncwarp();
  for (int i = lane; i < kW; i += 32)
    o_row[i] = i < kNLeaf ? s.out[i] : 0;  // symbol 258 is never real
  __syncwarp();
}

// Code lengths of one tree by the calling warp: f the row's 259 int32
// counts as load_counts leaves them (0 counts as 1), as the alphabet
// size (clamped to 0..258), o_row (259) int32 lengths out, at most 30,
// lanes >= as zero.  All 32 lanes must call it.
__device__ __forceinline__ void code_lengths_tree(
    const int (&f)[kLoads], int as, int* __restrict__ o_row,
    TreeScratch& s, int lane) {
  as = min(max(as, 0), kNLeaf);
  for (int i = lane; i < kMergeSlots; i += 32) s.merge[i] = kInfNode;
  for (int i = lane; i < kW; i += 32) s.out[i] = 0;
  s.cnt[lane] = 0;
  if (as <= 128) {
    sort_leaves<4>(f, as, lane, s.leaf);
    __syncwarp();
    tree_from_leaves<4>(as, o_row, s, lane);
  } else if (as <= 256) {
    sort_leaves<8>(f, as, lane, s.leaf);
    __syncwarp();
    tree_from_leaves<8>(as, o_row, s, lane);
  } else {
    sort_leaves<16>(f, as, lane, s.leaf);
    __syncwarp();
    tree_from_leaves<9>(as, o_row, s, lane);
  }
}

}  // namespace lbz2t
