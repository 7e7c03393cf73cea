// Suffix sorting of the batched BWT (bwt2), for Hopper (sm_90a): the
// seed as a radix sort by the first 4-byte word that carries its key,
// then a segmented sort of the runs of equal words; each doubling pass
// as a segmented sort of the lanes that are still tied.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/bwt2.py::_seed16 (:81) and
// _passx (:125) as _pass8 (:162) and _pass4 (:158), each with the
// _invert (:48) that ends it, and in the cyclic mode the v1 rotation
// sort of lbzip2_tpu/ops/bwt.py: _seed_sparse (:157), the doubling of
// _sparse_level (:218) and bwt_masked (:26, :43) and their tie-breaks.
// Each function sorts the lanes < n of every row by a tuple of keys and
// gives each lane the SA slot of the first lane of its equal-key class,
// its rank; the new ISA is
// ISA[SA[t]] = rank[t].
//
// The seed's key of position p is its 16-byte prefix as four big-endian
// words W0..W3 (bytes at or past n read 0).  A valid lane whose key K is
// FF FF FF FF 00 .. 00 (the pads' own key P) ties with the pads in JAX,
// and one whose K > P sorts after all N - n of them: such a lane's rank
// is its slot plus N - n, and a lane with K = P is unresolved whenever
// there are pads.  So the seed's ranks lie in [0, N), not in [0, n).
// The seed runs in rounds; no digit pass gathers:
//
//   seed_setup      cnt, the lists' counts and the rows' state to 0
//   round 0         kv_hist / radix_scan / kv_scatter, 4 passes: a stable
//                   LSD radix sort of the pairs (W0, p) by W0's 8-bit
//                   digits, the key moving with the lane (W0 read along p,
//                   coalesced, in the first pass); seed_flags, rank_carry:
//                   run starts where adjacent words differ, each lane's
//                   run start by a max-scan; seed_runs: a run of one lane
//                   is resolved (its rank its slot), every other lane
//                   gathers W1..W3 once, 12 bytes, into its slot, and each
//                   run is routed by its size with the pass's bins: 2 to
//                   kSmall lanes to seed_small, up to kLarge to a block
//                   bin's list, larger ones to the next round (a packed
//                   atomic gives each its index and its place there, in
//                   one order); ISA 0 at the lanes >= n
//   rounds 1 to 3   seed_compact, seed_work: round r takes the runs above
//                   kLarge lanes that round r - 1 found into a region of
//                   its own; 4 + 1 (or 2) passes sort them by (run index,
//                   W_r), (W_r, u) moving with the lane; seed_round_flags,
//                   rank_carry, seed_round: each lane's new slot, and its
//                   runs as in round 0 (W_{r+1}.. gathered again), until
//                   after round 3 a run is a class of equal 16 bytes
//   seed_small      a thread a lane of a run of 2 to kSmall lanes: its
//                   run's first slot plus the lanes of its run with
//                   smaller (W1, W2, W3)
//   seg_block       a block a run of up to 256, 1024 or 4096 lanes, as in
//                   the pass, on three words; round 0's runs on a second
//                   stream of the calling thread while rounds 1 to 3 run
//                   (their runs are another set of slots), joined back
//                   before the rounds' own runs
//   seed_pads       the pad-key rule on the one run it can touch, the run
//                   of W0 = FF FF FF FF (every lane with K >= P lies in
//                   it): K > P adds N - n, a lone K = P lane counts as
//                   unresolved when n < N
//
// A pass sorts by 8 keys, key j read from the current ISA at p + off_j
// with off_j = min(j k, N), mapped to
//     key_j(p) = N + ISA[p + off_j]   if p + off_j < n,
//                N - 1 - p            otherwise.
// Why the mapping is exact: JAX reads sentinels n - q - 2^30 past n
// (its _extend, the dynamic_slice clamp of the start to N and the patch
// where p + j k >= 2N), and along one key column q grows strictly with
// p in both regimes, which meet in order (3N - j k - 1 < 2N).  So JAX's
// sentinels fall strictly as p grows and lie below every rank, as
// N - 1 - p does below N + ISA.  Every mapped key is below 2N, and
// N < 2^23 keeps it inside the 24 bits of three digits.  The pad lanes
// (>= n) take no part: in JAX their key 0 is INT32_MAX.
//
// Key 0 of a pass is the ISA itself, so the lanes are already grouped
// by it: a lane's new rank is S[v] (the valid lanes whose ISA is below
// its own v) plus the lanes of its class whose keys 1 to 7 are smaller.
// A lane alone in its class keeps S[v], which is v itself after any
// pass (ranks are first slots among the valid lanes) but not after the
// seed.  So a pass is a segmented sort of the classes of two or more
// lanes, in the shape of Hou et al., "Fast Segmented Sort on GPUs"
// (ICS 2017), and the ISA is updated in place:
//
//   seg_setup      per row: the lanes it works on, n, or 0 when the
//                  previous pass's count (when given) is 0: a pass over
//                  a resolved row is the identity; cnt = 0; passes += 1
//   seg_hist       count[v] of each valid lane's v (a warp of one v adds
//                  once: the deep repeats put long runs in one v)
//   seg_scan_*     per (row, tile of 4096 values), then per row, then
//                  per value: S[v] = the exclusive sum of the counts, and
//                  the dense place of each class of two or more: classes
//                  above kLarge lanes first (region L), then the others
//                  (region A); the classes of kSmall < size <= kLarge go
//                  to three lists by size; count[v] goes back to 0 (the
//                  buffer is all zero between passes); a row whose lone
//                  lanes do not sit at S[v] (after the seed) is flagged
//   seg_compact    each tied lane to its class's dense range (a counter
//                  a class, a warp of one class at once; the order inside
//                  a class is any), and for region A its keys 0 to 7 once,
//                  32 bytes a lane, read along p (coalesced)
//   seg_work       region L's (row, tile) items, listed on the card
//   large route    digit passes over region L's lanes only (3 digits a
//                  key, keys 7 to 0, the class v last, each digit
//                  gathered from the ISA), then class starts by the keys
//                  (rank_flags); its kernels loop over the items on a
//                  grid of 8 blocks an SM, so an idle route (no class
//                  above kLarge: every text row) costs its 75 launches,
//                  not a block a tile of each row
// Every gather of the ISA is above this line, every write below (a
// kernel boundary on one stream): the pass runs in place.
//   seg_remap      (flagged rows only) a lone lane's ISA = S[v]
//   seg_small      a thread a lane of a class of at most kSmall lanes:
//                  its rank is S[v] plus the lanes of its class with
//                  smaller keys, counted over the class's keys (a warp's
//                  lanes read the same ones)
//   seg_block      a block a class of up to 256, 1024 or 4096 lanes: a
//                  bitonic sort of its slots by keys 1 to 7 in shared
//                  memory, class starts, a max-scan of the start slots
//   rank_carry/write  region L's ranks: S[v] plus the slot of the first
//                  lane of the sub-class inside the class
// Each route adds its lanes in classes of two or more to cnt.
//
// Modes (template parameters of the same kernels, not copies of them):
//
//   keys     a pass sorts by 8 keys (_pass8) or 4 (bwt2's _pass4,
//            lbzip2_tpu/ops/bwt2.py:158): the gathers, the digit passes
//            of region L (3 a key) and the class starts take kKeys keys;
//            a 4-key pass stores keys 4 to 7 as 0, so the block bins and
//            seg_small compare 7 keys as ever
//   cyclic   the v1 rotation sort (lbzip2_tpu/ops/bwt.py) on the rows as
//            they stand: the seed's words are bytes (p + d) mod n, with
//            JAX's second mod for n < 16 (_seed_sparse, :157-215), and
//            the pads' key is sixteen FF bytes, which no valid key
//            passes, so no rank moves and only a lone valid lane of
//            sixteen FF bytes counts as unresolved (JAX forms the classes
//            over the four words, :196-198); ranks are first slots among
//            the valid lanes.  A pass's key j is N + ISA[(p + o_j) mod n],
//            o_j = j k mod n taken in 64 bits by seg_setup (k passes n
//            before the loop ends) into a table a row, read where used
//   tie      the tie-break of equal rotations (fully periodic rows, left
//            after loop_passes(N) cyclic passes): keys past key 0 are
//            n - 1 - p, descending start (:90-95, :235-236), 4 keys
//
// What bounds it on the card.  The seed's digit passes carry 8 bytes a
// lane (read and written once a pass, the hist reads 4), 4 of them over
// every lane and 5 a round over the lanes of runs above kLarge; each
// tied lane gathers 12 bytes once a round (one or two 32-byte sectors,
// the rows in the 50 MB L2).  A digit pass costs some 11 ps a lane
// (the scatter) and 4 (the hist) on an H100, about three times its
// bytes at the memory's rate; which of its steps a tile waits on (the
// match of each lane's digit among its warp's, the scans, the staging
// in shared memory) is not measured.  The block bins' bitonic sorts
// take about as long again (round 0's beside rounds 1 to 3).  The doubling pass reads the ISA
// three times (hist, compact, and remap once after the seed) and the
// counts and sums three times (4 bytes a lane and a value each: some
// 0.5 GB at (32, 901120)), and each tied lane of region A gathers 7
// keys, one 32-byte sector each, and writes and reads its 32 bytes of
// keys; the ISA rows, 3.6 MB each, stay in the 50 MB L2 while a row's
// blocks run.  The lanes that are resolved, and the rows that are, cost
// the classify passes alone.  Its region L pays a full radix sort's
// price: 24 digit passes over its lanes, each gathering a digit at a
// random place of the ISA.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream, never
// synchronizes, and returns the first launch error.

#include <cuda_runtime.h>

namespace {

constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRounds = 16;                 // 32-lane rounds a warp takes
constexpr int kWarpSpan = 32 * kRounds;     // 512 lanes a warp
constexpr int kTile = kWarps * kWarpSpan;   // 4096 lanes a sort tile
constexpr int kScanThreads = 1024;
constexpr int kSeedWords = 4;               // the seed's 16 bytes
constexpr int kWordDigits = 32 / kBits;     // digit passes a word
constexpr int kLevels = kSeedWords - 1;     // rounds 0 to 2 find large runs
constexpr int kMaxKeys = 8;                 // a pass sorts by 4 or 8 keys
constexpr int kKeyDigits = 3;               // 24 bits a mapped key
constexpr int kMaxN = 1 << 23;              // 2N must fit 24 bits
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kThreads == kRadix, "a thread a digit in the scatter");
static_assert(kTile == kRounds * kThreads, "a tile is 16 rounds a block");

// The segmented pass's size bins (ops/bwt2.py SEG_SMALL, SEG_BLOCKS):
// classes of 2 to kSmall lanes go to seg_small, the rest up to kLarge
// to seg_block by the least capacity that holds them, larger ones to
// the radix route.  The seed routes its runs of equal W0 by the same
// bins.
constexpr int kSmall = 32;
constexpr int kBins = 3;
constexpr int kBinCap0 = 256, kBinCap1 = 1024, kBinCap2 = 4096;
constexpr int kLarge = kBinCap2;
constexpr unsigned short kSentinel = 0xFFFF;  // an empty slot of a block
static_assert(kLarge < kSentinel, "a class's slots fit 16 bits");

__device__ __forceinline__ int row_n(const int* ns, int b, int N) {
  return min(max(ns[b], 0), N);
}

// q mod n for 0 <= q and n >= 1: one subtraction covers q < 2n, the
// division the rest (only a row of n < 16 needs it).
__device__ __forceinline__ int wrap(int q, int n) {
  if (q >= n) q -= n;
  if (q >= n) q %= n;
  return q;
}

// Bytes p .. p + 3 of a row as a big-endian word: 0 at or past n, or in
// the cyclic mode (kCyclic, the rotation sort) bytes (p + j) mod n.
template <bool kCyclic>
__device__ __forceinline__ unsigned word_at(const unsigned char* blocks,
                                            size_t base, int p, int n) {
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = p + j;
    if constexpr (kCyclic)
      w = (w << 8) | blocks[base + wrap(q, n)];
    else
      w = (w << 8) | (q < n ? blocks[base + q] : 0u);
  }
  return w;
}

// The three words at p + 4, p + 8 and p + 12 (W1..W3 of position p), 0
// at or past n (cyclic: taken mod n): from four or five aligned 32-bit
// loads where the row starts on a word (N a multiple of 4) and they stay
// inside it (the fifth reaches byte q + 18 at most; cyclic: inside the
// n bytes, so nothing wraps), else byte by byte.
template <bool kCyclic>
__device__ __forceinline__ void words_after(const unsigned char* blocks,
                                            size_t base, int p, int n, int N,
                                            unsigned (&w)[3]) {
  const int q = p + 4;
  if ((N & 3) == 0 && q + 20 <= (kCyclic ? n : N)) {
    const unsigned* row =
        reinterpret_cast<const unsigned*>(blocks + base) + (q >> 2);
    unsigned x[5];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = row[i];
    const int sh = q & 3;
    x[4] = sh ? row[4] : 0u;
    // little-endian words: byte q + k is byte (sh + k) of x[], big-endian
    // order wanted: __byte_perm picks 4 bytes of (hi:lo) by selector
    const unsigned sel = sh == 0 ? 0x0123 : sh == 1 ? 0x1234
                       : sh == 2 ? 0x2345 : 0x3456;
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = __byte_perm(x[i], x[i + 1], sel);
    if constexpr (!kCyclic) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {  // bytes at or past n read 0
        const int lo = q + 4 * i;
        if (lo + 4 > n)
          w[i] = lo >= n ? 0u : w[i] & ~(0xFFFFFFFFu >> (8 * (n - lo)));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      w[i] = word_at<kCyclic>(blocks, base, q + 4 * i, n);
  }
}

// Where a pass's digit pass reads its digit: the current ISA, key j (its
// offset off in the suffix mode, from the host: an index into the
// kernel's parameters that only the card knows would copy them to local
// memory in every thread), the digit's place in the mapped key at shift.
struct Source {
  const int* isa;
  int j;
  int off;
  int shift;
};

// A pass's key mappings (the template parameter kMap of its kernels):
// the suffix sort's (bwt2), the rotation sort's (bwt), and the rotation
// sort's tie-break of equal rotations by descending start.
constexpr int kSuffix = 0, kCyclic = 1, kTieBreak = 2;

struct Offsets {
  int o[kMaxKeys];         // kSuffix: off_j = min(j k, N)
  long long jk[kMaxKeys];  // kCyclic: j k, which seg_setup takes mod n
  const int* row;          // kCyclic: (B, kMaxKeys) j k mod n a row
};

// Key j's offset in row b (the tie-break: -1 past key 0).  A cyclic
// row's offsets are read where they are used, from the (L1-resident)
// table seg_setup wrote, not held in registers.
template <int kMap>
__device__ __forceinline__ int key_offset(const Offsets& offs, int j, int b) {
  if constexpr (kMap == kSuffix)
    return offs.o[j];
  else if constexpr (kMap == kCyclic)
    return offs.row[b * kMaxKeys + j];
  else
    return j == 0 ? 0 : -1;
}

// The mapped key of lane p < n at offset off (see the head of the file).
template <int kMap>
__device__ __forceinline__ int pass_key(const int* isa, size_t base, int p,
                                        int off, int n, int N) {
  if constexpr (kMap == kSuffix) {
    const int q = p + off;
    return q < n ? N + isa[base + q] : N - 1 - p;
  } else if constexpr (kMap == kCyclic) {
    const int q = p + off;  // off < n
    return N + isa[base + (q >= n ? q - n : q)];
  } else {
    return off < 0 ? n - 1 - p : N + isa[base + p];
  }
}

// The lanes of the warp whose d equals this lane's, d in [0, kRadix]
// (kRadix marks a dead lane): one ballot a bit, as CUB's MatchAny does.
__device__ __forceinline__ unsigned peers_of(int d) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b <= kBits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// The (row, tile) items a block of a radix-route kernel takes: its own
// (blockIdx.y, blockIdx.x) when items is null (a full grid), else
// items[i] for i = blockIdx.x, blockIdx.x + gridDim.x, .. below *count
// (a region L, listed on the card: an idle route launches a few hundred
// blocks, not a block a tile of every row).
struct Work {
  const int2* items;
  const int* count;
};

__device__ __forceinline__ int work_items(const Work& w) {
  return w.items ? *w.count : 1;
}

__device__ __forceinline__ int work_first(const Work& w) {
  return w.items ? blockIdx.x : 0;
}

__device__ __forceinline__ int work_step(const Work& w) {
  return w.items ? gridDim.x : 1;
}

__device__ __forceinline__ int2 work_item(const Work& w, int i) {
  return w.items ? w.items[i] : make_int2(blockIdx.y, blockIdx.x);
}

// Calls f(b, tile) for the tiles of 4096 lanes of the block's items.
template <class Fn>
__device__ __forceinline__ void for_each_tile(const Work& work, Fn f) {
  for (int i = work_first(work); i < work_items(work); i += work_step(work)) {
    const int2 bt = work_item(work, i);
    f(bt.x, bt.y);
    __syncthreads();  // the shared memory of the next item
  }
}

// radix_hist: counts[b][digit][tile] of the lanes < lanes[b] of one
// tile, and each lane's digit in digits[b][t] for the scatter; a tile
// past the lanes writes nothing (the scan reads the tiles that hold
// lanes).  ns gives the rows' lengths for the digits.
template <int kMap>
__device__ __forceinline__ void hist_tile(
    int b, int tile, const int* __restrict__ sa_in,
    const int* __restrict__ ns, const int* __restrict__ lanes,
    int* __restrict__ counts, unsigned char* __restrict__ digits,
    const Offsets& offs, const Source& g, int N, int T) {
  __shared__ int h[kRadix];
  const int n = row_n(ns, b, N), nl = row_n(lanes, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t0 = tile * kTile;
  if (t0 >= nl) return;
  int off;
  if constexpr (kMap == kSuffix)
    off = g.off;
  else
    off = key_offset<kMap>(offs, g.j, b);
  h[threadIdx.x] = 0;
  __syncthreads();
  {
    int p[kRounds], d[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      p[r] = t < nl ? sa_in[base + t] : 0;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      d[r] = t < nl ? (pass_key<kMap>(g.isa, base, p[r], off, n, N) >>
                       g.shift) &
                          (kRadix - 1)
                    : kRadix;
      if (t < nl) digits[base + t] = static_cast<unsigned char>(d[r]);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const unsigned peers = peers_of(d[r]);
      if (d[r] < kRadix && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&h[d[r]], __popc(peers));
    }
  }
  __syncthreads();
  counts[(static_cast<size_t>(b) * kRadix + threadIdx.x) * T + tile] =
      h[threadIdx.x];
}

template <int kMap>
__global__ void __launch_bounds__(kThreads)
radix_hist(const int* __restrict__ sa_in, const int* __restrict__ ns,
           const int* __restrict__ lanes, Work work,
           int* __restrict__ counts, unsigned char* __restrict__ digits,
           Offsets offs, Source g, int N, int T) {
  for_each_tile(work, [&](int b, int tile) {
    hist_tile<kMap>(b, tile, sa_in, ns, lanes, counts, digits, offs, g, N,
                    T);
  });
}

// Inclusive scan of x over a warp with op (sum or max).
template <bool kMax>
__device__ __forceinline__ int warp_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = kMax ? max(x, y) : x + y;
  }
  return x;
}

// Exclusive scan over a block of kBlock threads of each thread's x with
// op; identity is op's neutral value.  A second call needs a
// __syncthreads after the first.
template <bool kMax, int kBlock>
__device__ __forceinline__ int block_exclusive(int x, int identity) {
  constexpr int kParts = kBlock / 32;
  __shared__ int part[kParts];
  const int incl = warp_scan<kMax>(x);
  if ((threadIdx.x & 31) == 31) part[threadIdx.x >> 5] = incl;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int w = threadIdx.x < kParts ? part[threadIdx.x] : identity;
    const int v = warp_scan<kMax>(w);
    const int prev = __shfl_up_sync(kFull, v, 1);
    if (threadIdx.x < kParts)
      part[threadIdx.x] = threadIdx.x == 0 ? identity : prev;
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if ((threadIdx.x & 31) == 0) excl = identity;
  const int carry = part[threadIdx.x >> 5];
  return kMax ? max(carry, excl) : carry + excl;
}

__device__ __forceinline__ int3 add3(int3 a, int3 b) {
  return make_int3(a.x + b.x, a.y + b.y, a.z + b.z);
}

// Exclusive sums of three counts at once over a block of kBlock
// threads; *total gets the block's sums.  A second call needs a
// __syncthreads after the first.
template <int kBlock>
__device__ __forceinline__ int3 block_exclusive3(int3 x, int3* total) {
  constexpr int kParts = kBlock / 32;
  __shared__ int3 part[kParts + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int3 incl = make_int3(warp_scan<false>(x.x), warp_scan<false>(x.y),
                              warp_scan<false>(x.z));
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int3 w = threadIdx.x < kParts ? part[threadIdx.x]
                                        : make_int3(0, 0, 0);
    const int3 v = make_int3(warp_scan<false>(w.x), warp_scan<false>(w.y),
                             warp_scan<false>(w.z));
    if (threadIdx.x < kParts)
      part[threadIdx.x] = make_int3(v.x - w.x, v.y - w.y, v.z - w.z);
    if (threadIdx.x == 31) part[kParts] = v;
  }
  __syncthreads();
  *total = part[kParts];
  const int3 c = part[warp];
  return make_int3(c.x + incl.x - x.x, c.y + incl.y - x.y,
                   c.z + incl.z - x.z);
}

// radix_scan: a warp per (row, digit) turns that digit's counts over the
// tiles that hold lanes into their exclusive prefix sums in place, 32
// tiles at a time, and writes the digit's total; the scatter adds the
// totals of the digits below (digit major order).
__global__ void __launch_bounds__(kThreads)
radix_scan(const int* __restrict__ lanes, int* __restrict__ counts,
           int* __restrict__ totals, int B, int N, int T) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * kRadix) return;
  const int tiles = (row_n(lanes, w / kRadix, N) + kTile - 1) / kTile;
  int* c = counts + static_cast<size_t>(w) * T;
  int run = 0;
  for (int i0 = 0; i0 < tiles; i0 += 32) {
    const int i = i0 + lane;
    const int v = i < tiles ? c[i] : 0;
    const int incl = warp_scan<false>(v);
    if (i < tiles) c[i] = run + incl - v;
    run += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) totals[w] = run;
}

// Where a stable digit-pass scatter puts the lanes of one tile: it
// zeroes at[][], counts each warp's lanes of each digit from the digits
// d (kRadix a dead lane; the peers kept in shared memory), and turns
// at[w][digit] into the slot of warp w's first lane of that digit.
struct ScatterPlan {
  int (*at)[kRadix];
  unsigned (*peers)[kThreads];
};

__device__ __forceinline__ void plan_scatter(
    const ScatterPlan& s, int b, int tile, const int (&d)[kRounds],
    const int* __restrict__ offsets, const int* __restrict__ totals, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&s.at[0][0])[i] = 0;
  // where each digit starts in the row: the totals of the digits below
  const int below_digits = block_exclusive<false, kThreads>(
      totals[static_cast<size_t>(b) * kRadix + threadIdx.x], 0);
  // this warp's count of each digit
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned m = peers_of(d[r]);
    s.peers[r][threadIdx.x] = m;
    if (d[r] < kRadix && lane == __ffs(m) - 1) s.at[warp][d[r]] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  {  // a thread a digit: where each warp's lanes of it start
    const int dig = threadIdx.x;
    int run = below_digits +
              offsets[(static_cast<size_t>(b) * kRadix + dig) * T + tile];
    for (int w = 0; w < kWarps; ++w) {
      const int c = s.at[w][dig];
      s.at[w][dig] = run;
      run += c;
    }
  }
  __syncthreads();
}

// radix_scatter: the stable scatter of one tile's lanes < lanes[b] by
// digit.
__device__ __forceinline__ void scatter_tile(
    int b, int tile, const int* __restrict__ sa_in,
    const int* __restrict__ lanes, const int* __restrict__ offsets,
    const int* __restrict__ totals, const unsigned char* __restrict__ digits,
    int* __restrict__ sa_out, int N, int T) {
  __shared__ int at[kWarps][kRadix];
  __shared__ unsigned peers[kRounds][kThreads];  // kept out of registers
  const int n = row_n(lanes, b, N);
  const int t0 = tile * kTile;
  if (t0 >= n) return;
  const size_t base = static_cast<size_t>(b) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = t0 + warp * kWarpSpan;
  int p[kRounds], d[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int t = w0 + r * 32 + lane;
    p[r] = t < n ? sa_in[base + t] : 0;
    d[r] = t < n ? digits[base + t] : kRadix;
  }
  plan_scatter({at, peers}, b, tile, d, offsets, totals, T);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool live = d[r] < kRadix;
    const unsigned m = peers[r][threadIdx.x];
    if (live) sa_out[base + at[warp][d[r]] + __popc(m & below)] = p[r];
    __syncwarp();
    if (live && lane == __ffs(m) - 1) at[warp][d[r]] += __popc(m);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
radix_scatter(const int* __restrict__ sa_in, const int* __restrict__ lanes,
              Work work, const int* __restrict__ offsets,
              const int* __restrict__ totals,
              const unsigned char* __restrict__ digits,
              int* __restrict__ sa_out, int N, int T) {
  for_each_tile(work, [&](int b, int tile) {
    scatter_tile(b, tile, sa_in, lanes, offsets, totals, digits, sa_out, N,
                 T);
  });
}

// ---- the seed's key-carrying digit passes --------------------------------

// The payload of a key-carrying sort: two int32 planes (B, N), a key
// word and a value moving together: round 0 carries (W0, p), rounds 1
// to 3 (W_r, u), u the lane's place in its region before the sort.  A
// null key plane reads (W0, p) from the rows.
struct Planes {
  int* key;
  int* val;
};

// The digit of a key-carrying pass: bits shift.. of the key or, where
// seg is given, of seg[u] (the index of the run that region lane u
// belongs to).
struct Digit {
  int shift;
  const int* seg;
};

template <bool kCyc>
__device__ __forceinline__ int2 load_payload(const Planes& in,
                                             const unsigned char* blocks,
                                             size_t base, int t, int n) {
  return in.key ? make_int2(in.key[base + t], in.val[base + t])
                : make_int2(
                      static_cast<int>(word_at<kCyc>(blocks, base, t, n)), t);
}

__device__ __forceinline__ int digit_of(const Digit& g, size_t base, int2 v) {
  const unsigned x = static_cast<unsigned>(g.seg ? g.seg[base + v.y] : v.x);
  return (x >> g.shift) & (kRadix - 1);
}

// The digit of lane t, reading only the word it needs.
template <bool kCyc>
__device__ __forceinline__ int digit_at(const Planes& in,
                                        const unsigned char* blocks,
                                        size_t base, int t, int n,
                                        const Digit& g) {
  unsigned x;
  if (!in.key)
    x = word_at<kCyc>(blocks, base, t, n);
  else if (g.seg)
    x = static_cast<unsigned>(g.seg[base + in.val[base + t]]);
  else
    x = static_cast<unsigned>(in.key[base + t]);
  return (x >> g.shift) & (kRadix - 1);
}

// kv_hist: counts[b][digit][tile] of the lanes < lanes[b] of one tile,
// each warp adding its lanes one by one to a histogram of its own (the
// scatter needs each lane's peers; the counts do not).
template <bool kCyc>
__global__ void __launch_bounds__(kThreads)
kv_hist(Planes in, const unsigned char* __restrict__ blocks,
        const int* __restrict__ lanes, Work work, int* __restrict__ counts,
        Digit g, int N, int T) {
  __shared__ int h[kWarps][kRadix];
  for_each_tile(work, [&](int b, int tile) {
    const int nl = row_n(lanes, b, N);
    const size_t base = static_cast<size_t>(b) * N;
    const int t0 = tile * kTile;
    if (t0 >= nl) return;
    for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
      (&h[0][0])[i] = 0;
    __syncthreads();
    int d[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      d[r] = t < nl ? digit_at<kCyc>(in, blocks, base, t, nl, g) : kRadix;
    }
    int* mine = h[threadIdx.x >> 5];
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (d[r] < kRadix) atomicAdd(&mine[d[r]], 1);
    __syncthreads();
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += h[w][threadIdx.x];
    counts[(static_cast<size_t>(b) * kRadix + threadIdx.x) * T + tile] = c;
  });
}

// Shared memory a key-carrying scatter stages a tile in: the keys and
// the values of kTile places, then a digit a place.
constexpr size_t kStageSmem = 2 * kTile * sizeof(int) + kTile;

// kv_scatter: the stable scatter of one tile's payloads by digit.  The
// tile is first put in its sorted order in shared memory, so that each
// digit's lanes go out as one contiguous run of whole sectors.  A lane's
// digits wait in shared memory (a byte each) and its peers are matched
// again where they are used, so that the key and the value (kept in two
// arrays of registers) leave room for 3 blocks an SM with no spill.
template <bool kCyc>
__device__ __forceinline__ void kv_scatter_tile(
    int b, int tile, const Planes& in, const unsigned char* __restrict__ blocks,
    const int* __restrict__ lanes, const int* __restrict__ offsets,
    const int* __restrict__ totals, const Planes& out, const Digit& g, int N,
    int T) {
  extern __shared__ int stage[];
  __shared__ int at[kWarps][kRadix];
  __shared__ int delta[kRadix];  // a digit's row slot less its tile slot
  __shared__ unsigned char din[kRounds][kThreads];  // each lane's digit
  unsigned char* digs = reinterpret_cast<unsigned char*>(stage + 2 * kTile);
  const int n = row_n(lanes, b, N);
  const int t0 = tile * kTile;
  if (t0 >= n) return;
  const size_t base = static_cast<size_t>(b) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = t0 + warp * kWarpSpan;
  int vk[kRounds], vv[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int t = w0 + r * 32 + lane;
    vk[r] = vv[r] = 0;
    if (t < n) {
      const int2 v = load_payload<kCyc>(in, blocks, base, t, n);
      vk[r] = v.x;
      vv[r] = v.y;
      din[r][threadIdx.x] = static_cast<unsigned char>(digit_of(g, base, v));
    }
  }
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&at[0][0])[i] = 0;
  // where each digit starts in the row: the totals of the digits below
  const int below_digits = block_exclusive<false, kThreads>(
      totals[static_cast<size_t>(b) * kRadix + threadIdx.x], 0);
  // this warp's count of each digit (the hardware's match: a little
  // faster here than peers_of's ballots)
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int d = w0 + r * 32 + lane < n ? din[r][threadIdx.x] : kRadix;
    const unsigned m = __match_any_sync(kFull, d);
    if (d < kRadix && lane == __ffs(m) - 1) at[warp][d] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  {  // a thread a digit: where it starts in the tile and in the row, and
     // where each warp's lanes of it start in the tile
    const int dig = threadIdx.x;
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += at[w][dig];
    const int local = block_exclusive<false, kThreads>(c, 0);
    delta[dig] = below_digits +
                 offsets[(static_cast<size_t>(b) * kRadix + dig) * T + tile] -
                 local;
    int run = local;
    for (int w = 0; w < kWarps; ++w) {
      const int cw = at[w][dig];
      at[w][dig] = run;
      run += cw;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int d = w0 + r * 32 + lane < n ? din[r][threadIdx.x] : kRadix;
    const bool live = d < kRadix;
    const unsigned m = __match_any_sync(kFull, d);
    if (live) {
      const int k = at[warp][d] + __popc(m & below);
      stage[k] = vk[r];
      stage[kTile + k] = vv[r];
      digs[k] = static_cast<unsigned char>(d);
    }
    __syncwarp();
    if (live && lane == __ffs(m) - 1) at[warp][d] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  const int here = min(kTile, n - t0);
  for (int k = threadIdx.x; k < here; k += kThreads) {
    const size_t to = base + k + delta[digs[k]];
    out.key[to] = stage[k];
    out.val[to] = stage[kTile + k];
  }
}

template <bool kCyc>
__global__ void __launch_bounds__(kThreads, 3)
kv_scatter(Planes in, const unsigned char* __restrict__ blocks,
           const int* __restrict__ lanes, Work work,
           const int* __restrict__ offsets, const int* __restrict__ totals,
           Planes out, Digit g, int N, int T) {
  for (int i = work_first(work); i < work_items(work); i += work_step(work)) {
    const int2 bt = work_item(work, i);
    kv_scatter_tile<kCyc>(bt.x, bt.y, in, blocks, lanes, offsets, totals, out,
                          g, N, T);
    __syncthreads();  // the shared memory of the next item
  }
}

// ---- ranks from sorted lanes ----------------------------------------------

// The key tuple of position p < n of row b: the pass's kKeys mapped
// keys.
template <int kKeys, int kMap>
__device__ __forceinline__ void keys_of(const int* isa, const Offsets& offs,
                                        int b, size_t base, int p, int n,
                                        int N, int* key) {
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
    key[j] = pass_key<kMap>(isa, base, p, key_offset<kMap>(offs, j, b), n, N);
}

// Calls f(b, tile) for the 256-lane rank tiles of the block's items: a
// full grid's block takes one each (every tile of the row to N when
// kWholeRow); a region L item is a 4096-lane tile, 16 rank tiles, those
// below lanes[b].
template <bool kWholeRow, class Fn>
__device__ __forceinline__ void for_each_rank_tile(const Work& work,
                                                   const int* lanes, int N,
                                                   Fn f) {
  for (int i = work_first(work); i < work_items(work); i += work_step(work)) {
    const int2 bt = work_item(work, i);
    const int nl = row_n(lanes, bt.x, N);
    const int subs = work.items ? kTile / kThreads : 1;
    for (int j = 0; j < subs; ++j) {
      const int tile = bt.y * subs + j;
      if (!kWholeRow && tile * kThreads >= nl) break;
      f(bt.x, tile);
      __syncthreads();  // the shared parts of the next tile
    }
  }
}

// Start flags and the tile's last start slot, from each lane's key tuple
// (a dead lane's is never read): flags[t] = 1 at a class start of a live
// lane t < nl (0 for a live lane that is none), agg[b][tile] the tile's
// last start slot or -1.  load(t, key) fills lane t's kKeys keys.
// Returns whether lane t starts a class.
template <int kKeys, class Load>
__device__ __forceinline__ bool start_flags(int b, int tile, int nl,
                                            unsigned char* flags, int* agg,
                                            size_t base, int T2,
                                            const Load& load) {
  __shared__ int part[kWarps];
  const int t = tile * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = t < nl;
  int key[kKeys], prev[kKeys];
#pragma unroll
  for (int i = 0; i < kKeys; ++i) key[i] = 0;
  if (live) load(t, key);
#pragma unroll
  for (int i = 0; i < kKeys; ++i) prev[i] = __shfl_up_sync(kFull, key[i], 1);
  if (live && lane == 0 && t > 0) load(t - 1, prev);
  bool start = t == 0;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) start |= key[i] != prev[i];
  start &= live;
  if (live) flags[base + t] = start ? 1 : 0;
  int s = start ? t : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = max(s, __shfl_xor_sync(kFull, s, o));
  if (lane == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
    for (int w = 0; w < kWarps; ++w) m = max(m, part[w]);
    agg[static_cast<size_t>(b) * T2 + tile] = m;
  }
  return start;
}

// rank_flags: a pass's region L, per sorted lane t < lanes[b], 1 at a
// class start (its keys, gathered again, differ from lane t - 1's);
// agg[b][tile] the tile's last start slot, or -1.  (start_flags does the
// same for the seed's keys; given the pass's 8 gathered keys, ptxas
// spilled it at 32 registers.)
template <int kKeys, int kMap>
__device__ __forceinline__ void flags_tile(
    int b, int tile, const int* __restrict__ sa, const int* __restrict__ ns,
    const int* __restrict__ lanes, const int* __restrict__ isa,
    const Offsets& offs, unsigned char* __restrict__ flags,
    int* __restrict__ agg, int N, int T2) {
  __shared__ int part[kWarps];
  const int n = row_n(ns, b, N), nl = row_n(lanes, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t = tile * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = t < nl;
  int key[kKeys], prev[kKeys];
#pragma unroll
  for (int i = 0; i < kKeys; ++i) key[i] = 0;
  if (live) keys_of<kKeys, kMap>(isa, offs, b, base, sa[base + t], n, N, key);
#pragma unroll
  for (int i = 0; i < kKeys; ++i)
    prev[i] = __shfl_up_sync(kFull, key[i], 1);
  if (live && lane == 0 && t > 0)
    keys_of<kKeys, kMap>(isa, offs, b, base, sa[base + t - 1], n, N, prev);
  bool start = t == 0;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) start |= key[i] != prev[i];
  if (t < N) flags[base + t] = live && start ? 1 : 0;
  int s = live && start ? t : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = max(s, __shfl_xor_sync(kFull, s, o));
  if (lane == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
    for (int w = 0; w < kWarps; ++w) m = max(m, part[w]);
    agg[static_cast<size_t>(b) * T2 + tile] = m;
  }
}

template <int kKeys, int kMap>
__global__ void __launch_bounds__(kThreads)
rank_flags(const int* __restrict__ sa, const int* __restrict__ ns,
           const int* __restrict__ lanes, Work work,
           const int* __restrict__ isa, Offsets offs,
           unsigned char* __restrict__ flags, int* __restrict__ agg, int N,
           int T2) {
  for_each_rank_tile<false>(work, lanes, N, [&](int b, int tile) {
    flags_tile<kKeys, kMap>(b, tile, sa, ns, lanes, isa, offs, flags, agg, N,
                            T2);
  });
}

// rank_carry: one block a row; agg becomes its exclusive max-scan over
// the tiles that hold lanes (the last start slot before each tile).
__global__ void __launch_bounds__(kScanThreads)
rank_carry(const int* __restrict__ lanes, int* __restrict__ agg, int N,
           int T2) {
  int* a = agg + static_cast<size_t>(blockIdx.x) * T2;
  const int tiles = (row_n(lanes, blockIdx.x, N) + kThreads - 1) / kThreads;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int hi = min(lo + per, tiles);
  int m = -1;
  for (int i = lo; i < hi; ++i) m = max(m, a[i]);
  int run = block_exclusive<true, kScanThreads>(m, -1);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run = max(run, v);
  }
}

// The rank of lane t < nl of a rank tile: the slot of the last class
// start at or before it (from flags and the tile's carry), whether its
// class has two or more lanes and whether it is the class's last, and
// the block's count of such lanes added to cnt[b] (when cnt is given).
struct Rank {
  int first;
  bool open;
  bool end;  // the lane is its class's last
};

__device__ __forceinline__ Rank rank_of(int b, int tile, int nl,
                                        const unsigned char* flags,
                                        const int* carry, int* cnt,
                                        size_t base, int T2) {
  __shared__ int part[kWarps], tally[kWarps];
  const int t = tile * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = t < nl;
  const bool start = live && (flags[base + t] & 1);
  const int incl = warp_scan<true>(start ? t : -1);
  if (lane == 31) part[warp] = incl;
  const bool end = t == nl - 1 || (t + 1 < nl && (flags[base + t + 1] & 1));
  const bool open = live && !(start && end);
  const int ones = __popc(__ballot_sync(kFull, open));
  if (lane == 0) tally[warp] = ones;
  __syncthreads();
  int rank = max(incl, carry[static_cast<size_t>(b) * T2 + tile]);
  for (int w = 0; w < warp; ++w) rank = max(rank, part[w]);
  if (cnt && threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += tally[w];
    if (c) atomicAdd(&cnt[b], c);
  }
  return {rank, open, end};
}

// rank_write: a pass's region L in place, S[v] + the sub-class's first
// slot - the class's first slot F[v] (v read from the lane itself
// first).
__global__ void __launch_bounds__(kThreads)
rank_write(const int* __restrict__ sa, const int* __restrict__ lanes,
           Work work, const unsigned char* __restrict__ flags,
           const int* __restrict__ carry, const int* __restrict__ S,
           const int* __restrict__ F, int* __restrict__ isa,
           int* __restrict__ cnt, int N, int T2) {
  for_each_rank_tile<false>(work, lanes, N, [&](int b, int tile) {
    const int nl = row_n(lanes, b, N);
    const size_t base = static_cast<size_t>(b) * N;
    const Rank r = rank_of(b, tile, nl, flags, carry, cnt, base, T2);
    const int t = tile * kThreads + threadIdx.x;
    if (t < nl) {
      const int p = sa[base + t];
      const int v = isa[base + p];
      isa[base + p] = S[static_cast<size_t>(b) * (N + 1) + v] + r.first -
                      F[base + v];
    }
  });
}

// ---- the segmented pass ---------------------------------------------------

// Per-row state of a pass, B entries each.
struct Rows {
  int* act;    // lanes the pass works on: n, or 0 for a skipped row
  int* nA;     // lanes of region A (classes of 2 to kLarge lanes)
  int* nL;     // lanes of region L (classes above kLarge)
  int* remap;  // 1 when a lone lane's S[v] differs from its v
  int* woff;   // the row's first item in the work list
};

struct Seg {
  int* S;         // (B, N + 1): valid lanes below each value, S[N] = n
  int* F;         // (B, N): a class's dense end, then (compact) its start
  int* pos;       // (B, N): region L's lanes, then region A's
  int* keys;      // (B, N, 8): region A's keys 0 to 7 (a 4-key pass's 4
                  // to 7 are 0), by dense slot
  int* tiles;     // (B, T, 3): the scan's tile sums, then their prefixes
  int* mcount;    // (kBins + 1): entries of each block bin's list, then
                  // of the work list
  int2* list[kBins];  // (row, v) of each class of a block bin
  int2* work;     // (B * T): region L's (row, tile of 4096 lanes) items
  Rows rows;
};

// The three sums a value's count adds to: all lanes, region A's, L's.
__device__ __forceinline__ int3 tri(int c) {
  return make_int3(c, (c >= 2 && c <= kLarge) ? c : 0, c > kLarge ? c : 0);
}

__global__ void seg_setup(const int* __restrict__ ns,
                          const int* __restrict__ prev,
                          int* __restrict__ cnt, int* __restrict__ passes,
                          Rows rows, int* __restrict__ mcount, Offsets offs,
                          int* __restrict__ row_off, int B, int N) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const bool work = prev == nullptr || prev[b] > 0;
    const int n = row_n(ns, b, N);
    rows.act[b] = work ? n : 0;
    rows.remap[b] = 0;
    cnt[b] = 0;
    if (passes && work) passes[b] += 1;
    if (row_off)  // a cyclic pass: its key offsets, j k mod n
      for (int j = 0; j < kMaxKeys; ++j)
        row_off[b * kMaxKeys + j] =
            n > 0 ? static_cast<int>(offs.jk[j] % n) : 0;
  }
  if (threadIdx.x < kBins) mcount[threadIdx.x] = 0;
}

// Region L's (row, tile) items, row after row, and their count after the
// block bins' (the radix route's Work); one block.
__device__ __forceinline__ void work_list(const Seg& s, int B) {
  if (threadIdx.x == 0) {
    int at = 0;
    for (int b = 0; b < B; ++b) {
      s.rows.woff[b] = at;
      at += (s.rows.nL[b] + kTile - 1) / kTile;
    }
    s.mcount[kBins] = at;
  }
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    const int tiles = (s.rows.nL[b] + kTile - 1) / kTile, at = s.rows.woff[b];
    for (int t = threadIdx.x; t < tiles; t += blockDim.x)
      s.work[at + t] = make_int2(b, t);
  }
}

__global__ void seg_work(Seg s, int B) { work_list(s, B); }

// seg_hist: counts[b][v] += the valid lanes of a tile whose ISA is v;
// a warp whose lanes hold one v adds once (the deep repeats' runs).
__global__ void __launch_bounds__(kThreads)
seg_hist(const int* __restrict__ isa, const int* __restrict__ act,
         int* __restrict__ counts, int N) {
  const int b = blockIdx.y, a = act[b];
  const int t0 = blockIdx.x * kTile;
  if (t0 >= a) return;
  const size_t base = static_cast<size_t>(b) * N;
  const int lane = threadIdx.x & 31;
  int vs[kRounds];  // the tile's loads first: in flight together
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int t = t0 + r * kThreads + threadIdx.x;
    vs[r] = t < a ? isa[base + t] : -1;
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int v = vs[r];
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(N)) v = -1;
    const int v0 = __shfl_sync(kFull, v, 0);
    if (__all_sync(kFull, v == v0)) {
      if (lane == 0 && v0 >= 0) atomicAdd(&counts[base + v0], 32);
    } else if (v >= 0) {
      atomicAdd(&counts[base + v], 1);
    }
  }
}

// seg_scan_tiles: the three sums of a tile of 4096 values.
__global__ void __launch_bounds__(kThreads)
seg_scan_tiles(const int* __restrict__ counts, Seg s, int N, int T) {
  const int tile = blockIdx.x, b = blockIdx.y;
  if (s.rows.act[b] == 0) return;
  const size_t base = static_cast<size_t>(b) * N;
  int3 sum = make_int3(0, 0, 0);
  for (int r = 0; r < kRounds; ++r) {
    const int v = tile * kTile + r * kThreads + threadIdx.x;
    sum = add3(sum, tri(v < N ? counts[base + v] : 0));
  }
  int3 total;
  block_exclusive3<kThreads>(sum, &total);
  if (threadIdx.x == 0) {
    int* o = s.tiles + (static_cast<size_t>(b) * T + tile) * 3;
    o[0] = total.x;
    o[1] = total.y;
    o[2] = total.z;
  }
}

// seg_scan_carry: one block a row; the tiles' sums become their
// exclusive prefixes; the row's region sizes and S[N] = n.
__global__ void __launch_bounds__(kScanThreads)
seg_scan_carry(Seg s, int N, int T) {
  const int b = blockIdx.x;
  if (s.rows.act[b] == 0) {
    if (threadIdx.x == 0) s.rows.nA[b] = s.rows.nL[b] = 0;
    return;
  }
  int* t3 = s.tiles + static_cast<size_t>(b) * T * 3;
  const int per = (T + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, T);
  const int hi = min(lo + per, T);
  int3 m = make_int3(0, 0, 0);
  for (int i = lo; i < hi; ++i)
    m = add3(m, make_int3(t3[3 * i], t3[3 * i + 1], t3[3 * i + 2]));
  int3 total;
  int3 run = block_exclusive3<kScanThreads>(m, &total);
  for (int i = lo; i < hi; ++i) {
    const int3 v = make_int3(t3[3 * i], t3[3 * i + 1], t3[3 * i + 2]);
    t3[3 * i] = run.x;
    t3[3 * i + 1] = run.y;
    t3[3 * i + 2] = run.z;
    run = add3(run, v);
  }
  if (threadIdx.x == 0) {
    s.rows.nA[b] = total.y;
    s.rows.nL[b] = total.z;
    s.S[static_cast<size_t>(b) * (N + 1) + N] = total.x;
  }
}

// The block bin (0, 1 or 2) of a class of c lanes, or -1 (lone, up to
// kSmall, or above kLarge).
__device__ __forceinline__ int block_bin(int c) {
  return c <= kSmall || c > kLarge ? -1
         : c <= kBinCap0           ? 0
         : c <= kBinCap1           ? 1
                                   : 2;
}

// Appends (b, v) of each lane whose bin is not -1 to that block bin's
// list, a warp's lanes of one bin with one atomic (every lane calls it).
__device__ __forceinline__ void list_append(int bin, int b, int v,
                                            int2* const* list, int* mcount) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kBins; ++i) {
    const unsigned m = __ballot_sync(kFull, bin == i);
    if (!m) continue;
    const int leader = __ffs(m) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(&mcount[i], __popc(m));
    at = __shfl_sync(kFull, at, leader);
    if (bin == i) list[i][at + __popc(m & below)] = make_int2(b, v);
  }
}

// seg_scan_apply: S[v], each tied class's dense end in F[v] (region L
// from 0, region A from nL), the block bins' lists, the remap flag, and
// count[v] back to 0.
__global__ void __launch_bounds__(kThreads)
seg_scan_apply(int* __restrict__ counts, Seg s, int N, int T) {
  const int tile = blockIdx.x, b = blockIdx.y;
  if (s.rows.act[b] == 0) return;
  const size_t base = static_cast<size_t>(b) * N;
  const size_t bS = static_cast<size_t>(b) * (N + 1);
  const int* t3 = s.tiles + (static_cast<size_t>(b) * T + tile) * 3;
  int3 run = make_int3(t3[0], t3[1], t3[2]);
  const int L = s.rows.nL[b];
  for (int r = 0; r < kRounds; ++r) {
    __syncthreads();  // the scan's shared parts of the round before
    const int v = tile * kTile + r * kThreads + threadIdx.x;
    const int c = v < N ? counts[base + v] : 0;
    int3 total;
    const int3 e = add3(block_exclusive3<kThreads>(tri(c), &total), run);
    if (v < N) {
      s.S[bS + v] = e.x;
      if (c) counts[base + v] = 0;
      if (c >= 2) s.F[base + v] = (c > kLarge ? e.z : L + e.y) + c;
      if (c == 1 && e.x != v) s.rows.remap[b] = 1;
    }
    list_append(block_bin(c), b, v, s.list, s.mcount);
    run = add3(run, total);
  }
}

// seg_compact: each tied lane p to its class's dense range (a warp whose
// lanes are all of one class takes 32 slots at once), and region A's
// keys 0 to kKeys - 1 of it.
template <int kKeys, int kMap>
__global__ void __launch_bounds__(kThreads)
seg_compact(const int* __restrict__ isa, Seg s, Offsets offs, int N) {
  const int b = blockIdx.y, a = s.rows.act[b];
  const int t0 = blockIdx.x * kTile;
  if (t0 >= a) return;
  const size_t base = static_cast<size_t>(b) * N;
  const size_t bS = static_cast<size_t>(b) * (N + 1);
  const int lane = threadIdx.x & 31;
  const auto key = [&](int j, int p) {
    return pass_key<kMap>(isa, base, p, key_offset<kMap>(offs, j, b), a, N);
  };
  int vs[kRounds], cs[kRounds];  // the tile's loads first: in flight together
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = t0 + r * kThreads + threadIdx.x;
    vs[r] = p < a ? isa[base + p] : -1;
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool ok = static_cast<unsigned>(vs[r]) < static_cast<unsigned>(N);
    cs[r] = ok ? s.S[bS + vs[r] + 1] - s.S[bS + vs[r]] : 0;
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = t0 + r * kThreads + threadIdx.x;
    const int v = vs[r], c = cs[r];
    const bool tied = c >= 2;
    const int v0 = __shfl_sync(kFull, tied ? v : -1, 0);
    int slot;
    if (__all_sync(kFull, tied && v == v0)) {
      int end = 0;
      if (lane == 0) end = atomicSub(&s.F[base + v], 32);
      slot = __shfl_sync(kFull, end, 0) - 1 - lane;
    } else if (tied) {
      slot = atomicSub(&s.F[base + v], 1) - 1;
    } else {
      continue;
    }
    s.pos[base + slot] = p;
    if (c <= kLarge) {
      int4* kp = reinterpret_cast<int4*>(s.keys + (base + slot) * 8);
      kp[0] = make_int4(v, key(1, p), key(2, p), key(3, p));
      if constexpr (kKeys == 8)
        kp[1] = make_int4(key(4, p), key(5, p), key(6, p), key(7, p));
      else  // the block sorts compare 7 keys: 4 to 7 equal
        kp[1] = make_int4(0, 0, 0, 0);
    }
  }
}

// seg_remap (rows whose lone lanes moved, after the seed): ISA = S[v].
__global__ void __launch_bounds__(kThreads)
seg_remap(int* __restrict__ isa, Seg s, int N) {
  const int b = blockIdx.y, a = s.rows.act[b];
  const int t0 = blockIdx.x * kTile;
  if (t0 >= a || !s.rows.remap[b]) return;
  const size_t base = static_cast<size_t>(b) * N;
  const size_t bS = static_cast<size_t>(b) * (N + 1);
  for (int r = 0; r < kRounds; ++r) {
    const int p = t0 + r * kThreads + threadIdx.x;
    if (p >= a) break;
    const int v = isa[base + p];
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(N)) continue;
    const int s0 = s.S[bS + v];
    if (s.S[bS + v + 1] - s0 == 1) isa[base + p] = s0;
  }
}

// -1, 0 or 1 as keys 1 to 7 of (a0, a1) compare with those of (b0, b1).
__device__ __forceinline__ int cmp7(int4 a0, int4 a1, int4 b0, int4 b1) {
  const int a[7] = {a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const int c[7] = {b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int j = 0; j < 7; ++j)
    if (a[j] != c[j]) return a[j] < c[j] ? -1 : 1;
  return 0;
}

// Adds the block's open lanes to cnt[b] (every thread calls it).
__device__ __forceinline__ void add_open(int open, int* cnt, int b) {
  const int w = __reduce_add_sync(kFull, open);
  if ((threadIdx.x & 31) == 0 && w) atomicAdd(&cnt[b], w);
}

// seg_small: a thread a lane of region A; a lane of a class of at most
// kSmall lanes counts the lanes of its class with smaller keys and with
// equal ones.  Four rounds' loads go out before their loops.
__global__ void __launch_bounds__(kThreads)
seg_small(int* __restrict__ isa, Seg s, int* __restrict__ cnt, int N) {
  constexpr int kAhead = 4;
  const int b = blockIdx.y;
  const int L = s.rows.nL[b], end = L + s.rows.nA[b];
  const int t0 = L + blockIdx.x * kTile;
  if (t0 >= end) return;
  const size_t base = static_cast<size_t>(b) * N;
  const size_t bS = static_cast<size_t>(b) * (N + 1);
  const int4* keys = reinterpret_cast<const int4*>(s.keys);
  int open = 0;
  for (int r0 = 0; r0 < kRounds; r0 += kAhead) {
    int4 m0[kAhead], m1[kAhead];
    int s0[kAhead], c[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int t = t0 + (r0 + q) * kThreads + threadIdx.x;
      c[q] = 0;
      if (t < end) {
        m0[q] = keys[(base + t) * 2];
        m1[q] = keys[(base + t) * 2 + 1];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int t = t0 + (r0 + q) * kThreads + threadIdx.x;
      if (t < end) {
        s0[q] = s.S[bS + m0[q].x];
        c[q] = s.S[bS + m0[q].x + 1] - s0[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c[q] < 2 || c[q] > kSmall) continue;
      const int t = t0 + (r0 + q) * kThreads + threadIdx.x;
      const int first = s.F[base + m0[q].x];
      int less = 0, equal = 0;
      for (int u = first; u < first + c[q]; ++u) {
        const int k = cmp7(keys[(base + u) * 2], keys[(base + u) * 2 + 1],
                           m0[q], m1[q]);
        less += k < 0;
        equal += k == 0;
      }
      isa[base + s.pos[base + t]] = s0[q] + less;
      open += equal > 1;
    }
  }
  add_open(open, cnt, b);
}

// The classes a block bin ranks.  The pass's: v a value of the ISA, its
// rank base S[v], its size, its dense range from F[v], keys 1 to 7 (all
// below 2N; a 4-key pass's keys 4 to 7 are 0).  The seed's (SeedClasses,
// below): v a run's first slot.
struct PassClasses {
  static constexpr int kKeys = 7;
  // threads a block and blocks an SM of the bins of 256, 1024 and 4096
  // lanes (ptxas spilled the last at 32 registers)
  static constexpr int kBlock[kBins] = {128, 256, 1024};
  static constexpr int kPerSm[kBins] = {16, 4, 1};
  Seg s;
  int N;
  // (rank base, size, first dense slot) of class v of row b
  __device__ __forceinline__ int3 at(int b, int v) const {
    const size_t bS = static_cast<size_t>(b) * (N + 1);
    const int s0 = s.S[bS + v];
    return make_int3(s0, s.S[bS + v + 1] - s0,
                     s.F[static_cast<size_t>(b) * N + v]);
  }
  __device__ __forceinline__ void load(int b, int slot, unsigned* k) const {
    const int4* keys = reinterpret_cast<const int4*>(s.keys);
    const size_t i = (static_cast<size_t>(b) * N + slot) * 2;
    const int4 k0 = keys[i], k1 = keys[i + 1];
    const int v[kKeys] = {k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
    for (int j = 0; j < kKeys; ++j) k[j] = static_cast<unsigned>(v[j]);
  }
  __device__ __forceinline__ int lane(int b, int slot) const {
    return s.pos[static_cast<size_t>(b) * N + slot];
  }
};

template <int kCap, int kKeys>
__device__ __forceinline__ bool slot_greater(const unsigned* kk, int a,
                                             int c) {
  if (a == kSentinel || c == kSentinel) return a == kSentinel && c != kSentinel;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const unsigned x = kk[j * kCap + a], y = kk[j * kCap + c];
    if (x != y) return x > y;
  }
  return false;
}

template <int kCap, int kKeys>
__device__ __forceinline__ bool slot_differs(const unsigned* kk, int a,
                                             int c) {
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
    if (kk[j * kCap + a] != kk[j * kCap + c]) return true;
  return false;
}

template <int kCap, int kKeys>
constexpr size_t block_smem() {
  return kKeys * kCap * sizeof(unsigned) + kCap * sizeof(unsigned short);
}

// seg_block: a block a class of the list's entries *from (0 when from
// is null) to *entries (kCap / 2 < size <= kCap, and above kSmall): its
// keys in shared memory (a column a key), its slots sorted by them
// (bitonic, to the next power of two), class starts, the max-scan of the
// start slots, and the ranks.
template <int kCap, int kBlock, int kPerSm, class Classes>
__global__ void __launch_bounds__(kBlock, kPerSm)
seg_block(const int2* __restrict__ list, const int* __restrict__ from,
          const int* __restrict__ entries, int* __restrict__ isa,
          Classes cls, int* __restrict__ cnt, int N) {
  constexpr int kKeys = Classes::kKeys;
  constexpr int kPer = kCap / kBlock;
  static_assert(kPer * kBlock == kCap, "slots spread evenly");
  extern __shared__ unsigned smem[];
  unsigned* kk = smem;
  unsigned short* idx =
      reinterpret_cast<unsigned short*>(smem + kKeys * kCap);
  const int total = *entries;
  for (int e = (from ? *from : 0) + blockIdx.x; e < total; e += gridDim.x) {
    const int2 bv = list[e];
    const int b = bv.x;
    const size_t base = static_cast<size_t>(b) * N;
    const int3 at = cls.at(b, bv.y);
    const int s0 = at.x, c = at.y, first = at.z;
    int p2 = 2;
    while (p2 < c) p2 <<= 1;
    for (int i = threadIdx.x; i < c; i += kBlock) {
      unsigned k[kKeys];
      cls.load(b, first + i, k);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kk[j * kCap + i] = k[j];
    }
    for (int i = threadIdx.x; i < p2; i += kBlock)
      idx[i] = i < c ? static_cast<unsigned short>(i) : kSentinel;
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = threadIdx.x; q < p2 / 2; q += kBlock) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const int a = idx[i], d = idx[i | j];
          if (slot_greater<kCap, kKeys>(kk, a, d) == ((i & k) == 0)) {
            idx[i] = static_cast<unsigned short>(d);
            idx[i | j] = static_cast<unsigned short>(a);
          }
        }
        __syncthreads();
      }
    }
    // sorted slot i < c: a start where its keys differ from slot i - 1's
    const int lo = threadIdx.x * kPer;
    int last = -1;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lo + q;
      if (i < c &&
          (i == 0 || slot_differs<kCap, kKeys>(kk, idx[i], idx[i - 1])))
        last = i;
    }
    int run = block_exclusive<true, kBlock>(last, -1);
    int open = 0;
    bool start = lo < c && (lo == 0 || slot_differs<kCap, kKeys>(
                                           kk, idx[lo], idx[lo - 1]));
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lo + q;
      const bool next =
          i + 1 < c && slot_differs<kCap, kKeys>(kk, idx[i + 1], idx[i]);
      if (i < c) {
        if (start) run = i;
        isa[base + cls.lane(b, first + idx[i])] = s0 + run;
        open += !(start && (i == c - 1 || next));
      }
      start = next;
    }
    add_open(open, cnt, b);
    __syncthreads();  // the shared keys and slots of the next class
  }
}

// ---- the seed ---------------------------------------------------------------

// The seed's buffers, carved from the pass's scratch (the seed runs
// before the pass on the same stream): W0 and the lanes ping-pong in
// (F, sa[0]) and (S, sa[1]); after the first stage cls takes F and
// runlen sa[0]; planes 0 to 2 of the pass's keys hold W1..W3 by slot,
// planes 4 to 7 a round's two payload buffers (its word, the lane's
// place u in its region); a region's lane positions and run indices
// take the pass's pos and S.  Large runs are listed by level: level r
// holds the runs above kLarge lanes that round r found (round 0 by W0,
// round r by W_r inside level r - 1's runs).
struct SeedBufs {
  const unsigned char* blocks;
  const int* ns;
  int* w0[2];    // W0 of the sorted lanes: stage 1's two buffers
  int* sa[2];    // the sorted lanes (positions p): the same; sorted: [1]
  int* cls;      // (B, N): a slot's run, its first slot
  int* runlen;   // (B, N): at a run's first slot its size, -1 - s for
                 // large run s
  int* keys;     // 8 planes (B, N)
  size_t plane;  // B * N
  int* lpos;     // (B, N): a region's lane u's position
  int* seg;      // (B, N): a region's lane u's run index
  int B;
  int segcap;    // the most runs above kLarge a row holds, N / (kLarge + 1)
  unsigned long long* ctr;  // (3, B): a level's runs << 32 | their lanes
  int* loff;     // (3, B, segcap): a large run's first place in its region
  int* lfirst;   // (3, B, segcap): its first slot
  int* ff;       // (B): the first slot of the run of W0 = FF FF FF FF,
                 // or INT_MAX
  int* snap;     // (kBins): the block bins' list counts after round 0
  int2* list[kBins];
  int* mcount;
  __host__ __device__ __forceinline__ size_t level(int l, int b) const {
    return (static_cast<size_t>(l) * B + b) * segcap;
  }
};

// The seed's block-bin classes: v the first slot of a run, its size
// runlen[v], its slots v .. v + size - 1, words 1 to 3.
struct SeedClasses {
  static constexpr int kKeys = 3;
  // threads a block and blocks an SM of the bins: 2048 threads an SM at
  // 32 registers, in blocks half the pass's (faster on the seed's many
  // small runs)
  static constexpr int kBlock[kBins] = {64, 128, 512};
  static constexpr int kPerSm[kBins] = {32, 16, 4};
  const int* runlen;
  const int* keys;
  const int* pos;
  size_t plane;
  int N;
  __device__ __forceinline__ int3 at(int b, int v) const {
    return make_int3(v, runlen[static_cast<size_t>(b) * N + v], v);
  }
  __device__ __forceinline__ void load(int b, int slot, unsigned* k) const {
    const size_t i = static_cast<size_t>(b) * N + slot;
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      k[j] = static_cast<unsigned>(keys[j * plane + i]);
  }
  __device__ __forceinline__ int lane(int b, int slot) const {
    return pos[static_cast<size_t>(b) * N + slot];
  }
};

// A round's payload buffers: planes 4 and 5, or 6 and 7, of the keys.
__host__ __device__ __forceinline__ Planes region(const SeedBufs& sb,
                                                  int which) {
  int* k = sb.keys + (4 + 2 * which) * sb.plane;
  return {k, k + sb.plane};
}

__global__ void seed_setup(SeedBufs sb, int* __restrict__ cnt) {
  for (int b = threadIdx.x; b < sb.B; b += blockDim.x) {
    cnt[b] = 0;
    for (int l = 0; l < kLevels; ++l) sb.ctr[l * sb.B + b] = 0;
    sb.ff[b] = 0x7FFFFFFF;
  }
  if (threadIdx.x < kBins) sb.mcount[threadIdx.x] = 0;
}

// The seed's sorted W0 of lane t.
struct WordAt {
  const int* w0;
  size_t base;
  __device__ __forceinline__ void operator()(int t, int* key) const {
    key[0] = w0[base + t];
  }
};

// seed_flags: run starts of the sorted W0 (flags, agg), and where the
// run of W0 = FF FF FF FF starts.
__global__ void __launch_bounds__(kThreads)
seed_flags(SeedBufs sb, unsigned char* __restrict__ flags,
           int* __restrict__ agg, int N, int T2) {
  const Work grid{nullptr, nullptr};
  for_each_rank_tile<true>(grid, sb.ns, N, [&](int b, int tile) {
    const size_t base = static_cast<size_t>(b) * N;
    const bool start = start_flags<1>(b, tile, row_n(sb.ns, b, N), flags,
                                      agg, base, T2, WordAt{sb.w0[1], base});
    const int t = tile * kThreads + threadIdx.x;
    if (start && static_cast<unsigned>(sb.w0[1][base + t]) == kFull)
      sb.ff[b] = t;
  });
}

// Where round r puts a lane at `slot` (position p, its run's first slot
// `first`; `open`: the run has two or more lanes; `end`: the lane is its
// run's last): a lone lane's rank is its slot; every other lane gathers
// the words its round has not compared, W_{r+1}..W3, into planes r..2 of
// its slot (the planes below, equal in the run, read 0), and the last
// lane routes the run by its size: its size at its first slot and a
// block bin (returned), or level r's large runs (its index and its
// region place from one packed atomic, so places follow indices).
template <bool kCyc>
__device__ __forceinline__ int emit_lane(const SeedBufs& sb, int r, int b,
                                         size_t base, int n, int N, int slot,
                                         int p, int first, bool open,
                                         bool end, int* isa) {
  sb.cls[base + slot] = first;
  if (!open) {
    isa[base + p] = slot;
    sb.runlen[base + slot] = 1;
    return -1;
  }
  unsigned w[kSeedWords - 1];
  words_after<kCyc>(sb.blocks, base, p, n, N, w);
#pragma unroll
  for (int j = 0; j < kSeedWords - 1; ++j)
    sb.keys[j * sb.plane + base + slot] = j < r ? 0 : static_cast<int>(w[j]);
  if (!end) return -1;
  const int c = slot - first + 1;
  if (c <= kLarge) {
    sb.runlen[base + first] = c;
    return block_bin(c);
  }
  const unsigned long long old = atomicAdd(
      &sb.ctr[r * sb.B + b], (1ull << 32) | static_cast<unsigned>(c));
  const int s = static_cast<int>(old >> 32);
  const size_t i = sb.level(r, b) + s;
  sb.loff[i] = static_cast<int>(old & kFull);
  sb.lfirst[i] = first;
  sb.runlen[base + first] = -1 - s;
  return -1;
}

// seed_runs: round 0 over the sorted slots: every slot's run (cls), a
// lone lane's rank, the words of the others, each run to its route;
// ISA 0 at the lanes n .. N - 1.
template <bool kCyc>
__global__ void __launch_bounds__(kThreads)
seed_runs(SeedBufs sb, const unsigned char* __restrict__ flags,
          const int* __restrict__ carry, int* __restrict__ isa, int N,
          int T2) {
  const Work grid{nullptr, nullptr};
  for_each_rank_tile<true>(grid, sb.ns, N, [&](int b, int tile) {
    const int n = row_n(sb.ns, b, N);
    const size_t base = static_cast<size_t>(b) * N;
    // no count here: seed_small, the bins and the last round count
    const Rank r = rank_of(b, tile, n, flags, carry, nullptr, base, T2);
    const int t = tile * kThreads + threadIdx.x;
    int bin = -1;
    if (t < n)
      bin = emit_lane<kCyc>(sb, 0, b, base, n, N, t, sb.sa[1][base + t],
                            r.first, r.open, r.end, isa);
    else if (t < N)
      isa[base + t] = 0;
    list_append(bin, b, r.first, sb.list, sb.mcount);
  });
}

// seed_compact: level l's large runs to round l + 1's region, a block a
// tile of 4096 places (a thread finds its run by a binary search of the
// places, which grow with the index): the run's next word W_{l+1}
// (plane l of its slots) and the lane's place u as the payload, the
// lane's position and its run's index beside it.
__global__ void __launch_bounds__(kThreads)
seed_compact(SeedBufs sb, int l, int N) {
  const int b = blockIdx.y;
  const unsigned long long ctr = sb.ctr[l * sb.B + b];
  const int runs = static_cast<int>(ctr >> 32);
  const int lanes = static_cast<int>(ctr & kFull);
  const int u0 = blockIdx.x * kTile;
  if (u0 >= lanes) return;
  const int* off = sb.loff + sb.level(l, b);
  const int* first = sb.lfirst + sb.level(l, b);
  const size_t base = static_cast<size_t>(b) * N;
  const Planes out = region(sb, 0);
  for (int r = 0; r < kRounds; ++r) {
    const int u = u0 + r * kThreads + threadIdx.x;
    if (u >= lanes) break;
    int lo = 0, hi = runs - 1;  // the last run whose place is <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= u) lo = mid;
      else hi = mid - 1;
    }
    const int t = first[lo] + u - off[lo];
    out.key[base + u] = sb.keys[l * sb.plane + base + t];
    out.val[base + u] = u;
    sb.lpos[base + u] = sb.sa[1][base + t];
    sb.seg[base + u] = lo;
  }
}

// seed_work: a region's lane counts from the level's packed counters,
// then its (row, tile) items; with snap given, the block bins' list
// counts as round 0 left them.
__global__ void seed_work(Seg s, const unsigned long long* __restrict__ ctr,
                          int* __restrict__ snap, int B) {
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    s.rows.nL[b] = static_cast<int>(ctr[b] & kFull);
  if (snap && threadIdx.x < kBins) snap[threadIdx.x] = s.mcount[threadIdx.x];
  __syncthreads();
  work_list(s, B);
}

// A region's key of sorted lane t: (its run, the round's word).
struct RegionKeyAt {
  const Planes& in;
  const int* seg;
  size_t base;
  __device__ __forceinline__ void operator()(int t, int* key) const {
    key[0] = seg[base + in.val[base + t]];
    key[1] = in.key[base + t];
  }
};

// seed_round_flags: a round's class starts, sorted by (run, word).
__global__ void __launch_bounds__(kThreads)
seed_round_flags(Planes in, const int* __restrict__ seg,
                 const int* __restrict__ lanes, Work work,
                 unsigned char* __restrict__ flags, int* __restrict__ agg,
                 int N, int T2) {
  for_each_rank_tile<false>(work, lanes, N, [&](int b, int tile) {
    const size_t base = static_cast<size_t>(b) * N;
    start_flags<2>(b, tile, row_n(lanes, b, N), flags, agg, base, T2,
                   RegionKeyAt{in, seg, base});
  });
}

// seed_round: round r (1 to 3) over its sorted region: each lane's new
// slot, its run's slot plus its place in the run, and its position
// there; rounds 1 and 2 then as round 0 (emit_lane); after round 3 a
// run's lanes agree in all 16 bytes: each takes its run's first slot,
// and the lanes of runs of two or more count.
template <bool kCyc>
__global__ void __launch_bounds__(kThreads)
seed_round(SeedBufs sb, Planes in, int r, const int* __restrict__ lanes,
           Work work, const unsigned char* __restrict__ flags,
           const int* __restrict__ carry, int* __restrict__ isa,
           int* __restrict__ cnt, int N, int T2) {
  const bool last = r == kSeedWords - 1;
  for_each_rank_tile<false>(work, lanes, N, [&](int b, int tile) {
    const int nl = row_n(lanes, b, N), n = row_n(sb.ns, b, N);
    const size_t base = static_cast<size_t>(b) * N;
    const Rank rk = rank_of(b, tile, nl, flags, carry, last ? cnt : nullptr,
                            base, T2);
    const int t = tile * kThreads + threadIdx.x;
    int bin = -1, first = 0;
    if (t < nl) {
      const int u = in.val[base + t];
      const size_t i = sb.level(r - 1, b) + sb.seg[base + u];
      const int delta = sb.lfirst[i] - sb.loff[i];
      const int slot = t + delta, p = sb.lpos[base + u];
      first = rk.first + delta;
      sb.sa[1][base + slot] = p;
      if (last)
        isa[base + p] = first;
      else
        bin = emit_lane<kCyc>(sb, r, b, base, n, N, slot, p, first, rk.open,
                              rk.end, isa);
    }
    list_append(bin, b, first, sb.list, sb.mcount);
  });
}

// -1, 0 or 1 as the kKeys words of a compare with those of c.
template <int kKeys>
__device__ __forceinline__ int cmp_words(const unsigned* a,
                                         const unsigned* c) {
#pragma unroll
  for (int j = 0; j < kKeys; ++j)
    if (a[j] != c[j]) return a[j] < c[j] ? -1 : 1;
  return 0;
}

// seed_small: a thread a slot of a run of 2 to kSmall lanes: its rank is
// the run's first slot plus the lanes of the run with smaller words.
__global__ void __launch_bounds__(kThreads)
seed_small(SeedBufs sb, int* __restrict__ isa, int* __restrict__ cnt,
           int N) {
  constexpr int kW = kSeedWords - 1;
  const int b = blockIdx.y, n = row_n(sb.ns, b, N);
  const int t0 = blockIdx.x * kTile;
  if (t0 >= n) return;
  const size_t base = static_cast<size_t>(b) * N;
  int open = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int t = t0 + r * kThreads + threadIdx.x;
    if (t >= n) break;
    const int f = sb.cls[base + t];
    const int c = sb.runlen[base + f];
    if (c < 2 || c > kSmall) continue;
    unsigned m[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j)
      m[j] = static_cast<unsigned>(sb.keys[j * sb.plane + base + t]);
    int less = 0, equal = 0;
    for (int u = f; u < f + c; ++u) {
      unsigned k[kW];
#pragma unroll
      for (int j = 0; j < kW; ++j)
        k[j] = static_cast<unsigned>(sb.keys[j * sb.plane + base + u]);
      const int o = cmp_words<kW>(k, m);
      less += o < 0;
      equal += o == 0;
    }
    isa[base + sb.sa[1][base + t]] = f + less;
    open += equal > 1;
  }
  add_open(open, cnt, b);
}

// seed_pads: one block a row with pads (n < N) whose run of W0 = FF FF
// FF FF is not empty: a lane with K > P ranks N - n further, and a lone
// lane with K = P is unresolved.  In the cyclic mode the pads' key is
// sixteen FF bytes, which no valid key passes: only a lone lane of
// sixteen FF bytes is unresolved.
template <bool kCyc>
__global__ void __launch_bounds__(kThreads)
seed_pads(SeedBufs sb, int* __restrict__ isa, int* __restrict__ cnt, int N) {
  __shared__ int equal;
  const int b = blockIdx.x, n = row_n(sb.ns, b, N), f = sb.ff[b];
  if (n >= N || f >= n) return;
  const size_t base = static_cast<size_t>(b) * N;
  if (threadIdx.x == 0) equal = 0;
  __syncthreads();
  int m = 0;
  for (int t = f + threadIdx.x; t < n; t += kThreads) {
    unsigned w[kSeedWords - 1];
    const int p = sb.sa[1][base + t];
    words_after<kCyc>(sb.blocks, base, p, n, N, w);
    if constexpr (kCyc)
      m += (w[0] & w[1] & w[2]) == kFull;
    else if (w[0] | w[1] | w[2])
      isa[base + p] += N - n;
    else
      ++m;
  }
  m = __reduce_add_sync(kFull, m);
  if ((threadIdx.x & 31) == 0 && m) atomicAdd(&equal, m);
  __syncthreads();
  if (threadIdx.x == 0 && equal == 1) cnt[b] += 1;
}

struct Scratch {
  int* sa[2];
  int* counts;
  int* agg;
  unsigned char* flags;  // also each digit pass's digits
  int* totals;
  Seg seg;
  char* levels;  // the seed's counters, FF-run starts and large runs
  int* row_off;  // (B, kMaxKeys): a cyclic pass's key offsets
};

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

int seed_segcap(int N) { return N / (kLarge + 1) + 1; }

size_t seed_levels_bytes(int B, int N) {
  return static_cast<size_t>(B) *
             (kLevels * 8 + 4 + 2 * kLevels * 4 * seed_segcap(N)) +
         kBins * 4;
}

constexpr int kParts = 21;

// The entries a block bin's list may need: every class above its lower
// bound, in every row.
size_t list_cap(int B, int N, int i) {
  const int lower[kBins] = {kSmall, kBinCap0, kBinCap1};
  return static_cast<size_t>(B) * N / (lower[i] + 1) + 1;
}

// Byte offsets of the scratch's parts: two suffix arrays, the (row,
// digit, tile) counts, the (row, rank tile) carries, a byte a lane (the
// digits, then the flags) and the (row, digit) totals, then the
// segmented pass's (S, F, pos, keys, the tile sums, five ints a row, the
// list counts, the lists and the work items), then the seed's (three
// levels of B packed counters, B FF-run starts, and three levels of
// (B, segcap) places and first slots of large runs), then a cyclic
// pass's key offsets, kMaxKeys a row.
size_t layout(int B, int N, size_t* part) {
  const size_t lanes = static_cast<size_t>(B) * N;
  const size_t T = (N + kTile - 1) / kTile, T2 = (N + kThreads - 1) / kThreads;
  const size_t sizes[kParts] = {
      lanes * 4, lanes * 4, B * kRadix * T * 4, B * T2 * 4, lanes,
      static_cast<size_t>(B) * kRadix * 4,
      static_cast<size_t>(B) * (N + 1) * 4, lanes * 4, lanes * 4, lanes * 32,
      B * T * 3 * 4, static_cast<size_t>(B) * 4, static_cast<size_t>(B) * 4,
      static_cast<size_t>(B) * 4, static_cast<size_t>(B) * 4,
      static_cast<size_t>(B) * 4, (kBins + 1) * 4,
      (list_cap(B, N, 0) + list_cap(B, N, 1) + list_cap(B, N, 2)) * 8,
      B * T * 8, seed_levels_bytes(B, N),
      static_cast<size_t>(B) * kMaxKeys * 4};
  size_t at = 0;
  for (int i = 0; i < kParts; ++i) {
    part[i] = at;
    at += align_up(sizes[i]);
  }
  return at;
}

Scratch carve(void* scratch, int B, int N) {
  size_t part[kParts];
  layout(B, N, part);
  char* s = static_cast<char*>(scratch);
  auto i32 = [&](int i) { return reinterpret_cast<int*>(s + part[i]); };
  Scratch w{{i32(0), i32(1)}, i32(2), i32(3),
            reinterpret_cast<unsigned char*>(s + part[4]), i32(5), {},
            s + part[19]};
  Seg& g = w.seg;
  g.S = i32(6);
  g.F = i32(7);
  g.pos = i32(8);
  g.keys = i32(9);
  g.tiles = i32(10);
  g.rows = {i32(11), i32(12), i32(13), i32(14), i32(15)};
  w.row_off = i32(20);
  g.mcount = i32(16);
  g.list[0] = reinterpret_cast<int2*>(s + part[17]);
  g.list[1] = g.list[0] + list_cap(B, N, 0);
  g.list[2] = g.list[1] + list_cap(B, N, 1);
  g.work = reinterpret_cast<int2*>(s + part[18]);
  return w;
}

SeedBufs seed_bufs(const Scratch& w, const unsigned char* blocks,
                   const int* ns, int B, int N) {
  const Seg& g = w.seg;
  SeedBufs sb;
  sb.blocks = blocks;
  sb.ns = ns;
  sb.w0[0] = g.F;
  sb.w0[1] = g.S;
  sb.sa[0] = w.sa[0];
  sb.sa[1] = w.sa[1];
  sb.cls = g.F;
  sb.runlen = w.sa[0];
  sb.keys = g.keys;
  sb.plane = static_cast<size_t>(B) * N;
  sb.lpos = g.pos;
  sb.seg = g.S;
  sb.B = B;
  sb.segcap = seed_segcap(N);
  sb.ctr = reinterpret_cast<unsigned long long*>(w.levels);
  sb.ff = reinterpret_cast<int*>(sb.ctr + kLevels * B);
  sb.loff = sb.ff + B;
  sb.lfirst = sb.loff + static_cast<size_t>(kLevels) * B * sb.segcap;
  sb.snap = sb.lfirst + static_cast<size_t>(kLevels) * B * sb.segcap;
  for (int i = 0; i < kBins; ++i) sb.list[i] = g.list[i];
  sb.mcount = g.mcount;
  return sb;
}

#define LAUNCHED()                                   \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return static_cast<int>(e); \
  } while (0)

#define RETURN_IF(x)        \
  do {                      \
    const int err_ = (x);   \
    if (err_) return err_;  \
  } while (0)

// Lets Kernel take `bytes` of dynamic shared memory, once a device (the
// setting holds for the process; a call on every launch cost the host
// a few microseconds each).
template <auto Kernel>
int allow_smem(size_t bytes) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (dev < kDevices && done[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kDevices) done[dev] = true;
  return 0;
}

// A pass's digit passes over region L (the lanes < lanes[b] of each
// row, from the compacted lanes sa_first), leaving the sorted lanes in
// w.sa[1] (an even number of passes); the tiles are the work list's
// items.
template <int kKeys, int kMap>
int digit_passes(const int* isa, const int* ns, const int* lanes,
                 const int* sa_first, const Work& work, dim3 grid,
                 const Scratch& w, const Offsets& offs, int B, int N,
                 cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  constexpr int kPasses = kKeys * kKeyDigits;
  static_assert((kPasses & 1) == 0, "the sorted suffix array ends in sa[1]");
  const int* in = sa_first;
  for (int i = 0; i < kPasses; ++i) {
    const int j = kKeys - 1 - i / kKeyDigits;
    const Source g{isa, j, offs.o[j], kBits * (i % kKeyDigits)};
    int* out = w.sa[i & 1];
    radix_hist<kMap><<<grid, kThreads, 0, s>>>(in, ns, lanes, work, w.counts,
                                               w.flags, offs, g, N, T);
    LAUNCHED();
    radix_scan<<<(B * kRadix + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        lanes, w.counts, w.totals, B, N, T);
    LAUNCHED();
    radix_scatter<<<grid, kThreads, 0, s>>>(in, lanes, work, w.counts,
                                            w.totals, w.flags, out, N, T);
    LAUNCHED();
    in = out;
  }
  return 0;
}

// A key-carrying digit pass from `in` to `out`: hist, scan, scatter.
template <bool kCyc>
int kv_pass(const Planes& in, const Planes& out,
            const unsigned char* blocks, const int* lanes, const Work& work,
            dim3 grid, const Digit& g, const Scratch& w, int B, int N,
            cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  RETURN_IF(allow_smem<kv_scatter<kCyc>>(kStageSmem));
  kv_hist<kCyc><<<grid, kThreads, 0, s>>>(in, blocks, lanes, work, w.counts,
                                          g, N, T);
  LAUNCHED();
  radix_scan<<<(B * kRadix + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      lanes, w.counts, w.totals, B, N, T);
  LAUNCHED();
  kv_scatter<kCyc><<<grid, kThreads, kStageSmem, s>>>(
      in, blocks, lanes, work, w.counts, w.totals, out, g, N, T);
  LAUNCHED();
  return 0;
}

// A block bin's kernel on a grid of kPerSm blocks an SM (as many as the
// list may need), each looping over the list.
template <int kCap, int kBlock, int kPerSm, class Classes>
int launch_block_bin(int i, const int2* list, const int* from,
                     const int* mcount, const Classes& cls, int* isa,
                     int* cnt, int B, int N, int sms, cudaStream_t s) {
  constexpr size_t kSmem = block_smem<kCap, Classes::kKeys>();
  if (kSmem > 48 * 1024)
    RETURN_IF((allow_smem<seg_block<kCap, kBlock, kPerSm, Classes>>(kSmem)));
  const size_t cap = list_cap(B, N, i);
  const int grid = static_cast<int>(
      cap < static_cast<size_t>(sms) * kPerSm ? cap : sms * kPerSm);
  seg_block<kCap, kBlock, kPerSm, Classes><<<grid, kBlock, kSmem, s>>>(
      list, from ? from + i : nullptr, mcount + i, isa, cls, cnt, N);
  LAUNCHED();
  return 0;
}

// The three block bins over their lists' entries from[i] (0 when from
// is null) to mcount[i].
template <class Classes>
int block_bins(int2* const* list, const int* from, const int* mcount,
               const Classes& cls, int* isa, int* cnt, int B, int N, int sms,
               cudaStream_t s) {
  RETURN_IF(
      (launch_block_bin<kBinCap0, Classes::kBlock[0], Classes::kPerSm[0]>(
          0, list[0], from, mcount, cls, isa, cnt, B, N, sms, s)));
  RETURN_IF(
      (launch_block_bin<kBinCap1, Classes::kBlock[1], Classes::kPerSm[1]>(
          1, list[1], from, mcount, cls, isa, cnt, B, N, sms, s)));
  RETURN_IF(
      (launch_block_bin<kBinCap2, Classes::kBlock[2], Classes::kPerSm[2]>(
          2, list[2], from, mcount, cls, isa, cnt, B, N, sms, s)));
  return 0;
}

// A second stream of the calling thread on one device, with the events
// that fork work to it and join it back, made at first use and kept for
// the thread's life: the seed sorts round 0's block bins on it while the
// rounds run on the caller's stream.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
  ~Side() {
    if (stream) cudaStreamDestroy(stream);
    if (fork) cudaEventDestroy(fork);
    if (join) cudaEventDestroy(join);
  }
};

int side_stream(Side** out) {
  constexpr int kDevices = 64;
  thread_local Side sides[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  Side& sd = sides[dev];
  if (!sd.stream &&
      (cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking) !=
           cudaSuccess ||
       cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming) !=
           cudaSuccess ||
       cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming) !=
           cudaSuccess))
    return static_cast<int>(cudaGetLastError());
  *out = &sd;
  return 0;
}

int multiprocessors(int* sms) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  return 0;
}

// The seed on the caller's stream (see lbz2t_bwt2_seed).
template <bool kCyc>
int seed(const unsigned char* bl, const int* n, int* out, int* c,
         void* scratch, int B, int N, cudaStream_t s) {
  int sms = 0;
  RETURN_IF(multiprocessors(&sms));
  const Scratch w = carve(scratch, B, N);
  const Seg& g = w.seg;
  const SeedBufs sb = seed_bufs(w, bl, n, B, N);
  const int T = (N + kTile - 1) / kTile, T2 = (N + kThreads - 1) / kThreads;
  const dim3 grid(T, B), grid2(T2, B), grid_l(sms * 8);
  const Work tiles{nullptr, nullptr}, items{g.work, g.mcount + kBins};

  seed_setup<<<1, kScanThreads, 0, s>>>(sb, c);
  LAUNCHED();
  // round 0: (W0, p) by W0's four digits, from the rows; its runs
  Planes in{nullptr, nullptr};
  for (int i = 0; i < kWordDigits; ++i) {
    const Planes to{sb.w0[i & 1], sb.sa[i & 1]};
    RETURN_IF(kv_pass<kCyc>(in, to, bl, n, tiles, grid,
                            Digit{kBits * i, nullptr}, w, B, N, s));
    in = to;
  }
  seed_flags<<<grid2, kThreads, 0, s>>>(sb, w.flags, w.agg, N, T2);
  LAUNCHED();
  rank_carry<<<B, kScanThreads, 0, s>>>(n, w.agg, N, T2);
  LAUNCHED();
  seed_runs<kCyc><<<grid2, kThreads, 0, s>>>(sb, w.flags, w.agg, out, N, T2);
  LAUNCHED();
  // rounds 1 to 3: the runs above kLarge lanes by their next word, then
  // the run's index, the word moving with the lane
  const int run_digits = N / (kLarge + 1) <= kRadix ? 1 : 2;
  const int passes = kWordDigits + run_digits;
  const SeedClasses classes{sb.runlen, sb.keys, sb.sa[1], sb.plane, N};
  Side* side = nullptr;
  RETURN_IF(side_stream(&side));
  for (int r = 1; r < kSeedWords; ++r) {
    seed_compact<<<grid, kThreads, 0, s>>>(sb, r - 1, N);
    LAUNCHED();
    seed_work<<<1, kThreads, 0, s>>>(g, sb.ctr + (r - 1) * B,
                                     r == 1 ? sb.snap : nullptr, B);
    LAUNCHED();
    if (r == 1) {  // round 0's block bins beside the rounds
      RETURN_IF(static_cast<int>(cudaEventRecord(side->fork, s)));
      RETURN_IF(static_cast<int>(
          cudaStreamWaitEvent(side->stream, side->fork, 0)));
      RETURN_IF(block_bins(sb.list, nullptr, sb.snap, classes, out, c, B, N,
                           sms, side->stream));
      RETURN_IF(static_cast<int>(cudaEventRecord(side->join, side->stream)));
    }
    Planes lin = region(sb, 0);
    for (int i = 0; i < passes; ++i) {
      const Planes to = region(sb, (i & 1) ^ 1);
      const Digit d = i < kWordDigits
                          ? Digit{kBits * i, nullptr}
                          : Digit{kBits * (i - kWordDigits), sb.seg};
      RETURN_IF(kv_pass<kCyc>(lin, to, nullptr, g.rows.nL, items, grid_l, d,
                              w, B, N, s));
      lin = to;
    }
    seed_round_flags<<<grid_l, kThreads, 0, s>>>(lin, sb.seg, g.rows.nL,
                                                 items, w.flags, w.agg, N,
                                                 T2);
    LAUNCHED();
    rank_carry<<<B, kScanThreads, 0, s>>>(g.rows.nL, w.agg, N, T2);
    LAUNCHED();
    seed_round<kCyc><<<grid_l, kThreads, 0, s>>>(
        sb, lin, r, g.rows.nL, items, w.flags, w.agg, out, c, N, T2);
    LAUNCHED();
  }
  RETURN_IF(static_cast<int>(cudaStreamWaitEvent(s, side->join, 0)));
  // the runs of 2 to kLarge lanes, by W1..W3: the bins' runs the rounds
  // found, and every small run
  RETURN_IF(block_bins(sb.list, sb.snap, sb.mcount, classes, out, c, B, N,
                       sms, s));
  seed_small<<<grid, kThreads, 0, s>>>(sb, out, c, N);
  LAUNCHED();
  // the pad key, on the run of W0 = FF FF FF FF
  seed_pads<kCyc><<<B, kThreads, 0, s>>>(sb, out, c, N);
  LAUNCHED();
  return 0;
}

// One pass of kKeys keys under mapping kMap, in place (see
// lbz2t_bwt2_pass).
template <int kKeys, int kMap>
int pass(int* is, const int* ns, const int* prev, int* c, int* passes,
         int* cv, void* scratch, int B, int N, long long k, cudaStream_t s) {
  Offsets offs;
  for (int j = 0; j < kMaxKeys; ++j) {
    const long long o = j * k;
    offs.o[j] = static_cast<int>(o < N ? o : N);
    offs.jk[j] = o;
  }
  int sms = 0;
  RETURN_IF(multiprocessors(&sms));
  const Scratch w = carve(scratch, B, N);
  const Seg& g = w.seg;
  offs.row = w.row_off;
  const int T = (N + kTile - 1) / kTile;
  const int T2 = (N + kThreads - 1) / kThreads;
  const dim3 grid(T, B);
  // region L's kernels take the work list's items, 8 blocks an SM
  const Work items{g.work, g.mcount + kBins};
  const dim3 grid_l(sms * 8);

  seg_setup<<<1, kScanThreads, 0, s>>>(ns, prev, c, passes, g.rows, g.mcount,
                                       offs,
                                       kMap == kCyclic ? w.row_off : nullptr,
                                       B, N);
  LAUNCHED();
  seg_hist<<<grid, kThreads, 0, s>>>(is, g.rows.act, cv, N);
  LAUNCHED();
  seg_scan_tiles<<<grid, kThreads, 0, s>>>(cv, g, N, T);
  LAUNCHED();
  seg_scan_carry<<<B, kScanThreads, 0, s>>>(g, N, T);
  LAUNCHED();
  seg_work<<<1, kThreads, 0, s>>>(g, B);
  LAUNCHED();
  seg_scan_apply<<<grid, kThreads, 0, s>>>(cv, g, N, T);
  LAUNCHED();
  seg_compact<kKeys, kMap><<<grid, kThreads, 0, s>>>(is, g, offs, N);
  LAUNCHED();
  // region L: the digit passes from its compacted lanes, the class starts
  RETURN_IF((digit_passes<kKeys, kMap>(is, g.rows.act, g.rows.nL, g.pos,
                                       items, grid_l, w, offs, B, N, s)));
  rank_flags<kKeys, kMap><<<grid_l, kThreads, 0, s>>>(
      w.sa[1], g.rows.act, g.rows.nL, items, is, offs, w.flags, w.agg, N, T2);
  LAUNCHED();
  // every gather is done: the writes
  seg_remap<<<grid, kThreads, 0, s>>>(is, g, N);
  LAUNCHED();
  seg_small<<<grid, kThreads, 0, s>>>(is, g, c, N);
  LAUNCHED();
  RETURN_IF(block_bins(g.list, nullptr, g.mcount, PassClasses{g, N}, is, c, B,
                       N, sms, s));
  rank_carry<<<B, kScanThreads, 0, s>>>(g.rows.nL, w.agg, N, T2);
  LAUNCHED();
  rank_write<<<grid_l, kThreads, 0, s>>>(w.sa[1], g.rows.nL, items, w.flags,
                                         w.agg, g.S, g.F, is, c, N, T2);
  LAUNCHED();
  return 0;
}

}  // namespace

// Bytes of scratch a (B, N) call needs.
extern "C" long long lbz2t_bwt2_scratch_bytes(int B, int N) {
  size_t part[kParts];
  return static_cast<long long>(layout(B, N, part));
}

// The seed: blocks (B, N) uint8, ns (B,) int32 -> isa (B, N) int32 (0 at
// lanes >= n), cnt (B,) int32.  cyclic 0: bwt2's _seed16, the 16-byte
// prefix of each suffix (bytes at or past n read 0, the pads' key rule);
// cyclic 1: the rotation sort's _seed_sparse (lbzip2_tpu/ops/bwt.py:157),
// bytes (p + d) mod n, each rank the first slot of its class among the
// valid lanes.
extern "C" int lbz2t_bwt2_seed(const void* blocks, const void* ns, void* isa,
                               void* cnt, void* scratch, int B, int N,
                               int cyclic, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N >= kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bl = static_cast<const unsigned char*>(blocks);
  const auto* n = static_cast<const int*>(ns);
  auto* out = static_cast<int*>(isa);
  auto* c = static_cast<int*>(cnt);
  const auto s = static_cast<cudaStream_t>(stream);
  return cyclic ? seed<true>(bl, n, out, c, scratch, B, N, s)
                : seed<false>(bl, n, out, c, scratch, B, N, s);
}

// One doubling pass in place: isa (B, N) int32 (values in [0, N) at
// lanes < n; lanes >= n neither read nor written), k >= 1, ns (B,) int32;
// prev (B,) int32 or null: a row whose prev is 0 is skipped; cnt (B,)
// int32 out; passes (B,) int32 or null: += 1 for each row not skipped;
// counts (B, N) int32, all 0, and left so.  nkeys and mapping pick the
// keys: (8, 0) bwt2's _pass8 and (4, 0) its _pass4 (offsets j k clamped
// to N, sentinels past n); (8, 1) the rotation sort's pass (N + isa at
// (p + j k) mod n); (4, 2) its tie-break (keys 1 to 3 the descending
// start n - 1 - p).
extern "C" int lbz2t_bwt2_pass(void* isa, const void* ns, const void* prev,
                               void* cnt, void* passes, void* counts,
                               void* scratch, int B, int N, long long k,
                               int nkeys, int mapping, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N >= kMaxN || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* is = static_cast<int*>(isa);
  const auto* n = static_cast<const int*>(ns);
  const auto* pv = static_cast<const int*>(prev);
  auto* c = static_cast<int*>(cnt);
  auto* ps = static_cast<int*>(passes);
  auto* cv = static_cast<int*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nkeys == 8 && mapping == kSuffix)
    return pass<8, kSuffix>(is, n, pv, c, ps, cv, scratch, B, N, k, s);
  if (nkeys == 4 && mapping == kSuffix)
    return pass<4, kSuffix>(is, n, pv, c, ps, cv, scratch, B, N, k, s);
  if (nkeys == 8 && mapping == kCyclic)
    return pass<8, kCyclic>(is, n, pv, c, ps, cv, scratch, B, N, k, s);
  if (nkeys == 4 && mapping == kTieBreak)
    return pass<4, kTieBreak>(is, n, pv, c, ps, cv, scratch, B, N, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
