// Suffix sorting of the batched BWT (bwt2), for Hopper (sm_90a): the
// seed by LSD radix passes, each doubling pass as a segmented sort of
// the lanes that are still tied.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/bwt2.py::_seed16 (:81) and
// _passx as the main path runs it, _pass8 (:125, :162), each with the
// _invert (:48) that ends it.  Both functions sort the lanes < n of
// every row by a tuple of keys and give each lane the SA slot of the
// first lane of its equal-key class, its rank; the new ISA is
// ISA[SA[t]] = rank[t].
//
// The seed is a stable LSD radix sort that carries only the suffix
// array (an int32 position a lane, ping-ponged between two buffers);
// digit d (d = 0 first) of position p is byte p + 15 - d of the row, 0
// at or past n: 16 byte passes over the 16-byte prefix.  A valid lane
// whose 16-byte key K is FF FF FF FF 00 .. 00 (the pads' own key P)
// ties with the pads in JAX, and one whose K > P sorts after all N - n
// of them; the rank step reproduces both: such a lane's rank is its
// slot plus N - n, and a lane with K = P is unresolved whenever there
// are pads.  So the seed's ranks lie in [0, N), not in [0, n).
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
//   large route    the seed's digit passes over region L's lanes only
//                  (3 digits a key, keys 7 to 0, the class v last), then
//                  class starts by the keys (rank_flags); its kernels
//                  loop over the items on a grid of 8 blocks an SM, so
//                  an idle route (no class above kLarge: every text row)
//                  costs its 75 launches, not a block a tile of each row
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
// What bounds it on the card: the classify passes read the ISA three
// times (hist, compact, and remap once after the seed) and the counts
// and sums three times (4 bytes a lane and a value each: some 0.5 GB at
// (32, 901120)), and each tied lane of region A gathers 7 keys, one
// 32-byte sector each, and writes and reads its 32 bytes of keys; the
// ISA rows, 3.6 MB each, stay in the 50 MB L2 while a row's blocks run.
// The lanes that are resolved, and the rows that are, cost the classify
// passes alone.  Region L pays a full radix sort's price: 24 digit
// passes over its lanes, each gathering a digit at a random place of
// the ISA.
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
constexpr int kSeedBytes = 16;
constexpr int kPassKeys = 8;
constexpr int kKeyDigits = 3;               // 24 bits a mapped key
constexpr int kMaxN = 1 << 23;              // 2N must fit 24 bits
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kThreads == kRadix, "a thread a digit in the scatter");
static_assert(kTile == kRounds * kThreads, "a tile is 16 rounds a block");

// The segmented pass's size bins (ops/bwt2.py SEG_SMALL, SEG_BLOCKS):
// classes of 2 to kSmall lanes go to seg_small, the rest up to kLarge
// to seg_block by the least capacity that holds them, larger ones to
// the radix route.
constexpr int kSmall = 32;
constexpr int kBins = 3;
constexpr int kBinCap0 = 256, kBinCap1 = 1024, kBinCap2 = 4096;
constexpr int kLarge = kBinCap2;
constexpr unsigned short kSentinel = 0xFFFF;  // an empty slot of a block
static_assert(kLarge < kSentinel, "a class's slots fit 16 bits");

__device__ __forceinline__ int row_n(const int* ns, int b, int N) {
  return min(max(ns[b], 0), N);
}

// Where a digit pass reads its digit: the rows' bytes (seed) or the
// current ISA (pass); off is the byte offset 15 - d or off_j, shift the
// digit's place in the mapped key.
struct Source {
  const unsigned char* blocks;
  const int* isa;
  int off;
  int shift;
};

struct Offsets {
  int o[kPassKeys];  // off_j = min(j k, N)
};

__device__ __forceinline__ int pass_key(const int* isa, size_t base, int p,
                                        int off, int n, int N) {
  const int q = p + off;
  return q < n ? N + isa[base + q] : N - 1 - p;
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
// (blockIdx.y, blockIdx.x) when items is null (the seed's full grid),
// else items[i] for i = blockIdx.x, blockIdx.x + gridDim.x, .. below
// *count (the pass's region L, listed on the card: an idle route
// launches a few hundred blocks, not a block a tile of every row).
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

template <bool kSeed>
__device__ __forceinline__ int digit_of(const Source& g, size_t base, int p,
                                        int n, int N) {
  const int q = p + g.off;
  if (kSeed) return q < n ? g.blocks[base + q] : 0;
  return (pass_key(g.isa, base, p, g.off, n, N) >> g.shift) & (kRadix - 1);
}

// radix_hist: counts[b][digit][tile] of the lanes < lanes[b] of one
// tile, and each lane's digit in digits[b][t] for the scatter; a tile
// past the lanes writes nothing (the scan reads the tiles that hold
// lanes).  ns gives the rows' lengths for the digits.
template <bool kSeed>
__device__ __forceinline__ void hist_tile(
    int b, int tile, const int* __restrict__ sa_in,
    const int* __restrict__ ns, const int* __restrict__ lanes,
    int* __restrict__ counts, unsigned char* __restrict__ digits,
    const Source& g, int N, int T) {
  __shared__ int h[kRadix];
  const int n = row_n(ns, b, N), nl = row_n(lanes, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t0 = tile * kTile;
  if (t0 >= nl) return;
  h[threadIdx.x] = 0;
  __syncthreads();
  {
    int p[kRounds], d[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      p[r] = t < nl ? (sa_in ? sa_in[base + t] : t) : 0;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      d[r] = t < nl ? digit_of<kSeed>(g, base, p[r], n, N) : kRadix;
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

template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
radix_hist(const int* __restrict__ sa_in, const int* __restrict__ ns,
           const int* __restrict__ lanes, Work work,
           int* __restrict__ counts, unsigned char* __restrict__ digits,
           Source g, int N, int T) {
  for (int i = work_first(work); i < work_items(work); i += work_step(work)) {
    const int2 bt = work_item(work, i);
    hist_tile<kSeed>(bt.x, bt.y, sa_in, ns, lanes, counts, digits, g, N, T);
    __syncthreads();  // the histogram of the next item
  }
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
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&at[0][0])[i] = 0;
  // where each digit starts in the row: the totals of the digits below
  const int below_digits = block_exclusive<false, kThreads>(
      totals[static_cast<size_t>(b) * kRadix + threadIdx.x], 0);
  const int w0 = t0 + warp * kWarpSpan;
  int p[kRounds], d[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int t = w0 + r * 32 + lane;
    p[r] = t < n ? (sa_in ? sa_in[base + t] : t) : 0;
    d[r] = t < n ? digits[base + t] : kRadix;
  }
  // this warp's count of each digit
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned m = peers_of(d[r]);
    peers[r][threadIdx.x] = m;
    if (d[r] < kRadix && lane == __ffs(m) - 1) at[warp][d[r]] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  {  // a thread a digit: where each warp's lanes of it start
    const int dig = threadIdx.x;
    int run = below_digits +
              offsets[(static_cast<size_t>(b) * kRadix + dig) * T + tile];
    for (int w = 0; w < kWarps; ++w) {
      const int c = at[w][dig];
      at[w][dig] = run;
      run += c;
    }
  }
  __syncthreads();
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
  for (int i = work_first(work); i < work_items(work); i += work_step(work)) {
    const int2 bt = work_item(work, i);
    scatter_tile(bt.x, bt.y, sa_in, lanes, offsets, totals, digits, sa_out,
                 N, T);
    __syncthreads();  // the shared counts of the next item
  }
}

// The key tuple of position p < n: the seed's 16 bytes as 4 big-endian
// words, or the pass's 8 mapped keys.
template <bool kSeed>
__device__ __forceinline__ void keys_of(const unsigned char* blocks,
                                        const int* isa, const Offsets& offs,
                                        size_t base, int p, int n, int N,
                                        int* key) {
  if (kSeed) {
#pragma unroll
    for (int i = 0; i < kSeedBytes / 4; ++i) {
      unsigned w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = p + 4 * i + j;
        w = (w << 8) | (q < n ? blocks[base + q] : 0u);
      }
      key[i] = static_cast<int>(w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPassKeys; ++j)
      key[j] = pass_key(isa, base, p, offs.o[j], n, N);
  }
}

// rank_flags: per sorted lane t < lanes[b], bit 0 a class start, bit 1
// the seed's K > P, bit 2 its K = P; 0 past it (the seed's tiles to N,
// the pass's to lanes[b]).  agg[b][tile] is the tile's last start slot,
// or -1.
template <bool kSeed>
__device__ __forceinline__ void flags_tile(
    int b, int tile, const int* __restrict__ sa, const int* __restrict__ ns,
    const int* __restrict__ lanes, const unsigned char* __restrict__ blocks,
    const int* __restrict__ isa, const Offsets& offs,
    unsigned char* __restrict__ flags, int* __restrict__ agg, int N,
    int T2) {
  constexpr int kKeys = kSeed ? kSeedBytes / 4 : kPassKeys;
  __shared__ int part[kWarps];
  const int n = row_n(ns, b, N), nl = row_n(lanes, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t = tile * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = t < nl;
  int key[kKeys], prev[kKeys];
#pragma unroll
  for (int i = 0; i < kKeys; ++i) key[i] = 0;
  if (live) keys_of<kSeed>(blocks, isa, offs, base, sa[base + t], n, N, key);
#pragma unroll
  for (int i = 0; i < kKeys; ++i) prev[i] = __shfl_up_sync(kFull, key[i], 1);
  if (live && lane == 0 && t > 0)
    keys_of<kSeed>(blocks, isa, offs, base, sa[base + t - 1], n, N, prev);
  bool start = t == 0;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) start |= key[i] != prev[i];
  int f = 0;
  if (live) {
    f = start ? 1 : 0;
    if (kSeed && key[0] == -1) {  // FF FF FF FF: against the pads' key
      const bool rest = (key[1] | key[2] | key[3]) != 0;
      f |= rest ? 2 : 4;
    }
  }
  if (t < N) flags[base + t] = static_cast<unsigned char>(f);
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

// Calls f(b, tile) for the 256-lane rank tiles of the block's items: the
// seed's grid takes one each; a pass's item is a 4096-lane tile of
// region L, 16 rank tiles, those below lanes[b].
template <bool kSeed, class Fn>
__device__ __forceinline__ void for_each_rank_tile(const Work& work,
                                                   const int* lanes, int N,
                                                   Fn f) {
  for (int i = work_first(work); i < work_items(work); i += work_step(work)) {
    const int2 bt = work_item(work, i);
    const int nl = row_n(lanes, bt.x, N);
    const int subs = work.items ? kTile / kThreads : 1;
    for (int j = 0; j < subs; ++j) {
      const int tile = bt.y * subs + j;
      if (!kSeed && tile * kThreads >= nl) break;
      f(bt.x, tile);
      __syncthreads();  // the shared parts of the next tile
    }
  }
}

template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
rank_flags(const int* __restrict__ sa, const int* __restrict__ ns,
           const int* __restrict__ lanes, Work work,
           const unsigned char* __restrict__ blocks,
           const int* __restrict__ isa, Offsets offs,
           unsigned char* __restrict__ flags, int* __restrict__ agg, int N,
           int T2) {
  for_each_rank_tile<kSeed>(work, lanes, N, [&](int b, int tile) {
    flags_tile<kSeed>(b, tile, sa, ns, lanes, blocks, isa, offs, flags, agg,
                      N, T2);
  });
}

// rank_carry: one block a row; agg becomes its exclusive max-scan over
// the tiles that hold lanes (the last start slot before each tile); the
// seed sets cnt[b] = 0 (a pass zeroes it in seg_setup and adds every
// route's lanes).
template <bool kSeed>
__global__ void __launch_bounds__(kScanThreads)
rank_carry(const int* __restrict__ lanes, int* __restrict__ agg,
           int* __restrict__ cnt, int N, int T2) {
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
  if (kSeed && threadIdx.x == 0) cnt[blockIdx.x] = 0;
}

// rank_write: ranks, unresolved counts and the new ISA.  The seed writes
// every lane of isa_out (0 at and past n); the pass's region L writes
// its own lanes in place, S[v] + the sub-class's first slot - the
// class's first slot F[v] (v read from the lane itself first).
template <bool kSeed>
__device__ __forceinline__ void write_tile(
    int b, int tile, const int* __restrict__ sa, const int* __restrict__ ns,
    const int* __restrict__ lanes, const unsigned char* __restrict__ flags,
    const int* __restrict__ carry, const int* __restrict__ S,
    const int* __restrict__ F, int* __restrict__ isa_out,
    int* __restrict__ cnt, int N, int T2) {
  __shared__ int part[kWarps], tally[kWarps];
  const int n = row_n(ns, b, N), nl = row_n(lanes, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t = tile * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = t < nl;
  const int f = live ? flags[base + t] : 0;
  const bool start = f & 1;
  const int incl = warp_scan<true>(live && start ? t : -1);
  if (lane == 31) part[warp] = incl;
  const bool end = t == nl - 1 || (t + 1 < nl && (flags[base + t + 1] & 1));
  const bool open = live && (!(start && end) || ((f & 4) && n < N));
  const int ones = __popc(__ballot_sync(kFull, open));
  if (lane == 0) tally[warp] = ones;
  __syncthreads();
  int rank = max(incl, carry[static_cast<size_t>(b) * T2 + tile]);
  for (int w = 0; w < warp; ++w) rank = max(rank, part[w]);
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += tally[w];
    if (c) atomicAdd(&cnt[b], c);
  }
  if (kSeed) {
    if (live)
      isa_out[base + sa[base + t]] = rank + ((f & 2) ? N - n : 0);
    else if (t < N)
      isa_out[base + t] = 0;
  } else if (live) {
    const int p = sa[base + t];
    const int v = isa_out[base + p];
    isa_out[base + p] =
        S[static_cast<size_t>(b) * (N + 1) + v] + rank - F[base + v];
  }
}

template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
rank_write(const int* __restrict__ sa, const int* __restrict__ ns,
           const int* __restrict__ lanes, Work work,
           const unsigned char* __restrict__ flags,
           const int* __restrict__ carry, const int* __restrict__ S,
           const int* __restrict__ F, int* __restrict__ isa_out,
           int* __restrict__ cnt, int N, int T2) {
  for_each_rank_tile<kSeed>(work, lanes, N, [&](int b, int tile) {
    write_tile<kSeed>(b, tile, sa, ns, lanes, flags, carry, S, F, isa_out,
                      cnt, N, T2);
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
  int* keys;      // (B, N, 8): region A's keys 0 to 7, by dense slot
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
                          Rows rows, int* __restrict__ mcount, int B,
                          int N) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const bool work = prev == nullptr || prev[b] > 0;
    rows.act[b] = work ? row_n(ns, b, N) : 0;
    rows.remap[b] = 0;
    cnt[b] = 0;
    if (passes && work) passes[b] += 1;
  }
  if (threadIdx.x < kBins) mcount[threadIdx.x] = 0;
}

// seg_work: region L's (row, tile) items, row after row, and their
// count after the block bins' (the radix route's Work).
__global__ void seg_work(Seg s, int B) {
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
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
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
    const int bin = c <= kSmall || c > kLarge ? -1
                    : c <= kBinCap0           ? 0
                    : c <= kBinCap1           ? 1
                                              : 2;
#pragma unroll
    for (int i = 0; i < kBins; ++i) {
      const unsigned m = __ballot_sync(kFull, bin == i);
      if (!m) continue;
      const int leader = __ffs(m) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&s.mcount[i], __popc(m));
      at = __shfl_sync(kFull, at, leader);
      if (bin == i) s.list[i][at + __popc(m & below)] = make_int2(b, v);
    }
    run = add3(run, total);
  }
}

// seg_compact: each tied lane p to its class's dense range (a warp whose
// lanes are all of one class takes 32 slots at once), and region A's
// keys 0 to 7 of it.
__global__ void __launch_bounds__(kThreads)
seg_compact(const int* __restrict__ isa, Seg s, Offsets offs, int N) {
  const int b = blockIdx.y, a = s.rows.act[b];
  const int t0 = blockIdx.x * kTile;
  if (t0 >= a) return;
  const size_t base = static_cast<size_t>(b) * N;
  const size_t bS = static_cast<size_t>(b) * (N + 1);
  const int lane = threadIdx.x & 31;
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
      kp[0] = make_int4(v, pass_key(isa, base, p, offs.o[1], a, N),
                        pass_key(isa, base, p, offs.o[2], a, N),
                        pass_key(isa, base, p, offs.o[3], a, N));
      kp[1] = make_int4(pass_key(isa, base, p, offs.o[4], a, N),
                        pass_key(isa, base, p, offs.o[5], a, N),
                        pass_key(isa, base, p, offs.o[6], a, N),
                        pass_key(isa, base, p, offs.o[7], a, N));
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

template <int kCap>
__device__ __forceinline__ bool slot_greater(const int* kk, int a, int c) {
  if (a == kSentinel || c == kSentinel) return a == kSentinel && c != kSentinel;
  const int x1 = kk[a], y1 = kk[c];
  if (x1 != y1) return x1 > y1;
#pragma unroll
  for (int j = 1; j < 7; ++j) {
    const int x = kk[j * kCap + a], y = kk[j * kCap + c];
    if (x != y) return x > y;
  }
  return false;
}

template <int kCap>
__device__ __forceinline__ bool slot_differs(const int* kk, int a, int c) {
  if (kk[a] != kk[c]) return true;
#pragma unroll
  for (int j = 1; j < 7; ++j)
    if (kk[j * kCap + a] != kk[j * kCap + c]) return true;
  return false;
}

template <int kCap>
constexpr size_t block_smem() {
  return 7 * kCap * sizeof(int) + kCap * sizeof(unsigned short);
}

// seg_block: a block a class of the list (kCap / 2 < size <= kCap, and
// above kSmall): keys 1 to 7 in shared memory (a column a key), its
// slots sorted by them (bitonic, to the next power of two), class starts,
// the max-scan of the start slots, and the ranks.
template <int kCap, int kBlock, int kPerSm>
__global__ void __launch_bounds__(kBlock, kPerSm)
seg_block(const int2* __restrict__ list, const int* __restrict__ entries,
          int* __restrict__ isa, Seg s, int* __restrict__ cnt, int N) {
  constexpr int kPer = kCap / kBlock;
  static_assert(kPer * kBlock == kCap, "slots spread evenly");
  extern __shared__ int smem[];
  int* kk = smem;
  unsigned short* idx = reinterpret_cast<unsigned short*>(smem + 7 * kCap);
  const int total = *entries;
  const int4* keys = reinterpret_cast<const int4*>(s.keys);
  for (int e = blockIdx.x; e < total; e += gridDim.x) {
    const int2 bv = list[e];
    const int b = bv.x, v = bv.y;
    const size_t base = static_cast<size_t>(b) * N;
    const size_t bS = static_cast<size_t>(b) * (N + 1);
    const int s0 = s.S[bS + v], c = s.S[bS + v + 1] - s0;
    const int first = s.F[base + v];
    int p2 = 2;
    while (p2 < c) p2 <<= 1;
    for (int i = threadIdx.x; i < c; i += kBlock) {
      const int4 k0 = keys[(base + first + i) * 2];
      const int4 k1 = keys[(base + first + i) * 2 + 1];
      kk[0 * kCap + i] = k0.y;
      kk[1 * kCap + i] = k0.z;
      kk[2 * kCap + i] = k0.w;
      kk[3 * kCap + i] = k1.x;
      kk[4 * kCap + i] = k1.y;
      kk[5 * kCap + i] = k1.z;
      kk[6 * kCap + i] = k1.w;
    }
    for (int i = threadIdx.x; i < p2; i += kBlock)
      idx[i] = i < c ? static_cast<unsigned short>(i) : kSentinel;
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = threadIdx.x; q < p2 / 2; q += kBlock) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const int a = idx[i], d = idx[i | j];
          if (slot_greater<kCap>(kk, a, d) == ((i & k) == 0)) {
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
      if (i < c && (i == 0 || slot_differs<kCap>(kk, idx[i], idx[i - 1])))
        last = i;
    }
    int run = block_exclusive<true, kBlock>(last, -1);
    int open = 0;
    bool start = lo < c && (lo == 0 ||
                            slot_differs<kCap>(kk, idx[lo], idx[lo - 1]));
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lo + q;
      const bool next = i + 1 < c &&
                        slot_differs<kCap>(kk, idx[i + 1], idx[i]);
      if (i < c) {
        if (start) run = i;
        isa[base + s.pos[base + first + idx[i]]] = s0 + run;
        open += !(start && (i == c - 1 || next));
      }
      start = next;
    }
    add_open(open, cnt, b);
    __syncthreads();  // the shared keys and slots of the next class
  }
}

struct Scratch {
  int* sa[2];
  int* counts;
  int* agg;
  unsigned char* flags;  // also each digit pass's digits
  int* totals;
  Seg seg;
};

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

constexpr int kParts = 19;

// The entries a block bin's list may need: every class above its lower
// bound, in every row.
size_t list_cap(int B, int N, int i) {
  const int lower[kBins] = {kSmall, kBinCap0, kBinCap1};
  return static_cast<size_t>(B) * N / (lower[i] + 1) + 1;
}

// Byte offsets of the scratch's parts: the seed's (two suffix arrays,
// the (row, digit, tile) counts, the (row, rank tile) carries, a byte a
// lane (the digits, then the flags) and the (row, digit) totals, all
// also the radix route's), then the segmented pass's (S, F, pos, keys,
// the tile sums, five ints a row, the list counts, the lists and the
// work items).
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
      B * T * 8};
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
            reinterpret_cast<unsigned char*>(s + part[4]), i32(5), {}};
  Seg& g = w.seg;
  g.S = i32(6);
  g.F = i32(7);
  g.pos = i32(8);
  g.keys = i32(9);
  g.tiles = i32(10);
  g.rows = {i32(11), i32(12), i32(13), i32(14), i32(15)};
  g.mcount = i32(16);
  g.list[0] = reinterpret_cast<int2*>(s + part[17]);
  g.list[1] = g.list[0] + list_cap(B, N, 0);
  g.list[2] = g.list[1] + list_cap(B, N, 1);
  g.work = reinterpret_cast<int2*>(s + part[18]);
  return w;
}

#define LAUNCHED()                                   \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return static_cast<int>(e); \
  } while (0)

// The digit passes over the lanes < lanes[b] of each row (the identity
// order first when sa_first is null), leaving the sorted suffix array
// in w.sa[1] (an even number of passes); the tiles are the grid's own
// (T, B) for the seed, the work list's items for a pass.
template <bool kSeed>
int digit_passes(const unsigned char* blocks, const int* isa,
                 const int* ns, const int* lanes, const int* sa_first,
                 const Work& work, dim3 grid, const Scratch& w,
                 const Offsets& offs, int B, int N, cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const int passes = kSeed ? kSeedBytes : kPassKeys * kKeyDigits;
  static_assert((kSeedBytes & 1) == 0 && ((kPassKeys * kKeyDigits) & 1) == 0,
                "the sorted suffix array ends in sa[1]");
  const int* in = sa_first;
  for (int i = 0; i < passes; ++i) {
    Source g{blocks, isa, 0, 0};
    if (kSeed) {
      g.off = kSeedBytes - 1 - i;
    } else {
      g.off = offs.o[kPassKeys - 1 - i / kKeyDigits];
      g.shift = kBits * (i % kKeyDigits);
    }
    int* out = w.sa[i & 1];
    radix_hist<kSeed><<<grid, kThreads, 0, s>>>(in, ns, lanes, work,
                                                w.counts, w.flags, g, N, T);
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

// A block bin's kernel on a grid of kPerSm blocks an SM (as many as the
// list may need), each looping over the list.
template <int kCap, int kBlock, int kPerSm>
int launch_block_bin(int i, const Scratch& w, int* isa, int* cnt, int B,
                     int N, int sms, cudaStream_t s) {
  constexpr size_t kSmem = block_smem<kCap>();
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seg_block<kCap, kBlock, kPerSm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t cap = list_cap(B, N, i);
  const int grid = static_cast<int>(
      cap < static_cast<size_t>(sms) * kPerSm ? cap : sms * kPerSm);
  seg_block<kCap, kBlock, kPerSm><<<grid, kBlock, kSmem, s>>>(
      w.seg.list[i], w.seg.mcount + i, isa, w.seg, cnt, N);
  LAUNCHED();
  return 0;
}

#define RETURN_IF(x)        \
  do {                      \
    const int err_ = (x);   \
    if (err_) return err_;  \
  } while (0)

}  // namespace

// Bytes of scratch a (B, N) call needs.
extern "C" long long lbz2t_bwt2_scratch_bytes(int B, int N) {
  size_t part[kParts];
  return static_cast<long long>(layout(B, N, part));
}

// _seed16: blocks (B, N) uint8, ns (B,) int32 -> isa (B, N) int32 (0 at
// lanes >= n), cnt (B,) int32.
extern "C" int lbz2t_bwt2_seed(const void* blocks, const void* ns, void* isa,
                               void* cnt, void* scratch, int B, int N,
                               void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N >= kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch w = carve(scratch, B, N);
  const auto* bl = static_cast<const unsigned char*>(blocks);
  const auto* n = static_cast<const int*>(ns);
  auto* out = static_cast<int*>(isa);
  auto* c = static_cast<int*>(cnt);
  const auto s = static_cast<cudaStream_t>(stream);
  const Offsets none{};
  const Work grid_tiles{nullptr, nullptr};
  const int T = (N + kTile - 1) / kTile, T2 = (N + kThreads - 1) / kThreads;
  const dim3 grid2(T2, B);
  RETURN_IF(digit_passes<true>(bl, nullptr, n, n, nullptr, grid_tiles,
                               dim3(T, B), w, none, B, N, s));
  rank_flags<true><<<grid2, kThreads, 0, s>>>(w.sa[1], n, n, grid_tiles, bl,
                                              nullptr, none, w.flags, w.agg,
                                              N, T2);
  LAUNCHED();
  rank_carry<true><<<B, kScanThreads, 0, s>>>(n, w.agg, c, N, T2);
  LAUNCHED();
  rank_write<true><<<grid2, kThreads, 0, s>>>(w.sa[1], n, n, grid_tiles,
                                              w.flags, w.agg, nullptr,
                                              nullptr, out, c, N, T2);
  LAUNCHED();
  return 0;
}

// _pass8 in place: isa (B, N) int32 (values in [0, N) at lanes < n;
// lanes >= n neither read nor written), k >= 1, ns (B,) int32; prev
// (B,) int32 or null: a row whose prev is 0 is skipped; cnt (B,) int32
// out; passes (B,) int32 or null: += 1 for each row not skipped;
// counts (B, N) int32, all 0, and left so.
extern "C" int lbz2t_bwt2_pass(void* isa, const void* ns, const void* prev,
                               void* cnt, void* passes, void* counts,
                               void* scratch, int B, int N, long long k,
                               void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N >= kMaxN || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  for (int j = 0; j < kPassKeys; ++j) {
    const long long o = j * k;
    offs.o[j] = static_cast<int>(o < N ? o : N);
  }
  const Scratch w = carve(scratch, B, N);
  const Seg& g = w.seg;
  auto* is = static_cast<int*>(isa);
  auto* c = static_cast<int*>(cnt);
  auto* cv = static_cast<int*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int T = (N + kTile - 1) / kTile;
  const int T2 = (N + kThreads - 1) / kThreads;
  const dim3 grid(T, B);
  // region L's kernels take the work list's items, 8 blocks an SM
  const Work items{g.work, g.mcount + kBins};
  const dim3 grid_l(sms * 8);

  seg_setup<<<1, kScanThreads, 0, s>>>(static_cast<const int*>(ns),
                                       static_cast<const int*>(prev), c,
                                       static_cast<int*>(passes), g.rows,
                                       g.mcount, B, N);
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
  seg_compact<<<grid, kThreads, 0, s>>>(is, g, offs, N);
  LAUNCHED();
  // region L: the digit passes from its compacted lanes, the class starts
  RETURN_IF(digit_passes<false>(nullptr, is, g.rows.act, g.rows.nL, g.pos,
                                items, grid_l, w, offs, B, N, s));
  rank_flags<false><<<grid_l, kThreads, 0, s>>>(w.sa[1], g.rows.act,
                                                g.rows.nL, items, nullptr, is,
                                                offs, w.flags, w.agg, N, T2);
  LAUNCHED();
  // every gather is done: the writes
  seg_remap<<<grid, kThreads, 0, s>>>(is, g, N);
  LAUNCHED();
  seg_small<<<grid, kThreads, 0, s>>>(is, g, c, N);
  LAUNCHED();
  RETURN_IF((launch_block_bin<kBinCap0, 128, 16>(0, w, is, c, B, N, sms, s)));
  RETURN_IF((launch_block_bin<kBinCap1, 256, 4>(1, w, is, c, B, N, sms, s)));
  RETURN_IF((launch_block_bin<kBinCap2, 1024, 1>(2, w, is, c, B, N, sms, s)));
  rank_carry<false><<<B, kScanThreads, 0, s>>>(g.rows.nL, w.agg, c, N,
                                                T2);
  LAUNCHED();
  rank_write<false><<<grid_l, kThreads, 0, s>>>(w.sa[1], g.rows.act,
                                                g.rows.nL, items, w.flags,
                                                w.agg, g.S, g.F, is, c, N,
                                                T2);
  LAUNCHED();
  return 0;
}
