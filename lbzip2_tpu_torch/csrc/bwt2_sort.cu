// Suffix sorting of the batched BWT (bwt2) by LSD radix passes, for
// Hopper (sm_90a).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/bwt2.py::_seed16 (:81) and
// _passx as the main path runs it, _pass8 (:125, :162), each with the
// _invert (:48) that ends it.  Both functions sort the lanes < n of
// every row by a tuple of keys and give each lane the SA slot of the
// first lane of its equal-key class, its rank; the new ISA is
// ISA[SA[t]] = rank[t].  Here the sort is a stable LSD radix sort that
// carries only the suffix array (an int32 position a lane, ping-ponged
// between two buffers); each 8-bit digit is read, when it is needed,
// from where the key lives:
//
//   seed  digit d (d = 0 first) of position p is byte p + 15 - d of the
//         row, 0 at or past n: 16 byte passes over the 16-byte prefix.
//   pass  8 keys, key j read from the current ISA at p + off_j with
//         off_j = min(j k, N), mapped to
//             key_j(p) = N + ISA[p + off_j]   if p + off_j < n,
//                        N - 1 - p            otherwise,
//         3 digits a key from key 7 down to key 0: 24 passes.
//
// Why the pass mapping is exact: JAX reads sentinels n - q - 2^30 past
// n (its _extend, the dynamic_slice clamp of the start to N and the
// patch where p + j k >= 2N), and along one key column q grows strictly
// with p in both regimes, which meet in order (3N - j k - 1 < 2N).  So
// JAX's sentinels fall strictly as p grows and lie below every rank, as
// N - 1 - p does below N + ISA.  Every mapped key is below 2N, and
// N < 2^23 keeps it inside the 24 bits of three digits.  The pad lanes
// (>= n) take no part: in JAX their key 0 is INT32_MAX, so in the pass
// they sort after every valid lane.  In the seed a valid lane whose
// 16-byte key K is FF FF FF FF 00 .. 00 (the pads' own key P) ties
// with the pads, and one whose K > P sorts after all N - n of them; the
// rank step reproduces both: such a lane's rank is its slot plus
// N - n, and a lane with K = P is unresolved whenever there are pads.
//
// Each digit pass is three launches:
//   radix_hist     a 256-bin histogram per (row, tile of 4096 lanes),
//                  equal digits of a warp counted once (peers_of);
//                  each lane's digit is kept in a byte for the scatter
//   radix_scan     a warp per (row, digit): the exclusive scan of its
//                  counts over the tiles, and its total; with the totals
//                  of the digits below (summed in the scatter's block)
//                  that is the scan over (digit, tile) in digit-major
//                  order: where each (digit, tile) starts in the output
//   radix_scatter  a stable scatter: a warp takes 512 consecutive lanes
//                  of the tile in rounds of 32, ranks a lane among its
//                  equal digits by ballots (peers_of: one a digit bit;
//                  popc of the peers below), counts in shared memory
//                  per warp.
// Then the rank step, three launches:
//   rank_flags     class starts: a lane's key tuple against its left
//                  neighbour's (a shuffle; lane 0 of a warp reads its
//                  own), the seed's K > P and K = P bits; per tile of
//                  256 lanes the last start slot
//   rank_carry     an exclusive max-scan of those per row; cnt = 0
//   rank_write     rank = max-scan of the start slots, the unresolved
//                  count (valid lanes in classes of two or more,
//                  JAX's _unresolved :73) by atomics, and the scatter
//                  ISA[SA[t]] = rank (JAX sorts a fifth time); lanes at
//                  and past n of the ISA get 0: no reader looks there.
//
// What bounds it on the card: each digit pass reads the suffix array
// twice and writes it once (4 bytes a lane each), writes and reads the
// digit byte, and gathers the digit once at a random place in the row,
// a 32-byte sector (the rows' bytes, 29 MB for (32, 901120), stay in the
// 50 MB L2; the ISA, 115 MB, does not); the rank step gathers each
// lane's whole key tuple.  The
// bytes the function itself must move are far below that: once in
// (the rows, or the ISA) and once out (the ISA).  A pass over an ISA
// whose classes are all resolved sorts by key 0 alone in effect and
// gives back the same ISA.
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

template <bool kSeed>
__device__ __forceinline__ int digit_of(const Source& g, size_t base, int p,
                                        int n, int N) {
  const int q = p + g.off;
  if (kSeed) return q < n ? g.blocks[base + q] : 0;
  const int key = q < n ? N + g.isa[base + q] : N - 1 - p;
  return (key >> g.shift) & (kRadix - 1);
}

// radix_hist: counts[b][digit][tile] of the lanes < n of one tile, and
// each lane's digit in digits[b][t] for the scatter.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
radix_hist(const int* __restrict__ sa_in, const int* __restrict__ ns,
           int* __restrict__ counts, unsigned char* __restrict__ digits,
           Source g, int N, int T) {
  __shared__ int h[kRadix];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n = row_n(ns, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  h[threadIdx.x] = 0;
  __syncthreads();
  const int t0 = tile * kTile;
  if (t0 < n) {
    int p[kRounds], d[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      p[r] = t < n ? (sa_in ? sa_in[base + t] : t) : 0;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = t0 + r * kThreads + threadIdx.x;
      d[r] = t < n ? digit_of<kSeed>(g, base, p[r], n, N) : kRadix;
      if (t < n) digits[base + t] = static_cast<unsigned char>(d[r]);
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
// op; identity is op's neutral value.
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

// radix_scan: a warp per (row, digit) turns that digit's counts over the
// tiles into their exclusive prefix sums in place, 32 tiles at a time,
// and writes the digit's total; the scatter adds the totals of the
// digits below (digit major order).
__global__ void __launch_bounds__(kThreads)
radix_scan(int* __restrict__ counts, int* __restrict__ totals, int B,
           int T) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * kRadix) return;
  int* c = counts + static_cast<size_t>(w) * T;
  int run = 0;
  for (int i0 = 0; i0 < T; i0 += 32) {
    const int i = i0 + lane;
    const int v = i < T ? c[i] : 0;
    const int incl = warp_scan<false>(v);
    if (i < T) c[i] = run + incl - v;
    run += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) totals[w] = run;
}

// radix_scatter: the stable scatter of one tile's lanes < n by digit.
__global__ void __launch_bounds__(kThreads)
radix_scatter(const int* __restrict__ sa_in, const int* __restrict__ ns,
              const int* __restrict__ offsets,
              const int* __restrict__ totals,
              const unsigned char* __restrict__ digits,
              int* __restrict__ sa_out, int N, int T) {
  __shared__ int at[kWarps][kRadix];
  __shared__ unsigned peers[kRounds][kThreads];  // kept out of registers
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n = row_n(ns, b, N);
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
    for (int j = 0; j < kPassKeys; ++j) {
      const int q = p + offs.o[j];
      key[j] = q < n ? N + isa[base + q] : N - 1 - p;
    }
  }
}

// rank_flags: per lane t < n of the sorted row, bit 0 a class start,
// bit 1 the seed's K > P, bit 2 its K = P; 0 at and past n.  agg[b][tile]
// is the tile's last start slot, or -1.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
rank_flags(const int* __restrict__ sa, const int* __restrict__ ns,
           const unsigned char* __restrict__ blocks,
           const int* __restrict__ isa, Offsets offs,
           unsigned char* __restrict__ flags, int* __restrict__ agg, int N,
           int T2) {
  constexpr int kKeys = kSeed ? kSeedBytes / 4 : kPassKeys;
  __shared__ int part[kWarps];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n = row_n(ns, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t = tile * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = t < n;
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

// rank_carry: one block a row; agg becomes its exclusive max-scan (the
// last start slot before each tile) and cnt[b] = 0.
__global__ void __launch_bounds__(kScanThreads)
rank_carry(int* __restrict__ agg, int* __restrict__ cnt, int T2) {
  int* a = agg + static_cast<size_t>(blockIdx.x) * T2;
  const int per = (T2 + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, T2);
  const int hi = min(lo + per, T2);
  int m = -1;
  for (int i = lo; i < hi; ++i) m = max(m, a[i]);
  int run = block_exclusive<true, kScanThreads>(m, -1);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run = max(run, v);
  }
  if (threadIdx.x == 0) cnt[blockIdx.x] = 0;
}

// rank_write: ranks, unresolved counts and the new ISA.
__global__ void __launch_bounds__(kThreads)
rank_write(const int* __restrict__ sa, const int* __restrict__ ns,
           const unsigned char* __restrict__ flags,
           const int* __restrict__ carry, int* __restrict__ isa_out,
           int* __restrict__ cnt, int N, int T2) {
  __shared__ int part[kWarps], tally[kWarps];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n = row_n(ns, b, N);
  const size_t base = static_cast<size_t>(b) * N;
  const int t = tile * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = t < n;
  const int f = live ? flags[base + t] : 0;
  const bool start = f & 1;
  const int incl = warp_scan<true>(live && start ? t : -1);
  if (lane == 31) part[warp] = incl;
  const bool end = t == n - 1 || (t + 1 < n && (flags[base + t + 1] & 1));
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
  if (live)
    isa_out[base + sa[base + t]] = rank + ((f & 2) ? N - n : 0);
  else if (t < N)
    isa_out[base + t] = 0;
}

struct Scratch {
  int* sa[2];
  int* counts;
  int* agg;
  unsigned char* flags;  // also each digit pass's digits
  int* totals;
};

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

constexpr int kParts = 6;

// Byte offsets of the scratch's parts: two suffix arrays, the (row,
// digit, tile) counts, the (row, rank tile) carries, a byte a lane (the
// digits, then the flags) and the (row, digit) totals.
size_t layout(int B, int N, size_t* part) {
  const size_t lanes = static_cast<size_t>(B) * N;
  const size_t T = (N + kTile - 1) / kTile, T2 = (N + kThreads - 1) / kThreads;
  const size_t sizes[kParts] = {lanes * 4, lanes * 4, B * kRadix * T * 4,
                                B * T2 * 4, lanes, B * kRadix * 4};
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
  return {{reinterpret_cast<int*>(s + part[0]),
           reinterpret_cast<int*>(s + part[1])},
          reinterpret_cast<int*>(s + part[2]),
          reinterpret_cast<int*>(s + part[3]),
          reinterpret_cast<unsigned char*>(s + part[4]),
          reinterpret_cast<int*>(s + part[5])};
}

#define LAUNCHED()                                   \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return static_cast<int>(e); \
  } while (0)

// The digit passes, then the rank step, on stream s.
template <bool kSeed>
int sort_and_rank(const unsigned char* blocks, const int* isa_in,
                  const int* ns, int* isa_out, int* cnt, const Scratch& w,
                  const Offsets& offs, int B, int N, cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const int T2 = (N + kThreads - 1) / kThreads;
  const dim3 grid(T, B), grid2(T2, B);
  const int passes = kSeed ? kSeedBytes : kPassKeys * kKeyDigits;
  const int* in = nullptr;  // the identity before the first pass
  for (int i = 0; i < passes; ++i) {
    Source g{blocks, isa_in, 0, 0};
    if (kSeed) {
      g.off = kSeedBytes - 1 - i;
    } else {
      g.off = offs.o[kPassKeys - 1 - i / kKeyDigits];
      g.shift = kBits * (i % kKeyDigits);
    }
    int* out = w.sa[i & 1];
    radix_hist<kSeed>
        <<<grid, kThreads, 0, s>>>(in, ns, w.counts, w.flags, g, N, T);
    LAUNCHED();
    radix_scan<<<(B * kRadix + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        w.counts, w.totals, B, T);
    LAUNCHED();
    radix_scatter<<<grid, kThreads, 0, s>>>(in, ns, w.counts, w.totals,
                                            w.flags, out, N, T);
    LAUNCHED();
    in = out;
  }
  rank_flags<kSeed><<<grid2, kThreads, 0, s>>>(in, ns, blocks, isa_in, offs,
                                               w.flags, w.agg, N, T2);
  LAUNCHED();
  rank_carry<<<B, kScanThreads, 0, s>>>(w.agg, cnt, T2);
  LAUNCHED();
  rank_write<<<grid2, kThreads, 0, s>>>(in, ns, w.flags, w.agg, isa_out, cnt,
                                        N, T2);
  LAUNCHED();
  return 0;
}

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
  const Offsets none{};
  return sort_and_rank<true>(
      static_cast<const unsigned char*>(blocks), nullptr,
      static_cast<const int*>(ns), static_cast<int*>(isa),
      static_cast<int*>(cnt), carve(scratch, B, N), none, B, N,
      static_cast<cudaStream_t>(stream));
}

// _pass8: isa_in (B, N) int32 (values in [0, N) at lanes < n), k >= 1,
// ns (B,) int32 -> isa_out (B, N) int32 (0 at lanes >= n), cnt (B,).
extern "C" int lbz2t_bwt2_pass(const void* isa_in, const void* ns,
                               void* isa_out, void* cnt, void* scratch, int B,
                               int N, long long k, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N >= kMaxN || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  for (int j = 0; j < kPassKeys; ++j) {
    const long long o = j * k;
    offs.o[j] = static_cast<int>(o < N ? o : N);
  }
  return sort_and_rank<false>(
      nullptr, static_cast<const int*>(isa_in), static_cast<const int*>(ns),
      static_cast<int*>(isa_out), static_cast<int*>(cnt),
      carve(scratch, B, N), offs, B, N, static_cast<cudaStream_t>(stream));
}
