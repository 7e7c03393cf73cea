// Huffman group decode of one bzip2 block, for Hopper (sm_90a).
//
// Replaces the XLA-compiled lbzip2_tpu/ops/huffdec.py::decode_groups,
// a 50-step lax.scan over all groups of a block.  The host has already
// walked the code lengths (native retrieve_boundaries), so every
// group's start bit is known and the groups are independent: one thread
// decodes one group's 50 symbols.  Per symbol, exactly as the JAX scan:
//
//   v    = the 20 bits at the cursor (two words, big-endian bit order)
//   k    = 1 + #{kk in 1..20 : v >= base[kk + 1]}      (code length)
//   slot = count[k] + (int32(v - base[k]) >> (20 - k))  (wraps, signed)
//   sym  = perm[tree][clip(slot, 0, 257)];  cursor += k
//
// lanes past a group's EOB included: a cursor past the window reads the
// last word (JAX's mode="clip" gathers), and offset 0 takes the first
// word alone.
//
// What bounds it: not bytes (1.6 MB a 900 kB text block) but the chain
// of 50 dependent steps in each thread, and a block has only 7,000 to
// 18,000 groups: fewer threads than the card holds.  So the design
// shortens the step:
//
//   - huff_lut, once a call: for each tree a table of the top 10 bits of
//     v (1,024 entries).  k is monotone in v, and so is slot for a fixed
//     k unless the wrapped difference changes sign, which makes the two
//     ends differ; so where (k, slot) agree at both ends of an entry's
//     2^10 values they hold throughout, and the entry stores k and the
//     symbol (16 bits: k in the low 5, the symbol in the high 11).  Any
//     other entry is 0 and escapes to the 20 compares above, which keeps
//     unordered tables and the signed shift exact.
//   - huffdec: a CTA is two warps of 64 groups (109 CTAs for a 900 kB
//     text block, one an SM).  It copies the tables (12 kB) into shared
//     memory with asynchronous copies, all in flight at once, while it
//     reads its groups' starts and trees: one device-memory latency
//     before the decode.  Each thread then keeps a 64-bit bit buffer
//     refilled a word at a time from a word fetched ahead, so a step is
//     a shift, one shared-memory lookup and a shift of the buffer; the
//     symbols are staged in shared memory and written out with 16-byte
//     stores.  A negative start (never the boundary walk's) takes the
//     clipped two-word read of every step instead.
//
// chip_smoke.py --variants times edited copies against this one: the
// table read from device memory, CTAs of one warp, the escape path not
// inlined, the buffer as two 32-bit halves; and stamps the decode's
// phases.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches both kernels on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 50;
constexpr int kMaxLen = 20;
constexpr int kTrees = 6;
constexpr int kBase = 22;
constexpr int kPerm = 258;
constexpr int kLutBits = 10;                 // bits of v an entry keys on
constexpr int kLut = 1 << kLutBits;          // entries a tree
constexpr int kSpan = kMaxLen - kLutBits;    // low bits of v an entry spans
constexpr int kCta = 64;                     // groups (threads) a CTA

struct Code {
  int k;
  long long slot;
};

// The JAX step for the 20-bit window v under one tree's base and count.
// JAX shifts (v - base) as int32 (u32 >> int32 promotes to int32 with
// x64 off): where v < base the wrapped difference is negative and the
// shift arithmetic.  The slot is summed in 64 bits, as the plain version
// sums it.
__device__ __forceinline__ Code length_slot(const unsigned* tb, const int* tc,
                                            unsigned v) {
  int k = 1;
#pragma unroll
  for (int kk = 1; kk <= kMaxLen; ++kk) k += v >= tb[kk + 1];
  return {k, (long long)tc[k] + ((int)(v - tb[k]) >> (kMaxLen - k))};
}

__device__ __forceinline__ int clip_slot(long long slot) {
  return (int)min(max(slot, 0ll), (long long)(kPerm - 1));
}

__global__ void huff_lut(const unsigned* __restrict__ base,
                         const int* __restrict__ count,
                         const int* __restrict__ perm,
                         unsigned short* __restrict__ lut, int nt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nt * kLut) return;
  const int t = i >> kLutBits;
  const unsigned lo = (unsigned)(i & (kLut - 1)) << kSpan;
  const unsigned hi = lo | ((1u << kSpan) - 1);
  const Code a = length_slot(base + t * kBase, count + t * kBase, lo);
  const Code b = length_slot(base + t * kBase, count + t * kBase, hi);
  unsigned short e = 0;
  if (a.k == b.k && a.slot == b.slot) {
    const int sym = perm[t * kPerm + clip_slot(a.slot)];
    if (sym >= 0 && sym < 2048) e = (unsigned short)(sym << 5 | a.k);
  }
  lut[i] = e;
}

struct Tables {
  const unsigned short* lut;  // shared: this tree's entries
  const unsigned* base;       // shared
  const int* count;           // shared
  const int* perm;            // global: escapes only
};

__device__ __forceinline__ int decode_v(const Tables& tt, unsigned v,
                                        int* sym) {
  const unsigned e = tt.lut[v >> kSpan];
  if (e != 0) {
    *sym = (int)(e >> 5);
    return (int)(e & 31);
  }
  const Code c = length_slot(tt.base, tt.count, v);
  *sym = __ldg(tt.perm + clip_slot(c.slot));
  return c.k;
}

// One group from bit p >= 0 through a 64-bit buffer, refilled a word at
// a time from a word fetched ahead (through the L1 cache: neighbouring
// groups read neighbouring words); past the window the last word
// repeats, as JAX's clipped gathers read it.
__device__ __forceinline__ int decode_buffered(
    const Tables& tt, const unsigned* __restrict__ words, int W, int p,
    int* out) {
  auto word = [&](int i) { return __ldg(words + min(i, W - 1)); };
  const int q = p >> 5;
  unsigned long long buf =
      ((unsigned long long)word(q) << 32 | word(q + 1)) << (p & 31);
  int nb = 64 - (p & 31);  // valid bits at the top of buf, >= 32
  unsigned ahead = word(q + 2);
  int nxt = q + 3;
  for (int s = 0; s < kGroup; ++s) {
    int sym;
    const int k = decode_v(tt, (unsigned)(buf >> (64 - kMaxLen)), &sym);
    out[s] = sym;
    buf <<= k;
    nb -= k;
    p += k;
    if (nb < 32) {
      buf |= (unsigned long long)ahead << (32 - nb);
      nb += 32;
      ahead = word(nxt++);
    }
  }
  return p;
}

// One group with the JAX scan's own reads: the two words at the cursor,
// clipped into the window (a negative start).
__device__ __forceinline__ int decode_clipped(
    const Tables& tt, const unsigned* __restrict__ words, int W, int p,
    int* out) {
  for (int s = 0; s < kGroup; ++s) {
    const int w = p >> 5;  // each word index clipped on its own, as JAX
    const int o = p & 31;
    const unsigned w0 = __ldg(words + min(max(w, 0), W - 1));
    unsigned v = w0;
    if (o != 0)
      v = (w0 << o) | (__ldg(words + min(max(w + 1, 0), W - 1)) >> (32 - o));
    int sym;
    const int k = decode_v(tt, v >> (32 - kMaxLen), &sym);
    out[s] = sym;
    p += k;
  }
  return p;
}

// Asynchronous copies into shared memory (cp.async) of 16 and 4 bytes:
// every load of a thread in flight at once, where a loop of loads and
// stores would wait out one device-memory latency an iteration.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__global__ void __launch_bounds__(kCta)
huffdec(const unsigned* __restrict__ words,
        const int* __restrict__ group_start,
        const int* __restrict__ group_tree,
        const unsigned* __restrict__ base, const int* __restrict__ count,
        const int* __restrict__ perm,
        const unsigned short* __restrict__ lut, int* __restrict__ syms,
        int* __restrict__ end, int G, int W, int nt) {
  __shared__ __align__(16) unsigned short s_lut[kTrees * kLut];
  __shared__ unsigned s_base[kTrees * kBase];
  __shared__ int s_count[kTrees * kBase];
  __shared__ __align__(16) int s_out[kCta * kGroup];

  const int g0 = blockIdx.x * kCta;
  const int g = g0 + threadIdx.x;
  const bool live = g < G;
  for (int i = threadIdx.x; i < nt * kLut / 8; i += kCta)
    copy16(s_lut + 8 * i, lut + 8 * i);
  for (int i = threadIdx.x; i < nt * kBase; i += kCta) {
    copy4(s_base + i, base + i);
    copy4(s_count + i, count + i);
  }
  const int start = live ? group_start[g] : 0;
  const int tree = live ? group_tree[g] : 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (live) {
    const int t = min(max(tree, 0), nt - 1);
    const Tables tt = {s_lut + t * kLut, s_base + t * kBase,
                       s_count + t * kBase, perm + t * kPerm};
    int* out = s_out + threadIdx.x * kGroup;
    end[g] = start < 0 ? decode_clipped(tt, words, W, start, out)
                       : decode_buffered(tt, words, W, start, out);
  }
  __syncthreads();
  // coalesced copy-out of this CTA's rows of syms (g0 * 50 ints is a
  // multiple of 16 bytes)
  const int n = min(kCta, G - g0) * kGroup;
  int* dst = syms + (size_t)g0 * kGroup;
  for (int i = threadIdx.x; i < n / 4; i += kCta)
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(s_out)[i];
  for (int i = (n & ~3) + threadIdx.x; i < n; i += kCta) dst[i] = s_out[i];
}

}  // namespace

// words (W,) u32 bits; group_start, group_tree (G,) int32; base, count
// (nt, 22) and perm (nt, 258) int32; lut (nt, 1024) u16 scratch; syms
// (G, 50) and end (G,) int32 outputs; all device pointers, lut and syms
// 16-byte aligned.
extern "C" int lbz2t_huffdec(const void* words, const void* group_start,
                             const void* group_tree, const void* base,
                             const void* count, const void* perm,
                             void* lut, void* syms, void* end, int G, int W,
                             int nt, void* stream) {
  if (G <= 0 || W <= 0 || nt <= 0 || nt > kTrees)
    return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  huff_lut<<<(nt * kLut + 255) / 256, 256, 0, s>>>(
      static_cast<const unsigned*>(base), static_cast<const int*>(count),
      static_cast<const int*>(perm), static_cast<unsigned short*>(lut), nt);
  huffdec<<<(G + kCta - 1) / kCta, kCta, 0, s>>>(
      static_cast<const unsigned*>(words),
      static_cast<const int*>(group_start),
      static_cast<const int*>(group_tree),
      static_cast<const unsigned*>(base), static_cast<const int*>(count),
      static_cast<const int*>(perm),
      static_cast<const unsigned short*>(lut), static_cast<int*>(syms),
      static_cast<int*>(end), G, W, nt);
  return (int)cudaGetLastError();
}
