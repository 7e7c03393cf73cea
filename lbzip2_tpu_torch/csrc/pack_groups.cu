// Group bit-packing of the entropy chain for Hopper (sm_90a): every
// 50-symbol group's Huffman codes, by its selector's table, into each
// row's payload bit stream of big-endian 32-bit words.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/chain.py::_pack_groups (:222,
// jitted as pack_groups :332).  The TPU form packs in two levels of
// scatter-adds: the 50 codes of a group into a 33-word slot, then every
// slot shifted to its group's offset into the row (the plain PyTorch
// version holds them in int64, ten (B, G, 50)-sized temporaries).  Here:
//
//   pack_gbits  a CTA takes kChunk groups of one row, a warp kPerWarp of
//               them: each lane looks up one or two symbols' lengths
//               in the row's six length tables (shared memory), and
//               __reduce_add_sync gives the group's bits (0 for groups
//               at and past ngroups); the CTA's sum goes to a chunk
//               total.  The CTA of chunk 0 also writes the row's tables
//               packed as (len << 24) | code, the TPU form's one gather.
//   pack_place  the same CTAs again: the chunk totals before the CTA
//               (at most 282 at 901121 lanes) and the bits of the
//               chunk's groups before each warp give every group its
//               start bit, after start_bit.  A warp takes a group: its
//               50 (len, code) pairs from the packed tables in shared
//               memory, a warp scan of the lengths, each code ORed into
//               a warp slot of 34 words in shared memory (one or two
//               words a code), then the slot's words go out: a word the
//               group covers whole is stored, its two edge words are
//               ORed into the zeroed output (atomicOr: they share bits
//               with the neighbouring groups).  Words at and past W are
//               dropped (the TPU form's dump slot), so a row that
//               overflows W still gets its words below W exactly; bits
//               past the row's total stay 0.
//
// The words are u32 bit patterns in an int32 tensor (half the bytes of
// the port's int64 convention for a JAX uint32); the total bits a row
// (start_bit included) are int64.  Codes are at most 20 bits (the tables
// hold 24) and below 2^len.
//
// What bounds it: bytes.  It needs only the symbols below nm of the
// groups below ngroups and those groups' selectors.  On the smoke's
// (32, 901121) text batch (nm 347,809 to 351,572 a row, W = 80384) that
// is 44.7 MB of symbols, 0.9 MB of selectors and 0.6 MB of tables read
// and 10.3 MB of words written, 56.5 MB in all: 0.0169 ms at 3.35 TB/s
// (chip_smoke.py, phase 20).  The two launches read the symbols twice,
// and a code takes one or two shared-memory atomics.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 8;                 // groups a warp, in turn
constexpr int kChunk = kWarps * kPerWarp;   // groups a CTA
constexpr int kGroup = 50;
constexpr int kTrees = 6;
constexpr int kWidth = 259;
constexpr int kTab = kTrees * kWidth;
constexpr int kSlot = 34;  // words 1000 bits touch from any bit offset
constexpr unsigned kFull = 0xFFFFFFFFu;

int groups_of(int NP) { return (NP + kGroup - 1) / kGroup; }
int chunks_of(int NP) { return (groups_of(NP) + kChunk - 1) / kChunk; }

// the padded group view's symbol at lane p: mtfv below nm (0 past NP),
// the dummy `as` at and past it
__device__ __forceinline__ int symbol(const int* __restrict__ row, int p,
                                      int nm, int NP, int as) {
  return p < nm ? (p < NP ? __ldg(row + p) : 0) : as;
}

// a (tree, symbol) pair's entry of the flat (6 x 259) tables
__device__ __forceinline__ int entry(int tree, int sym) {
  return min(max(tree * kWidth + sym, 0), kTab - 1);
}

struct RowArgs {
  const int* mtfv;
  int nm, as, ng;
};

__device__ __forceinline__ RowArgs row_args(const int* mtfv,
                                            const int* nm,
                                            const int* ninuse,
                                            const int* ngroups, int b,
                                            int NP, int G) {
  return {mtfv + (size_t)b * NP, nm[b], ninuse[b] + 2,
          min(max(ngroups[b], 0), G)};
}

__device__ __forceinline__ int tree_of(const int* __restrict__ sel, int b,
                                       int g, int G) {
  return min(max(__ldg(sel + (size_t)b * G + g), 0), kTrees - 1);
}

__global__ void __launch_bounds__(kThreads)
    pack_gbits(const int* __restrict__ mtfv, const int* __restrict__ nm,
               const int* __restrict__ ninuse,
               const int* __restrict__ ngroups, const int* __restrict__ sel,
               const long long* __restrict__ codes,
               const int* __restrict__ lens, int NP, int G, int chunks,
               int* __restrict__ packed, int* __restrict__ gbits,
               int* __restrict__ csum) {
  __shared__ int len_s[kTab];
  __shared__ int part[kWarps];
  const int b = blockIdx.y, c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kTab; i += kThreads) {
    const int l = lens[(size_t)b * kTab + i];
    len_s[i] = l;
    if (c == 0)
      packed[(size_t)b * kTab + i] =
          (l << 24) | (int)(codes[(size_t)b * kTab + i] & 0xFFFFFF);
  }
  __syncthreads();
  const RowArgs r = row_args(mtfv, nm, ninuse, ngroups, b, NP, G);
  int sum = 0;
  for (int i = 0; i < kPerWarp; ++i) {
    const int g = c * kChunk + warp * kPerWarp + i;
    if (g >= G) break;  // the whole warp
    int bits = 0;
    if (g < r.ng) {
      const int tree = tree_of(sel, b, g, G);
      const int p = g * kGroup + lane;
      bits = len_s[entry(tree, symbol(r.mtfv, p, r.nm, NP, r.as))];
      if (lane < kGroup - 32)
        bits += len_s[entry(tree, symbol(r.mtfv, p + 32, r.nm, NP, r.as))];
      bits = __reduce_add_sync(kFull, bits);
    }
    if (lane == 0) gbits[(size_t)b * G + g] = bits;
    sum += bits;
  }
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += part[w];
    csum[(size_t)b * chunks + c] = s;
  }
}

// OR a code of len bits into the slot at bit off (MSB first)
__device__ __forceinline__ void place(unsigned* slot, int off, int len,
                                      unsigned code) {
  if (len <= 0) return;
  const int o = off & 31, j = off >> 5;
  const unsigned long long win = (unsigned long long)code << (64 - o - len);
  atomicOr(slot + j, (unsigned)(win >> 32));
  if (o + len > 32) atomicOr(slot + j + 1, (unsigned)win);
}

__global__ void __launch_bounds__(kThreads)
    pack_place(const int* __restrict__ mtfv, const int* __restrict__ nm,
               const int* __restrict__ ninuse,
               const int* __restrict__ ngroups, const int* __restrict__ sel,
               const int* __restrict__ start_bit,
               const int* __restrict__ packed, const int* __restrict__ gbits,
               const int* __restrict__ csum, int NP, int G, int chunks,
               int W, unsigned* __restrict__ words,
               long long* __restrict__ total) {
  __shared__ int tab[kTab];
  __shared__ int gb[kChunk];
  __shared__ int part[kWarps];
  __shared__ unsigned slots[kWarps][kSlot];
  const int b = blockIdx.y, c = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kTab; i += kThreads)
    tab[i] = packed[(size_t)b * kTab + i];
  for (int i = tid; i < kChunk; i += kThreads) {
    const int g = c * kChunk + i;
    gb[i] = g < G ? gbits[(size_t)b * G + g] : 0;
  }
  unsigned* slot = slots[warp];
  for (int j = lane; j < kSlot; j += 32) slot[j] = 0;
  int before = 0;  // the bits of the chunks before this one
  for (int j = tid; j < c; j += kThreads)
    before += csum[(size_t)b * chunks + j];
  before = __reduce_add_sync(kFull, before);
  if (lane == 0) part[warp] = before;
  __syncthreads();
  int base = start_bit[b];
  for (int w = 0; w < kWarps; ++w) base += part[w];
  int gstart = base;
  for (int k = 0; k < warp * kPerWarp; ++k) gstart += gb[k];
  if (c == chunks - 1 && tid == 0) {
    long long t = base;
    for (int k = 0; k < kChunk; ++k) t += gb[k];
    total[b] = t;
  }
  const RowArgs r = row_args(mtfv, nm, ninuse, ngroups, b, NP, G);
  unsigned* out = words + (size_t)b * W;
  for (int i = 0; i < kPerWarp; ++i) {
    const int k = warp * kPerWarp + i, g = c * kChunk + k;
    if (g >= r.ng) break;  // the whole warp: no bits past ngroups
    const int bits = gb[k], start = gstart;
    gstart += bits;
    if (!bits) continue;
    const int tree = tree_of(sel, b, g, G);
    const int p = g * kGroup + lane;
    const int e0 = tab[entry(tree, symbol(r.mtfv, p, r.nm, NP, r.as))];
    const int e1 = lane < kGroup - 32
                       ? tab[entry(tree, symbol(r.mtfv, p + 32, r.nm, NP,
                                                r.as))]
                       : 0;
    const int l0 = e0 >> 24, l1 = e1 >> 24;
    // inclusive scans of the lanes' first symbols, then their second ones
    int x0 = l0, x1 = l1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y0 = __shfl_up_sync(kFull, x0, d);
      const int y1 = __shfl_up_sync(kFull, x1, d);
      if (lane >= d) {
        x0 += y0;
        x1 += y1;
      }
    }
    const int first = __shfl_sync(kFull, x0, 31);
    const int wbase = start >> 5, o = start & 31;
    place(slot, o + x0 - l0, l0, e0 & 0xFFFFFF);
    place(slot, o + first + x1 - l1, l1, e1 & 0xFFFFFF);
    __syncwarp();
    const int end = start + bits;
    const int nw = ((end - 1) >> 5) - wbase + 1;
    for (int j = lane; j < nw; j += 32) {
      const int w = wbase + j;
      const unsigned v = slot[j];
      slot[j] = 0;
      if (w >= W) continue;
      if (w * 32 >= start && w * 32 + 32 <= end)
        out[w] = v;  // the group's own word
      else if (v)
        atomicOr(out + w, v);  // an edge word, shared with a neighbour
    }
    __syncwarp();
  }
}

}  // namespace

// int32 words of the scratch for B rows of NP symbols: the packed tables,
// the bits of every group and a total a chunk of groups
extern "C" long long lbz2t_pack_scratch_ints(int B, int NP) {
  return (long long)B * (kTab + groups_of(NP) + chunks_of(NP));
}

// mtfv (B, NP), nm, ninuse, ngroups (B,), sel (B, ceil(NP / 50)), lens
// (B, 6, 259) and start_bit (B,) int32, codes (B, 6, 259) int64 in;
// words (B, W) int32 zeroed and total (B,) int64 out; scratch of
// lbz2t_pack_scratch_ints int32; all device pointers.
extern "C" int lbz2t_pack_groups(const void* mtfv, const void* nm,
                                 const void* ninuse, const void* ngroups,
                                 const void* sel, const void* codes,
                                 const void* lens, const void* start_bit,
                                 void* words, void* total, void* scratch,
                                 int B, int NP, int W, void* stream) {
  if (B <= 0 || NP <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = groups_of(NP), chunks = chunks_of(NP);
  int* packed = static_cast<int*>(scratch);
  int* gbits = packed + (size_t)B * kTab;
  int* csum = gbits + (size_t)B * G;
  const dim3 grid(chunks, B);
  const int* sv = static_cast<const int*>(mtfv);
  const int* nmv = static_cast<const int*>(nm);
  const int* nu = static_cast<const int*>(ninuse);
  const int* ng = static_cast<const int*>(ngroups);
  const int* se = static_cast<const int*>(sel);
  pack_gbits<<<grid, kThreads, 0, s>>>(
      sv, nmv, nu, ng, se, static_cast<const long long*>(codes),
      static_cast<const int*>(lens), NP, G, chunks, packed, gbits, csum);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pack_place<<<grid, kThreads, 0, s>>>(
      sv, nmv, nu, ng, se, static_cast<const int*>(start_bit), packed, gbits,
      csum, NP, G, chunks, W, static_cast<unsigned*>(words),
      static_cast<long long*>(total));
  return (int)cudaGetLastError();
}
