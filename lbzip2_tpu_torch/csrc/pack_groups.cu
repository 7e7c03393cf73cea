// Group bit-packing of the entropy chain for Hopper (sm_90a): every
// 50-symbol group's Huffman codes, by its selector's table, into each
// row's payload bit stream of big-endian 32-bit words.
//
// Replaces the XLA-compiled lbzip2_tpu/ops/chain.py::_pack_groups (:222,
// jitted as pack_groups :332).  The TPU form packs in two levels of
// scatter-adds: the 50 codes of a group into a 33-word slot, then every
// slot shifted to its group's offset into the row (the plain PyTorch
// version holds them in int64, ten (B, G, 50)-sized temporaries).  Here
// one launch reads each symbol once, a single-pass chained scan with
// decoupled look-back over the bits (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA NVR-2016-002):
//
//   pack_chunks a CTA draws a ticket (an atomic counter, not blockIdx:
//               every chunk it waits on has then started) for a chunk of
//               kChunk groups of one row, chunk-major across the rows.
//               It copies the chunk's symbols below nm of the valid
//               groups (coalesced, each once, by cp.async: all of a
//               thread's 50 in flight at once) and its selectors into
//               shared memory, and the row's tables packed as
//               (len << 24) | code, only the entries of the symbols 0 ..
//               ninuse + 2 (the row's alphabet and the dummy `as`; a
//               symbol outside them, which no valid row has, reads its
//               entry from device memory).  A thread takes a group: it
//               puts its 50 entries in place of the symbols and sums
//               their lengths; a CTA scan gives each group's offset and
//               the chunk's bits.  The CTA publishes them as the chunk's
//               aggregate (status A) and warp 0 looks back over the
//               row's earlier chunks, 32 at a time, adding the
//               aggregates up to the first inclusive sum (status P); a
//               status and its sum share one 64-bit word, so one store
//               publishes both.  It publishes its inclusive sum (P),
//               then every group has its start bit, after start_bit, and
//               each thread packs its group's codes MSB first through a
//               64-bit accumulator, a word out each time 32 bits fill: a
//               word the group covers whole is stored, its first word
//               (unless it starts on a word) and its last partial one
//               are ORed into the zero-filled output (atomicOr: they
//               share bits with the neighbouring groups).  Words at and
//               past W are dropped (the TPU form's dump slot), so a row
//               that overflows W still gets its words below W exactly;
//               bits past the row's total stay 0.  The chunk of the
//               row's last valid group (chunk 0 when ngroups is 0)
//               writes the row's total; chunks past it write nothing.
//   flat mode   (lbz2t_pack_flat) the same launch stores the payload
//               download's compaction as it packs: the function
//               lbzip2_tpu/ops/chain.py::_flatten_words (:362) of
//               pack_groups' words, as _flatten_download (:380) composes
//               them.  Given each row's inclusive word end ends[r] and
//               its count wcnt[r] = ends[r] - ends[r - 1], a row stores
//               word w at flat[ends[r] - wcnt[r] + w] for w < wcnt[r]
//               (put's W check made per row), into a zero-filled (F,)
//               output; a row of wcnt 0 (it does not fit) writes nothing
//               and its CTAs stop at once.  Neighbouring rows never share
//               a flat word, so edge words keep their atomicOr.  This
//               replaces a (B, W) words array, its zero fill and a second
//               launch that read the live words back (csrc/
//               flatten_words.cu, which stays for _flatten_words).
//
// The chunk is kChunk = 128 groups (6,400 symbols, 25.6 KB of shared
// memory at a stride of 51 words a group, so a thread's walk over its
// group meets no bank twice) so that the tables every CTA reads stay
// small beside its symbols: on text (ninuse about 30) 6 x 33 entries of
// 12 bytes, 2.4 KB from L2 a CTA, 10.8 MB over the smoke's 4,512 CTAs
// against 44.7 MB of symbols; at ninuse 256, 18.6 KB.  Per-call state on
// the card, no host read and no reset launch: the descriptors' status
// carries the call's epoch and the CTA that draws the last ticket
// zeroes the counter (ops/lookback.py keeps the scratch per thread and
// device and advances the epoch).
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
// (chip_smoke.py, phase 20).  The flat mode writes the F flat words in
// place of the (B, W) ones.  A group is a thread's sequential walk:
// a warp packs 32 groups at once with a few instructions a code, where a
// warp a group would spend two scans and shared atomics on each.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;               // a thread a group
constexpr int kChunk = kThreads;            // groups a CTA
constexpr int kGroup = 50;
constexpr int kStride = kGroup + 1;         // a group's words in shared
constexpr int kTrees = 6;
constexpr int kWidth = 259;
constexpr int kTab = kTrees * kWidth;
constexpr int kAgg = 1, kIncl = 2;          // a descriptor's kinds
constexpr unsigned kFull = 0xFFFFFFFFu;

int groups_of(int NP) { return (NP + kGroup - 1) / kGroup; }
int chunks_of(int NP) { return (groups_of(NP) + kChunk - 1) / kChunk; }

// the padded group view's symbol at lane p into shared memory: mtfv below
// nm by an asynchronous copy (0 past NP), the dummy `as` at and past it
__device__ __forceinline__ void stage_symbol(int* dst,
                                             const int* __restrict__ row,
                                             int p, int nm, int NP, int as) {
  if (p < nm && p < NP) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(row + p)
                 : "memory");
  } else {
    *dst = p < nm ? 0 : as;
  }
}

// a (tree, symbol) pair's entry of the flat (6 x 259) tables
__device__ __forceinline__ int entry(int tree, int sym) {
  return min(max(tree * kWidth + sym, 0), kTab - 1);
}

__device__ __forceinline__ int packed(const long long* __restrict__ codes,
                                      const int* __restrict__ lens,
                                      size_t e) {
  return (__ldg(lens + e) << 24) | (int)(__ldg(codes + e) & 0xFFFFFF);
}

// a symbol's (len << 24 | code) for the tree: from shared memory for the
// symbols 0 .. lim, else from device memory
__device__ __forceinline__ int lookup(const int* tab, int tree, int sym,
                                      int lim,
                                      const long long* __restrict__ codes,
                                      const int* __restrict__ lens,
                                      size_t row) {
  if ((unsigned)sym <= (unsigned)lim) return tab[tree * kWidth + sym];
  return packed(codes, lens, row + entry(tree, sym));
}

// a word of the group's bits into the output: stored when the group
// covers it whole, else ORed (an edge word, shared with a neighbour);
// nothing at or past the row's row_words words
__device__ __forceinline__ void put(unsigned* out, int w, unsigned v,
                                    bool whole, int row_words) {
  if (w >= row_words) return;
  if (whole)
    out[w] = v;
  else if (v)
    atomicOr(out + w, v);
}

// a descriptor: the status (epoch << 2 | kind, 0 while unpublished) in
// the high word, the chunk's aggregate or inclusive bits in the low one
__device__ __forceinline__ unsigned long long ld_desc(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* p, int kind,
                                        unsigned bits, int epoch) {
  const unsigned long long v =
      (unsigned long long)(unsigned)(epoch << 2 | kind) << 32 | bits;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// warp 0: the bits of the row's chunks before chunk c, right to left, 32
// descriptors at a time, up to the first inclusive sum (a lane left of
// chunk 0 holds 0 as inclusive)
__device__ unsigned look_back(const unsigned long long* rd, int c, int epoch,
                              int lane) {
  unsigned acc = 0;
  for (int top = c - 1;; top -= 32) {
    const int j = top - lane;
    int kind = kIncl;
    unsigned v = 0;
    if (j >= 0) {
      unsigned long long w;
      do {
        w = ld_desc(rd + j);
      } while ((int)(w >> 34) != epoch);
      kind = (int)(w >> 32) & 3;
      v = (unsigned)w;
    }
    const unsigned incl = __ballot_sync(kFull, kind == kIncl);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    acc += __reduce_add_sync(kFull, lane <= stop ? v : 0u);
    if (incl) return acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_chunks(const int* __restrict__ mtfv, const int* __restrict__ nm,
                const int* __restrict__ ninuse,
                const int* __restrict__ ngroups, const int* __restrict__ sel,
                const long long* __restrict__ codes,
                const int* __restrict__ lens,
                const int* __restrict__ start_bit,
                const int* __restrict__ ends, int B, int NP, int G,
                int chunks, int W, int F, int epoch,
                unsigned* __restrict__ words, long long* __restrict__ total,
                unsigned long long* __restrict__ desc,
                int* __restrict__ ticket) {
  __shared__ int ent[kChunk * kStride];  // symbols, then their entries
  __shared__ int tab[kTab];
  __shared__ int tree_s[kChunk];
  __shared__ unsigned warp_bits[kThreads / 32];
  __shared__ int s_ticket;
  __shared__ unsigned s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const int k = atomicAdd(ticket, 1);
    if (k == B * chunks - 1) atomicExch(ticket, 0);  // the last one drawn
    s_ticket = k;
  }
  __syncthreads();
  const int c = s_ticket / B, b = s_ticket % B;
  // the row's words: words[b, :W], or in the flat mode flat[start, end)
  unsigned* out = words + (size_t)b * W;
  int row_words = W;
  if (ends) {
    const int start = b ? ends[b - 1] : 0;
    row_words = min(ends[b], F) - start;
    if (row_words <= 0) return;  // the row does not fit: no word to write
    out = words + start;
  }
  const int ng = min(max(ngroups[b], 0), G);
  const int cc = ng ? (ng - 1) / kChunk : 0;  // the row's last chunk
  if (c > cc) return;  // no valid group: its words stay 0
  const int rnm = nm[b], as = ninuse[b] + 2;
  const int g0 = c * kChunk;
  const int valid = min(kChunk, ng - g0);  // the chunk's valid groups

  // the valid groups' symbols, coalesced, each read once, every copy in
  // flight at once; the trees and the tables' entries of the symbols
  // 0 .. lim
  const int* row = mtfv + (size_t)b * NP;
  const int p0 = g0 * kGroup;
  for (int i = tid; i < valid * kGroup; i += kThreads)
    stage_symbol(ent + i / kGroup * kStride + i % kGroup, row, p0 + i, rnm,
                 NP, as);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < valid)
    tree_s[tid] = min(max(__ldg(sel + (size_t)b * G + g0 + tid), 0),
                      kTrees - 1);
  const int lim = min(max(as, 0), kWidth - 1);
  const size_t rtab = (size_t)b * kTab;
  for (int i = tid; i < kTrees * (lim + 1); i += kThreads) {
    const int e = i / (lim + 1) * kWidth + i % (lim + 1);
    tab[e] = packed(codes, lens, rtab + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // a thread a group: its entries in place of its symbols, its bits
  int* mine = ent + tid * kStride;
  int bits = 0;
  if (tid < valid) {
    const int tree = tree_s[tid];
#pragma unroll 10
    for (int k = 0; k < kGroup; ++k) {
      const int e = lookup(tab, tree, mine[k], lim, codes, lens, rtab);
      mine[k] = e;
      bits += e >> 24;
    }
  }
  // the groups' start bits in the chunk, the chunk's bits
  int incl = bits;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_bits[warp] = incl;
  __syncthreads();
  unsigned sum = 0, before_warp = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before_warp += warp_bits[w];
    sum += warp_bits[w];
  }
  if (warp == 0) {
    unsigned before = 0;
    unsigned long long* rd = desc + (size_t)b * chunks;
    if (c == 0) {
      if (lane == 0) publish(rd, kIncl, sum, epoch);
    } else {
      if (lane == 0) publish(rd + c, kAgg, sum, epoch);
      before = look_back(rd, c, epoch, lane);
      if (lane == 0) publish(rd + c, kIncl, before + sum, epoch);
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  const int base = start_bit[b] + (int)s_before;
  if (total && c == cc && tid == 0) total[b] = (long long)base + sum;
  if (!bits) return;  // no bit, or no valid group

  // a thread packs its group's codes MSB first into 32-bit words: the
  // first word is the group's own only when it starts on a word, the
  // last partial one is shared with the next group
  const int start = base + (int)before_warp + incl - bits;
  int w = start >> 5, nb = start & 31;  // bits of the word in acc
  bool whole = nb == 0;
  unsigned long long acc = 0;
#pragma unroll 10
  for (int k = 0; k < kGroup; ++k) {
    const int e = mine[k], len = e >> 24;
    if (len > 0) {
      acc = acc << len | (unsigned)(e & 0xFFFFFF);
      nb += len;
      if (nb >= 32) {
        nb -= 32;
        put(out, w++, (unsigned)(acc >> nb), whole, row_words);
        whole = true;
      }
    }
  }
  if (nb) put(out, w, (unsigned)(acc << (32 - nb)), false, row_words);
}

}  // namespace

// 64-bit words of the chunk descriptors for B rows of NP symbols (their
// status tagged with the call's epoch: any content is safe), and int32
// words of the state the kernel leaves 0 (zeroed once when made): the
// ticket counter
extern "C" long long lbz2t_pack_desc_words(int B, int NP) {
  return (long long)B * chunks_of(NP);
}
extern "C" long long lbz2t_pack_state_ints(int B) { return B > 0 ? 1 : 0; }

namespace {

int launch(const void* mtfv, const void* nm, const void* ninuse,
           const void* ngroups, const void* sel, const void* codes,
           const void* lens, const void* start_bit, const void* ends,
           void* words, void* total, void* desc, void* state, int B, int NP,
           int W, int F, int epoch, void* stream) {
  if (B <= 0 || NP <= 0 || W < 0 || F < 0 || epoch <= 0 ||
      epoch >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = groups_of(NP), chunks = chunks_of(NP);
  pack_chunks<<<B * chunks, kThreads, 0, s>>>(
      static_cast<const int*>(mtfv), static_cast<const int*>(nm),
      static_cast<const int*>(ninuse), static_cast<const int*>(ngroups),
      static_cast<const int*>(sel), static_cast<const long long*>(codes),
      static_cast<const int*>(lens), static_cast<const int*>(start_bit),
      static_cast<const int*>(ends), B, NP, G, chunks, W, F, epoch,
      static_cast<unsigned*>(words), static_cast<long long*>(total),
      static_cast<unsigned long long*>(desc), static_cast<int*>(state));
  return (int)cudaGetLastError();
}

}  // namespace

// mtfv (B, NP), nm, ninuse, ngroups (B,), sel (B, ceil(NP / 50)), lens
// (B, 6, 259) and start_bit (B,) int32, codes (B, 6, 259) int64 in;
// words (B, W) int32 zeroed and total (B,) int64 out; desc and state as
// above, epoch in 1 .. 2^29 - 1 and not the previous call's on this desc;
// all device pointers.
extern "C" int lbz2t_pack_groups(const void* mtfv, const void* nm,
                                 const void* ninuse, const void* ngroups,
                                 const void* sel, const void* codes,
                                 const void* lens, const void* start_bit,
                                 void* words, void* total, void* desc,
                                 void* state, int B, int NP, int W,
                                 int epoch, void* stream) {
  return launch(mtfv, nm, ninuse, ngroups, sel, codes, lens, start_bit,
                nullptr, words, total, desc, state, B, NP, W, 0, epoch,
                stream);
}

// The flat mode: the inputs of lbz2t_pack_groups and ends (B,) int32, the
// rows' inclusive word ends (non-decreasing, each row's count at most W);
// flat (F,) int32 zeroed out, the words of row r at [ends[r - 1],
// ends[r]) (from 0 for row 0), slots at and past F dropped.
extern "C" int lbz2t_pack_flat(const void* mtfv, const void* nm,
                               const void* ninuse, const void* ngroups,
                               const void* sel, const void* codes,
                               const void* lens, const void* start_bit,
                               const void* ends, void* flat, void* desc,
                               void* state, int B, int NP, int W, int F,
                               int epoch, void* stream) {
  if (!ends) return (int)cudaErrorInvalidValue;
  return launch(mtfv, nm, ninuse, ngroups, sel, codes, lens, start_bit,
                ends, flat, nullptr, desc, state, B, NP, W, F, epoch,
                stream);
}
