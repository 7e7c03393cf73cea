// MSB-first bit packer for Hopper (sm_90a): N (value, nbits) fields into
// big-endian 32-bit words, one launch behind the output's zero fill.
//
// Replaces the XLA-compiled device op lbzip2_tpu/ops/bitpack.py::
// pack_bits_device, which finds every output bit's field by merging the
// field starts with the output-bit grid in two sorts over 33N lanes (a
// TPU has no scatter to speak of).  Here each field's start bit is a
// prefix sum of the lengths, found in one pass: a single-pass chained
// scan with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA NVR-2016-002),
// as csrc/pack_groups.cu and csrc/rle2.cu do.
//
//   pack_scan  persistent CTAs (at most one wave) draw tickets (an
//              atomic counter, not blockIdx: every tile a CTA waits on
//              has then been drawn by a running CTA) for tiles of
//              kTile = kThreads x kPer fields, each CTA the next tile's
//              ticket and fields in flight while it finishes the
//              current one.  A thread loads its kPer consecutive
//              lengths and values by vector loads (by scalar ones for
//              inputs off 16-byte alignment and for the last, partial
//              vector), lengths 0 at and past nf.  A CTA scan of the
//              threads' bit counts gives each thread's offset and the
//              tile's bits, published as the tile's aggregate (status
//              A).  Each thread packs its fields MSB first through a
//              64-bit accumulator into the tile's words in shared
//              memory from the tile's first bit (a word the thread
//              covers whole is stored, its edge words ORed by shared
//              atomics), before the tile's start bit is known; then
//              warp 0 looks back over the earlier tiles, 32 descriptors
//              at a time, adding the aggregates up to the first
//              inclusive sum (status P; a status and its sum share one
//              64-bit word, so one store publishes both), and publishes
//              the tile's inclusive sum.  The tile's words go out in one
//              coalesced pass, shifted by the start bit's offset in its
//              word: a word the tile covers whole is stored, a word it
//              shares with the tiles beside it (its first, unless the
//              tile starts on a word, and its last partial one) is ORed
//              into the zero-filled output by atomicOr, and only when
//              it holds a set bit.  The tile of the last ticket writes
//              total_bits.
//
// Per-call state on the card, no host read and no reset launch: the
// descriptors' status carries the call's epoch and the CTA that draws the
// last ticket (each CTA draws one past the tiles) zeroes the counter
// (ops/lookback.py keeps the scratch per thread and device and advances
// the epoch).  Only tiles up to field nf - 1's are drawn.
//
// The words are int64 slots holding the u32 in their low half (the port's
// convention for a JAX uint32), values int64 the same way, lengths int32
// in 0..32.
//
// What bounds it: bytes, 12 a field in and up to 8 a field out (the zero
// fill writes 8 N more).  The scan adds a descriptor a tile; a field costs
// a few instructions.  At a text block's 347,851 fields every tile is
// resident at once and the chain of one tile binds: its ticket, its
// loads, and a look-back whose depth grows with the tiles before it.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // fields a thread
constexpr int kTile = kThreads * kPer;     // fields a CTA
constexpr int kWarps = kThreads / 32;
static_assert(kPer % 4 == 0, "a thread's fields by 16-byte loads");
constexpr int kTileWords = kTile + 2;      // a zero word, the tile's bits
constexpr int kAgg = 1, kIncl = 2;         // a descriptor's kinds
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// warp 0: the bits of the tiles before tile c, right to left, 32
// descriptors at a time, up to the first inclusive sum (a lane left of
// tile 0 holds 0 as inclusive)
__device__ __forceinline__ unsigned look_back(const unsigned long long* desc,
                                              int c, int epoch, int lane) {
  unsigned acc = 0;
  for (int top = c - 1;; top -= 32) {
    const int j = top - lane;
    int kind = kIncl;
    unsigned v = 0;
    if (j >= 0) {
      unsigned long long w;
      do {
        w = ld_desc(desc + j);
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

// a word of a thread's bits into the tile's words: stored when the thread
// covers it whole, else ORed
__device__ __forceinline__ void put(unsigned* sw, int w, unsigned v,
                                    bool whole) {
  if (whole)
    sw[w] = v;
  else if (v)
    atomicOr(sw + w, v);
}

// a thread's kPer fields of tile c: lengths 0 at and past nf
template <bool kVector>
__device__ __forceinline__ void load_fields(const long long* values,
                                            const int* lens, int nf, int c,
                                            int tid, int* len,
                                            unsigned* val) {
  const int f0 = c * kTile + tid * kPer;
  if (kVector && f0 + kPer <= nf) {
#pragma unroll
    for (int g = 0; g < kPer; g += 4) {
      const int4 l4 = __ldg(reinterpret_cast<const int4*>(lens + f0 + g));
      const longlong2 v01 =
          __ldg(reinterpret_cast<const longlong2*>(values + f0 + g));
      const longlong2 v23 =
          __ldg(reinterpret_cast<const longlong2*>(values + f0 + g + 2));
      len[g] = l4.x;
      len[g + 1] = l4.y;
      len[g + 2] = l4.z;
      len[g + 3] = l4.w;
      val[g] = (unsigned)v01.x;
      val[g + 1] = (unsigned)v01.y;
      val[g + 2] = (unsigned)v23.x;
      val[g + 3] = (unsigned)v23.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = f0 + k < nf;
      len[k] = in ? __ldg(lens + f0 + k) : 0;
      val[k] = in ? (unsigned)__ldg(values + f0 + k) : 0u;
    }
  }
}

// a thread's fields MSB first into the tile's words, the tile's first
// bit at bit 31 of sw[1]: its bits start at bit 32 + start of sw
__device__ __forceinline__ void pack_fields(unsigned* sw, int start, int bits,
                                            const int* len,
                                            const unsigned* val) {
  if (!bits) return;
  int w = start >> 5, nb = start & 31;  // bits of the word in acc
  bool whole = nb == 0;
  unsigned long long acc = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int l = len[k];
    if (l > 0) {
      const unsigned v = l == 32 ? val[k] : val[k] & ((1u << l) - 1);
      acc = acc << l | v;
      nb += l;
      if (nb >= 32) {
        nb -= 32;
        put(sw, w++, (unsigned)(acc >> nb), whole);
        whole = true;
      }
    }
  }
  if (nb) put(sw, w, (unsigned)(acc << (32 - nb)), false);
}

// thread 0: the next ticket; the CTA that draws the last one (every CTA
// draws one past the tiles) leaves the counter at 0
__device__ __forceinline__ int draw(int* ticket, int last) {
  const int k = atomicAdd(ticket, 1);
  if (k == last) atomicExch(ticket, 0);
  return k;
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    pack_scan(const long long* __restrict__ values,
              const int* __restrict__ lens, int nf, int tiles, int epoch,
              unsigned long long* __restrict__ words, int* __restrict__ total,
              unsigned long long* __restrict__ desc,
              int* __restrict__ ticket) {
  __shared__ unsigned sw[kTileWords];  // 0, then the tile's bits
  __shared__ unsigned warp_bits[kWarps];
  __shared__ int s_ticket[2];
  __shared__ unsigned s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last = tiles + gridDim.x - 1;  // the last ticket drawn
  if (tid == 0) s_ticket[0] = draw(ticket, last);
  for (int i = tid; i < kTileWords; i += kThreads) sw[i] = 0;
  __syncthreads();
  int c = s_ticket[0];
  int len[kPer];
  unsigned val[kPer];
  if (c < tiles) load_fields<kVector>(values, lens, nf, c, tid, len, val);
  for (int round = 1; c < tiles; ++round) {
    // the next tile's ticket, then its fields, in flight while this
    // tile looks back, packs and stores
    if (tid == 0) s_ticket[round & 1] = draw(ticket, last);
    int bits = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) bits += len[k];
    int incl = bits;  // the threads' offsets in the tile, its bits
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_bits[warp] = incl;
    __syncthreads();
    unsigned sum = 0, before_warp = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before_warp += warp_bits[w];
      sum += warp_bits[w];
    }
    if (warp == 0 && lane == 0)
      publish(desc + c, c ? kAgg : kIncl, sum, epoch);
    const int next = s_ticket[round & 1];
    int nlen[kPer];
    unsigned nval[kPer];
    if (next < tiles)
      load_fields<kVector>(values, lens, nf, next, tid, nlen, nval);
    pack_fields(sw, 32 + (int)before_warp + incl - bits, bits, len, val);
    if (warp == 0) {  // the tile's start bit
      unsigned before = 0;
      if (c) {
        before = look_back(desc, c, epoch, lane);
        if (lane == 0) publish(desc + c, kIncl, before + sum, epoch);
      }
      if (lane == 0) s_before = before;
    }
    __syncthreads();
    const unsigned base = s_before;
    if (c == tiles - 1 && tid == 0) *total = (int)(base + sum);

    // the tile's words out, shifted right by o = base & 31: whole ones
    // stored, the ones shared with the tiles beside it ORed; sw zeroed
    // behind them for the next tile
    const int o = base & 31;
    const int end = o + (int)sum;  // the tile's bits end here, from word 0
    const int nw = (end + 31) >> 5;
    unsigned long long* out = words + (base >> 5);
    for (int j = tid; j < nw; j += kThreads) {
      const unsigned v = o ? sw[j] << (32 - o) | sw[j + 1] >> o : sw[j + 1];
      if (32 * j >= o && 32 * j + 32 <= end)
        out[j] = v;
      else if (v)
        atomicOr(out + j, (unsigned long long)v);
    }
    __syncthreads();
    for (int i = tid + 1; i <= nw; i += kThreads) sw[i] = 0;
    c = next;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      len[k] = nlen[k];
      val[k] = nval[k];
    }
  }
}

// CTAs of one wave of kernel on the current device (at most kMaxDevices
// devices), found once a device and kernel
constexpr int kMaxDevices = 64;
int wave_of[2][kMaxDevices];

template <typename K>
cudaError_t wave(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& held = wave_of[kernel == pack_scan<true>][dev];
  if (held == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm * sms <= 0) return cudaErrorInvalidConfiguration;
    held = per_sm * sms;
  }
  *out = held;
  return cudaSuccess;
}

}  // namespace

// 64-bit words of the tile descriptors for N fields (their status tagged
// with the call's epoch: any content is safe), and int32 words of the
// state the kernel leaves 0 (zeroed once when made): the ticket counter
extern "C" long long lbz2t_pack_bits_desc_words(int N) {
  return N > 0 ? (N + kTile - 1) / kTile : 1;
}
extern "C" long long lbz2t_pack_bits_state_ints() { return 1; }

// values (N,) int64 and lens (N,) int32 in; words (N,) int64 zeroed and
// total (1,) int32 out; fields at and past nf (0 <= nf <= N) ignored;
// threads and per the wrapper's constants (checked); desc and state as
// above, epoch in 1 .. 2^29 - 1 and not the previous call's on this desc;
// all device pointers.
extern "C" int lbz2t_pack_bits(const void* values, const void* lens, int N,
                               int nf, int threads, int per, void* words,
                               void* total, void* desc, void* state,
                               int epoch, void* stream) {
  if (N <= 0 || nf < 0 || nf > N || threads != kThreads || per != kPer ||
      epoch <= 0 || epoch >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = nf > 0 ? (nf + kTile - 1) / kTile : 1;
  const bool vector =
      ((reinterpret_cast<unsigned long long>(values) |
        reinterpret_cast<unsigned long long>(lens)) & 15) == 0;
  auto kernel = vector ? pack_scan<true> : pack_scan<false>;
  int ctas = 0;
  const cudaError_t e = wave(kernel, &ctas);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiles < ctas ? tiles : ctas, kThreads, 0, s>>>(
      static_cast<const long long*>(values), static_cast<const int*>(lens),
      nf, tiles, epoch, static_cast<unsigned long long*>(words),
      static_cast<int*>(total), static_cast<unsigned long long*>(desc),
      static_cast<int*>(state));
  return (int)cudaGetLastError();
}
