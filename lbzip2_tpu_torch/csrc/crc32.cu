// Zero-init bzip2 CRC register of a block, for Hopper (sm_90a): one
// launch, every segment folded to the block's end, the last CTA to
// finish XORs the CTAs' sums.
//
// Replaces the XLA-compiled device op lbzip2_tpu/ops/crc.py::
// crc32_device.  The register is linear over GF(2) in the bytes: with
// S^L "advance by L zero bytes" and T the byte table,
//
//   crc(block[:n]) = XOR over bytes p < n of S^(n - 1 - p)(T[block[p]])
//
// so the bytes may be cut into any pieces, each piece's zero-init CRC
// advanced by its distance to n and the results XORed in any order.
// Leading zero bytes never change a zero-init CRC.
//
// The cut: the block is read in virtual coordinates q = p + a, a the
// block's address mod 16, so that every 16-byte vector q = 16i .. 16i + 15
// is one aligned load; the virtual bytes before q = a are zeros (leading,
// free).  With E = a + n, the vectors below Eb = E & ~15 are the body
// and the t = E - Eb bytes past it the tail.  The body is cut into
// segments of seg_bytes from its end back (segment c covers virtual
// [Eb - (c + 1) seg, Eb - c seg); the front one may start below 0, where
// its vectors are leading zeros), so its register is advanced by
// c seg + t to reach E.
//
//   crc_segments  persistent CTAs (at most one wave, a grid-stride over
//     the segments) of kThreads threads.  Each reads 5.1 KB of matrices
//     and bit images and builds its tables from them in shared memory
//     (each table is linear in its byte: an entry is the XOR of its set
//     bits' entries; a thread builds 16 entries in Gray-code order, one
//     XOR each), the first kAhead rounds' data in flight meanwhile.  A
//     segment is rounds of kWarps warp chunks of 1 KB; lane l of a warp
//     loads the vectors at 16 l and 512 + 16 l of its chunk (coalesced),
//     its 32-byte leaf, whose zero-init CRC relative to the second
//     vector's end comes from 32 positional tables.  The tables are laid
//     out position-minor (entry (j, b) at b * 64 + j and, again, at
//     b * 64 + 32 + j), and lane l looks up place l + i at step i, so the
//     32 lookups of a warp fall in 32 different banks whatever the bytes
//     are, with one permute, one add and one load a byte; the lane's leaf
//     is rotated by l bytes in registers once so that step i's byte has a
//     fixed register.  A lane's leaves over the rounds are folded by
//     acc = S^(kRound)(acc) ^ leaf (four byte-table lookups in shared
//     memory), then lane l applies its own matrix, S^(16 (31 - l)) (32
//     independent loads), and __reduce_xor_sync sums the warp's lanes
//     at the end of its chunk.  Each warp then advances its chunk's
//     register to E by the hex digits of its distance, one 32 x 32 GF(2)
//     matrix a nonzero digit (lane k loads column k of each at the
//     start): lane k takes its column when bit k of the register is set
//     and __reduce_xor_sync sums the columns.  The CTA of segment 0 adds
//     the tail, read by bytes.  A CTA XORs its segments' registers into
//     one slot and takes a ticket (one acquire-release atomic); the CTA
//     that draws the last one XORs every slot (its warp 0), writes the
//     register and leaves the ticket at 0.
//
// The head vector (the one at q = 0 when a > 0) and the tail are read by
// byte loads, bytes >= n never.  The slots and the ticket are held per
// thread and device by the wrapper (ops/lookback.py::scratch, the ticket
// 0 between calls), so a call allocates nothing but its output.
//
// What bounds it: at 8 MiB, bytes (2.50 us at 3.35 TB/s); the lookups
// are one a byte in shared memory without bank conflicts.  At a 900 kB
// block the bound (0.27 us) is below a launch: a chain of latencies sets
// the time there (the tables' read and build, one load, the fold, the
// advance, the ticket and the last CTA's read of the slots).
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;                  // bytes a warp a round
constexpr int kRound = kWarps * kChunk;       // bytes a CTA a round
constexpr int kDigits = 6;                    // hex digits of a distance
constexpr int kLevels = kDigits * 15;         // matrices S^(v 16^p)
constexpr int kAhead = 3;                     // rounds loaded ahead
// the tables in device memory, in words: the matrices of S^(v 16^p) for
// p < kDigits, v = 1..15, at (15 p + v - 1) (column i the image of bit
// i), then each leaf place's register of the 8 single-bit bytes, then
// lane l's matrix S^(16 (31 - l)), column k at k * 32 + l
constexpr int kBasis = 32 * 8;
constexpr int kLaneMats = 32 * 32;
constexpr int kTabWords = kLevels * 32 + kBasis + kLaneMats;
// in shared memory: the positional tables (256 rows of 64: the 32 places,
// twice), the byte tables (4 x 256) of S^(kRound), what they are built
// from (its matrix, the basis) and the lanes' matrices
constexpr int kPos = 256 * 64;                // a row twice: no wrap
constexpr int kStaged = 32 + kBasis + kLaneMats;
constexpr int kSmemWords = kPos + 1024 + kStaged;
constexpr size_t kSmem = (size_t)kSmemWords * 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kStagedPer = (kStaged + kThreads - 1) / kThreads;
static_assert(kRound == 1 << 14, "the round's advance is S^(4 16^3)");

// the matrix of S^(v 16^p)
__host__ __device__ constexpr int matrix(int p, int v) {
  return 15 * p + v - 1;
}

// the staged word i: S^(kRound) = S^(4 16^3), the basis, the lanes'
// matrices
__device__ __forceinline__ int staged_word(int i) {
  return i < 32 ? matrix(3, 4) * 32 + i : kLevels * 32 + i - 32;
}

__device__ __forceinline__ unsigned advance(const unsigned* t, unsigned x) {
  return t[x & 0xFF] ^ t[256 + ((x >> 8) & 0xFF)] ^
         t[512 + ((x >> 16) & 0xFF)] ^ t[768 + (x >> 24)];
}

// the XOR of the words m[i] whose bit i of v is set, for the low 4 bits
__device__ __forceinline__ unsigned span4(const unsigned* m, unsigned v) {
  return (v & 1 ? m[0] : 0u) ^ (v & 2 ? m[1] : 0u) ^ (v & 4 ? m[2] : 0u) ^
         (v & 8 ? m[3] : 0u);
}

// Every table is linear in its byte over GF(2): a byte's entry is the XOR
// of its set bits' entries.  A thread builds the 16 entries of one table
// that share one nibble (value f, bit images fixed): that nibble's part,
// then the other nibble's 16 values in Gray-code order (bit images
// gray), one XOR each; the entry whose other nibble is i goes to
// dst[i * stride].
__device__ __forceinline__ void build_row(unsigned* dst, int stride,
                                          int dup, const unsigned* fixed,
                                          unsigned f, const unsigned* gray) {
  unsigned e[16];
  e[0] = span4(fixed, f);
#pragma unroll
  for (int g = 1; g < 16; ++g) {  // g ^ (g >> 1) flips one bit a step
    const int cur = g ^ (g >> 1), prev = (g - 1) ^ ((g - 1) >> 1);
    e[cur] = e[prev] ^ gray[31 - __clz(cur ^ prev)];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dst[i * stride] = e[i];
    if (dup) dst[i * stride + dup] = e[i];
  }
}

// the positional tables, pos[b * 64 + j] and pos[b * 64 + 32 + j], from
// the basis: a thread a place (a lane each: the stores meet 32 banks) and
// a high nibble; the byte tables [k][b] of S^(kRound) from its matrix's
// columns: a thread a byte place k and a low nibble
__device__ void build_tables(unsigned* tab, int tid) {
  unsigned* pos = tab;
  unsigned* lvl = pos + kPos;
  const unsigned* stride = lvl + 1024;
  const unsigned* basis = stride + 32;
  for (int e = tid; e < 32 * 16 + 4 * 16; e += kThreads) {
    if (e < 32 * 16) {
      const int j = e & 31, h = e >> 5;
      const unsigned* place = basis + j * 8;
      build_row(pos + h * 16 * 64 + j, 64, 32, place + 4, h, place);
    } else {
      const int v = e & 15, k = (e >> 4) & 3;
      const unsigned* col = stride + 8 * k;
      build_row(lvl + k * 256 + v, 16, 0, col, v, col + 4);
    }
  }
}

__device__ __forceinline__ void load_vec(const unsigned char* p, unsigned* w) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// the 16 bytes of the vector at virtual q0 (a multiple of 16): zeros
// before the stream, the head vector by bytes, any other by one load
__device__ __forceinline__ void vector_at(const unsigned char* base,
                                          long long q0, int a, unsigned* w) {
  if (q0 < 0) {
    w[0] = w[1] = w[2] = w[3] = 0;
  } else if (q0 == 0 && a > 0) {
    for (int k = 0; k < 4; ++k) {
      unsigned x = 0;
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * k + i;
        if (q >= a) x |= (unsigned)__ldg(base + q) << (8 * i);
      }
      w[k] = x;
    }
  } else {
    load_vec(base + q0, w);
  }
}

// a lane's leaf of round r of the segment starting at virtual s0
__device__ __forceinline__ void leaf_at(const unsigned char* base,
                                        long long s0, int r, int a, int warp,
                                        int lane, unsigned* w) {
  const long long q0 = s0 + (long long)r * kRound + warp * kChunk + 16 * lane;
  vector_at(base, q0, a, w);
  vector_at(base, q0 + kChunk / 2, a, w + 4);
}

// zero-init CRC of a lane's 32-byte leaf w[0..7] (little-endian words,
// the byte at the lower address low) relative to its end: rotate the leaf
// by l bytes, then step i looks up place l + i (its row's second copy past
// 31), bank (l + i) & 31
__device__ __forceinline__ unsigned leaf_crc(const unsigned* w0,
                                             const unsigned* pos, int lane) {
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = w0[k];
  const int v = lane >> 2;
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) {
    unsigned r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = v & m ? w[(k + m) & 7] : w[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = r[k];
  }
  const unsigned u = 8u * (lane & 3);
  unsigned r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = __funnelshift_r(w[k], w[(k + 1) & 7], u);
  // byte b's row starts at word 64 b: the permute puts b at bits 8..15,
  // its byte offset; place lane + i < 64 is an offset in the load
  const unsigned char* row =
      reinterpret_cast<const unsigned char*>(pos + lane);
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const unsigned off = __byte_perm(r[i >> 2], 0, 0x4404 | (i & 3) << 4);
    acc ^= *reinterpret_cast<const unsigned*>(row + off + 4 * i);
  }
  return acc;
}

// the distance from the end of warp's chunk in the last round of segment
// c to E: kChunk (kWarps - 1 - warp) to the segment's end, c seg + t more
__device__ __forceinline__ long long distance(int c, long long seg, int t,
                                              int warp) {
  return (long long)c * seg + t + (long long)kChunk * (kWarps - 1 - warp);
}

// lane's column of the matrix of each nonzero hex digit of d
__device__ __forceinline__ void columns(const unsigned* tables, long long d,
                                        int lane, unsigned* col) {
#pragma unroll
  for (int p = 0; p < kDigits; ++p) {
    const int v = (int)(d >> (4 * p)) & 15;
    col[p] = v ? __ldg(tables + matrix(p, v) * 32 + lane) : 0u;
  }
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__global__ void __launch_bounds__(kThreads)
    crc_segments(const unsigned char* __restrict__ block, long long n, int a,
                 const unsigned* __restrict__ tables, long long seg,
                 int nsegs, unsigned* __restrict__ slots,
                 int* __restrict__ ticket,
                 unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned tab[];
  __shared__ unsigned warp_reg[kWarps];
  const unsigned* pos = tab;
  const unsigned* lvl = tab + kPos;
  unsigned* staged = tab + kPos + 1024;
  const unsigned* lane_mat = staged + 32 + kBasis;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long E = a + n, Eb = E & ~15LL;
  const int t = (int)(E - Eb);
  const unsigned char* base = block - a;  // virtual q = 0, 16-aligned
  const int rounds = (int)(seg / kRound);

  // first what the tables are built from (the round's matrix, the basis)
  // and the lanes' matrices, and the columns of this warp's advance (a
  // matrix a nonzero hex digit of its distance), then the first kAhead
  // rounds' leaves, in flight while the tables are built
  unsigned word[kStagedPer];
#pragma unroll
  for (int k = 0; k < kStagedPer; ++k) {
    const int i = tid + k * kThreads;
    word[k] = i < kStaged ? __ldg(tables + staged_word(i)) : 0u;
  }
  int c = blockIdx.x;
  long long d = distance(c, seg, t, warp);
  unsigned col[kDigits];
  columns(tables, d, lane, col);
  unsigned w[kAhead + 1][8] = {};
  long long s0 = Eb - (c + 1) * seg;  // the segment's virtual start
#pragma unroll
  for (int r = 0; r < kAhead; ++r)
    if (r < rounds) leaf_at(base, s0, r, a, warp, lane, w[r]);
#pragma unroll
  for (int k = 0; k < kStagedPer; ++k)
    if (tid + k * kThreads < kStaged) staged[tid + k * kThreads] = word[k];
  __syncthreads();
  build_tables(tab, tid);
  __syncthreads();

  unsigned total = 0;  // thread 0: the CTA's segments, advanced
  for (;;) {
    unsigned acc = 0;
    for (int r = 0; r < rounds; ++r) {
      if (r + kAhead < rounds)
        leaf_at(base, s0, r + kAhead, a, warp, lane, w[kAhead]);
      acc = advance(lvl, acc) ^ leaf_crc(w[0], pos, lane);
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) w[i][k] = w[i + 1][k];
    }
    const int cn = c + gridDim.x;  // the next segment's first leaves
    const long long sn = Eb - (cn + 1) * seg;
    if (cn < nsegs) {
#pragma unroll
      for (int r = 0; r < kAhead; ++r)
        if (r < rounds) leaf_at(base, sn, r, a, warp, lane, w[r]);
    }
    const long long dn = distance(cn, seg, t, warp);
    unsigned coln[kDigits];
    if (cn < nsegs) columns(tables, dn, lane, coln);
    // lane l's register ends 16 (31 - l) bytes before its chunk's end:
    // each lane applies its own matrix (32 independent loads, bank l),
    // the warp sums the results
    unsigned moved = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      moved ^= (acc >> k) & 1 ? lane_mat[k * 32 + lane] : 0u;
    acc = __reduce_xor_sync(kFull, moved);
    // the warp's register to E: the columns of its set bits summed over
    // the warp, a matrix a nonzero hex digit of the distance
#pragma unroll
    for (int p = 0; p < kDigits; ++p)
      if ((d >> (4 * p)) & 15)
        acc = __reduce_xor_sync(kFull, (acc >> lane) & 1 ? col[p] : 0u);
    if (c == 0 && warp == 0) {  // the tail: t bytes, read by bytes
      unsigned x = 0;
      const long long q = Eb + lane;
      if (lane < t && q >= a) {
        const unsigned b = __ldg(base + q);
        x = pos[b * 64 + 32 - t + lane];  // distance t - 1 - lane to E
      }
      acc ^= __reduce_xor_sync(kFull, x);
    }
    if (lane == 0) warp_reg[warp] = acc;
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kWarps; ++k) total ^= warp_reg[k];
    }
    c = cn;
    s0 = sn;
    d = dn;
#pragma unroll
    for (int p = 0; p < kDigits; ++p) col[p] = coln[p];
    if (c >= nsegs) break;
    __syncthreads();
  }

  // one slot a CTA; the last CTA to finish XORs them all (warp 0)
  if (warp) return;
  int last = 0;
  if (lane == 0) {
    slots[blockIdx.x] = total;
    last = atomic_add_acq_rel(ticket, 1) == (int)gridDim.x - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  unsigned x = 0;
  for (int i = lane; i < (int)gridDim.x; i += 32) x ^= __ldcg(slots + i);
  x = __reduce_xor_sync(kFull, x);
  if (lane == 0) {
    *out = x;
    *ticket = 0;
  }
}

// CTAs of one wave on the current device (at most kMaxDevices devices),
// found once a device; the kernel's shared memory raised above 48 KB there
constexpr int kMaxDevices = 64;
int wave_of[kMaxDevices];

cudaError_t wave(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (wave_of[dev] == 0) {
    e = cudaFuncSetAttribute(crc_segments,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc_segments,
                                                        kThreads, kSmem);
    if (e != cudaSuccess) return e;
    if (per_sm * sms <= 0) return cudaErrorInvalidConfiguration;
    wave_of[dev] = per_sm * sms;
  }
  *out = wave_of[dev];
  return cudaSuccess;
}

}  // namespace

// words of the tables the kernel reads (the hex digits' matrices, the leaf
// places' bit images, the lanes' matrices; the layout
// ops/crc.py::_kernel_tables builds)
extern "C" long long lbz2t_crc32_table_words() { return kTabWords; }

// block (n bytes at any address) uint8; tables as above; seg_bytes a
// multiple of kRound and threads == kThreads (the wrapper's constants,
// checked); slots (max_slots) uint32 scratch, ticket one int32 left 0
// (zeroed once when made); out one uint64 (the register, zero-extended);
// all device pointers.  n <= 8 MiB.
extern "C" int lbz2t_crc32(const void* block, long long n, const void* tables,
                           long long seg_bytes, int threads, void* slots,
                           int max_slots, void* ticket, void* out,
                           void* stream) {
  if (n < 0 || n > (8LL << 20) || threads != kThreads || seg_bytes <= 0 ||
      seg_bytes % kRound)
    return (int)cudaErrorInvalidValue;
  const int a = (int)(reinterpret_cast<unsigned long long>(block) & 15);
  const long long Eb = (a + n) & ~15LL;
  const long long nsegs = Eb > 0 ? (Eb + seg_bytes - 1) / seg_bytes : 1;
  if (nsegs > max_slots) return (int)cudaErrorInvalidValue;
  int ctas = 0;
  const cudaError_t e = wave(&ctas);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(nsegs < ctas ? nsegs : ctas);
  crc_segments<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(block), n, a,
      static_cast<const unsigned*>(tables), seg_bytes, (int)nsegs,
      static_cast<unsigned*>(slots), static_cast<int*>(ticket),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
