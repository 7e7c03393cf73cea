/* entropy.c — native block entropy encoder (MTF+RLE2 -> bitstream).
 *
 * Implements the bzip2 block payload encoder validated against the
 * repo's Python oracle and the reference binary (behavioral spec:
 * reference src/encode.c:340-1281; all code here is an independent
 * structure over that spec).  Stages:
 *   - mtf_rle2: MTF + zero-run bijective-base-2 coding of BWT bytes
 *   - greedy initial symbol partition into equivalence classes
 *   - EM clustering (cluster_factor iters): per-group tree selection
 *     by true per-tree bit cost folded through the spec's 10-bit-lane
 *     carry semantics, then per-tree Huffman refit (huffman2.c)
 *   - package-merge length limiting + tree-height cost search
 *   - selector MTF, byte-alignment padding (tree_pad/dummy selector)
 *   - big-endian bit packing
 *
 * Compiled into lbz2_native.so (included from lbz2_native.c).
 */

#define MAX_ALPHA 258
#define EM_MAX_GROUPS ((MAX_BLOCK_SIZE + GROUP_SIZE - 1) / GROUP_SIZE + 1)

#ifdef ENT_PROF  /* opt-in substage timing, same scheme as ITB_PROF */
#include <time.h>
double ENTP[8];
static double entp_now(void){struct timespec ts;clock_gettime(CLOCK_MONOTONIC,&ts);return ts.tv_sec+1e-9*ts.tv_nsec;}
#define ENT_T0 double _ent_t0 = entp_now();
#define ENTT(k) ENTP[k] += entp_now() - _ent_t0; _ent_t0 = entp_now();
#else
#define ENT_T0
#define ENTT(k)
#endif

#include "huffman2.c"

/* ---------------- MTF + RLE2 ---------------- */

/* bwt: block bytes; cmap_used: 0/1 per byte value.
 * mtfv_out must hold MAX_BLOCK_SIZE+GROUP_SIZE+2 entries.
 * Returns nmtf. */
static long mtf_rle2_c(const uint8_t *bwt, long n, const uint8_t *cmap_used,
                       uint16_t *mtfv_out) {
  uint8_t cmap[256];
  uint8_t order[256];
  int ninuse = 0;
  for (int i = 0; i < 256; i++) {
    cmap[i] = (uint8_t)ninuse;
    if (cmap_used[i]) ninuse++;
  }
  for (int i = 0; i < ninuse; i++) order[i] = (uint8_t)i;
  long nm = 0;
  long k = 0; /* pending zero-run */
  uint8_t u = 0;
  for (long i = 0; i < n; i++) {
    uint8_t c = cmap[bwt[i]];
    if (c == u) { k++; continue; }
    while (k) { k--; mtfv_out[nm++] = (uint16_t)(k & 1); k >>= 1; }
    /* find rank of c (>=1) and move to front */
    int r = 1;
    uint8_t prev = order[0];
    order[0] = c;
    while (prev != c) {
      uint8_t t = order[r];
      order[r] = prev;
      prev = t;
      r++;
    }
    /* r-1 is the rank; we emitted shifts for r-1 slots */
    mtfv_out[nm++] = (uint16_t)r; /* rank (r-1) + 1 == r */
    u = c;
  }
  while (k) { k--; mtfv_out[nm++] = (uint16_t)(k & 1); k >>= 1; }
  mtfv_out[nm++] = (uint16_t)(ninuse + 1); /* EOB */
  return nm;
}

/* MTF + RLE2 straight from (byte, runlen) tokens — the device BWT's
 * download format (ops/bwt2.py emit2).  A run of L equal bytes is one
 * MTF rank followed by L-1 front hits, so the zero-run accounting
 * works per token instead of per byte; adjacent tokens may repeat the
 * same byte (runs split at 255), which just extends the pending run.
 * Bit-identical to mtf_rle2_c over the expanded bytes. */
static long mtf_rle2_tokens_c(const uint16_t *tok, long ntok,
                              const uint8_t *cmap_used,
                              uint16_t *mtfv_out) {
  uint8_t cmap[256];
  union { uint8_t b[264]; uint64_t w[33]; } order;
  int ninuse = 0;
  for (int i = 0; i < 256; i++) {
    cmap[i] = (uint8_t)ninuse;
    if (cmap_used[i]) ninuse++;
  }
  /* bytes >= ninuse are never a hit (the scan always terminates at c,
   * which lives below ninuse) but must be defined for the word reads */
  memset(order.b, 0xFF, sizeof(order.b));
  for (int i = 0; i < ninuse; i++) order.b[i] = (uint8_t)i;
  long nm = 0;
  long k = 0; /* pending zero-run (front hits) */
  uint8_t u = 0;
  for (long t = 0; t < ntok; t++) {
    uint8_t c = cmap[tok[t] >> 8];
    long len = tok[t] & 0xFF;
    if (c == u) { k += len; continue; }
    while (k) { k--; mtfv_out[nm++] = (uint16_t)(k & 1); k >>= 1; }
    /* rank of c: SWAR zero-byte scan over 8-byte words of the MTF
     * list, then one memmove shift — ~r/8 word steps instead of the
     * r-step byte-at-a-time chain (r-1 = rank; the list always
     * contains c so the scan terminates) */
    uint64_t pat = (uint64_t)c * 0x0101010101010101ULL;
    int wi = 0;
    uint64_t x;
    for (;;) {
      x = order.w[wi] ^ pat;
      uint64_t zf = (x - 0x0101010101010101ULL) & ~x &
                    0x8080808080808080ULL;
      if (zf) { x = zf; break; }
      wi++;
    }
    int rb = __builtin_ctzll(x) >> 3;
    int r = wi * 8 + rb;                          /* position of c */
    if (wi == 0) {
      /* common case: shift happens inside word 0, no memmove */
      uint64_t w0 = order.w[0];
      uint64_t low = (r == 7) ? ~0ULL : ((1ULL << (8 * (r + 1))) - 1);
      order.w[0] = (w0 & ~low) | (((w0 << 8) | c) & low);
    } else {
      memmove(order.b + 1, order.b, (size_t)r);
      order.b[0] = c;
    }
    mtfv_out[nm++] = (uint16_t)(r + 1);
    u = c;
    k += len - 1;
  }
  while (k) { k--; mtfv_out[nm++] = (uint16_t)(k & 1); k >>= 1; }
  mtfv_out[nm++] = (uint16_t)(ninuse + 1); /* EOB */
  return nm;
}

/* Full payload encode from run tokens (device-BWT fast path: skips
 * materializing the 900k BWT byte row entirely). */
long lbz2_encode_payload_from_tokens(const uint16_t *tok, long ntok,
                                     const uint8_t *cmap_used,
                                     long bwt_idx, uint32_t crc_stored,
                                     int cluster_factor,
                                     uint16_t *mtfv_scratch,
                                     uint8_t *out);

/* ---------------- initial equivalence classes ----------------
 *
 * Partition the MTF alphabet into nt contiguous classes of roughly
 * equal total frequency.  Expressed over precomputed prefix sums:
 * class t spans [a, b) where b is the smallest bound such that either
 * the remaining classes could not each get a nonzero symbol, or the
 * class holds at least 1/m of the remaining mass (m = classes left);
 * a class that overshot the average by more than half its last
 * symbol's frequency gives that symbol back.  Spec semantics:
 * reference src/encode.c:779-841. */
static void initial_classes(uint8_t lengths[MAX_TREES][MAX_ALPHA + 1],
                            const uint32_t *mtf_freq, int as, long nm,
                            int nt) {
  static __thread uint64_t P[MAX_ALPHA + 2];  /* freq prefix sums */
  static __thread int NZ[MAX_ALPHA + 2];      /* nonzero-count prefix */
  P[0] = 0;
  NZ[0] = 0;
  for (int v = 0; v < as; v++) {
    P[v + 1] = P[v] + mtf_freq[v];
    NZ[v + 1] = NZ[v] + (mtf_freq[v] != 0);
  }
  int nz_total = NZ[as];
  int nte = nt < nz_total ? nt : nz_total;

  int a = 0;
  for (int m = nte; m >= 1; m--) {
    int t = nte - m;
    uint64_t rem = nm - P[a];   /* mass left for classes t..nte-1 */
    int b = a + 1;
    while (NZ[as] - NZ[b] > m - 1 &&
           (P[b] - P[a]) * (uint64_t)m < rem)
      b++;
    uint64_t c2 = P[b] - P[a];
    uint64_t f_last = mtf_freq[b - 1];
    if (c2 > f_last && (2 * c2 - f_last) * (uint64_t)m > 2 * rem)
      b--;
    for (int v = a; v < b; v++) lengths[t][v] = 0;
    a = b;
  }
}

/* ---------------- EM + full payload encode ---------------- */

long lbz2_encode_payload_from_mtfv(uint16_t *mtfv, long nm,
                                   const uint8_t *cmap_used, long bwt_idx,
                                   uint32_t crc_stored, int cluster_factor,
                                   uint8_t *out);

typedef struct {
  uint64_t bits;
  int nbits;
  uint8_t *out;
  long pos;
} bw_t;

static inline void bw_put(bw_t *w, uint32_t v, int k) {
  w->bits = (w->bits << k) | v;
  w->nbits += k;
  while (w->nbits >= 8) {
    w->nbits -= 8;
    w->out[w->pos++] = (uint8_t)(w->bits >> w->nbits);
  }
}

/* Full payload encode.  bwt_bytes: BWT output bytes for one block.
 * Returns payload byte length.  The run scan is fused into the MTF
 * loop (BWT rows are run-heavy by construction, so the MTF does one
 * rank lookup per RUN, not per byte; no intermediate token array —
 * that cost a 2-byte write+read per run).  mtf_rle2_c /
 * mtf_rle2_tokens_c remain as differential oracles, tested in
 * tests/test_native.py. */
long lbz2_encode_payload(const uint8_t *bwt_bytes, long n,
                         const uint8_t *cmap_used, long bwt_idx,
                         uint32_t crc_stored, int cluster_factor,
                         uint16_t *mtfv_scratch, uint8_t *out) {
  ENT_T0
  uint8_t cmap[256];
  union { uint8_t b[264]; uint64_t w[33]; } order;
  int ninuse = 0;
  for (int v = 0; v < 256; v++) {
    cmap[v] = (uint8_t)ninuse;
    if (cmap_used[v]) ninuse++;
  }
  memset(order.b, 0xFF, sizeof(order.b));
  for (int v = 0; v < ninuse; v++) order.b[v] = (uint8_t)v;
  uint16_t *mv = mtfv_scratch;
  long nm = 0;
  long k = 0;  /* pending zero-run (front hits) */
  uint8_t u = 0;
  long i = 0;
  while (i < n) {
    uint8_t cb = bwt_bytes[i];
    long j = i + 1;
    while (j < n && bwt_bytes[j] == cb) j++;
    long len = j - i;
    i = j;
    uint8_t c = cmap[cb];
    if (c == u) { k += len; continue; }
    while (k) { k--; mv[nm++] = (uint16_t)(k & 1); k >>= 1; }
    uint64_t pat = (uint64_t)c * 0x0101010101010101ULL;
    int wi = 0;
    uint64_t x;
    for (;;) {
      x = order.w[wi] ^ pat;
      uint64_t zf = (x - 0x0101010101010101ULL) & ~x &
                    0x8080808080808080ULL;
      if (zf) { x = zf; break; }
      wi++;
    }
    int r = wi * 8 + (__builtin_ctzll(x) >> 3);
    if (wi == 0) {
      uint64_t w0 = order.w[0];
      uint64_t low = (r == 7) ? ~0ULL : ((1ULL << (8 * (r + 1))) - 1);
      order.w[0] = (w0 & ~low) | (((w0 << 8) | c) & low);
    } else {
      memmove(order.b + 1, order.b, (size_t)r);
      order.b[0] = c;
    }
    mv[nm++] = (uint16_t)(r + 1);
    u = c;
    k += len - 1;
  }
  while (k) { k--; mv[nm++] = (uint16_t)(k & 1); k >>= 1; }
  mv[nm++] = (uint16_t)(ninuse + 1);  /* EOB */
  ENTT(1)
  return lbz2_encode_payload_from_mtfv(mtfv_scratch, nm, cmap_used,
                                       bwt_idx, crc_stored,
                                       cluster_factor, out);
}

/* Byte-loop MTF variant kept as the differential oracle for the
 * token MTF (tests/test_native.py). */
long lbz2_encode_payload_bytewise(const uint8_t *bwt_bytes, long n,
                                  const uint8_t *cmap_used,
                                  long bwt_idx, uint32_t crc_stored,
                                  int cluster_factor,
                                  uint16_t *mtfv_scratch,
                                  uint8_t *out) {
  long nm = mtf_rle2_c(bwt_bytes, n, cmap_used, mtfv_scratch);
  return lbz2_encode_payload_from_mtfv(mtfv_scratch, nm, cmap_used,
                                       bwt_idx, crc_stored,
                                       cluster_factor, out);
}

long lbz2_encode_payload_from_tokens(const uint16_t *tok, long ntok,
                                     const uint8_t *cmap_used,
                                     long bwt_idx, uint32_t crc_stored,
                                     int cluster_factor,
                                     uint16_t *mtfv_scratch,
                                     uint8_t *out) {
  long nm = mtf_rle2_tokens_c(tok, ntok, cmap_used, mtfv_scratch);
  return lbz2_encode_payload_from_mtfv(mtfv_scratch, nm, cmap_used,
                                       bwt_idx, crc_stored,
                                       cluster_factor, out);
}

long lbz2_encode_payload_from_mtfv(uint16_t *mtfv, long nm,
                                   const uint8_t *cmap_used, long bwt_idx,
                                   uint32_t crc_stored, int cluster_factor,
                                   uint8_t *out) {
  ENT_T0
  int as = (int)mtfv[nm - 1] + 1;
  long ns = (nm + GROUP_SIZE - 1) / GROUP_SIZE;
  int nt = nm > 2400 ? 6 : nm > 1200 ? 5 : nm > 600 ? 4 :
           nm > 300 ? 3 : nm > 150 ? 2 : 1;

  /* pad last group with dummy symbol `as` */
  for (long i = nm; i < ns * GROUP_SIZE; i++) mtfv[i] = (uint16_t)as;

  /* global MTF freq for initial ECs */
  uint32_t mtf_freq[MAX_ALPHA + 1];
  memset(mtf_freq, 0, sizeof(mtf_freq));
  for (long i = 0; i < nm; i++) mtf_freq[mtfv[i]]++;

  static __thread uint8_t lengths[MAX_TREES][MAX_ALPHA + 1];
  static __thread uint32_t codes_tab[MAX_TREES][MAX_ALPHA + 1];
  static __thread uint32_t freqs[MAX_TREES][MAX_ALPHA + 1];
  static __thread uint8_t selectors[EM_MAX_GROUPS + 1];
  memset(lengths, 1, sizeof(lengths));

  initial_classes(lengths, mtf_freq, as, nm, nt);
  ENTT(2)

  /* EM iterations.  E-step: per-group per-tree bit costs from a
   * symbol-major table of ONE uint64 per symbol holding all six
   * trees' lengths in base-1024 lanes — the spec's own packed layout
   * (cost lanes wrap mod 1024 and lane overflow carries into the
   * next tree's lane, reference semantics src/encode.c:847-877).
   * uint64 addition is associative and commutative mod 2^64, so the
   * group total — including every cross-lane carry — is identical no
   * matter how the 50 adds are ordered or split across independent
   * accumulators; four parallel chains hide the load latency while
   * costing half the adds of a carry-free 16-bit-lane layout. */
  /* Fixed-point cutoff: if an E-step reproduces the previous
   * iteration's selectors, freqs are identical too, the M-step
   * reproduces the same lengths, and every remaining iteration is the
   * identity — so the final (lengths, freqs, selectors) state equals
   * the full cluster_factor run's, bit-for-bit, and the loop may
   * stop.  EM typically converges in 3-5 of the 8 iterations. */
  static __thread uint8_t prev_sel[EM_MAX_GROUPS + 1];
  for (int iter = 0; iter < cluster_factor; iter++) {
    static __thread uint64_t lenP[MAX_ALPHA + 1];
    for (int v = 0; v <= as; v++) {
      uint64_t a = 0;
      if (v < as)
        for (int t = 0; t < MAX_TREES; t++)
          a += (uint64_t)lengths[t][v] << (10 * t);
      lenP[v] = a;
    }

    memset(freqs, 0, (size_t)nt * sizeof(freqs[0]));
    uint8_t *sp = selectors;
    for (long g = 0; g < ns; g++) {
      const uint16_t *gs = mtfv + g * GROUP_SIZE;
      uint64_t a = 0, b = 0, c = 0, d = 0;
      for (int i = 0; i < GROUP_SIZE - 2; i += 4) {   /* 48 = 12x4 */
        a += lenP[gs[i]];
        b += lenP[gs[i + 1]];
        c += lenP[gs[i + 2]];
        d += lenP[gs[i + 3]];
      }
      a += lenP[gs[GROUP_SIZE - 2]];                  /* tail 48, 49 */
      b += lenP[gs[GROUP_SIZE - 1]];
      a += b + c + d;
      unsigned bc = 0x400;
      int bt = 0;
      for (int t = 0; t < nt; t++) {
        unsigned cst = (unsigned)(a >> (10 * t)) & 0x3FF;
        if (t == 0 || cst < bc) { bc = cst; bt = t; }
      }
      *sp++ = (uint8_t)bt;
      for (int i = 0; i < GROUP_SIZE; i++) freqs[bt][gs[i]]++;
    }
    ENTT(3)
    for (int t = 0; t < nt; t++)
      make_code_lengths2(lengths[t], freqs[t], as);
    ENTT(4)
    if (iter > 0 && memcmp(selectors, prev_sel, (size_t)ns) == 0)
      break;  /* fixed point reached */
    if (iter < cluster_factor - 1)
      memcpy(prev_sel, selectors, (size_t)ns);
  }

  ENTT(4)
  /* reorder trees by first use; assign final codes */
  int tmap_old2new[MAX_TREES], tmap_new2old[MAX_TREES];
  uint32_t cost = 0;
  {
    unsigned not_seen = (1u << nt) - 1;
    int new_nt = 0;
    for (long g = 0; g < ns && not_seen; g++) {
      int t = selectors[g];
      if (not_seen & (1u << t)) {
        not_seen -= 1u << t;
        tmap_old2new[t] = new_nt;
        tmap_new2old[new_nt] = t;
        new_nt++;
        cost += assign_codes2(codes_tab[t], lengths[t], freqs[t], as);
        codes_tab[t][as] = 0;
        lengths[t][as] = 0;
      }
    }
    if (new_nt == 1) {
      /* the format requires >= 2 trees: fabricate a balanced dummy */
      new_nt = 2;
      int t = tmap_new2old[0] ^ 1;
      tmap_old2new[t] = 1;
      tmap_new2old[1] = t;
      int cl0 = 0;
      while ((2 << cl0) <= as) cl0++;  /* cl0 = floor(log2(as)) */
      int v = 0;
      int nshort = (2 << cl0) - as;
      for (; v < nshort; v++) lengths[t][v] = (uint8_t)cl0;
      if (v < as) cost += 2;
      for (; v < as; v++) lengths[t][v] = (uint8_t)(cl0 + 1);
      cost += (uint32_t)as + 5;
    }
    nt = new_nt;
  }

  /* selector MTF */
  static __thread uint8_t smtf[EM_MAX_GROUPS + 2];
  long n_smtf = 0;
  {
    int order[MAX_TREES] = {0, 1, 2, 3, 4, 5};
    for (long g = 0; g < ns; g++) {
      int c = tmap_old2new[selectors[g]];
      int j = 0;
      while (order[j] != c) j++;
      for (int q = j; q > 0; q--) order[q] = order[q - 1];
      order[0] = c;
      smtf[n_smtf++] = (uint8_t)j;
    }
  }

  /* cost + padding */
  uint64_t total = 48 + 32 + 1 + 24 + 3 + 15 + cost;
  for (long i = 0; i < n_smtf; i++) total += smtf[i] + 1;
  int pad = (int)((8 - (total & 7)) & 7);
  int tree_pad = pad >> 1;
  long num_selectors = ns;
  if (pad & 1) { smtf[n_smtf++] = 0; num_selectors++; }

  ENTT(5)
  /* transmit */
  bw_t w = {0, 0, out, 0};
  bw_put(&w, 0x314159u, 24);
  bw_put(&w, 0x265359u, 24);
  bw_put(&w, crc_stored, 32);
  bw_put(&w, 0, 1);
  bw_put(&w, (uint32_t)bwt_idx, 24);
  {
    uint32_t big = 0;
    uint32_t packs[16];
    for (int i = 0; i < 16; i++) {
      uint32_t pk = 0;
      for (int j = 0; j < 16; j++)
        pk = (pk << 1) | (cmap_used[16 * i + j] ? 1u : 0u);
      packs[i] = pk;
      big = (big << 1) | (pk ? 1u : 0u);
    }
    bw_put(&w, big, 16);
    for (int i = 0; i < 16; i++)
      if (packs[i]) bw_put(&w, packs[i], 16);
  }
  bw_put(&w, (uint32_t)nt, 3);
  bw_put(&w, (uint32_t)num_selectors, 15);
  for (long i = 0; i < n_smtf; i++) {
    int v = smtf[i] + 1;
    bw_put(&w, (1u << v) - 2, v);
  }
  for (int tn = 0; tn < nt; tn++) {
    const uint8_t *len = lengths[tmap_new2old[tn]];
    int a = len[0];
    if (tn == 0) a = a < 4 ? a + tree_pad : a - tree_pad;
    bw_put(&w, (uint32_t)a, 5);
    for (int v = 0; v < as; v++) {
      int c = len[v];
      while (a < c) { bw_put(&w, 2, 2); a++; }
      while (a > c) { bw_put(&w, 3, 2); a--; }
      bw_put(&w, 0, 1);
    }
  }
  ENTT(6)
  for (long g = 0; g < ns; g++) {
    int t = selectors[g];
    const uint32_t *C = codes_tab[t];
    const uint8_t *B = lengths[t];
    const uint16_t *gs = mtfv + g * GROUP_SIZE;
    for (int i = 0; i < GROUP_SIZE; i++) {
      uint16_t mv = gs[i];
      bw_put(&w, C[mv], B[mv]);
    }
  }
  ENTT(7)
  /* stream is byte-aligned by construction */
  return w.pos;
}

/* ---------------- device-chain host halves ----------------
 *
 * The device chain (ops/chain.py) runs MTF+RLE2 and the EM E-steps on
 * the device; these entry points are the tiny sequential pieces kept on
 * the host: the per-tree Huffman refit between E-steps and the final
 * model/header build (everything of lbz2_encode_payload_from_mtfv
 * except the EM loop and the group-code transmit, which packs on
 * device).  Spec: reference src/encode.c:714-766, 883-987, 1087-1281.
 */

void lbz2_em_mstep(const uint32_t *freqs /* B*6*(MAX_ALPHA+1) */,
                   const int32_t *as, const int32_t *nt, long nb,
                   uint8_t *lengths /* B*6*(MAX_ALPHA+1) in-out */) {
  const long S = (long)MAX_TREES * (MAX_ALPHA + 1);
  for (long b = 0; b < nb; b++)
    for (int t = 0; t < nt[b]; t++)
      make_code_lengths2(lengths + b * S + (long)t * (MAX_ALPHA + 1),
                         freqs + b * S + (long)t * (MAX_ALPHA + 1),
                         as[b]);
}

/* Final model + full block header for one batch.
 * selectors: (nb, gcap) old-tree-id per group (first ngroups valid);
 * freqs: (nb, 6, 259) from the last E-step; lengths: in EM state, out
 * final; codes out; hdr: (nb, hdr_cap) bytes; hdr_bits / payload_bits
 * out per row.  Returns 0, or -(row+1) if a header overflowed hdr_cap
 * (caller falls back to the host path for that batch). */
long lbz2_chain_finish(const uint8_t *selectors, const int32_t *ngroups,
                       const uint32_t *freqs, const int32_t *as_arr,
                       const int32_t *nt_arr, long nb, long gcap,
                       const uint8_t *cmap_used, const int32_t *bwt_idx,
                       const uint32_t *crc_stored,
                       uint8_t *lengths_io, uint32_t *codes_out,
                       uint8_t *hdr, long hdr_cap,
                       int32_t *hdr_bits, int64_t *payload_bits) {
  const long S = (long)MAX_TREES * (MAX_ALPHA + 1);
  for (long b = 0; b < nb; b++) {
    int as = as_arr[b];
    int nt = nt_arr[b];
    long ns = ngroups[b];
    const uint8_t *sel = selectors + b * gcap;
    const uint32_t *fr = freqs + b * S;
    uint8_t (*lengths)[MAX_ALPHA + 1] =
        (uint8_t (*)[MAX_ALPHA + 1])(lengths_io + b * S);
    uint32_t (*codes_tab)[MAX_ALPHA + 1] =
        (uint32_t (*)[MAX_ALPHA + 1])(codes_out + b * S);

  /* reorder trees by first use; assign final codes */
    int tmap_old2new[MAX_TREES], tmap_new2old[MAX_TREES];
    uint32_t cost = 0;
    unsigned not_seen = (1u << nt) - 1;
    int new_nt = 0;
    for (long g = 0; g < ns && not_seen; g++) {
      int t = sel[g];
      if (not_seen & (1u << t)) {
        not_seen -= 1u << t;
        tmap_old2new[t] = new_nt;
        tmap_new2old[new_nt] = t;
        new_nt++;
        cost += assign_codes2(codes_tab[t], lengths[t],
                              fr + (long)t * (MAX_ALPHA + 1), as);
        codes_tab[t][as] = 0;
        lengths[t][as] = 0;
      }
    }
    if (new_nt == 1) {
      new_nt = 2;
      int t = tmap_new2old[0] ^ 1;
      tmap_old2new[t] = 1;
      tmap_new2old[1] = t;
      int cl0 = 0;
      while ((2 << cl0) <= as) cl0++;
      int v = 0;
      int nshort = (2 << cl0) - as;
      for (; v < nshort; v++) lengths[t][v] = (uint8_t)cl0;
      if (v < as) cost += 2;
      for (; v < as; v++) lengths[t][v] = (uint8_t)(cl0 + 1);
      cost += (uint32_t)as + 5;
    }

    /* exact payload bit count = sum freq * final length (the dummy
     * symbol's length is 0; unused trees have all-zero freqs) */
    int64_t pbits = 0;
    for (int t = 0; t < MAX_TREES; t++)
      for (int v = 0; v <= as; v++)
        pbits += (int64_t)fr[(long)t * (MAX_ALPHA + 1) + v] *
                 lengths[t][v];
    payload_bits[b] = pbits;

    /* selector MTF */
    static __thread uint8_t smtf[EM_MAX_GROUPS + 2];
    long n_smtf = 0;
    {
      int order[MAX_TREES] = {0, 1, 2, 3, 4, 5};
      for (long g = 0; g < ns; g++) {
        int c = tmap_old2new[sel[g]];
        int j = 0;
        while (order[j] != c) j++;
        for (int q = j; q > 0; q--) order[q] = order[q - 1];
        order[0] = c;
        smtf[n_smtf++] = (uint8_t)j;
      }
    }

    /* padding */
    uint64_t total = 48 + 32 + 1 + 24 + 3 + 15 + cost;
    for (long i = 0; i < n_smtf; i++) total += smtf[i] + 1;
    int pad = (int)((8 - (total & 7)) & 7);
    int tree_pad = pad >> 1;
    long num_selectors = ns;
    if (pad & 1) { smtf[n_smtf++] = 0; num_selectors++; }

    /* header transmit (everything before the group codes) */
    const uint8_t *cm = cmap_used + b * 256;
    bw_t w = {0, 0, hdr + b * hdr_cap, 0};
    bw_put(&w, 0x314159u, 24);
    bw_put(&w, 0x265359u, 24);
    bw_put(&w, crc_stored[b], 32);
    bw_put(&w, 0, 1);
    bw_put(&w, (uint32_t)bwt_idx[b], 24);
    {
      uint32_t big = 0;
      uint32_t packs[16];
      for (int i = 0; i < 16; i++) {
        uint32_t pk = 0;
        for (int j = 0; j < 16; j++)
          pk = (pk << 1) | (cm[16 * i + j] ? 1u : 0u);
        packs[i] = pk;
        big = (big << 1) | (pk ? 1u : 0u);
      }
      bw_put(&w, big, 16);
      for (int i = 0; i < 16; i++)
        if (packs[i]) bw_put(&w, packs[i], 16);
    }
    bw_put(&w, (uint32_t)new_nt, 3);
    bw_put(&w, (uint32_t)num_selectors, 15);
    for (long i = 0; i < n_smtf; i++) {
      int v = smtf[i] + 1;
      bw_put(&w, (1u << v) - 2, v);
    }
    for (int tn = 0; tn < new_nt; tn++) {
      const uint8_t *len = lengths[tmap_new2old[tn]];
      int a = len[0];
      if (tn == 0) a = a < 4 ? a + tree_pad : a - tree_pad;
      bw_put(&w, (uint32_t)a, 5);
      for (int v = 0; v < as; v++) {
        int c = len[v];
        while (a < c) { bw_put(&w, 2, 2); a++; }
        while (a > c) { bw_put(&w, 3, 2); a--; }
        bw_put(&w, 0, 1);
      }
      if (w.pos + 128 > hdr_cap) return -(b + 1);
    }
    /* flush the partial byte (hdr_bits records the true bit length) */
    long bits = w.pos * 8 + w.nbits;
    if (w.nbits) bw_put(&w, 0, 8 - w.nbits);
    hdr_bits[b] = (int32_t)bits;
  }
  return 0;
}
