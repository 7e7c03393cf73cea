/* lbz2_native.c — host-side native kernels for lbzip2_tpu_torch.
 *
 * Clean-room implementations of the host-resident hot paths, built from
 * the specs validated by the Python oracle (lbzip2_tpu_torch/ref/*):
 *
 *   - rle1_collect: RLE1 block collector with lbzip2-exact window +
 *     capacity split rules (spec: ref/rle1.py; reference behavior
 *     src/encode.c:136-336).
 *   - crc32_block: bzip2 MSB-first CRC-32, slice-by-8.
 *   - retrieve_block: block payload decode — bitmap, delta trees with
 *     batched bounds, selector MTF with deferred bad-tree errors,
 *     two-level canonical Huffman decode, inverse MTF, RLE2 run
 *     expansion (spec: ref/decoder.py; reference src/decode.c:519-798).
 *   - ibwt_emit: counting-sort IBWT pointer build + chase fused with
 *     RLE1 expansion and CRC (reference src/decode.c:852-930, 944-1144),
 *     including legacy derandomization.
 *
 * Exposed with a plain C ABI for ctypes.  Error codes match
 * lbzip2_tpu_torch.core.constants.Error values.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#define MAX_BLOCK_SIZE 900000
#define GROUP_SIZE 50
#define MAX_CODE_LENGTH 20
#define MAX_TREES 6
#define SELECTOR_CLAMP 18001
#define MAX_SELECTORS_HARD 32767

enum {
  E_OK = 0, E_MORE = 1, E_FINISH = 2, E_MAGIC = 3, E_HEADER = 4,
  E_BITMAP = 5, E_TREES = 6, E_GROUPS = 7, E_SELECTOR = 8, E_DELTA = 9,
  E_PREFIX = 10, E_INCOMPLT = 11, E_EMPTY = 12, E_UNTERM = 13,
  E_RUNLEN = 14, E_BLKCRC = 15, E_STRMCRC = 16, E_OVERFLOW = 17,
  E_BWTIDX = 18, E_EOF = 19,
};

/* ------------------------------------------------------------------ */
/* CRC32 (bzip2 polynomial, MSB first), slice-by-8                     */
/* ------------------------------------------------------------------ */

static uint32_t crc_tab[8][256];
static int crc_ready = 0;

static void crc_init(void) {
  if (crc_ready) return;
  for (int i = 0; i < 256; i++) {
    uint32_t c = (uint32_t)i << 24;
    for (int k = 0; k < 8; k++)
      c = (c << 1) ^ ((c & 0x80000000u) ? 0x04C11DB7u : 0u);
    crc_tab[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (int i = 0; i < 256; i++) {
      uint32_t c = crc_tab[t - 1][i];
      crc_tab[t][i] = (c << 8) ^ crc_tab[0][c >> 24];
    }
  crc_ready = 1;
}

void lbz2_init(void) { crc_init(); }

uint32_t lbz2_crc32_block(const uint8_t *p, long n, uint32_t crc) {
  crc_init();
  long i = 0;
  /* slice-by-8: process 8 bytes per step.  The register advances 8
     zero-byte steps while folding in 8 message bytes. */
  for (; i + 8 <= n; i += 8) {
    uint32_t hi = crc;
    crc = crc_tab[7][((hi >> 24) ^ p[i]) & 0xFF]
        ^ crc_tab[6][((hi >> 16) ^ p[i + 1]) & 0xFF]
        ^ crc_tab[5][((hi >> 8) ^ p[i + 2]) & 0xFF]
        ^ crc_tab[4][(hi ^ p[i + 3]) & 0xFF]
        ^ crc_tab[3][p[i + 4]]
        ^ crc_tab[2][p[i + 5]]
        ^ crc_tab[1][p[i + 6]]
        ^ crc_tab[0][p[i + 7]];
  }
  for (; i < n; i++)
    crc = (crc << 8) ^ crc_tab[0][((crc >> 24) ^ p[i]) & 0xFF];
  return crc;
}

/* ------------------------------------------------------------------ */
/* RLE1 collector                                                      */
/* ------------------------------------------------------------------ */

/* Consume one run against capacity; returns new pos, updates *used,
 * sets *full.  Mirrors ref/rle1.py _consume_run. */
static long consume_run(long pos, long run_len, long *used, long mbs,
                        int *full) {
  long left = run_len;
  while (left > 0) {
    long r = left < 259 ? left : 259;
    long cap = mbs - *used;
    if (r < 4) {
      if (r >= cap) { *used = mbs; *full = 1; return pos + cap; }
      pos += r; *used += r; left -= r;
      continue;
    }
    if (cap <= 3) { *used += cap; *full = 1; return pos + cap; }
    if (cap == 4) { *used += 3; *full = 1; return pos + 3; } /* state-3 */
    pos += r; *used += 5; left -= r;
    if (*used == mbs) { *full = 1; return pos; }
  }
  *full = 0;
  return pos;
}

/* Split input into blocks (window granul, capacity mbs) and transform.
 * out_buf receives concatenated RLE1 bytes; starts/ends/out_lens get
 * per-block input spans and output lengths; cmaps gets 256 bytes per
 * block (0/1 flags).  Returns block count, or -1 on overflow of the
 * provided arrays. */
long lbz2_rle1_collect(const uint8_t *in, long n, long mbs, long granul,
                       uint8_t *out_buf, long out_cap,
                       long *starts, long *ends, long *out_lens,
                       uint8_t *cmaps, long max_blocks) {
  long nblocks = 0;
  long out_pos = 0;
  long wstart = 0;
  if (granul <= 0) granul = n > 0 ? n : 1;

  while (wstart < n) {
    long wend = wstart + granul < n ? wstart + granul : n;
    long pos = wstart;
    while (pos < wend) {
      if (nblocks >= max_blocks) return -1;
      long begin = pos;
      long used = 0;
      int full = 0;
      uint8_t *cm = cmaps + nblocks * 256;
      memset(cm, 0, 256);
      long op = out_pos;
      /* single fused walk: apply capacity rules per run AND emit the
       * consumed prefix's RLE1 transform (the sub-run actually
       * consumed is re-derivable from the cursor delta: a full
       * 259-chunk emits 4+len, any capacity cut leaves < 4 literals).
       *
       * Literal sprint: runs shorter than 4 are emitted verbatim and
       * consume capacity 1:1 whether walked run-by-run or in bulk, so
       * scan ahead to the next >=4 run (one compare per byte on the
       * no-run fast path), mark cmap bits in the same pass, and
       * memcpy the whole stretch. */
      while (pos < wend && !full) {
        /* scan bounded by remaining capacity so every byte marked in
         * the cmap is a byte this block actually takes */
        long cap = mbs - used;
        long jmax = pos + (cap < wend - pos ? cap : wend - pos);
        long j = pos;
        while (j < jmax) {
          uint8_t c0 = in[j];
          if (j + 3 < wend && c0 == in[j + 1] && c0 == in[j + 2] &&
              c0 == in[j + 3])
            break;
          cm[c0] = 1;
          j++;
        }
        if (j > pos) {              /* literal stretch [pos, j) */
          long take = j - pos;
          if (op + take > out_cap) return -1;
          memcpy(out_buf + op, in + pos, (size_t)take);
          op += take;
          used += take;
          pos += take;
          if (used == mbs) { full = 1; break; }
          if (pos >= wend) break;
        }
        /* run of >= 4 at pos */
        uint8_t c = in[pos];
        long k = pos + 4;
        while (k < wend && in[k] == c) k++;
        long rl = k - pos;
        long p2 = pos;
        while (rl > 0 && !full) {
          long r = rl < 259 ? rl : 259;
          long before = p2;
          p2 = consume_run(p2, r, &used, mbs, &full);
          long consumed = p2 - before;
          if (op + 5 > out_cap) return -1;
          cm[c] = 1;
          if (consumed == r && r >= 4) {
            out_buf[op++] = c; out_buf[op++] = c;
            out_buf[op++] = c; out_buf[op++] = c;
            out_buf[op++] = (uint8_t)(r - 4);
            cm[r - 4] = 1;
          } else {
            for (long m = 0; m < consumed; m++) out_buf[op++] = c;
          }
          rl -= r;
        }
        pos = p2;
      }
      starts[nblocks] = begin;
      ends[nblocks] = pos;
      out_lens[nblocks] = op - out_pos;
      out_pos = op;
      nblocks++;
    }
    wstart = wend;
  }
  return nblocks;
}

/* ------------------------------------------------------------------ */
/* Bit reader                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
  const uint8_t *data;
  long nbits;
  long pos;
} bits_t;

static inline int bits_left(const bits_t *b) { return b->pos < b->nbits; }

static inline uint32_t bits_peek20(const bits_t *b) {
  /* 20 bits MSB-first from b->pos, zero-padded past end of stream. */
  long byte = b->pos >> 3;
  int off = (int)(b->pos & 7);
  long nbytes = (b->nbits + 7) >> 3;
  uint64_t v;
  if (byte + 4 <= nbytes) {  /* hot path: one unaligned load */
    uint32_t w;
    memcpy(&w, b->data + byte, 4);
    v = __builtin_bswap32(w);
  } else {
    v = 0;
    for (int k = 0; k < 4; k++)
      v = (v << 8) |
          (uint64_t)((byte + k) < nbytes ? b->data[byte + k] : 0);
  }
  v >>= (12 - off);
  return (uint32_t)(v & 0xFFFFF);
}

static inline long bits_read(bits_t *b, int k, int *err) {
  if (b->pos + k > b->nbits) { *err = 1; return 0; }
  long v = 0;
  for (int i = 0; i < k; i++) {
    long p = b->pos + i;
    v = (v << 1) | ((b->data[p >> 3] >> (7 - (p & 7))) & 1);
  }
  b->pos += k;
  return v;
}

/* ------------------------------------------------------------------ */
/* Block retrieve (Huffman decode + IMTF + RLE2)                       */
/* ------------------------------------------------------------------ */

/* first-level LUT entry (u32):
 *   bit 31 LONGF : first code longer than LUT_WIDTH (slow path)
 *   bit 30 PAIRF : entry decodes TWO symbols in one step
 *   [0,5)  k     : total bits consumed (pair) / code length (single)
 *   [5,14) sym1
 *   [14,23) sym2  (pair only)
 *   [23,28) k1    (pair only: first code's length, for group-boundary
 *                  and EOF splits)
 * A two-symbol step halves the serial bit-position dependency chain —
 * the fundamental limit of Huffman decode — and short RUNA/RUNB pairs
 * (the bulk of text payloads) almost always fit 11 bits together. */
#define LUTF_LONG 0x80000000u
#define LUTF_PAIR 0x40000000u

typedef struct {
  int status;                    /* E_OK or deferred error */
  uint64_t base[MAX_CODE_LENGTH + 2];  /* left-justified 20-bit bases */
  int count[MAX_CODE_LENGTH + 2];      /* cum counts of lengths < k */
  uint16_t perm[258];
  uint32_t lut[2048];
} tree_t;

#define LUT_WIDTH 11

static void make_tree(tree_t *t, const uint8_t *len, int alpha) {
  int C[MAX_CODE_LENGTH + 2];
  memset(C, 0, sizeof(C));
  for (int s = 0; s < alpha; s++) C[len[s]]++;
  uint64_t kraft = 0;
  for (int k = 1; k <= MAX_CODE_LENGTH; k++)
    kraft += (uint64_t)C[k] << (MAX_CODE_LENGTH - k);
  if (kraft != (1u << MAX_CODE_LENGTH)) {
    t->status = kraft < (1u << MAX_CODE_LENGTH) ? E_INCOMPLT : E_PREFIX;
    return;
  }
  uint64_t sofar = 0;
  for (int k = 1; k <= MAX_CODE_LENGTH; k++) {
    t->base[k] = sofar;
    sofar += (uint64_t)C[k] << (MAX_CODE_LENGTH - k);
  }
  t->base[MAX_CODE_LENGTH + 1] = 1u << MAX_CODE_LENGTH;
  int cum = 0;
  for (int k = 1; k <= MAX_CODE_LENGTH; k++) {
    t->count[k] = cum;
    cum += C[k];
  }
  /* counting sort of symbols by length; internal symbol values:
     0=EOB, 1..255 MTFV, 257=RUNA, 258=RUNB */
  int idx[MAX_CODE_LENGTH + 2];
  memcpy(idx, t->count, sizeof(idx));
  for (int s = 0; s < alpha; s++) {
    int sym = s == 0 ? 257 : s == 1 ? 258 : s == alpha - 1 ? 0 : s - 1;
    t->perm[idx[len[s]]++] = (uint16_t)sym;
  }
  /* first-level LUT: single-symbol pass, then pair fill */
  int code = 0;
  int inc = 1 << (LUT_WIDTH - 1);
  for (int k = 1; k <= LUT_WIDTH; k++) {
    for (int s = t->count[k]; s < t->count[k + 1]; s++) {
      uint32_t x = ((uint32_t)t->perm[s] << 5) | (uint32_t)k;
      for (int v = 0; v < inc; v++) t->lut[code + v] = x;
      code += inc;
    }
    inc >>= 1;
  }
  while (code < (1 << LUT_WIDTH)) t->lut[code++] = LUTF_LONG;
  /* pair fill: entry e starts with (k1, sym1); if the next code also
   * completes inside the window, fold it in */
  for (int e = 0; e < (1 << LUT_WIDTH); e++) {
    uint32_t x = t->lut[e];
    if (x & LUTF_LONG) continue;
    int k1 = (int)(x & 31);
    int s1 = (int)((x >> 5) & 511);
    if (s1 == 0) continue;             /* EOB: the block ends here */
    int rem = LUT_WIDTH - k1;
    if (rem <= 0) continue;
    uint32_t v2 = ((uint32_t)e << k1) & ((1u << LUT_WIDTH) - 1);
    uint32_t x2 = t->lut[v2];
    if (x2 & LUTF_LONG) continue;
    /* x2 may itself already be pair-converted by this loop: take its
     * FIRST code only (k1 field when paired) */
    int k2 = (int)((x2 & LUTF_PAIR) ? (x2 >> 23) & 31 : x2 & 31);
    if (k2 > rem) continue;
    int s2 = (int)((x2 >> 5) & 511);
    t->lut[e] = LUTF_PAIR | (uint32_t)(k1 + k2) |
                ((uint32_t)s1 << 5) | ((uint32_t)s2 << 14) |
                ((uint32_t)k1 << 23);
  }
  t->status = E_OK;
}

/* single-symbol view of a LUT entry (resumable/boundary walkers) */
static inline void lut_first(uint32_t x, int *k1, int *sym1) {
  if (x & LUTF_PAIR) {
    *k1 = (int)((x >> 23) & 31);
  } else {
    *k1 = (int)(x & 31);
  }
  *sym1 = (int)((x >> 5) & 511);
}

/* Decode one block payload after magic+CRC.  Returns error code.
 * On success: out_bwt holds block_size bytes, *bwt_idx, *randomized set,
 * *bitpos advanced past the payload. */
long lbz2_retrieve_block(const uint8_t *data, long nbits, long *bitpos,
                         uint8_t *out_bwt, long *block_size,
                         long *bwt_idx, int *randomized) {
  bits_t bs = { data, nbits, *bitpos };
  int err = 0;
  /* ~17 KiB/tree on the stack: thread-safe, no allocation */
  tree_t trees[MAX_TREES];
  uint8_t used_bytes[256];
  int n_used = 0;

  int rand_bit = (int)bits_read(&bs, 1, &err);
  long idx = bits_read(&bs, 24, &err);
  long big = bits_read(&bs, 16, &err);
  if (err) return E_EOF;
  for (int i = 0; i < 16; i++) {
    if ((big >> (15 - i)) & 1) {
      long small = bits_read(&bs, 16, &err);
      if (err) return E_EOF;
      for (int j = 0; j < 16; j++)
        if ((small >> (15 - j)) & 1)
          used_bytes[n_used++] = (uint8_t)(16 * i + j);
    }
  }
  if (n_used == 0) return E_BITMAP;
  int alpha = n_used + 2;

  long num_trees = bits_read(&bs, 3, &err);
  if (err) return E_EOF;
  if (num_trees < 2 || num_trees > MAX_TREES) return E_TREES;
  long num_sel = bits_read(&bs, 15, &err);
  if (err) return E_EOF;
  if (num_sel == 0) return E_GROUPS;

  uint8_t selectors[MAX_SELECTORS_HARD + 1];
  for (long g = 0; g < num_sel; g++) {
    int k = 0;
    for (;;) {
      long b = bits_read(&bs, 1, &err);
      if (err) return E_EOF;
      if (b == 0) break;
      k++;
      if (k > 6) return E_SELECTOR;
    }
    if (k + 1 > num_trees) return E_SELECTOR;
    selectors[g] = (uint8_t)k;
  }

  for (int tr = 0; tr < num_trees; tr++) {
    uint8_t len_arr[258];
    long cur = bits_read(&bs, 5, &err);
    if (err) return E_EOF;
    int j = 0;
    while (j < alpha) {
      int ops = 0, terminated = 0;
      while (ops < 3) {
        long b = bits_read(&bs, 1, &err);
        if (err) return E_EOF;
        if (b == 0) { terminated = 1; break; }
        long b2 = bits_read(&bs, 1, &err);
        if (err) return E_EOF;
        cur += b2 == 0 ? 1 : -1;
        ops++;
      }
      if (cur < 1 || cur > MAX_CODE_LENGTH) return E_DELTA;
      if (terminated) len_arr[j++] = (uint8_t)cur;
    }
    make_tree(&trees[tr], len_arr, alpha);
  }

  /* group decode */
  uint8_t imtf[256];
  memcpy(imtf, used_bytes, n_used);
  int tree_mtf[MAX_TREES] = {0, 1, 2, 3, 4, 5};
  uint32_t run_char = imtf[0];
  uint64_t run = 0;
  int shift = 0;
  long size = 0;
  long ns = num_sel < SELECTOR_CLAMP ? num_sel : SELECTOR_CLAMP;
  int eob = 0;

  for (long g = 0; g < ns && !eob; g++) {
    int si = selectors[g];
    int tsel = tree_mtf[si];
    for (int q = si; q > 0; q--) tree_mtf[q] = tree_mtf[q - 1];
    tree_mtf[0] = tsel;
    tree_t *T = &trees[tsel];
    if (T->status != E_OK) return T->status;

/* RLE2 + IMTF processing of one decoded symbol; `continue` skips to
 * the next symbol of the group, EOB sets eob and breaks the group */
#define PROC_SYM(sym)                                                  \
      if (sym == 0) { /* EOB */                                        \
        if (run > (uint64_t)(MAX_BLOCK_SIZE - size)) return E_OVERFLOW;\
        memset(out_bwt + size, run_char, run);                         \
        size += run;                                                   \
        eob = 1;                                                       \
        break;                                                         \
      }                                                                \
      if (sym >= 256 && run <= MAX_BLOCK_SIZE) {                       \
        run += (uint64_t)(sym - 256) << shift;                         \
        shift++;                                                       \
      } else {                                                         \
        if (run > (uint64_t)(MAX_BLOCK_SIZE - size)) return E_OVERFLOW;\
        if (run <= 8) {                                                \
          /* typical runs are 1-3 bytes: one unconditional 8-byte      \
           * broadcast store beats a memset call.  Callers provision   \
           * 8 bytes of slack past MAX_BLOCK_SIZE. */                  \
          uint64_t bc = (uint64_t)run_char * 0x0101010101010101ULL;    \
          memcpy(out_bwt + size, &bc, 8);                              \
        } else {                                                       \
          memset(out_bwt + size, run_char, run);                       \
        }                                                              \
        size += run;                                                   \
        { /* inverse MTF */                                            \
          int r_ = sym;                                                \
          uint8_t c_ = imtf[r_];                                       \
          memmove(imtf + 1, imtf, r_);                                 \
          imtf[0] = c_;                                                \
          run_char = c_;                                               \
        }                                                              \
        run = 1;                                                       \
        shift = 0;                                                     \
      }

    for (int m = 0; m < GROUP_SIZE; m++) {
      uint32_t v = bits_peek20(&bs);
      uint32_t x = T->lut[v >> (MAX_CODE_LENGTH - LUT_WIDTH)];
      int k, sym;
      if (!(x & LUTF_LONG)) {
        k = (int)(x & 31);
        sym = (int)((x >> 5) & 511);
        if ((x & LUTF_PAIR) && m + 1 < GROUP_SIZE &&
            bs.pos + k <= bs.nbits) {
          /* two symbols in one step */
          bs.pos += k;
          PROC_SYM(sym)
          m++;
          int sym2 = (int)((x >> 14) & 511);
          PROC_SYM(sym2)
          continue;
        }
        if (x & LUTF_PAIR) k = (int)((x >> 23) & 31);  /* first only */
      } else {
        k = LUT_WIDTH + 1;
        while ((uint64_t)v >= T->base[k + 1]) k++;
        sym = T->perm[T->count[k] + (long)((v - T->base[k]) >> (MAX_CODE_LENGTH - k))];
      }
      if (bs.pos + k > bs.nbits) return E_EOF;
      bs.pos += k;
      PROC_SYM(sym)
    }
  }
#undef PROC_SYM
  if (!eob) return E_UNTERM;
  if (size == 0) return E_EMPTY;
  if (idx >= size) return E_BWTIDX;

  *bitpos = bs.pos;
  *block_size = size;
  *bwt_idx = idx;
  *randomized = rand_bit;
  return E_OK;
}

/* ------------------------------------------------------------------ */
/* Resumable retrieve (streaming decode)                               */
/*                                                                     */
/* The reference's retrieve() is a coroutine that suspends on input    */
/* exhaustion at any bit (src/decode.c:387-407 NEED(), state enum      */
/* :140-149).  This streaming decoder reaches the same suspend-       */
/* anywhere contract with phase + group granularity, exploiting two    */
/* format bounds:                                                      */
/*   - a block header is <= ~33 KB (32767 unary selectors + 6 delta    */
/*     trees), so the header phase simply re-parses when more input    */
/*     arrives (bounded rework, no saved mid-header state);            */
/*   - a group is <= 50 codes x 20 bits, so the group phase snapshots  */
/*     its small live state only when the window end is near and       */
/*     rolls back to the group boundary on exhaustion.                 */
/* Positions are absolute, so the caller may extend (or slide, byte-   */
/* aligned) its window between steps.  E_MORE = feed more input.       */
/* ------------------------------------------------------------------ */

typedef struct {
  int phase;     /* 0 = header pending, 1 = decoding groups */
  long pos;      /* absolute bit position of next unread bit */
  int rand_bit;
  long idx;
  int num_trees;
  long num_sel, ns;
  long g;        /* next group to decode */
  int eob;
  uint32_t run_char;
  uint64_t run;
  int shift;
  long size;
  int n_used;
  int tree_mtf[MAX_TREES];
  uint8_t imtf[256];
  tree_t trees[MAX_TREES];
  uint8_t selectors[MAX_SELECTORS_HARD + 1];
} retr_state_t;

void *lbz2_retr_new(void) { return calloc(1, sizeof(retr_state_t)); }
void lbz2_retr_free(void *p) { free(p); }

/* Decode one 50-symbol group; bs positions are window-relative.
 * Returns E_OK (st->eob may be set) or an error (E_EOF = exhausted
 * mid-group; caller rolls back). */
static long retr_group(retr_state_t *st, bits_t *bs, uint8_t *out_bwt) {
  int si = st->selectors[st->g];
  int tsel = st->tree_mtf[si];
  for (int q = si; q > 0; q--) st->tree_mtf[q] = st->tree_mtf[q - 1];
  st->tree_mtf[0] = tsel;
  tree_t *T = &st->trees[tsel];
  if (T->status != E_OK) return T->status;

  for (int m = 0; m < GROUP_SIZE; m++) {
    uint32_t v = bits_peek20(bs);
    uint32_t x = T->lut[v >> (MAX_CODE_LENGTH - LUT_WIDTH)];
    int k, sym;
    if (!(x & LUTF_LONG)) {
      lut_first(x, &k, &sym);
    } else {
      k = LUT_WIDTH + 1;
      while ((uint64_t)v >= T->base[k + 1]) k++;
      sym = T->perm[T->count[k] +
                    (long)((v - T->base[k]) >> (MAX_CODE_LENGTH - k))];
    }
    if (bs->pos + k > bs->nbits) return E_EOF;
    bs->pos += k;

    if (sym == 0) { /* EOB */
      if (st->run > (uint64_t)(MAX_BLOCK_SIZE - st->size))
        return E_OVERFLOW;
      memset(out_bwt + st->size, st->run_char, st->run);
      st->size += st->run;
      st->eob = 1;
      return E_OK;
    }
    if (sym >= 256 && st->run <= MAX_BLOCK_SIZE) {
      st->run += (uint64_t)(sym - 256) << st->shift;
      st->shift++;
      continue;
    }
    if (st->run > (uint64_t)(MAX_BLOCK_SIZE - st->size))
      return E_OVERFLOW;
    memset(out_bwt + st->size, st->run_char, st->run);
    st->size += st->run;
    {
      int r = sym;
      uint8_t c = st->imtf[r];
      memmove(st->imtf + 1, st->imtf, r);
      st->imtf[0] = c;
      st->run_char = c;
    }
    st->run = 1;
    st->shift = 0;
  }
  return E_OK;
}

/* One resume step.  data holds absolute bits [base_bit, nbits_abs)
 * with base_bit % 8 == 0; start_bit = absolute payload start (just
 * past magic+CRC), used on the first step only.  Returns E_MORE when
 * the window is exhausted mid-block (state saved; call again with
 * more input), E_OK when the block is complete, or an error. */
long lbz2_retr_step(void *handle, const uint8_t *data, long base_bit,
                    long nbits_abs, long start_bit, uint8_t *out_bwt,
                    long *end_pos, long *block_size, long *bwt_idx,
                    int *randomized) {
  retr_state_t *st = (retr_state_t *)handle;
  bits_t bs = { data, nbits_abs - base_bit, 0 };

  if (st->phase == 0) {
    /* header: parse from scratch; on exhaustion nothing is kept */
    bs.pos = start_bit - base_bit;
    int err = 0;
    uint8_t used_bytes[256];
    int n_used = 0;
    int rand_bit = (int)bits_read(&bs, 1, &err);
    long idx = bits_read(&bs, 24, &err);
    long big = bits_read(&bs, 16, &err);
    if (err) return E_MORE;
    for (int i = 0; i < 16; i++) {
      if ((big >> (15 - i)) & 1) {
        long small = bits_read(&bs, 16, &err);
        if (err) return E_MORE;
        for (int j = 0; j < 16; j++)
          if ((small >> (15 - j)) & 1)
            used_bytes[n_used++] = (uint8_t)(16 * i + j);
      }
    }
    if (n_used == 0) return E_BITMAP;
    int alpha = n_used + 2;

    long num_trees = bits_read(&bs, 3, &err);
    if (err) return E_MORE;
    if (num_trees < 2 || num_trees > MAX_TREES) return E_TREES;
    long num_sel = bits_read(&bs, 15, &err);
    if (err) return E_MORE;
    if (num_sel == 0) return E_GROUPS;

    for (long g = 0; g < num_sel; g++) {
      int k = 0;
      for (;;) {
        long b = bits_read(&bs, 1, &err);
        if (err) return E_MORE;
        if (b == 0) break;
        k++;
        if (k > 6) return E_SELECTOR;
      }
      if (k + 1 > num_trees) return E_SELECTOR;
      st->selectors[g] = (uint8_t)k;
    }

    for (int tr = 0; tr < num_trees; tr++) {
      uint8_t len_arr[258];
      long cur = bits_read(&bs, 5, &err);
      if (err) return E_MORE;
      int j = 0;
      while (j < alpha) {
        int ops = 0, terminated = 0;
        while (ops < 3) {
          long b = bits_read(&bs, 1, &err);
          if (err) return E_MORE;
          if (b == 0) { terminated = 1; break; }
          long b2 = bits_read(&bs, 1, &err);
          if (err) return E_MORE;
          cur += b2 == 0 ? 1 : -1;
          ops++;
        }
        if (cur < 1 || cur > MAX_CODE_LENGTH) return E_DELTA;
        if (terminated) len_arr[j++] = (uint8_t)cur;
      }
      make_tree(&st->trees[tr], len_arr, alpha);
    }

    st->rand_bit = rand_bit;
    st->idx = idx;
    st->num_trees = (int)num_trees;
    st->num_sel = num_sel;
    st->ns = num_sel < SELECTOR_CLAMP ? num_sel : SELECTOR_CLAMP;
    st->n_used = n_used;
    memcpy(st->imtf, used_bytes, (size_t)n_used);
    for (int i = 0; i < MAX_TREES; i++) st->tree_mtf[i] = i;
    st->run_char = st->imtf[0];
    st->run = 0;
    st->shift = 0;
    st->size = 0;
    st->g = 0;
    st->eob = 0;
    st->pos = base_bit + bs.pos;
    st->phase = 1;
  }

  /* group phase */
  bs.pos = st->pos - base_bit;
  while (st->g < st->ns && !st->eob) {
    if (bs.nbits - bs.pos >= GROUP_SIZE * MAX_CODE_LENGTH) {
      /* a whole worst-case group fits: no rollback needed */
      long r = retr_group(st, &bs, out_bwt);
      if (r != E_OK) return r;  /* E_EOF impossible here */
    } else {
      /* near the window end: snapshot the group-boundary state and
       * roll back on exhaustion */
      struct {
        int tree_mtf[MAX_TREES];
        uint8_t imtf[256];
        uint32_t run_char;
        uint64_t run;
        int shift;
        long size;
      } snap;
      memcpy(snap.tree_mtf, st->tree_mtf, sizeof(st->tree_mtf));
      memcpy(snap.imtf, st->imtf, sizeof(st->imtf));
      snap.run_char = st->run_char;
      snap.run = st->run;
      snap.shift = st->shift;
      snap.size = st->size;
      long gpos = bs.pos;
      long r = retr_group(st, &bs, out_bwt);
      if (r == E_EOF) {
        memcpy(st->tree_mtf, snap.tree_mtf, sizeof(st->tree_mtf));
        memcpy(st->imtf, snap.imtf, sizeof(st->imtf));
        st->run_char = snap.run_char;
        st->run = snap.run;
        st->shift = snap.shift;
        st->size = snap.size;
        st->pos = base_bit + gpos;
        return E_MORE;
      }
      if (r != E_OK) return r;
    }
    st->g++;
    st->pos = base_bit + bs.pos;
  }
  if (!st->eob) return E_UNTERM;
  if (st->size == 0) return E_EMPTY;
  if (st->idx >= st->size) return E_BWTIDX;

  *end_pos = base_bit + bs.pos;
  *block_size = st->size;
  *bwt_idx = st->idx;
  *randomized = st->rand_bit;
  return E_OK;
}

/* ------------------------------------------------------------------ */
/* Device-Huffman decode halves (ops/huffdec.py)                       */
/*                                                                     */
/* Group boundaries are inherently sequential (bzip2's selector-       */
/* switched trees leave no bit-level synchronization points), so a     */
/* light length-only walk stays on the host; the actual symbol         */
/* extraction — the bulk of retrieve — then parallelizes on device     */
/* over all groups at once, and the device's per-group end cursors     */
/* are reconciled against the next group's start (speculation check).  */
/* ------------------------------------------------------------------ */

/* Parse one block header and length-walk the payload.  Outputs the
 * per-group (start bit, resolved tree) pairs plus the decode tables
 * the device kernel consumes.  Returns E_OK or an error code. */
long lbz2_retrieve_boundaries(const uint8_t *data, long nbits,
                              long *bitpos, int32_t *out_idx,
                              int32_t *out_rand, uint8_t *out_used,
                              int32_t *out_alpha, int32_t *out_ntrees,
                              int64_t *group_start, uint8_t *group_tree,
                              int32_t *out_ngroups, int32_t *out_nsyms,
                              uint32_t *out_base /* nt*22 */,
                              int32_t *out_count /* nt*22 */,
                              uint16_t *out_perm /* nt*258 */) {
  bits_t bs = { data, nbits, *bitpos };
  int err = 0;
  tree_t trees[MAX_TREES];
  uint8_t used_bytes[256];
  int n_used = 0;
  memset(out_used, 0, 256);

  int rand_bit = (int)bits_read(&bs, 1, &err);
  long idx = bits_read(&bs, 24, &err);
  long big = bits_read(&bs, 16, &err);
  if (err) return E_EOF;
  for (int i = 0; i < 16; i++) {
    if ((big >> (15 - i)) & 1) {
      long small = bits_read(&bs, 16, &err);
      if (err) return E_EOF;
      for (int j = 0; j < 16; j++)
        if ((small >> (15 - j)) & 1) {
          out_used[16 * i + j] = 1;
          used_bytes[n_used++] = (uint8_t)(16 * i + j);
        }
    }
  }
  if (n_used == 0) return E_BITMAP;
  int alpha = n_used + 2;

  long num_trees = bits_read(&bs, 3, &err);
  if (err) return E_EOF;
  if (num_trees < 2 || num_trees > MAX_TREES) return E_TREES;
  long num_sel = bits_read(&bs, 15, &err);
  if (err) return E_EOF;
  if (num_sel == 0) return E_GROUPS;

  uint8_t selectors[MAX_SELECTORS_HARD + 1];
  for (long g = 0; g < num_sel; g++) {
    int k = 0;
    for (;;) {
      long b = bits_read(&bs, 1, &err);
      if (err) return E_EOF;
      if (b == 0) break;
      k++;
      if (k > 6) return E_SELECTOR;
    }
    if (k + 1 > num_trees) return E_SELECTOR;
    selectors[g] = (uint8_t)k;
  }

  for (int tr = 0; tr < num_trees; tr++) {
    uint8_t len_arr[258];
    long cur = bits_read(&bs, 5, &err);
    if (err) return E_EOF;
    int j = 0;
    while (j < alpha) {
      int ops = 0, terminated = 0;
      while (ops < 3) {
        long b = bits_read(&bs, 1, &err);
        if (err) return E_EOF;
        if (b == 0) { terminated = 1; break; }
        long b2 = bits_read(&bs, 1, &err);
        if (err) return E_EOF;
        cur += b2 == 0 ? 1 : -1;
        ops++;
      }
      if (cur < 1 || cur > MAX_CODE_LENGTH) return E_DELTA;
      if (terminated) len_arr[j++] = (uint8_t)cur;
    }
    make_tree(&trees[tr], len_arr, alpha);
  }

  /* length-only walk: record group starts + resolved trees */
  int tree_mtf[MAX_TREES] = {0, 1, 2, 3, 4, 5};
  long ns = num_sel < SELECTOR_CLAMP ? num_sel : SELECTOR_CLAMP;
  long nsyms = 0;
  int eob = 0;
  long g;
  for (g = 0; g < ns && !eob; g++) {
    int si = selectors[g];
    int tsel = tree_mtf[si];
    for (int q = si; q > 0; q--) tree_mtf[q] = tree_mtf[q - 1];
    tree_mtf[0] = tsel;
    tree_t *T = &trees[tsel];
    if (T->status != E_OK) return T->status;
    group_start[g] = bs.pos;
    group_tree[g] = (uint8_t)tsel;

    for (int m = 0; m < GROUP_SIZE; m++) {
      uint32_t v = bits_peek20(&bs);
      uint32_t x = T->lut[v >> (MAX_CODE_LENGTH - LUT_WIDTH)];
      int k, sym;
      if (!(x & LUTF_LONG)) {
        lut_first(x, &k, &sym);
      } else {
        k = LUT_WIDTH + 1;
        while ((uint64_t)v >= T->base[k + 1]) k++;
        sym = T->perm[T->count[k] +
                      (long)((v - T->base[k]) >> (MAX_CODE_LENGTH - k))];
      }
      if (bs.pos + k > bs.nbits) return E_EOF;
      bs.pos += k;
      nsyms++;
      if (sym == 0) { eob = 1; break; }
    }
  }
  if (!eob) return E_UNTERM;

  *bitpos = bs.pos;
  *out_idx = (int32_t)idx;
  *out_rand = rand_bit;
  *out_alpha = alpha;
  *out_ntrees = (int32_t)num_trees;
  *out_ngroups = (int32_t)g;
  *out_nsyms = (int32_t)nsyms;
  for (int tr = 0; tr < num_trees; tr++) {
    for (int k = 0; k <= MAX_CODE_LENGTH + 1; k++) {
      out_base[tr * 22 + k] = (uint32_t)trees[tr].base[k];
      out_count[tr * 22 + k] = trees[tr].count[k];
    }
    memcpy(out_perm + tr * 258, trees[tr].perm, 258 * sizeof(uint16_t));
  }
  return E_OK;
}

/* IMTF + RLE2 expansion from device-decoded symbols (internal values:
 * 0=EOB, 1..255 = MTF rank, 257=RUNA, 258=RUNB).  Returns block size
 * or a negative error. */
long lbz2_imtf_rle2(const uint16_t *syms, long nsyms,
                    const uint8_t *used_flags, uint8_t *out_bwt) {
  uint8_t imtf[256];
  int n_used = 0;
  for (int v = 0; v < 256; v++)
    if (used_flags[v]) imtf[n_used++] = (uint8_t)v;
  if (n_used == 0) return -E_BITMAP;
  uint32_t run_char = imtf[0];
  uint64_t run = 0;
  int shift = 0;
  long size = 0;
  for (long i = 0; i < nsyms; i++) {
    int sym = syms[i];
    if (sym == 0) {
      if (run > (uint64_t)(MAX_BLOCK_SIZE - size)) return -E_OVERFLOW;
      memset(out_bwt + size, run_char, run);
      size += run;
      if (size == 0) return -E_EMPTY;
      return size;
    }
    if (sym >= 256 && run <= MAX_BLOCK_SIZE) {
      run += (uint64_t)(sym - 256) << shift;
      shift++;
      continue;
    }
    if (run > (uint64_t)(MAX_BLOCK_SIZE - size)) return -E_OVERFLOW;
    memset(out_bwt + size, run_char, run);
    size += run;
    {
      int r = sym;
      uint8_t c = imtf[r];
      memmove(imtf + 1, imtf, r);
      imtf[0] = c;
      run_char = c;
    }
    run = 1;
    shift = 0;
  }
  return -E_UNTERM;
}

/* ------------------------------------------------------------------ */
/* IBWT + derandomize + RLE1 expand + CRC (fused emit)                 */
/* ------------------------------------------------------------------ */

static const uint16_t rand_table[512] = {
  619,720,127,481,931,816,813,233,566,247,985,724,205,454,863,491,741,242,
  949,214,733,859,335,708,621,574,73,654,730,472,419,436,278,496,867,210,
  399,680,480,51,878,465,811,169,869,675,611,697,867,561,862,687,507,283,
  482,129,807,591,733,623,150,238,59,379,684,877,625,169,643,105,170,607,
  520,932,727,476,693,425,174,647,73,122,335,530,442,853,695,249,445,515,
  909,545,703,919,874,474,882,500,594,612,641,801,220,162,819,984,589,513,
  495,799,161,604,958,533,221,400,386,867,600,782,382,596,414,171,516,375,
  682,485,911,276,98,553,163,354,666,933,424,341,533,870,227,730,475,186,
  263,647,537,686,600,224,469,68,770,919,190,373,294,822,808,206,184,943,
  795,384,383,461,404,758,839,887,715,67,618,276,204,918,873,777,604,560,
  951,160,578,722,79,804,96,409,713,940,652,934,970,447,318,353,859,672,
  112,785,645,863,803,350,139,93,354,99,820,908,609,772,154,274,580,184,
  79,626,630,742,653,282,762,623,680,81,927,626,789,125,411,521,938,300,
  821,78,343,175,128,250,170,774,972,275,999,639,495,78,352,126,857,956,
  358,619,580,124,737,594,701,612,669,112,134,694,363,992,809,743,168,974,
  944,375,748,52,600,747,642,182,862,81,344,805,988,739,511,655,814,334,
  249,515,897,955,664,981,649,113,974,459,893,228,433,837,553,268,926,240,
  102,654,459,51,686,754,806,760,493,403,415,394,687,700,946,670,656,610,
  738,392,760,799,887,653,978,321,576,617,626,502,894,679,243,440,680,879,
  194,572,640,724,926,56,204,700,707,151,457,449,797,195,791,558,945,679,
  297,59,87,824,713,663,412,693,342,606,134,108,571,364,631,212,174,643,
  304,329,343,97,430,751,497,314,983,374,822,928,140,206,73,263,980,736,
  876,478,430,305,170,514,364,692,829,82,855,953,676,246,369,970,294,750,
  807,827,150,790,288,923,804,378,215,828,592,281,565,555,710,82,896,831,
  547,261,524,462,293,465,502,56,661,821,976,991,658,869,905,758,745,193,
  768,550,608,933,378,286,215,979,792,961,61,688,793,644,986,403,106,366,
  905,644,372,567,466,434,645,210,389,550,919,135,780,773,635,389,707,100,
  626,958,165,504,920,176,193,713,857,265,203,50,668,108,645,990,626,197,
  510,357,358,850,858,364,936,638
};

/* --- resumable emit (the reference's decode.c:944-1144 analogue) ---
 *
 * lbz2_ibwt_links builds the IBWT successor table once; lbz2_emit_chunk
 * then expands RLE1 into caller-sized buffers, suspending with full
 * state whenever the buffer fills, so decoders can bound output memory
 * with a fixed slot pool (reference src/expand.c:31-52 policy). */

typedef struct {
  long k;        /* BWT chars consumed (of n) */
  long cur;      /* current successor pointer */
  long rand_i;   /* derandomization table index */
  long rand_j;   /* next derandomization position */
  long pending;  /* run bytes still to emit (buffer-full suspend) */
  int run;       /* consecutive equal literals seen (0..4) */
  int last;      /* previous literal */
  uint32_t crc;  /* CRC register */
} lbz2_emit_state;

/* Build the successor table; returns the start pointer ptr[idx], or -3
 * if idx is out of range. */
long lbz2_ibwt_links(const uint8_t *bwt, long n, long idx,
                     int32_t *ptr_out) {
  if (idx < 0 || idx >= n) return -3;
  crc_init();
  long cnt[256];
  memset(cnt, 0, sizeof(cnt));
  for (long i = 0; i < n; i++) cnt[bwt[i]]++;
  long cum = 0;
  long base[256];
  for (int c = 0; c < 256; c++) { base[c] = cum; cum += cnt[c]; }
  for (long i = 0; i < n; i++) ptr_out[base[bwt[i]]++] = (int32_t)i;
  return ptr_out[idx];
}

void lbz2_emit_init(lbz2_emit_state *st, long start_ptr) {
  st->k = 0;
  st->cur = start_ptr;
  st->rand_i = 0;
  st->rand_j = 617;
  st->pending = 0;
  st->run = 0;
  st->last = -1;
  st->crc = 0xFFFFFFFFu;
}

/* Emit up to out_cap bytes; returns bytes written (resume while
 * lbz2_emit_done says no), or -2 on missing run length at stream end. */
long lbz2_emit_chunk(const uint8_t *bwt, long n, const int32_t *ptr,
                     int rand_flag, lbz2_emit_state *st, uint8_t *out,
                     long out_cap) {
  long op = 0;
  uint32_t crc = st->crc;
  int run = st->run, last = st->last;
  long cur = st->cur, k = st->k;
  long rand_i = st->rand_i, rand_j = st->rand_j;

  if (st->pending > 0) {
    while (st->pending > 0 && op < out_cap) {
      out[op++] = (uint8_t)last;
      crc = (crc << 8) ^ crc_tab[0][((crc >> 24) ^ last) & 0xFF];
      st->pending--;
    }
    if (st->pending > 0) goto suspend;
    run = 0;
    last = -1; /* a completed long run never chains */
  }

  while (k < n) {
    if (op >= out_cap) goto suspend;
    uint32_t ch = bwt[cur];
    cur = ptr[cur];
    k++;
    if (rand_flag && k - 1 == rand_j) {
      ch ^= 1;
      rand_i = (rand_i + 1) & 0x1FF;
      rand_j += rand_table[rand_i];
    }
    if (run == 4) {
      long extra = ch;
      long now = extra < out_cap - op ? extra : out_cap - op;
      for (long q = 0; q < now; q++) {
        out[op++] = (uint8_t)last;
        crc = (crc << 8) ^ crc_tab[0][((crc >> 24) ^ last) & 0xFF];
      }
      if (now < extra) {
        st->pending = extra - now;
        run = 0;
        goto suspend;
      }
      run = 0;
      last = -1;
      continue;
    }
    if ((int)ch == last) run++; else { run = 1; last = (int)ch; }
    out[op++] = (uint8_t)ch;
    crc = (crc << 8) ^ crc_tab[0][((crc >> 24) ^ ch) & 0xFF];
  }
  if (run == 4) return -2; /* missing run length */

suspend:
  st->crc = crc;
  st->run = run;
  st->last = last;
  st->cur = cur;
  st->k = k;
  st->rand_i = rand_i;
  st->rand_j = rand_j;
  return op;
}

int lbz2_emit_done(const lbz2_emit_state *st, long n) {
  return st->k >= n && st->pending == 0;
}

/* --- bidirectional IBWT ordering + linear RLE1 expansion -----------
 *
 * The list chase is latency-bound (a serial chain of cache misses);
 * running the FORWARD chain from ptr[idx] and the BACKWARD chain from
 * idx (via a predecessor table) interleaved overlaps two independent
 * miss chains (~1.4x one chain on real blocks).  The RLE1 expansion
 * then runs over the materialized linear buffer — no random loads,
 * runs become memsets, and the CRC moves to the slice-by-8 kernel
 * over the output.  Role of reference decode.c:852-930 + :944-1144,
 * re-decomposed for ILP. */

/* Materialize the decode-order byte sequence (incl. derandomization).
 * ptr/pred: int32[n] scratch.  Returns 0 or -3 on a bad index.
 *
 * Four overlapped chains via pointer squaring: one gather pass builds
 * ptr2 = ptr∘ptr (independent loads — pipelines at memory-level
 * parallelism, unlike the chase), a second squares it to ptr4; four
 * interleaved chains then each walk every 4th output position, so the
 * serial miss chain is n/4 long instead of n/2 (the previous
 * bidirectional form).  Output writes stay sequential (positions
 * 4k..4k+3 per step). */
long lbz2_ibwt_order(const uint8_t *bwt, long n, long idx,
                     int rand_flag, int32_t *ptr, int32_t *pred,
                     uint8_t *rle_out) {
  if (idx < 0 || idx >= n) return -3;
  long cnt[256];
  memset(cnt, 0, sizeof(cnt));
  for (long i = 0; i < n; i++) cnt[bwt[i]]++;
  long base[256], cum = 0;
  for (int c = 0; c < 256; c++) { base[c] = cum; cum += cnt[c]; }
  for (long i = 0; i < n; i++) ptr[base[bwt[i]]++] = (int32_t)i;

  if (n < 64) { /* tiny block: plain chase */
    long cur = ptr[idx];
    for (long k = 0; k < n; k++) { rle_out[k] = bwt[cur];
                                   cur = ptr[cur]; }
  } else {
    int32_t *ptr2 = pred; /* pred table no longer used: reuse */
    for (long i = 0; i + 8 < n; i++) {
      __builtin_prefetch(&ptr[ptr[i + 8]]);
      ptr2[i] = ptr[ptr[i]];
    }
    for (long i = n - 9 < 0 ? 0 : n - 9; i < n; i++)
      ptr2[i] = ptr[ptr[i]];
    /* chain heads: output positions 0,1,2,3 */
    long c0 = ptr[idx];
    long c1 = ptr[c0], c2 = ptr[c1], c3 = ptr[c2];
    /* square again into ptr (reads only ptr2) */
    for (long i = 0; i + 8 < n; i++) {
      __builtin_prefetch(&ptr2[ptr2[i + 8]]);
      ptr[i] = ptr2[ptr2[i]];
    }
    for (long i = n - 9 < 0 ? 0 : n - 9; i < n; i++)
      ptr[i] = ptr2[ptr2[i]];
    long q = n / 4;
    for (long k = 0; k < q; k++) {
      long b = 4 * k;
      rle_out[b] = bwt[c0];     c0 = ptr[c0];
      rle_out[b + 1] = bwt[c1]; c1 = ptr[c1];
      rle_out[b + 2] = bwt[c2]; c2 = ptr[c2];
      rle_out[b + 3] = bwt[c3]; c3 = ptr[c3];
    }
    long b = 4 * q;
    if (b < n) { rle_out[b++] = bwt[c0]; }
    if (b < n) { rle_out[b++] = bwt[c1]; }
    if (b < n) { rle_out[b++] = bwt[c2]; }
  }

  if (rand_flag) { /* toggle at the legacy derandomization positions */
    long ri = 0, rj = 617;
    while (rj < n) {
      rle_out[rj] ^= 1;
      ri = (ri + 1) & 0x1FF;
      rj += rand_table[ri];
    }
  }
  return 0;
}

typedef struct {
  long k;       /* order-buffer bytes consumed */
  long pending; /* run bytes still to emit (buffer-full suspend) */
  int run;
  int last;
} lbz2_rle_state;

void lbz2_rle_init(lbz2_rle_state *st) {
  st->k = 0;
  st->pending = 0;
  st->run = 0;
  st->last = -1;
}

/* Emit up to out_cap bytes from the linear order buffer; resumable.
 * Returns bytes written or -2 on a truncated final run.  CRC is NOT
 * folded here — callers run the slice-by-8 kernel over the output. */
long lbz2_rle1_expand_chunk(const uint8_t *rle, long n,
                            lbz2_rle_state *st, uint8_t *out,
                            long out_cap) {
  long op = 0;
  int run = st->run, last = st->last;
  long k = st->k;
  if (st->pending > 0) {
    long now = st->pending < out_cap ? st->pending : out_cap;
    memset(out, (uint8_t)last, (size_t)now);
    op = now;
    st->pending -= now;
    if (st->pending > 0) goto suspend;
    run = 0;
    last = -1;
  }
  while (k < n) {
    if (op >= out_cap) goto suspend;
    uint32_t ch = rle[k++];
    if (run == 4) {
      long extra = ch;
      long now = extra < out_cap - op ? extra : out_cap - op;
      memset(out + op, (uint8_t)last, (size_t)now);
      op += now;
      if (now < extra) {
        st->pending = extra - now;
        run = 0;
        goto suspend;
      }
      run = 0;
      last = -1;
      continue;
    }
    if ((int)ch == last) run++; else { run = 1; last = (int)ch; }
    out[op++] = (uint8_t)ch;
  }
  if (run == 4) return -2; /* missing run length */

suspend:
  st->run = run;
  st->last = last;
  st->k = k;
  return op;
}

int lbz2_rle_done(const lbz2_rle_state *st, long n) {
  return st->k >= n && st->pending == 0;
}

/* One-shot: order + expand + slice-by-8 CRC.  Returns output length,
 * -1 if out_cap exceeded, -2 on missing run length, -3 bad index. */
long lbz2_ibwt_emit2(const uint8_t *bwt, long n, long idx,
                     int rand_flag, int32_t *ptr, int32_t *pred,
                     uint8_t *rle_scratch, uint8_t *out, long out_cap,
                     uint32_t *crc_out) {
  long r = lbz2_ibwt_order(bwt, n, idx, rand_flag, ptr, pred,
                           rle_scratch);
  if (r < 0) return r;
  lbz2_rle_state st;
  lbz2_rle_init(&st);
  long op = lbz2_rle1_expand_chunk(rle_scratch, n, &st, out, out_cap);
  if (op == -2) return -2;
  if (!lbz2_rle_done(&st, n)) return -1;
  crc_init();
  *crc_out = lbz2_crc32_block(out, op, 0xFFFFFFFFu);
  return op;
}

/* IBWT + optional derandomization + RLE1 expansion + CRC.
 * ptr_scratch: caller-provided int32[n].
 * Returns output length, or -1 if out_cap exceeded, -2 on missing run
 * length (ERR_RUNLEN).  *crc gets the register (init 0xFFFFFFFF). */
long lbz2_ibwt_emit(const uint8_t *bwt, long n, long idx, int rand_flag,
                    int32_t *ptr_scratch, uint8_t *out, long out_cap,
                    uint32_t *crc_out) {
  crc_init();
  long cnt[256];
  memset(cnt, 0, sizeof(cnt));
  for (long i = 0; i < n; i++) cnt[bwt[i]]++;
  long cum = 0;
  long base[256];
  for (int c = 0; c < 256; c++) { base[c] = cum; cum += cnt[c]; }
  /* ptr[slot] = BWT position whose (char, position) is slot-th */
  for (long i = 0; i < n; i++) ptr_scratch[base[bwt[i]]++] = (int32_t)i;

  /* decode order chars; apply derandomization on the fly */
  long rand_i = 0, rand_j = 617;
  uint32_t crc = 0xFFFFFFFFu;
  long op = 0;

  long cur = ptr_scratch[idx];
  /* RLE1 expansion state */
  int run = 0;          /* consecutive equal literals seen (0..4) */
  int last = -1;

  for (long k = 0; k < n; k++) {
    uint32_t ch = bwt[cur];
    cur = ptr_scratch[cur];
    if (rand_flag) {
      if (k == rand_j) {
        ch ^= 1;
        rand_i = (rand_i + 1) & 0x1FF;
        rand_j += rand_table[rand_i];
      }
    }
    if (run == 4) {
      /* ch is a run-length byte */
      long extra = ch;
      if (op + extra > out_cap) return -1;
      for (long q = 0; q < extra; q++) {
        out[op++] = (uint8_t)last;
        crc = (crc << 8) ^ crc_tab[0][((crc >> 24) ^ last) & 0xFF];
      }
      run = 0;
      last = -1;
      continue;
    }
    if ((int)ch == last) run++; else { run = 1; last = (int)ch; }
    if (op + 1 > out_cap) return -1;
    out[op++] = (uint8_t)ch;
    crc = (crc << 8) ^ crc_tab[0][((crc >> 24) ^ ch) & 0xFF];
  }
  if (run == 4) return -2; /* missing run length */
  *crc_out = crc;
  return op;
}

/* Speculative magic scan (role of the reference's scan-DFA,
 * src/parse.c:282-342 over scantab.h, re-expressed as an 8-phase
 * shift-register scan): all bit offsets where the 48-bit big-endian
 * magic occurs.  Matches are >= 48 bits apart (the magics have no
 * period < 48), so out needs at most nbytes/6 + 2 entries. */
long lbz2_scan_magic(const uint8_t *data, long nbytes, uint64_t magic,
                     int64_t *out) {
  if (nbytes < 6) return 0;
  const uint64_t M = (1ULL << 48) - 1;
  magic &= M;
  long cnt = 0;
  /* reg: bytes [i, i+7) MSB-first; window at bit 8i+s (s=0..7) is
   * (reg >> (8 - s)) & M */
  uint64_t reg = 0;
  for (long k = 0; k < 6; k++) reg = (reg << 8) | data[k];
  for (long i = 0; i + 7 <= nbytes; i++) {
    reg = ((reg << 8) | data[i + 6]) & ((1ULL << 56) - 1);
    for (int s = 0; s < 8; s++)
      if (((reg >> (8 - s)) & M) == magic)
        out[cnt++] = 8 * i + s;
  }
  /* tail: the s=0 window of the final 6 bytes has no 7th byte */
  if (nbytes >= 6) {
    uint64_t v = 0;
    for (long k = nbytes - 6; k < nbytes; k++) v = (v << 8) | data[k];
    if (v == magic) out[cnt++] = 8 * (nbytes - 6);
  }
  return cnt;
}

#include "entropy.c"
#include "itbwt.c"
#include "sais.c"

/* Fused window worker: RLE1-collect one in_granul window, then
 * CRC + BWT + entropy-encode every resulting block — a whole window
 * per ctypes call with caller-provided reusable scratch, so the
 * Python orchestration layer pays no per-block allocation or
 * wrapper cost (the reference keeps a persistent per-worker encoder
 * arena for the same reason, src/encode.c:109-132).
 *
 * blk_scratch: >= wn*5/4+64 B (RLE1 worst-case expansion)
 * R/bwt_scratch: >= mbs+16 B; mtfv_scratch: >= mbs+52 u16
 * out: payloads back to back; pay_lens/crcs/starts/ends per block.
 * Returns nblocks, or <0 on error/capacity. */
long lbz2_encode_window(const uint8_t *win, long wn, long mbs,
                        int cluster_factor, uint8_t *blk_scratch,
                        long blk_cap, uint8_t *R_scratch,
                        uint8_t *bwt_scratch, uint16_t *mtfv_scratch,
                        uint8_t *out, long out_cap, long *starts,
                        long *ends, long *pay_lens, uint32_t *crcs,
                        long max_blocks) {
  long blens[512];
  uint8_t cmaps[512 * 256];
  if (max_blocks > 512) max_blocks = 512;
  long nb = lbz2_rle1_collect(win, wn, mbs, wn, blk_scratch, blk_cap,
                              starts, ends, blens, cmaps, max_blocks);
  if (nb < 0) return nb;
  long bpos = 0, opos = 0;
  for (long b = 0; b < nb; b++) {
    long blen = blens[b];
    const uint8_t *blk = blk_scratch + bpos;
    bpos += blen;
    uint32_t crc = lbz2_crc32_block(win + starts[b], ends[b] - starts[b],
                                    0xFFFFFFFFu) ^ 0xFFFFFFFFu;
    crcs[b] = crc;
    if (out_cap - opos < blen + (blen >> 1) + 8192) return -3;
    long m = lbz2_lyndon_prep(blk, blen, R_scratch);
    long idx;
    if (m >= 0) {
      idx = itb_bwt(R_scratch, (int32_t)blen, bwt_scratch,
                    (int32_t)((blen - m) % blen));
      if (idx < 0) idx = lbz2_bwt(blk, blen, bwt_scratch);
    } else {
      idx = lbz2_bwt(blk, blen, bwt_scratch);
    }
    if (idx < 0) return -4;
    long pl = lbz2_encode_payload(bwt_scratch, blen, cmaps + b * 256,
                                  idx, crc, cluster_factor,
                                  mtfv_scratch, out + opos);
    if (pl <= 0) return -5;
    pay_lens[b] = pl;
    opos += pl;
  }
  return nb;
}

/* Full block encode: BWT (SA-IS) + entropy, host-only path. */
long lbz2_encode_block(const uint8_t *block, long n,
                       const uint8_t *cmap_used, uint32_t crc_stored,
                       int cluster_factor, uint8_t *bwt_scratch,
                       uint16_t *mtfv_scratch, uint8_t *out) {
  long idx = lbz2_bwt(block, n, bwt_scratch);
  if (idx < 0) return -1;
  return lbz2_encode_payload(bwt_scratch, n, cmap_used, idx, crc_stored,
                             cluster_factor, mtfv_scratch, out);
}
