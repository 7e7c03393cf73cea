/* itbwt.c — two-stage suffix sort (Itoh–Tanaka style) for the host BWT.
 *
 * Clean-room implementation of the published two-stage / B*-subset
 * suffix sorting idea (Itoh & Tanaka 1999; the reference's divbwt,
 * src/divbwt.c:1488-1726, is the behavioral spec of the role this
 * fills).  Differences from the reference by design:
 *   - operates on a plain string with virtual-sentinel suffix
 *     semantics (the caller passes the least rotation R of the block,
 *     whose suffix order equals its rotation order); the reference
 *     wraps one character (T[n]=T[0]) and handles rotations directly;
 *   - B* substrings are ordered by a ternary-split multikey quicksort
 *     plus a Larsson–Sadakane prefix-doubling pass over the reduced
 *     rank sequence (the reference uses a bespoke introsort with
 *     block swap-merges plus a tandem-repeat sort);
 *   - the BWT byte for a slot is emitted into a separate output array
 *     at the moment the slot's suffix is placed (the reference stores
 *     complemented characters into the suffix array in place).
 *
 * Suffix types (scanning right to left; suffix n-1 is type A because
 * the virtual sentinel is smaller than everything):
 *   A: suffix i >  suffix i+1  (R[i] > R[i+1], or equal chars and
 *                               i+1 is A)
 *   B: suffix i <  suffix i+1
 *   B* = type B suffix whose successor suffix is type A.
 * Every plain-B suffix has a B successor, so once the B* subset is
 * sorted, one right-to-left scan per first-char region induces all B
 * suffixes, and one left-to-right scan over the whole array induces
 * all A suffixes (and the BWT falls out).
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#ifdef ITB_PROF
#include <stdio.h>
#include <time.h>
double ITBP[8];
static double itbp_now(void){struct timespec ts;clock_gettime(CLOCK_MONOTONIC,&ts);return ts.tv_sec+1e-9*ts.tv_nsec;}
#define ITBT(k) ITBP[k] += itbp_now() - _itb_t0; _itb_t0 = itbp_now();
#else
#define ITBT(k)
#endif

/* tuning knobs (overridable with -D for experiments; defaults are the
 * measured best on the dev box) */
#ifndef ITB_INS_THRESH
#define ITB_INS_THRESH 10
#endif
#ifndef ITB_PREFETCH
#define ITB_PREFETCH 8
#endif
#ifndef ITB_RADIX_MIN
#define ITB_RADIX_MIN 96
#endif

/* ---- substring machinery -------------------------------------------- */

typedef struct {
  const uint8_t *R;
  const int32_t *PB;   /* B* positions, ascending text order */
  int32_t m, n;
} itb_ctx;

/* end (exclusive) of B* substring #j: next B* start + 2, or n */
static inline int32_t itb_end(const itb_ctx *c, int32_t j) {
  return (j + 1 < c->m) ? c->PB[j + 1] + 2 : c->n;
}

/* byte key of substring #j at depth d: -1 once exhausted */
static inline int32_t itb_key(const itb_ctx *c, int32_t j, int32_t d) {
  int32_t p = c->PB[j];
  return (p + d < itb_end(c, j)) ? (int32_t)c->R[p + d] : -1;
}

/* full compare of substrings #a, #b from depth d (both known equal
 * before d).  <0, 0, >0; 0 means identical content and length. */
static int itb_cmp(const itb_ctx *c, int32_t a, int32_t b, int32_t d) {
  const uint8_t *R = c->R;
  int32_t pa = c->PB[a], pb = c->PB[b];
  int32_t ea = itb_end(c, a), eb = itb_end(c, b);
  int32_t ia = pa + d, ib = pb + d;
  while (ia < ea && ib < eb) {
    if (R[ia] != R[ib]) return (int)R[ia] - (int)R[ib];
    ia++; ib++;
  }
  if (ia < ea) return 1;   /* b exhausted first -> b smaller */
  if (ib < eb) return -1;
  return 0;
}

/* heapsort of B*-indices a[0..nn) by full substring compare from
 * depth d — the bounded-stack fallback for itb_mkqsort.  O(k log k)
 * compares, no extra memory, no recursion. */
static void itb_heapsort(const itb_ctx *c, int32_t *a, int32_t nn,
                         int32_t d) {
  for (int32_t start = nn / 2 - 1; start >= 0; start--) {
    int32_t root = start;
    int32_t v = a[root];
    for (;;) {
      int32_t ch = 2 * root + 1;
      if (ch >= nn) break;
      if (ch + 1 < nn && itb_cmp(c, a[ch], a[ch + 1], d) < 0) ch++;
      if (itb_cmp(c, v, a[ch], d) >= 0) break;
      a[root] = a[ch]; root = ch;
    }
    a[root] = v;
  }
  for (int32_t end = nn - 1; end > 0; end--) {
    int32_t v = a[end];
    a[end] = a[0];
    int32_t root = 0;
    for (;;) {
      int32_t ch = 2 * root + 1;
      if (ch >= end) break;
      if (ch + 1 < end && itb_cmp(c, a[ch], a[ch + 1], d) < 0) ch++;
      if (itb_cmp(c, v, a[ch], d) >= 0) break;
      a[root] = a[ch]; root = ch;
    }
    a[root] = v;
  }
}

/* ternary-split multikey quicksort of B*-indices A[0..cnt) from depth
 * d (explicit bounded stack; insertion sort for small runs; heapsort
 * fallback when the stack nears capacity — the partition chain can
 * push 2 entries per depth level without popping on inputs whose
 * substrings share long common prefixes with sparse paired
 * deviations, so depth is NOT logarithmic in the worst case). */
#ifndef ITB_STK       /* overridable so tests can force the spill path */
#define ITB_STK 256
#endif
static void itb_mkqsort(const itb_ctx *c, int32_t *A, int32_t cnt,
                        int32_t d0) {
  struct { int32_t *a; int32_t cnt, d; } stk[ITB_STK];
  int sp = 0;
  stk[sp].a = A; stk[sp].cnt = cnt; stk[sp].d = d0; sp++;
  while (sp > 0) {
    sp--;
    int32_t *a = stk[sp].a;
    int32_t nn = stk[sp].cnt, d = stk[sp].d;
    while (nn > 1) {
      if (nn <= 12) {
        for (int32_t i = 1; i < nn; i++) {
          int32_t v = a[i], j = i;
          while (j > 0 && itb_cmp(c, a[j - 1], v, d) > 0) {
            a[j] = a[j - 1]; j--;
          }
          a[j] = v;
        }
        break;
      }
      /* median-of-3 pivot key */
      int32_t k0 = itb_key(c, a[0], d);
      int32_t k1 = itb_key(c, a[nn / 2], d);
      int32_t k2 = itb_key(c, a[nn - 1], d);
      int32_t kp;
      if (k0 < k1) kp = (k1 < k2) ? k1 : (k0 < k2 ? k2 : k0);
      else kp = (k0 < k2) ? k0 : (k1 < k2 ? k2 : k1);
      /* 3-way partition on key kp */
      int32_t lo = 0, i = 0, hi = nn;
      while (i < hi) {
        int32_t k = itb_key(c, a[i], d);
        if (k < kp) { int32_t t = a[lo]; a[lo] = a[i]; a[i] = t;
                      lo++; i++; }
        else if (k > kp) { hi--; int32_t t = a[hi]; a[hi] = a[i];
                           a[i] = t; }
        else i++;
      }
      /* [0,lo) < kp; [lo,hi) == kp; [hi,nn) > kp.  Loop on the
       * largest of the three; push the other two (bounded: spill to
       * heapsort when the stack is nearly full). */
      int32_t sl = lo, sg = nn - hi;
      int32_t se = ((kp >= 0) && (hi - lo > 1)) ? hi - lo : 0;
      int32_t *pa[3] = { a, a + lo, a + hi };
      int32_t pc[3] = { sl, se, sg };
      int32_t pd[3] = { d, d + 1, d };
      int big = 0;
      if (pc[1] > pc[big]) big = 1;
      if (pc[2] > pc[big]) big = 2;
      for (int q = 0; q < 3; q++) {
        if (q == big || pc[q] <= 1) continue;
        if (sp >= ITB_STK - 2) {            /* bounded: sort in place */
          itb_heapsort(c, pa[q], pc[q], pd[q]);
          continue;
        }
        stk[sp].a = pa[q]; stk[sp].cnt = pc[q]; stk[sp].d = pd[q];
        sp++;
      }
      if (pc[big] <= 1) break;
      a = pa[big]; nn = pc[big]; d = pd[big];
    }
  }
}

/* ---- Larsson–Sadakane doubling over the reduced rank sequence ------- */

/* quicksort of packed (key << 19 | value) words, ascending; values
 * occupy the low 19 bits so key order dominates (19 value bits are
 * enough: m <= n/2 <= 450000 < 2^19; 19 also leaves exactly 45 high
 * bits for stage 1's five 9-bit symbol lanes — 45+20 would overflow
 * the u64 and drop the top bit of the depth-2 symbol for 0xFF) */
static void itb_u64sort(uint64_t *a, int32_t lo, int32_t hi) {
  while (hi - lo > ITB_INS_THRESH) {
    uint64_t x = a[lo], y = a[(lo + hi) / 2], z = a[hi];
    uint64_t kp = x < y ? (y < z ? y : (x < z ? z : x))
                        : (x < z ? x : (y < z ? z : y));
    kp >>= 19;
    int32_t i = lo, j = hi, k = lo;
    while (k <= j) {
      uint64_t v = a[k] >> 19;
      if (v < kp) { uint64_t t = a[i]; a[i] = a[k]; a[k] = t;
                    i++; k++; }
      else if (v > kp) { uint64_t t = a[j]; a[j] = a[k]; a[k] = t;
                         j--; }
      else k++;
    }
    if (i - lo < hi - j) { itb_u64sort(a, lo, i - 1); lo = j + 1; }
    else { itb_u64sort(a, j + 1, hi); hi = i - 1; }
  }
  for (int32_t i = lo + 1; i <= hi; i++) {
    uint64_t v = a[i];
    int32_t j = i;
    while (j > lo && (a[j - 1] >> 19) > (v >> 19)) {
      a[j] = a[j - 1]; j--;
    }
    a[j] = v;
  }
}

/* ---- the full suffix sort ------------------------------------------- */

/* Suffix-sort R[0..n) (virtual sentinel) into SA[0..n) and emit the
 * rotation BWT bytes (bwt[r] = R[(SA[r]+n-1) mod n]).  Returns the
 * slot of suffix `want` (-1 if want < 0), or -9 when the input has no
 * B* suffix (caller falls back; cannot happen for Lyndon inputs). */
long itb_bwt(const uint8_t *R, int32_t n, uint8_t *bwt_out,
             int32_t want) {
  if (n < 2) { if (n == 1) { bwt_out[0] = R[0]; } return 0; }

#ifdef ITB_PROF
  double _itb_t0 = itbp_now();
#endif
  int32_t *cntA = (int32_t *)calloc(257, sizeof(int32_t));
  int32_t *cntB = (int32_t *)calloc(65536, sizeof(int32_t));
  int32_t *cntBs = (int32_t *)calloc(65536, sizeof(int32_t));
  int32_t *PB = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n / 2 + 2));
  if (!cntA || !cntB || !cntBs || !PB) {
    free(cntA); free(cntB); free(cntBs); free(PB);
    return -8;
  }

  /* classify + count (right to left); collect B* positions */
  int32_t m = 0;
  {
    int32_t i = n - 1;
    int c1 = R[n - 1];
    cntA[c1]++;            /* suffix n-1: type A (sentinel) */
    i--;
    int prev_type_a = 1;
    for (; i >= 0; i--) {
      int c0 = R[i];
      if (c0 > c1 || (c0 == c1 && prev_type_a)) {
        cntA[c0]++;
        prev_type_a = 1;
      } else {
        if (prev_type_a) { cntBs[(c0 << 8) | c1]++; PB[m++] = i; }
        else cntB[(c0 << 8) | c1]++;
        prev_type_a = 0;
      }
      c1 = c0;
    }
  }
  if (m == 0 || m > 0x7FFFF) {
    /* no B* suffix, or too many for the 19-bit value lanes (cannot
     * happen for bzip2 blocks: B* positions are non-adjacent, so
     * m <= n/2 <= 450000 < 2^19) — caller falls back to SA-IS */
    free(cntA); free(cntB); free(cntBs); free(PB);
    return -9;
  }
  /* PB was collected right-to-left: reverse to ascending */
  for (int32_t i = 0, j = m - 1; i < j; i++, j--) {
    int32_t t = PB[i]; PB[i] = PB[j]; PB[j] = t;
  }

  int32_t *SB = (int32_t *)malloc(sizeof(int32_t) * (size_t)m);
  int32_t *RK = (int32_t *)malloc(sizeof(int32_t) * (size_t)m);
  if (!SB || !RK) {
    free(cntA); free(cntB); free(cntBs); free(PB); free(SB); free(RK);
    return -8;
  }
  /* cumulative B* bucket ends (placement consumes the global sorted
   * order bucket by bucket) */
  {
    int32_t sum = 0;
    for (int32_t b = 0; b < 65536; b++) {
      sum += cntBs[b];
      cntBs[b] = sum;
    }
  }

  ITBT(0)  /* classify + bucket sums */
  itb_ctx C = { R, PB, m, n };

  /* Global substring sort, stage 1: one scatter by the first two
   * symbols (their joint distribution is exactly the cntBs histogram
   * already computed during classification), then per-bucket in-cache
   * sorts of a packed 45-bit key of substring symbols 2..6 (9 bits
   * each: byte value + 1; 0 = past-end, which sorts first, matching
   * the first-exhausted-is-smaller substring order).  Resolves depth
   * 7 total — groups still tied finish with multikey quicksort at
   * depth 7.  One 8-byte scatter pass replaces the previous global
   * 4-pass 63-bit LSD radix (~5x less DRAM traffic); buckets average
   * m/65536 entries and even the biggest text buckets fit L2. */
  {
    uint64_t *K = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)m);
    int32_t *cur = (int32_t *)malloc(sizeof(int32_t) * 65536);
    if (!K || !cur) {
      free(K); free(cur);
      free(cntA); free(cntB); free(cntBs); free(PB); free(SB); free(RK);
      return -8;
    }
    for (int32_t b = 0; b < 65536; b++)
      cur[b] = b ? cntBs[b - 1] : 0;    /* bucket start offsets */
    for (int32_t j = 0; j < m; j++) {
      int32_t p = PB[j];
      int32_t e = (j + 1 < m) ? PB[j + 1] + 2 : n;
      uint64_t k = 0;
      int32_t w = e - p;
      if (w >= 7) {
        for (int q = 2; q < 7; q++)
          k = (k << 9) | (uint64_t)(R[p + q] + 1);
      } else {
        for (int q = 2; q < w; q++)
          k = (k << 9) | (uint64_t)(R[p + q] + 1);
        k <<= 9 * (7 - (w > 2 ? w : 2));
      }
      int32_t bkt = ((int32_t)R[p] << 8) | R[p + 1];
      K[cur[bkt]++] = (k << 19) | (uint32_t)j;   /* j < 2^19: m <= n/2 */
    }

    ITBT(1)  /* key build + bucket scatter */
    /* per-bucket: sort on the packed key (value bits don't disturb
     * key order within ties, and tie order is irrelevant — tied
     * groups are renamed below), then name groups.  rank = the last
     * slot of each tied group. */
    for (int32_t b = 0; b < 65536; b++) {
      int32_t lo = b ? cntBs[b - 1] : 0, hi = cntBs[b];
      if (hi - lo < 1) continue;
      if (hi - lo > 1) itb_u64sort(K, lo, hi - 1);
      /* (measured on this box: in-cache quicksort beats both LSD and
       * MSD/American-flag byte radix at every realistic bucket size) */
      int32_t gs = lo;
      while (gs < hi) {
        int32_t ge = gs + 1;
        uint64_t k = K[gs] >> 19;
        while (ge < hi && (K[ge] >> 19) == k) ge++;
        for (int32_t x = gs; x < ge; x++)
          SB[x] = (int32_t)(K[x] & 0x7FFFF);
        if (ge - gs > 1 && (k & 511) != 0) {
          itb_mkqsort(&C, SB + gs, ge - gs, 7);
          int32_t r_end;
          for (int32_t r = ge - 1; r >= gs; r = r_end - 1) {
            r_end = r;
            while (r_end > gs &&
                   itb_cmp(&C, SB[r_end - 1], SB[r_end], 7) == 0)
              r_end--;
            for (int32_t x = r_end; x <= r; x++) RK[SB[x]] = r;
          }
        } else {
          /* singleton, or identical short substrings (key exhausted) */
          for (int32_t x = gs; x < ge; x++) RK[SB[x]] = ge - 1;
        }
        gs = ge;
      }
    }
    free(K); free(cur);
  }

  ITBT(2)  /* naming */
  /* Larsson–Sadakane doubling on unsorted groups (double-buffered
   * worklist of [lo,hi] slot ranges; every group has >= 2 members so
   * each list holds at most m entries). */
  {
    int32_t *W = (int32_t *)malloc(sizeof(int32_t) * (size_t)(m + 2));
    int32_t *W2 = (int32_t *)malloc(sizeof(int32_t) * (size_t)(m + 2));
    uint64_t *PK = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)m);
    uint64_t *PT = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)m);
    if (!W || !W2 || !PK || !PT) {
      free(W); free(W2); free(PK); free(PT);
      free(cntA); free(cntB); free(cntBs);
      free(PB); free(SB); free(RK);
      return -8;
    }
    int32_t wn = 0;
    for (int32_t r = 0; r < m;) {
      int32_t hi = RK[SB[r]];
      if (hi > r) { W[wn++] = r; W[wn++] = hi; }
      r = hi + 1;
    }
    int32_t h = 1;
    while (wn > 0) {
      int32_t wm = 0;
      for (int32_t w = 0; w < wn; w += 2) {
        int32_t lo = W[w], hi = W[w + 1];
        /* triple step: pack (rank(j+h)+1, rank(j+2h)+1, j) — two
         * 19-bit rank lanes + the 19-bit value fit one u64, so each
         * round orders by prefix 3h for the same sort cost (~35%
         * fewer rounds on repeat-heavy inputs).  Rank -1 (reduced
         * suffix ends) packs as 0.  The RK gathers are the random
         * accesses here: prefetch 8 ahead (SB streams sequentially);
         * in-round refreshed ranks are fine — refinement only splits
         * groups consistently with the prefix order. */
        for (int32_t x = lo; x <= hi; x++) {
          if (x + ITB_PREFETCH <= hi) {
            int32_t jp = SB[x + ITB_PREFETCH];
            if (jp + h < m) __builtin_prefetch(&RK[jp + h]);
            if (jp + 2 * h < m) __builtin_prefetch(&RK[jp + 2 * h]);
          }
          int32_t j = SB[x];
          uint64_t k1 = (j + h < m) ? (uint64_t)(RK[j + h] + 1) : 0;
          uint64_t k2 = (j + 2 * h < m) ? (uint64_t)(RK[j + 2 * h] + 1)
                                        : 0;
          PK[x] = (k1 << 38) | (k2 << 19) | (uint32_t)j;
        }
        if (hi - lo > ITB_RADIX_MIN) {
          /* rank lanes sit in bits 19..57: four 10-bit LSD passes in
           * L1/L2 beat the comparison sort for big groups (the
           * page-repeat-heavy corpora that stress doubling produce
           * many of them) */
          int32_t s = hi - lo + 1;
          uint64_t *src = PK + lo, *dst = PT;
          for (int pass = 0; pass < 4; pass++) {
            int sh = 19 + 10 * pass;
            int32_t hst[1024];
            memset(hst, 0, sizeof(hst));
            for (int32_t x = 0; x < s; x++) hst[(src[x] >> sh) & 1023]++;
            if (hst[(src[0] >> sh) & 1023] == s) continue;
            int32_t sum = 0;
            for (int d = 0; d < 1024; d++) {
              int32_t t = hst[d]; hst[d] = sum; sum += t;
            }
            for (int32_t x = 0; x < s; x++)
              dst[hst[(src[x] >> sh) & 1023]++] = src[x];
            uint64_t *t = src; src = dst; dst = t;
          }
          if (src != PK + lo)
            memcpy(PK + lo, src, sizeof(uint64_t) * (size_t)s);
        } else {
          itb_u64sort(PK, lo, hi);
        }
        /* split into subgroups, refresh ranks */
        int32_t gs = lo;
        for (int32_t x = lo + 1; x <= hi + 1; x++) {
          if (x > hi || (PK[x] >> 19) != (PK[gs] >> 19)) {
            for (int32_t y = gs; y < x; y++) {
              int32_t j = (int32_t)(PK[y] & 0x7FFFF);
              SB[y] = j;
              RK[j] = x - 1;
            }
            if (x - gs > 1) { W2[wm++] = gs; W2[wm++] = x - 1; }
            gs = x;
          }
        }
      }
      int32_t *t = W; W = W2; W2 = t;
      wn = wm;
      h *= 3;
    }
    free(W); free(W2); free(PK); free(PT);
  }

  ITBT(3)  /* LS doubling */
  /* ---- bucket layout over the full SA ------------------------------ */
  int32_t *SA = (int32_t *)malloc(sizeof(int32_t) * (size_t)n);
  int32_t *kA = (int32_t *)malloc(sizeof(int32_t) * 256);
  int32_t *kB = (int32_t *)malloc(sizeof(int32_t) * 256);
  int32_t *regS = (int32_t *)malloc(sizeof(int32_t) * 257);
  int32_t *regE = (int32_t *)malloc(sizeof(int32_t) * 257);
  /* endB[c0<<8|c1] = end (exclusive) of B(c0,c1); startBs similar */
  int32_t *endB = cntB;     /* rewritten in place */
  int32_t *startBs = (int32_t *)malloc(sizeof(int32_t) * 65536);
  if (!SA || !kA || !kB || !regS || !regE || !startBs) {
    free(SA); free(kA); free(kB); free(regS); free(regE);
    free(startBs); free(cntA); free(cntB); free(cntBs);
    free(PB); free(SB); free(RK);
    return -8;
  }
  {
    /* recover per-bucket B* counts from the cumulative cursor array */
    int32_t off = 0;
    for (int c0 = 0; c0 < 256; c0++) {
      kA[c0] = off;                       /* A(c0) start */
      off += cntA[c0];
      regS[c0] = off;                     /* region: B part of c0 */
      {  /* B(c0,c0) (no B* possible there) */
        int32_t b = (c0 << 8) | c0;
        off += endB[b]; endB[b] = off;
      }
      for (int c1 = c0 + 1; c1 < 256; c1++) {
        int32_t b = (c0 << 8) | c1;
        int32_t prevBs = (b == 0) ? 0 : cntBs[b - 1];
        int32_t nBs = cntBs[b] - prevBs;
        startBs[b] = off;
        off += nBs;
        off += endB[b]; endB[b] = off;
      }
      regE[c0] = off;
    }
    /* (off == n) */
  }

  /* Induction entries pack the slot's BWT byte with the suffix
   * position: entry = (byte << ITB_BSH) | pos, possibly ~-flipped.
   * One random store per induced suffix instead of two (separate
   * bwt_out[slot] writes measured +0.14 s/43 MB vs divbwt's
   * construct, which stores chars into SA in place); the bytes are
   * extracted with one sequential pass at the end.
   * positive value = B-duty (predecessor is type B);
   * ~value = A-duty (predecessor is type A, or suffix 0). */
#define ITB_BSH 23
#define ITB_PMASK ((1 << ITB_BSH) - 1)
  if (n > ITB_PMASK) {  /* cannot pack; bzip2 blocks are <= 900001 */
    free(SA); free(kA); free(kB); free(regS); free(regE);
    free(startBs); free(cntA); free(cntB); free(cntBs);
    free(PB); free(SB); free(RK);
    return -7;
  }
  {
    int32_t r = 0;  /* global sorted B* cursor */
    for (int32_t b = 0; b < 65536 && r < m; b++) {
      int32_t prevBs = (b == 0) ? 0 : cntBs[b - 1];
      int32_t nBs = cntBs[b] - prevBs;
      if (nBs == 0) continue;
      int32_t slot = startBs[b];
      for (int32_t x = 0; x < nBs; x++, r++, slot++) {
        int32_t p = PB[SB[r]];
        int32_t byte = (p > 0) ? R[p - 1] : R[n - 1];
        int32_t e = (byte << ITB_BSH) | p;
        if (p > 0 && R[p - 1] <= R[p]) SA[slot] = e;
        else SA[slot] = ~e;
      }
    }
  }

  ITBT(4)  /* layout + B* place */
  long want_slot = -1;

  /* B-induce: regions by first char, descending; scan right to left */
  for (int c = 255; c >= 0; c--) {
    int32_t lo = regS[c], hi = regE[c];
    if (hi <= lo) continue;
    for (int c0 = 0; c0 <= c; c0++) kB[c0] = endB[(c0 << 8) | c];
    for (int32_t j = hi - 1; j >= lo; j--) {
      if (j - 16 >= lo) {
        int32_t vp = SA[j - 16];
        if (vp < 0) vp = ~vp;
        __builtin_prefetch(&R[vp & ITB_PMASK]);
      }
      int32_t v = SA[j];
      if (v < 0) { SA[j] = ~v; continue; }   /* A-duty: leave for A-scan */
      int32_t t = (v & ITB_PMASK) - 1;        /* pos > 0 for B-duty */
      int32_t slot = --kB[R[t]];
      int32_t byte = (t > 0) ? R[t - 1] : R[n - 1];
      int32_t e = (byte << ITB_BSH) | t;
      if (t > 0 && R[t - 1] <= R[t]) SA[slot] = e;
      else SA[slot] = ~e;
      SA[j] = ~v;                             /* done; A-scan skips */
    }
  }

  ITBT(5)  /* B-induce */
  /* A-induce: seed suffix n-1, then scan the whole array ascending */
  {
    int32_t t = n - 1;
    int32_t slot = kA[R[t]]++;
    int32_t e = ((int32_t)R[t - 1] << ITB_BSH) | t;
    SA[slot] = (R[t - 1] >= R[t]) ? e : ~e;
  }
  for (int32_t i = 0; i < n; i++) {
    if (i + 16 < n) {
      int32_t vp = SA[i + 16];
      if (vp < 0) vp = ~vp;
      __builtin_prefetch(&R[vp & ITB_PMASK]);
    }
    int32_t v = SA[i];
    if (v < 0) {
      v = ~v;
      SA[i] = v;
      if (want == (v & ITB_PMASK)) want_slot = i;
      continue;
    }
    int32_t pos = v & ITB_PMASK;
    if (want == pos) want_slot = i;
    if (pos == 0) continue;                  /* suffix 0: nothing before */
    int32_t t = pos - 1;
    if (R[t] < R[pos]) continue;             /* predecessor is type B */
    int32_t slot = kA[R[t]]++;
    int32_t byte = (t > 0) ? R[t - 1] : R[n - 1];
    int32_t e = (byte << ITB_BSH) | t;
    SA[slot] = (t > 0 && R[t - 1] >= R[t]) ? e : ~e;
  }
  /* extract the packed BWT bytes: one sequential pass */
  for (int32_t i = 0; i < n; i++)
    bwt_out[i] = (uint8_t)((uint32_t)SA[i] >> ITB_BSH);

  ITBT(6)  /* A-induce */
  free(SA); free(kA); free(kB); free(regS); free(regE); free(startBs);
  free(cntA); free(cntB); free(cntBs); free(PB); free(SB); free(RK);
  return want_slot;
}
