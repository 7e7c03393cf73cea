/* sais.c — clean-room SA-IS suffix array construction + rotation BWT.
 *
 * Standard induced-sorting algorithm (Nong/Zhang/Chan, "Two Efficient
 * Algorithms for Linear Time Suffix Array Construction").  Used for the
 * host-path BWT: the rotation sort of block T is obtained from the
 * suffix array of T.T (doubled string, virtual sentinel) restricted to
 * positions < n — this yields exactly the same order and tie-breaking
 * as the prefix-doubling oracle (equal rotations order by position,
 * since T[0..i) is always a prefix of T[0..j) for i<j).
 *
 * Replaces the role of the reference's divsufsort (src/divbwt.c) with a
 * different algorithm; output BWT strings are identical by correctness
 * of any rotation sort.
 */

#include <stdlib.h>

/* itbwt.c (two-stage B*-subset sorter; the production fast path) */
long itb_bwt(const uint8_t *R, int32_t n, uint8_t *bwt_out,
             int32_t want);

/* induced sort of suffix array for s[0..n-1] over alphabet K.
 * Instantiated twice (uint8_t level-0 input, int32_t recursion) via the
 * SAIS_TEMPLATE macro to halve level-0 memory traffic. */

static void sais_int(const int32_t *s, int32_t *SA, int32_t n, int32_t K);

#define IS_S(i) (t[(i) >> 3] & (1 << ((i) & 7)))
#define SET_S(i) (t[(i) >> 3] |= (uint8_t)(1 << ((i) & 7)))
#define CLR_S(i) (t[(i) >> 3] &= (uint8_t)~(1 << ((i) & 7)))

#define SAIS_TEMPLATE(SUFFIX, CHAR_T)                                   \
static void get_buckets_##SUFFIX(const CHAR_T *s, int32_t *bkt,         \
                                 int32_t n, int32_t K, int end) {       \
  int32_t i, sum = 0;                                                   \
  for (i = 0; i < K; i++) bkt[i] = 0;                                   \
  for (i = 0; i < n; i++) bkt[s[i]]++;                                  \
  for (i = 0; i < K; i++) {                                             \
    sum += bkt[i];                                                      \
    bkt[i] = end ? sum : sum - bkt[i];                                  \
  }                                                                     \
}                                                                       \
                                                                        \
static void induce_sa_##SUFFIX(const CHAR_T *s, int32_t *SA,            \
                               const uint8_t *t, int32_t *bkt,          \
                               int32_t n, int32_t K) {                  \
  int32_t i, j;                                                         \
  get_buckets_##SUFFIX(s, bkt, n, K, 0);                                \
  j = n - 1;                                                            \
  if (!(IS_S(j))) SA[bkt[s[j]]++] = j;                                  \
  for (i = 0; i < n; i++) {                                             \
    j = SA[i] - 1;                                                      \
    if (SA[i] > 0 && !(IS_S(j))) SA[bkt[s[j]]++] = j;                   \
  }                                                                     \
  get_buckets_##SUFFIX(s, bkt, n, K, 1);                                \
  for (i = n - 1; i >= 0; i--) {                                        \
    j = SA[i] - 1;                                                      \
    if (SA[i] > 0 && IS_S(j)) SA[--bkt[s[j]]] = j;                      \
  }                                                                     \
}                                                                       \
                                                                        \
static void sais_##SUFFIX(const CHAR_T *s, int32_t *SA, int32_t n,      \
                          int32_t K) {                                  \
  int32_t i, j;                                                         \
  if (n == 0) return;                                                   \
  if (n == 1) { SA[0] = 0; return; }                                    \
                                                                        \
  uint8_t *t = (uint8_t *)calloc(((size_t)n >> 3) + 1, 1);              \
  int32_t *bkt = (int32_t *)malloc(sizeof(int32_t) * (size_t)(K + 1));  \
                                                                        \
  CLR_S(n - 1);                                                         \
  for (i = n - 2; i >= 0; i--) {                                        \
    if (s[i] < s[i + 1] || (s[i] == s[i + 1] && IS_S(i + 1))) SET_S(i); \
  }                                                                     \
                                                                        \
  /* step 1: place LMS suffixes at bucket ends, induce */               \
  get_buckets_##SUFFIX(s, bkt, n, K, 1);                                \
  for (i = 0; i < n; i++) SA[i] = -1;                                   \
  for (i = 1; i < n; i++)                                               \
    if (IS_S(i) && !IS_S(i - 1)) SA[--bkt[s[i]]] = i;                   \
  induce_sa_##SUFFIX(s, SA, t, bkt, n, K);                              \
                                                                        \
  /* step 2: compact + name LMS substrings */                           \
  int32_t m = 0;                                                        \
  for (i = 0; i < n; i++) {                                             \
    j = SA[i];                                                          \
    if (j > 0 && IS_S(j) && !IS_S(j - 1)) SA[m++] = j;                  \
  }                                                                     \
  for (i = m; i < n; i++) SA[i] = -1;                                   \
  int32_t name = 0, prev = -1;                                          \
  for (i = 0; i < m; i++) {                                             \
    int32_t pos = SA[i];                                                \
    int diff = 0;                                                       \
    if (prev == -1) diff = 1;                                           \
    else {                                                              \
      for (j = 0; ; j++) {                                              \
        if (pos + j >= n || prev + j >= n) { diff = 1; break; }         \
        if (s[pos + j] != s[prev + j]) { diff = 1; break; }             \
        int ps = IS_S(pos + j) && (pos + j > 0) && !IS_S(pos + j - 1);  \
        int qs = IS_S(prev + j) && (prev + j > 0) &&                    \
                 !IS_S(prev + j - 1);                                   \
        if (j > 0 && (ps || qs)) { diff = !(ps && qs); break; }         \
      }                                                                 \
    }                                                                   \
    if (diff) { name++; prev = pos; }                                   \
    SA[m + pos / 2] = name - 1;                                         \
  }                                                                     \
  int32_t *s1 = SA + n - m;                                             \
  for (i = n - 1, j = n - 1; i >= m; i--)                               \
    if (SA[i] >= 0) SA[j--] = SA[i];                                    \
                                                                        \
  /* step 3: order LMS (recurse on reduced problem if names repeat) */  \
  if (name < m) {                                                       \
    sais_int(s1, SA, m, name);                                          \
  } else {                                                              \
    for (i = 0; i < m; i++) SA[s1[i]] = i;                              \
  }                                                                     \
  {                                                                     \
    int32_t k2 = 0;                                                     \
    for (i = 1; i < n; i++)                                             \
      if (IS_S(i) && !IS_S(i - 1)) s1[k2++] = i;                        \
    for (i = 0; i < m; i++) SA[i] = s1[SA[i]];                          \
  }                                                                     \
                                                                        \
  /* step 4: final induced sort from sorted LMS */                      \
  for (i = m; i < n; i++) SA[i] = -1;                                   \
  get_buckets_##SUFFIX(s, bkt, n, K, 1);                                \
  for (i = m - 1; i >= 0; i--) {                                        \
    j = SA[i];                                                          \
    SA[i] = -1;                                                         \
    SA[--bkt[s[j]]] = j;                                                \
  }                                                                     \
  induce_sa_##SUFFIX(s, SA, t, bkt, n, K);                              \
                                                                        \
  free(t);                                                              \
  free(bkt);                                                            \
}

SAIS_TEMPLATE(int, int32_t)
SAIS_TEMPLATE(u8, uint8_t)

/* Index of the lexicographically least rotation of T[0..n): the classic
 * two-pointer duel (amortized O(n)).  Runs over a doubled copy so the
 * inner loop needs no wraparound arithmetic.  Two candidate starts
 * race; a mismatch at offset k disqualifies the loser and every start
 * it dominates. */
long lbz2_min_rotation(const uint8_t *T, long n) {
  uint8_t *TT = (uint8_t *)malloc((size_t)(2 * n));
  if (!TT) return 0; /* degrade: rotation 0 is always valid input */
  memcpy(TT, T, (size_t)n);
  memcpy(TT + n, T, (size_t)n);
  long i = 0, j = 1, k = 0;
  while (i < n && j < n && k < n) {
    uint8_t a = TT[i + k], b = TT[j + k];
    if (a == b) { k++; continue; }
    if (a > b) i += k + 1; else j += k + 1;
    if (i == j) j++;
    k = 0;
  }
  free(TT);
  return i < j ? i : j;
}

/* Is R[0..n) a proper power u^k?  R is periodic with some period p < n
 * dividing n iff it has period n/q for some prime q | n, so a handful
 * of (early-exiting) border memcmps decide primitivity in practice in
 * O(#prime factors) time on non-degenerate data. */
static int is_periodic(const uint8_t *R, long n) {
  long rest = n;
  for (long q = 2; q * q <= rest; q++) {
    if (rest % q) continue;
    while (rest % q == 0) rest /= q;
    long p = n / q;
    if (memcmp(R, R + p, (size_t)(n - p)) == 0) return 1;
  }
  if (rest > 1 && rest < n) {
    long p = n / rest;
    if (memcmp(R, R + p, (size_t)(n - p)) == 0) return 1;
  }
  return 0;
}

/* Prepare one block for the suffix-sort BWT paths: write the least
 * rotation of T into R[0..n) and return the rotation index m, or -1 if
 * T is fully periodic (caller must use the doubled-string fallback). */
long lbz2_lyndon_prep(const uint8_t *T, long n, uint8_t *R) {
  if (n <= 0) return -1;
  long m = lbz2_min_rotation(T, n);
  memcpy(R, T + m, (size_t)(n - m));
  memcpy(R + n - m, T, (size_t)m);
  if (n == 1) return 0;
  return is_periodic(R, n) ? -1 : m;
}

/* SA-IS BWT over an already-least-rotated R (test/differential entry:
 * same contract as itb_bwt — emit rotation-BWT bytes, return the slot
 * of suffix `want`). */
long lbz2_bwt_sais_rot(const uint8_t *R, long n, uint8_t *bwt_out,
                       long want) {
  if (n <= 0) return -1;
  if (n == 1) { bwt_out[0] = R[0]; return 0; }
  int32_t *SA = (int32_t *)malloc(sizeof(int32_t) * (size_t)n);
  if (!SA) return -2;
  sais_u8(R, SA, (int32_t)n, 256);
  long idx = -1;
  for (long r = 0; r < n; r++) {
    int32_t q = SA[r];
    if (q == want) idx = r;
    bwt_out[r] = R[q == 0 ? n - 1 : q - 1];
  }
  free(SA);
  return idx;
}

/* Rotation-sort BWT of T[0..n): returns primary index, fills bwt_out.
 *
 * Fast path: rotate T to its least rotation R (a Lyndon word when T is
 * primitive); the rotations of a Lyndon word sort in the same relative
 * order as its suffixes, so one n-length SA-IS suffices.  Rotation j of
 * T is rotation (j - m) mod n of R; the BWT byte for suffix rank r is
 * R[(SA[r] + n - 1) mod n] and the primary index is the rank of
 * R-rotation (n - m) mod n.
 *
 * Fully-periodic blocks (T = u^k) fall back to the doubled-string sort,
 * whose tie order (equal rotations by descending start) is the repo\'s
 * established convention.  Replaces the role of the reference\'s
 * divsufsort (src/divbwt.c) with different algorithms throughout. */
long lbz2_bwt(const uint8_t *T, long n, uint8_t *bwt_out) {
  if (n <= 0) return -1;
  if (n == 1) { bwt_out[0] = T[0]; return 0; }

  uint8_t *R = (uint8_t *)malloc((size_t)n);
  if (!R) return -2;
  long m = lbz2_lyndon_prep(T, n, R);
  if (m < 0) {
    /* fully periodic: doubled-string fallback (rare) */
    free(R);
    long nn = 2 * n;
    uint8_t *s = (uint8_t *)malloc((size_t)nn);
    int32_t *SA2 = (int32_t *)malloc(sizeof(int32_t) * (size_t)nn);
    if (!s || !SA2) { free(s); free(SA2); return -2; }
    memcpy(s, T, (size_t)n);
    memcpy(s + n, T, (size_t)n);
    sais_u8(s, SA2, (int32_t)nn, 256);
    long r = 0, idx = -1;
    for (long i = 0; i < nn; i++) {
      int32_t q = SA2[i];
      if (q < n) {
        if (q == 0) idx = r;
        bwt_out[r++] = T[q == 0 ? n - 1 : q - 1];
      }
    }
    free(s);
    free(SA2);
    return idx;
  }

  long i0 = (n - m) % n; /* R-rotation index of T-rotation 0 */

  /* fast path: two-stage B*-subset sort (itbwt.c); ~1.6x the SA-IS
   * below on text.  Falls back on no-B* inputs (non-increasing R,
   * possible only for degenerate near-periodic blocks) and on
   * allocation failure. */
  long idx = itb_bwt(R, (int32_t)n, bwt_out, (int32_t)i0);
  if (idx >= 0) { free(R); return idx; }

  int32_t *SA = (int32_t *)malloc(sizeof(int32_t) * (size_t)n);
  if (!SA) { free(R); return -2; }
  sais_u8(R, SA, (int32_t)n, 256);
  idx = -1;
  for (long r = 0; r < n; r++) {
    int32_t q = SA[r];
    if (q == i0) idx = r;
    bwt_out[r] = R[q == 0 ? n - 1 : q - 1];
  }
  free(R);
  free(SA);
  return idx;
}
