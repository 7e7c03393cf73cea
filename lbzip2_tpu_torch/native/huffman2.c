/* huffman2.c — Huffman code-length computation and length-limited code
 * assignment for the bzip2 entropy coder, built on explicit node
 * records and FIFO queues.
 *
 * Bit-exactness contract (spec: reference src/encode.c:547-1010, via
 * the repo's validated oracle): the output depth vector of the bzip2
 * encoder is fully determined by a total order on tree nodes.  We
 * express that order as an explicit lexicographic key tuple
 *
 *      K(node) = (freq, height, nleaf mod 256, tag)
 *
 * where tag = MAX_ALPHA - symbol for leaves, and an internal node
 * created by the j-th merge carries the tag of the j-th smallest leaf
 * (an artifact of the spec's storage layout that can break ties, so we
 * reproduce it as part of the key).  Given K, the code lengths are
 * those of the two-queue Huffman procedure:
 *   - leaves queue: leaves sorted ascending by K
 *   - internal queue: FIFO of merged nodes (in creation order)
 *   - each step consumes two nodes per the decision table in
 *     huff_pick_pair() below, preferring leaves on key ties.
 * Depths are then re-assigned by rank profile: the d-th smallest leaf
 * gets the d-th largest depth of the multiset of leaf depths.
 *
 * The length-limited variant (assign_codes2) runs a textbook
 * package-merge per candidate height: level list L_1 = sorted leaves,
 * L_d = merge(leaves, adjacent-pairs(L_{d-1})); the optimal solution
 * takes the first 2(as-1) items of L_h, and a leaf's code length is
 * the number of levels whose taken prefix contains it.  Package keys
 * use K(package) = (freq sum, height, 0, 0).
 */

#define MAX_HUFF_LEN2 30

typedef struct {
  uint32_t f;   /* frequency sum */
  uint8_t h;    /* subtree height (0 for leaves) */
  uint8_t nl;   /* leaf count mod 256 (1 for leaves, 0 for packages) */
  uint16_t tag; /* MAX_ALPHA - symbol for leaves; slot tag for merges */
} hkey2;

static inline int hkey2_lt(hkey2 a, hkey2 b) {
  if (a.f != b.f) return a.f < b.f;
  if (a.h != b.h) return a.h < b.h;
  if (a.nl != b.nl) return a.nl < b.nl;
  return a.tag < b.tag;
}

static inline int hkey2_le(hkey2 a, hkey2 b) { return !hkey2_lt(b, a); }

static inline hkey2 hkey2_merge(hkey2 a, hkey2 b, uint16_t tag) {
  hkey2 m;
  m.f = a.f + b.f;
  m.h = (uint8_t)((a.h > b.h ? a.h : b.h) + 1);
  m.nl = (uint8_t)(a.nl + b.nl);
  m.tag = tag;
  return m;
}

/* Ascending insertion sort of leaf keys (freq asc, then tag asc, i.e.
 * equal-frequency symbols in descending symbol order). */
static void hkey2_sort_asc(hkey2 *a, int n) {
  for (int i = 1; i < n; i++) {
    hkey2 t = a[i];
    int j = i;
    while (j > 0 && hkey2_lt(t, a[j - 1])) {
      a[j] = a[j - 1];
      j--;
    }
    a[j] = t;
  }
}

/* Decision table for one merge step of the two-queue method.
 * Inputs: the two cheapest leaves (if any) and the two oldest unmerged
 * internal nodes (if any).  Output: which queue each of the two
 * consumed nodes comes from.  Ties prefer leaves.  Returns a 2-bit
 * mask: bit0 = first pick is internal, bit1 = second pick is internal.
 */
static int huff_pick_pair(const hkey2 *leaf, int nleaf,
                          const hkey2 *intq, int nint) {
  if (nleaf == 0 || (nint >= 2 && hkey2_lt(intq[1], leaf[0])))
    return 3; /* internal + internal */
  if (nint == 0 || (nleaf >= 2 && hkey2_le(leaf[1], intq[0])))
    return 0; /* leaf + leaf */
  return 1;   /* oldest internal + cheapest leaf */
}

/* Leaf-depth profile of the (unlimited) Huffman code over `keys`
 * (ascending).  Fills prof[0..MAX_HUFF_LEN2] with the number of leaves
 * per depth. */
static void huff_depth_profile(const hkey2 *keys, int as, int *prof) {
  /* node ids: 0..as-1 leaves (ascending rank), as.. merges */
  hkey2 nk[2 * MAX_ALPHA];
  int child[2 * MAX_ALPHA][2];
  int depth_of[2 * MAX_ALPHA];
  int li = 0;          /* next unconsumed leaf */
  int ii = 0, m = 0;   /* internal FIFO: ids as+ii .. as+m-1 */

  for (int i = 0; i < as; i++) nk[i] = keys[i];

  for (int step = 1; step < as; step++) {
    int picks = huff_pick_pair(nk + li, as - li, nk + as + ii, m - ii);
    int c0 = (picks & 1) ? as + ii++ : li++;
    int c1 = (picks & 2) ? as + ii++ : li++;
    int id = as + m;
    /* the j-th merge carries the tag of the j-th smallest leaf */
    nk[id] = hkey2_merge(nk[c0], nk[c1], keys[step - 1].tag);
    child[id][0] = c0;
    child[id][1] = c1;
    m++;
  }

  memset(prof, 0, (MAX_HUFF_LEN2 + 1) * sizeof(int));
  if (as == 1) { prof[0] = 1; return; }

  /* top-down depth propagation from the root (last merge) */
  int stack[2 * MAX_ALPHA];
  int sp = 0;
  int root = as + m - 1;
  depth_of[root] = 0;
  stack[sp++] = root;
  while (sp) {
    int id = stack[--sp];
    if (id < as) {
      int d = depth_of[id];
      prof[d > MAX_HUFF_LEN2 ? MAX_HUFF_LEN2 : d]++;
      continue;
    }
    for (int c = 0; c < 2; c++) {
      int ch = child[id][c];
      depth_of[ch] = depth_of[id] + 1;
      stack[sp++] = ch;
    }
  }
}

/* Huffman code lengths (unlimited-depth variant used inside the EM
 * loop).  freq==0 is clamped to 1 before keying. */
static void make_code_lengths2(uint8_t *len_out /*MAX_ALPHA+1*/,
                               const uint32_t *freq, int as) {
  hkey2 keys[MAX_ALPHA];
  int prof[MAX_HUFF_LEN2 + 1];
  for (int v = 0; v < as; v++) {
    keys[v].f = freq[v] ? freq[v] : 1;
    keys[v].h = 0;
    keys[v].nl = 1;
    keys[v].tag = (uint16_t)(MAX_ALPHA - v);
  }
  hkey2_sort_asc(keys, as);
  huff_depth_profile(keys, as, prof);
  /* rank profile assignment: ascending ranks get descending depths */
  int rank = 0;
  for (int d = MAX_HUFF_LEN2; d >= 0; d--)
    for (int k = prof[d]; k > 0; k--, rank++)
      len_out[MAX_ALPHA - keys[rank].tag] = (uint8_t)d;
}

/* ---- textbook package-merge (per height limit) ---- */

typedef struct {
  hkey2 k;
  int is_leaf; /* 1: leaf (payload = ascending rank); 0: package */
} pm2_item;

/* Package key: frequency sum and height only (leaf count and tag are
 * not part of a package's identity, unlike build-tree merges). */
static inline hkey2 pm2_pair(hkey2 a, hkey2 b) {
  hkey2 m;
  m.f = a.f + b.f;
  m.h = (uint8_t)((a.h > b.h ? a.h : b.h) + 1);
  m.nl = 0;
  m.tag = 0;
  return m;
}

/* Fill cnt_taken_leaves[d] (d = 1..h) = number of leaves inside the
 * taken prefix at level d, for the optimal height-h solution.  Lists
 * are built bottom-up, then the taken prefix is resolved top-down. */
static void pm2_profile(const hkey2 *leaves, int as, int h,
                        uint8_t *depth_by_rank /*as*/) {
  static __thread pm2_item lists[MAX_CODE_LENGTH + 1][2 * MAX_ALPHA];
  static __thread int lsize[MAX_CODE_LENGTH + 1];

  for (int q = 0; q < as; q++) {
    lists[1][q].k = leaves[q];
    lists[1][q].is_leaf = 1;
  }
  lsize[1] = as;

  for (int d = 2; d <= h; d++) {
    int np = lsize[d - 1] / 2;
    int i = 0, j = 0, o = 0;
    while (i < as || j < np) {
      hkey2 pk;
      if (j < np)
        pk = pm2_pair(lists[d - 1][2 * j].k, lists[d - 1][2 * j + 1].k);
      if (j >= np || (i < as && hkey2_le(leaves[i], pk))) {
        lists[d][o].k = leaves[i++];
        lists[d][o++].is_leaf = 1;
      } else {
        lists[d][o].k = pk;
        lists[d][o++].is_leaf = 0;
        j++;
      }
    }
    lsize[d] = o;
  }

  memset(depth_by_rank, 0, (size_t)as);
  int take = 2 * (as - 1);
  for (int d = h; d >= 1 && take > 0; d--) {
    if (take > lsize[d]) take = lsize[d];
    int pkgs = 0, leaf_rank = 0;
    for (int i = 0; i < take; i++) {
      if (lists[d][i].is_leaf)
        depth_by_rank[leaf_rank++]++;
      else
        pkgs++;
    }
    take = 2 * pkgs;
  }
}

/* Length-limited canonical code assignment + bit-cost of transmitting
 * the tree and its codes.  Searches heights 2..MAX_CODE_LENGTH for the
 * cheapest delta-coded representation (spec quirks preserved: the
 * search breaks at the first height whose solution doesn't use its
 * full depth, and an immediately-broken search returns cost 2^32-1
 * with height MAX_CODE_LENGTH). */
static uint32_t assign_codes2(uint32_t *code, uint8_t *length,
                              const uint32_t *freq, int as) {
  hkey2 leaves[MAX_ALPHA];
  uint8_t dbr[MAX_ALPHA];
  for (int v = 0; v < as; v++) {
    leaves[v].f = freq[v];
    leaves[v].h = 0;
    leaves[v].nl = 1;
    leaves[v].tag = (uint16_t)(MAX_ALPHA - v);
  }
  hkey2_sort_asc(leaves, as);

  uint64_t best_cost = ~(uint64_t)0;
  int best_height = MAX_CODE_LENGTH;
  for (int h = 2; h <= MAX_CODE_LENGTH; h++) {
    if ((1 << h) < as) continue;
    pm2_profile(leaves, as, h, dbr);
    if (dbr[0] != h) break; /* solution shallower than its limit */
    uint64_t cost = 0;
    for (int q = 0; q < as; q++) {
      length[MAX_ALPHA - leaves[q].tag] = dbr[q];
      cost += (uint64_t)leaves[q].f * dbr[q];
    }
    for (int sym = 1; sym < as; sym++) {
      int d = (int)length[sym - 1] - (int)length[sym];
      cost += 2 * (uint64_t)(d < 0 ? -d : d);
    }
    cost += 5 + (uint64_t)as;
    if (cost < best_cost) {
      best_cost = cost;
      best_height = h;
    }
  }

  pm2_profile(leaves, as, best_height, dbr);
  for (int q = 0; q < as; q++)
    length[MAX_ALPHA - leaves[q].tag] = dbr[q];

  /* canonical codes: bases per depth, then codes in symbol order */
  uint32_t base_code[MAX_CODE_LENGTH + 2];
  int cnt[MAX_CODE_LENGTH + 2];
  memset(cnt, 0, sizeof(cnt));
  for (int q = 0; q < as; q++) cnt[dbr[q]]++;
  uint32_t next_code = 0;
  for (int d = 1; d <= best_height; d++) {
    base_code[d] = next_code;
    next_code = (next_code + (uint32_t)cnt[d]) << 1;
  }
  for (int sym = 0; sym < as; sym++)
    code[sym] = base_code[length[sym]]++;
  return (uint32_t)best_cost;
}
