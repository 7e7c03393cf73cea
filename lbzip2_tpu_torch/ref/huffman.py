"""Multi-table canonical Huffman modeling — the bzip2 entropy-coder model.

Behavioral spec: reference src/encode.c:547-1137 (every numeric detail —
tie-breaking, EM trajectory, height-cost search — is semantically
significant because the encoder's output bytes depend on it and
bit-exact parity with the reference binary is a test target).

The implementation mirrors the repo's native formulation
(lbzip2_tpu_torch/native/huffman2.c): the node order that fixes all
tie-breaks is the explicit lexicographic key

    K(node) = (freq, height, nleaf mod 256, tag)

with tag = MAX_ALPHA_SIZE - symbol for leaves, and the j-th merge
carrying the tag of the j-th smallest leaf.  Code lengths come from the
two-queue Huffman procedure expressed as a decision table over
leaf/internal FIFOs; length-limited codes come from a textbook
per-height package-merge (level lists + taken-prefix counting).
"""

from __future__ import annotations

import numpy as np

from lbzip2_tpu_torch.core.constants import (GROUP_SIZE, MAX_ALPHA_SIZE,
                                       MAX_CODE_LENGTH, MAX_TREES)

MAX_HUFF_CODE_LENGTH = 30


def _leaf_keys(freq, alpha_size: int, clamp: bool) -> list[tuple]:
    """Ascending leaf keys (freq, height=0, nleaf=1, tag)."""
    keys = [(max(int(freq[v]), 1) if clamp else int(freq[v]),
             0, 1, MAX_ALPHA_SIZE - v) for v in range(alpha_size)]
    keys.sort()
    return keys


def _merge_key(a: tuple, b: tuple, tag: int) -> tuple:
    """Build-tree merge: freq sum, height max+1, leaf count mod 256."""
    return (a[0] + b[0], max(a[1], b[1]) + 1, (a[2] + b[2]) & 0xFF, tag)


def _pair_key(a: tuple, b: tuple) -> tuple:
    """Package-merge pair: only freq sum and height identify a package."""
    return (a[0] + b[0], max(a[1], b[1]) + 1, 0, 0)


def _huff_depth_profile(keys: list[tuple], as_: int) -> list[int]:
    """Leaf-depth histogram of the two-queue Huffman code over `keys`.

    Decision table per merge step (ties prefer leaves):
      - two internals when there is no leaf, or the 2nd-oldest internal
        is strictly cheaper than the cheapest leaf;
      - two leaves when there is no internal, or the 2nd-cheapest leaf
        is <= the oldest internal;
      - otherwise one of each (oldest internal + cheapest leaf).
    """
    children: list[tuple[int, int]] = []  # per internal node
    ikeys: list[tuple] = []               # internal FIFO keys
    li = 0  # next leaf
    ii = 0  # internal FIFO head

    def pick():
        nonlocal li, ii
        nleaf = as_ - li
        nint = len(ikeys) - ii
        if nleaf == 0 or (nint >= 2 and ikeys[ii + 1] < keys[li]):
            c = (~ii, ~(ii + 1))
            ii += 2
        elif nint == 0 or (nleaf >= 2 and keys[li + 1] <= ikeys[ii]):
            c = (li, li + 1)
            li += 2
        else:
            c = (~ii, li)
            ii += 1
            li += 1
        return c

    for step in range(1, as_):
        c0, c1 = pick()
        k0 = ikeys[~c0] if c0 < 0 else keys[c0]
        k1 = ikeys[~c1] if c1 < 0 else keys[c1]
        ikeys.append(_merge_key(k0, k1, keys[step - 1][3]))
        children.append((c0, c1))

    prof = [0] * (MAX_HUFF_CODE_LENGTH + 1)
    if as_ == 1:
        prof[0] = 1
        return prof
    stack = [(len(children) - 1, 0)]  # (internal index, depth)
    while stack:
        node, d = stack.pop()
        for c in children[node]:
            if c >= 0:
                dc = min(d + 1, MAX_HUFF_CODE_LENGTH)
                prof[dc] += 1
            else:
                stack.append((~c, d + 1))
    return prof


def make_code_lengths(freq: np.ndarray, alpha_size: int) -> np.ndarray:
    """Huffman code lengths, unlimited depth (EM inner loop variant).

    Zero frequencies are clamped to 1.  Depths are re-assigned by rank
    profile: the q-th smallest leaf gets the q-th largest depth.
    """
    keys = _leaf_keys(freq, alpha_size, clamp=True)
    prof = _huff_depth_profile(keys, alpha_size)
    lengths = np.zeros(MAX_ALPHA_SIZE + 1, dtype=np.uint8)
    rank = 0
    for d in range(MAX_HUFF_CODE_LENGTH, -1, -1):
        for _ in range(prof[d]):
            lengths[MAX_ALPHA_SIZE - keys[rank][3]] = d
            rank += 1
    assert rank == alpha_size
    return lengths


def _pm_depths(leaves: list[tuple], as_: int, h: int) -> list[int]:
    """Textbook package-merge depth-by-rank for height limit h.

    Level list L_1 = sorted leaves; L_d = merge(leaves, adjacent pairs
    of L_{d-1}).  The optimal solution takes the first 2(as-1) items of
    L_h; a leaf's code length = number of levels whose taken prefix
    contains it.
    """
    lists: list[list[tuple[tuple, bool]]] = [[]] * (h + 1)
    lists[1] = [(k, True) for k in leaves]
    for d in range(2, h + 1):
        prev = lists[d - 1]
        pairs = [_pair_key(prev[2 * j][0], prev[2 * j + 1][0])
                 for j in range(len(prev) // 2)]
        merged = []
        i = j = 0
        while i < as_ or j < len(pairs):
            if j >= len(pairs) or (i < as_ and leaves[i] <= pairs[j]):
                merged.append((leaves[i], True))
                i += 1
            else:
                merged.append((pairs[j], False))
                j += 1
        lists[d] = merged

    depth = [0] * as_
    take = 2 * (as_ - 1)
    for d in range(h, 0, -1):
        if take <= 0:
            break
        take = min(take, len(lists[d]))
        pkgs = 0
        rank = 0
        for i in range(take):
            if lists[d][i][1]:
                depth[rank] += 1
                rank += 1
            else:
                pkgs += 1
        take = 2 * pkgs
    return depth


def assign_codes(freq: np.ndarray, alpha_size: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """Length-limited canonical codes + transmission cost.

    Searches heights 2..MAX_CODE_LENGTH for the cheapest delta-coded
    tree (spec quirks preserved: the search breaks at the first height
    whose solution doesn't use its full depth, and an immediately-broken
    search reports cost 2^32-1 with height MAX_CODE_LENGTH).
    Returns (lengths[MAX_ALPHA_SIZE+1], codes[...], cost_bits).
    """
    as_ = alpha_size
    leaves = _leaf_keys(freq, as_, clamp=False)
    lengths = np.zeros(MAX_ALPHA_SIZE + 1, dtype=np.uint8)

    best_cost = (1 << 64) - 1
    best_height = MAX_CODE_LENGTH
    for h in range(2, MAX_CODE_LENGTH + 1):
        if (1 << h) < as_:
            continue
        dbr = _pm_depths(leaves, as_, h)
        if dbr[0] != h:
            break  # solution shallower than its limit
        cost = 0
        for q in range(as_):
            lengths[MAX_ALPHA_SIZE - leaves[q][3]] = dbr[q]
            cost += leaves[q][0] * dbr[q]
        for sym in range(1, as_):
            cost += 2 * abs(int(lengths[sym - 1]) - int(lengths[sym]))
        cost += 5 + as_
        if cost < best_cost:
            best_cost = cost
            best_height = h

    dbr = _pm_depths(leaves, as_, best_height)
    cnt = [0] * (MAX_CODE_LENGTH + 2)
    for q in range(as_):
        lengths[MAX_ALPHA_SIZE - leaves[q][3]] = dbr[q]
        cnt[dbr[q]] += 1

    base_code = [0] * (MAX_CODE_LENGTH + 2)
    next_code = 0
    for d in range(1, best_height + 1):
        base_code[d] = next_code
        next_code = (next_code + cnt[d]) << 1
    assert next_code == (1 << (best_height + 1))

    codes = np.zeros(MAX_ALPHA_SIZE + 1, dtype=np.uint32)
    for sym in range(as_):
        d = int(lengths[sym])
        codes[sym] = base_code[d]
        base_code[d] += 1
    return lengths, codes, int(best_cost) & 0xFFFFFFFF


def generate_initial_trees(mtf_freq: np.ndarray, nm: int, nt: int
                           ) -> np.ndarray:
    """Initial equivalence-class split over frequency prefix sums.

    Class t spans [a, b): b extends while the remaining classes can
    still each get a nonzero symbol and the class holds under 1/m of
    the remaining mass (m = classes left, current included); a class
    that overshot the average by more than half its last symbol's
    frequency gives that symbol back.  Returns
    length[MAX_TREES][MAX_ALPHA_SIZE+1]: 0 inside the class, 1 outside.
    """
    length = np.ones((MAX_TREES, MAX_ALPHA_SIZE + 1), dtype=np.uint8)
    P = np.concatenate([[0], np.cumsum(mtf_freq, dtype=np.int64)])
    NZ = np.concatenate([[0], np.cumsum(mtf_freq > 0, dtype=np.int64)])
    nz_total = int(NZ[-1])
    nte = min(nt, nz_total)

    a = 0
    for m in range(nte, 0, -1):
        t = nte - m
        rem = nm - int(P[a])
        b = a + 1
        while nz_total - int(NZ[b]) > m - 1 and \
                (int(P[b]) - int(P[a])) * m < rem:
            b += 1
        c2 = int(P[b]) - int(P[a])
        f_last = int(mtf_freq[b - 1])
        if c2 > f_last and (2 * c2 - f_last) * m > 2 * rem:
            b -= 1
        length[t, a:b] = 0
        a = b
    return length


def num_trees_for(nm: int) -> int:
    """Tree-count thresholds (src/encode.c:1027-1031)."""
    return (6 if nm > 2400 else
            5 if nm > 1200 else
            4 if nm > 600 else
            3 if nm > 300 else
            2 if nm > 150 else 1)


class PrefixModel:
    """Result of generate_prefix_code: trees, selectors, cost."""

    def __init__(self):
        self.num_trees = 0
        self.num_selectors = 0  # may be bumped +1 for padding later
        self.selectors = None  # old tree ids, per real group
        self.selector_mtf = None  # MTF'd (new-id) selector values
        self.lengths = None  # [MAX_TREES][MAX_ALPHA_SIZE+1], by old id
        self.codes = None  # same indexing
        self.tmap_old2new = None
        self.tmap_new2old = None
        self.tree_pad = 0
        self.cost = 0  # bits for trees+codes (reference return value)


def generate_prefix_code(mtfv: np.ndarray, cluster_factor: int
                         ) -> PrefixModel:
    """EM tree clustering + code assignment (spec: encode.c:1005-1137).

    `mtfv` is the MTF value array ending in EOB."""
    nm = int(mtfv.size)
    as_ = int(mtfv[-1]) + 1
    ns = (nm + GROUP_SIZE - 1) // GROUP_SIZE
    nt = num_trees_for(nm)

    # Pad last group with the dummy symbol `as_`.
    padded = np.full(ns * GROUP_SIZE, as_, dtype=np.int64)
    padded[:nm] = mtfv
    groups = padded.reshape(ns, GROUP_SIZE)

    mtf_freq = np.bincount(mtfv.astype(np.int64), minlength=MAX_ALPHA_SIZE + 1)
    # NB: the EC clamp (nt = min(nt, #nonzero symbols)) is local to
    # generate_initial_trees; the EM loop keeps the threshold-based nt,
    # so never-assigned trees (all-ones lengths) still compete.
    lengths = generate_initial_trees(mtf_freq, nm, nt)

    freqs = np.zeros((MAX_TREES, MAX_ALPHA_SIZE + 1), dtype=np.int64)
    selectors = None

    for _ in range(cluster_factor):
        # Pack per-tree code lengths into 10-bit lanes of uint64 and
        # accumulate per group with uint64 wraparound: lane t of the
        # group sum is the tree-t group cost plus the carry chain from
        # lower lanes — part of the spec behavior.
        len_pack = np.zeros(as_ + 1, dtype=np.uint64)
        for t in range(MAX_TREES):
            len_pack[:as_] += (lengths[t, :as_].astype(np.uint64)
                               << np.uint64(10 * t))
        gvals = len_pack[groups]  # (ns, 50)
        gsums = gvals.sum(axis=1, dtype=np.uint64)
        lanes = np.stack([(gsums >> np.uint64(10 * t)) & np.uint64(0x3FF)
                          for t in range(nt)], axis=1)
        selectors = np.argmin(lanes, axis=1)  # first min wins, as spec

        freqs[:] = 0
        for t in range(nt):
            sel_groups = groups[selectors == t]
            if sel_groups.size:
                freqs[t] = np.bincount(sel_groups.ravel(),
                                       minlength=MAX_ALPHA_SIZE + 1)
        for t in range(nt):
            lengths[t] = make_code_lengths(freqs[t], as_)

    model = PrefixModel()
    model.num_selectors = ns
    model.selectors = selectors.astype(np.int64)

    # Reorder trees by first occurrence in the selector sequence; assign
    # final length-limited codes per used tree.
    cost = 0
    tmap_old2new = np.zeros(MAX_TREES, dtype=np.int64)
    tmap_new2old = np.zeros(MAX_TREES, dtype=np.int64)
    codes = np.zeros((MAX_TREES, MAX_ALPHA_SIZE + 1), dtype=np.uint32)
    not_seen = (1 << nt) - 1
    new_nt = 0
    for t in selectors.tolist():
        if not_seen == 0:
            break
        if not_seen & (1 << t):
            not_seen -= 1 << t
            tmap_old2new[t] = new_nt
            tmap_new2old[new_nt] = t
            new_nt += 1
            lt, ct, c = assign_codes(freqs[t], as_)
            lengths[t] = lt
            codes[t] = ct
            lengths[t][as_] = 0
            codes[t][as_] = 0
            cost += c

    assert new_nt >= 1
    if new_nt == 1:
        # bzip2 requires >= 2 trees: synthesize a dummy balanced tree
        # (spec: src/encode.c:1117-1132).
        new_nt = 2
        t = int(tmap_new2old[0]) ^ 1
        tmap_old2new[t] = 1
        tmap_new2old[1] = t
        cl0 = as_.bit_length() - 1  # floor(log2(as))
        v = 0
        nshort = (2 << cl0) - as_
        while v < nshort:
            lengths[t][v] = cl0
            v += 1
        if v < as_:
            cost += 2
        while v < as_:
            lengths[t][v] = cl0 + 1
            v += 1
        cost += as_ + 5

    model.num_trees = new_nt
    model.lengths = lengths
    model.codes = codes
    model.tmap_old2new = tmap_old2new
    model.tmap_new2old = tmap_new2old
    model.cost = cost
    return model
