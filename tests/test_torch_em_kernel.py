"""The EM loop's CUDA kernels (lbzip2_tpu_torch/csrc/em_chain.cu and
code_lengths.cuh) as a row-wise numpy model, held against the plain
PyTorch loop and against the JAX package's em_chain.

A CUDA kernel runs only on a card, where chip_smoke.py holds it against
the plain version.  What can be checked on the CPU is the algorithm the
kernels are written to: the E-step as wrapping sums of packed 10-bit
lanes over a group's 50 symbols, one selector for the groups past a
row's last, the control words in device memory, and the warp M-step
(the bitonic network's index rule, the two-queue merge with a largest
key past each queue's end and its refill read ahead of the pick, the
depths by pointer jumping, the rank profile from suffix counts).
The model below follows the kernels statement by statement; inputs are
made with numpy from seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu.ops import huffenc as jhuff
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import huffenc
from lbzip2_tpu_torch.ref.huffman import (generate_initial_trees,
                                          num_trees_for)

W = 259
NLEAF = 258
M32 = 0xFFFFFFFF
INF = 0x7FFFFFFF
INF_NODE = (INF << 32) | INF
NP = 8193  # the 8192 bucket's row of symbols: 164 groups
G = (NP + 49) // 50


# --- the model -------------------------------------------------------------

def model_warp_sort(key: np.ndarray) -> np.ndarray:
    """warp_sort<K>: the bitonic network over 32 * K slots, slot i in
    register i % K of lane i // K.  Whether a slot's partner lies in
    another lane or in the same one, slot i takes the smaller of the
    pair when (i & j == 0) == (i & k == 0), else the larger."""
    n = key.size
    i = np.arange(n)
    key = key.copy()
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            other = key[i ^ j]
            small = ((i & j) == 0) == ((i & k) == 0)
            key = np.where(small, np.minimum(key, other),
                           np.maximum(key, other))
            j >>= 1
        k <<= 1
    return key


def model_code_lengths_tree(f_row: np.ndarray, as_: int) -> np.ndarray:
    """code_lengths_tree: one tree by one warp."""
    as_ = min(max(int(as_), 0), NLEAF)
    K = 4 if as_ <= 128 else 8 if as_ <= 256 else 16
    key = np.full(32 * K, INF, np.int64)
    for lane in range(32):  # symbol lane + 32 r starts in register r
        for r in range(min(K, 9)):
            i = lane + 32 * r
            if i < as_:
                key[lane * K + r] = (max(int(f_row[i]), 1) << 9) | \
                    (NLEAF - i)
    key = model_warp_sort(key)
    leaf = [INF_NODE] * 264
    for i in range(min(32 * K, 264)):
        if key[i] != INF:
            leaf[i] = ((int(key[i]) >> 9) << 32) | (1 << 9) | \
                (int(key[i]) & 511)
    merge = [INF_NODE] * 260
    parent = [None] * 516  # a read before a write would raise below
    nmerge = max(as_ - 1, 0)
    li = ii = 0
    L0, L1, I0, I1 = leaf[0], leaf[1], INF_NODE, INF_NODE
    for m in range(nmerge):
        # the refill is read before the pick is known: two leaves and two
        # merges past the heads (a merge not made yet reads as largest)
        X2, X3, Y2, Y3 = leaf[li + 2], leaf[li + 3], merge[ii + 2], \
            merge[ii + 3]
        pick_ii = I1 < L0
        pick_ll = not pick_ii and not I0 < L1
        a = L0 if pick_ll else I0
        b = I1 if pick_ii else L1 if pick_ll else L0
        c0 = li if pick_ll else NLEAF + ii
        c1 = NLEAF + ii + 1 if pick_ii else li + 1 if pick_ll else li
        t0, t1 = a & M32, b & M32
        f = ((a >> 32) + (b >> 32)) & M32
        height = max(t0 >> 17, t1 >> 17) + 1
        nl = (((t0 >> 9) & 255) + ((t1 >> 9) & 255)) & 255
        made = (f << 32) | (height << 17) | (nl << 9) | (leaf[m] & 511)
        merge[m] = made
        parent[c0] = parent[c1] = NLEAF + m
        dl = 0 if pick_ii else 2 if pick_ll else 1
        di = 2 - dl
        # the merge just made is the queue's entry m, wherever that falls
        v = [made if ii + k == m else old
             for k, old in enumerate((I0, I1, Y2, Y3))]
        L0, L1 = (L0, L1, X2, X3)[dl:dl + 2]
        I0, I1 = v[di:di + 2]
        li += dl
        ii += di
    # depths by pointer jumping over the as leaves and as - 1 merges: each
    # round doubles the distance every node has summed towards the root
    ids = list(range(as_)) + [NLEAF + j for j in range(nmerge)]
    dist = {i: 1 for i in ids}
    if ids:
        root = NLEAF + nmerge - 1 if nmerge else 0
        parent[root], dist[root] = root, 0
    par = {i: parent[i] for i in ids}
    k = 0
    while (1 << k) < nmerge:
        dist, par = ({i: dist[i] + dist[par[i]] for i in ids},
                     {i: par[par[i]] for i in ids})
        k += 1
    assert all(par[i] == par[ids[-1]] for i in ids)  # every node at the root
    cnt = [0] * 32
    for r in range(as_):
        cnt[min(dist[r], 30)] += 1
    # rank r takes the largest depth d whose suffix count S[d] exceeds r
    S = [sum(cnt[d:]) for d in range(32)]
    out = np.zeros(W, np.int32)
    for r in range(as_):
        d = 0
        for e in range(1, 31):
            if S[e] > r:
                d = e
        out[NLEAF - (leaf[r] & 511)] = d
    out[NLEAF] = 0
    return out


def _pack3(lengths3: np.ndarray) -> np.ndarray:
    L = lengths3.astype(np.uint64)
    return (L[0] + (L[1] << 10) + (L[2] << 20)) & M32


def _select_tree(glo, ghi, nt: int):
    """select_tree, over arrays of groups."""
    glo = np.asarray(glo, np.uint64)
    ghi = (np.asarray(ghi, np.uint64) + (glo >> 30)) & M32
    best = np.full(glo.shape, 0x400, np.int64)
    bt = np.zeros(glo.shape, np.int32)
    for t in range(6):
        c = (((glo if t < 3 else ghi) >> (10 * (t % 3))) & 0x3FF).astype(
            np.int64)
        better = (c < best) | (t == 0) if t < nt else np.zeros_like(c, bool)
        best = np.where(better, c, best)
        bt = np.where(better, t, bt)
    return bt


def model_estep_row(row, nm, ninuse, nt, lengths):
    """em_estep for one row: (selectors (G,), freqs (6, W))."""
    np_ = row.size
    g_all = (np_ + 49) // 50
    dummy = min(max(int(ninuse) + 2, 0), W - 1)
    nm = min(max(int(nm), 0), np_)
    ngroups = (nm + 49) // 50
    lo, hi = _pack3(lengths[:3]), _pack3(lengths[3:])
    sym = np.full(ngroups * 50, dummy, np.int64)
    sym[:nm] = np.clip(row[:nm], 0, W - 1)
    sym = sym.reshape(ngroups, 50)
    glo = lo[sym].sum(1) & M32  # the warp's wrapping 32-bit sum
    ghi = hi[sym].sum(1) & M32
    sel = np.empty(g_all, np.int32)
    sel[:ngroups] = _select_tree(glo, ghi, int(nt))
    sel[ngroups:] = _select_tree((50 * lo[dummy]) & M32,
                                 (50 * hi[dummy]) & M32, int(nt))
    freqs = np.zeros((6, W), np.int32)
    np.add.at(freqs, (np.repeat(sel[:ngroups], 50), sym.reshape(-1)), 1)
    return sel, freqs


def model_em_loop(mtfv, nm, ninuse, nt, lengths0, cf, trace=None):
    """lbz2t_em_chain: cf rounds of em_estep and em_mstep over the control
    words ctl[0] done, ctl[1] iterations, ctl[2 + it] changed."""
    B = mtfv.shape[0]
    ctl = np.zeros(2 + cf, np.int32)
    lengths = lengths0.astype(np.int32).copy()
    sel = np.full((B, (mtfv.shape[1] + 49) // 50), -1, np.int32)
    freqs = np.zeros((B, 6, W), np.int32)
    for it in range(cf):
        if not ctl[0]:  # em_estep
            ctl[1] = it + 1
            moved = []
            for b in range(B):
                s, f = model_estep_row(mtfv[b], nm[b], ninuse[b], nt[b],
                                       lengths[b])
                moved.append(bool(it > 0 and (s != sel[b]).any()))
                sel[b] = s
                freqs[b] += f
            ctl[2 + it] |= int(any(moved))
            if trace is not None:
                trace.append(moved)
        if it + 1 < cf and not ctl[0]:  # em_mstep
            if it > 0 and ctl[2 + it] == 0:
                ctl[0] = 1
                continue
            for b in range(B):
                for t in range(int(nt[b])):
                    lengths[b, t] = model_code_lengths_tree(
                        freqs[b, t], ninuse[b] + 2)
            freqs[:] = 0
    return sel, freqs, lengths, np.int32(ctl[1])


# --- inputs ----------------------------------------------------------------

def _rows(specs, seed):
    """specs: (nm, ninuse, skew) a row -> mtfv (B, NP), nm, ninuse.  A row
    is nm - 1 symbols below ninuse + 1 and the end-of-block symbol; skew
    picks a Zipf-like distribution (text after MTF) or a uniform one."""
    rng = np.random.default_rng(seed)
    B = len(specs)
    mtfv = np.zeros((B, NP), np.int32)
    nm = np.array([s[0] for s in specs], np.int32)
    ninuse = np.array([s[1] for s in specs], np.int32)
    for b, (n, nu, skew) in enumerate(specs):
        if nu and n > 1:
            p = 1.0 / np.arange(1, nu + 2) ** skew
            mtfv[b, :n - 1] = rng.choice(nu + 1, n - 1, p=p / p.sum())
        mtfv[b, n - 1] = nu + 1
    return mtfv, nm, ninuse


def _initial_trees(mtfv, nm, ninuse):
    """What chain_payloads feeds the loop: nt and the initial trees from
    the flat histogram, lanes at and past `as` zero."""
    B = mtfv.shape[0]
    nt = np.array([num_trees_for(int(v)) for v in nm], np.int32)
    lengths = np.ones((B, 6, W), np.int32)
    for b in range(B):
        hist = np.bincount(mtfv[b, :nm[b]], minlength=W).astype(np.int64)
        lengths[b] = generate_initial_trees(hist, int(nm[b]), int(nt[b]))
        lengths[b, :, ninuse[b] + 2:] = 0
    return nt, lengths


TEXT8 = [(8193, 70, 1.3), (8000, 90, 1.1), (6100, 40, 1.5), (8193, 120, 0.9),
         (2500, 60, 1.2), (7777, 30, 2.0), (4000, 200, 0.7), (8100, 10, 1.0)]
# 1 to 6 trees: a tree more past 150, 300, 600, 1200 and 2400 symbols
TREES = [(100, 20, 1.0), (151, 30, 1.0), (301, 40, 1.2), (601, 50, 1.1),
         (1201, 60, 1.3), (2401, 5, 1.0), (150, 250, 0.6), (2400, 250, 0.6)]
# rows of a few symbols settle at once; the long skewed row keeps moving
SETTLING = [(30, 3, 1.0), (8193, 180, 0.8), (51, 2, 1.0), (120, 4, 1.0),
            (49, 1, 1.0), (8193, 150, 1.0), (200, 6, 1.0), (1, 0, 1.0)]
EDGES = [(1, 0, 1.0), (2, 0, 1.0), (8193, 256, 0.3), (8193, 256, 0.0),
         (50, 7, 1.0), (51, 7, 1.0), (8150, 256, 0.2), (100, 0, 1.0)]

CASES = {
    "text_8_rows": (TEXT8, 8, "trees"),
    "rows_1": (TEXT8[:1], 8, "trees"),
    "rows_3": (TEXT8[1:4], 8, "trees"),
    "rows_5": (TEXT8[3:], 8, "trees"),
    "nt_1_to_6": (TREES, 8, "trees"),
    "one_row_still_changing": (SETTLING, 8, "trees"),
    "cluster_factor_1": (TEXT8, 1, "trees"),
    "cluster_factor_2": (TEXT8, 2, "trees"),
    "one_group_rows": ([(50, 9, 1.0), (7, 3, 1.0), (1, 0, 1.0)], 8, "trees"),
    "lengths_to_30_costs_past_1023": (TEXT8, 8, "random30"),
    "as_2_and_258": (EDGES, 8, "trees"),
    "as_2_and_258_lengths_to_30": (EDGES, 8, "random30"),
}


def _case(name):
    specs, cf, how = CASES[name]
    mtfv, nm, ninuse = _rows(specs, seed=len(name))
    nt, lengths = _initial_trees(mtfv, nm, ninuse)
    if how == "random30":  # the dummy's lane and the dead trees too
        rng = np.random.default_rng(5)
        lengths = rng.integers(1, 31, lengths.shape).astype(np.int32)
    return mtfv, nm, ninuse, nt, lengths, cf


@pytest.mark.parametrize("name", list(CASES))
def test_model_equals_plain_loop_and_jax(name):
    mtfv, nm, ninuse, nt, lengths0, cf = _case(name)
    trace = []
    want = model_em_loop(mtfv, nm, ninuse, nt, lengths0, cf, trace)
    got = huffenc.em_chain_rows(*(to_torch(a) for a in (
        mtfv, nm, ninuse, nt, lengths0)), cf)
    for g, w in zip(got, want):  # sel (all G), freqs, lengths, iters
        np.testing.assert_array_equal(to_numpy(g), w)
    hist_g, _, ngroups = jchain.group_hist(
        jnp.asarray(mtfv), jnp.asarray(nm), jnp.asarray(ninuse))
    ref = jhuff.em_chain(hist_g, ngroups, jnp.asarray(nt),
                         jnp.asarray(ninuse + 2), jnp.asarray(lengths0), cf)
    for r, w in zip(ref, want):
        np.testing.assert_array_equal(np.asarray(r), w)
    assert want[0].shape == (mtfv.shape[0], G)
    if name == "one_row_still_changing":
        # an iteration in which some rows repeat their selectors while
        # another row's still move: the loop must go on for the batch
        assert any(any(m) and not all(m) for m in trace[1:]), trace
        assert want[3] > 2
    if name == "lengths_to_30_costs_past_1023":
        sym = np.clip(mtfv[0, :8150], 0, W - 1).reshape(-1, 50)
        cost = lengths0[0][:, sym].sum(2)  # (6, groups), exact
        assert cost.max() > 1023  # a 10-bit lane overflows
        assert ((_pack3(lengths0[0, :3])[sym].sum(1) & M32) >> 30).any(), \
            "lane 2 never carries into the high word"
    if name == "nt_1_to_6":
        assert sorted(set(nt)) == [1, 2, 3, 4, 5, 6]
    if name.startswith("as_2_and_258"):
        assert set(ninuse + 2) >= {2, 258}


@pytest.mark.parametrize("k", [4, 8, 16])
def test_model_sort_network_sorts(k):
    """The index rule of warp_sort orders 32 * K keys, ties and the
    largest key included."""
    rng = np.random.default_rng(k)
    for hi in (3, 1 << 30):
        key = rng.integers(0, hi, 32 * k).astype(np.int64)
        key[rng.integers(0, 32 * k, 5)] = INF
        np.testing.assert_array_equal(model_warp_sort(key), np.sort(key))


@pytest.mark.parametrize("trial", ["ties", "spread", "edges", "fibonacci"])
def test_model_tree_equals_plain_code_lengths(trial):
    """The warp M-step alone against the plain version, on alphabets of
    every sort width and the deepest trees (the clamp at 30)."""
    rng = np.random.default_rng(3)
    if trial == "fibonacci":
        fib = [1, 1]
        while fib[-1] + fib[-2] < 2 ** 22:
            fib.append(fib[-1] + fib[-2])
        freqs = np.ones((3, W), np.int32)
        freqs[0, :len(fib)] = fib
        freqs[1, :len(fib)] = fib[::-1]
        freqs[2, 100:100 + len(fib)] = fib
        as_arr = np.array([len(fib), 258, 258], np.int32)
    else:
        as_arr = np.array([0, 1, 2, 3, 4, 127, 128, 129, 255, 256, 257, 258],
                          np.int32)
        hi = {"ties": 3, "spread": 900000, "edges": 1}[trial]
        freqs = rng.integers(0, hi, (as_arr.size, W)).astype(np.int32)
    want = to_numpy(huffenc.make_code_lengths_rows(to_torch(freqs),
                                                   to_torch(as_arr)))
    got = np.stack([model_code_lengths_tree(f, a)
                    for f, a in zip(freqs, as_arr)])
    np.testing.assert_array_equal(got, want)
    assert trial != "fibonacci" or got.max() == 30


def test_wrapper_refuses_other_devices_and_bad_inputs():
    """CPU tensors take the plain loop; a CUDA tensor would launch the
    kernels; anything else raises (nothing falls back silently)."""
    import torch

    mtfv, nm, ninuse, nt, lengths0, cf = _case("rows_1")
    args = [to_torch(a) for a in (mtfv, nm, ninuse, nt, lengths0)]
    with pytest.raises(ValueError, match="unsupported device"):
        huffenc.em_chain_rows(*(a.to("meta") for a in args), cf)
    with pytest.raises(ValueError, match="one CUDA device"):
        huffenc.em_chain_cuda(*args, cf)
    assert isinstance(huffenc.em_launches, int)
    assert torch.equal(huffenc.em_chain_rows(*args, 1)[3],
                       torch.tensor(1, dtype=torch.int32))
