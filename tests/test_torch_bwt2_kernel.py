"""The digit passes of lbzip2_tpu_torch/csrc/bwt2_sort.cu, row by row
in numpy, against the port's plain ``_pass8_plain`` and JAX's
``_pass8`` on the CPU (the seed's model is
tests/test_torch_bwt2_seed_runs.py).

The model follows the kernels' algorithm step by step: stable LSD radix
passes of 8-bit digits over the lanes < n, counted per (digit,
tile of 4096 lanes), scanned digit major, scattered in each tile warp
span (512 lanes) after warp span; the digits are those of the mapped
keys ``N + ISA[p + off_j]`` or ``N - 1 - p`` (off_j = min(j k, N)),
three a key; then class starts, the max-scan of start slots over tiles
of 256 lanes with carries, the unresolved count and the scatter
ISA[SA[t]] = rank.  The kernels define the ISA on lanes < n only, so
valid lanes and the counts are compared, exactly.  Rows come from
native.lyndon_prep at the 8192 bucket, B = 8, as in
tests/test_torch_bwt2.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native lyndon_prep")

N, B = 8192, 8
BITS, RADIX = 8, 256          # the kernels' digit
TILE, SPAN = 4096, 512        # a sort tile, a warp's span of it
WARPS = TILE // SPAN
RANK_TILE = 256               # lanes a block of the rank kernels
KEYS, KEY_DIGITS = 8, 3
INF, BIG = 2 ** 31 - 1, 1 << 30


# -- the kernels' algorithm -------------------------------------------------

def radix_pass(sa: np.ndarray, digits: np.ndarray) -> np.ndarray:
    """One digit pass over the lanes of sa: counts per (tile, warp span,
    digit), the digit-major exclusive scan over (digit, tile), the warp
    spans of a tile in order, lanes of a span in order."""
    n = sa.size
    lane = np.arange(n)
    tile, warp = lane // TILE, (lane % TILE) // SPAN
    T = max(1, -(-n // TILE))
    per_warp = np.zeros((T, WARPS, RADIX), np.int64)
    np.add.at(per_warp, (tile, warp, digits), 1)
    per_tile = per_warp.sum(1)                               # (T, RADIX)
    flat = per_tile.T.ravel()                                # digit major
    start = (np.cumsum(flat) - flat).reshape(RADIX, T)
    warp_base = np.cumsum(per_warp, 1) - per_warp            # earlier warps
    group = (tile * WARPS + warp) * RADIX + digits
    order = np.argsort(group, kind="stable")
    first = np.searchsorted(group[order], group[order])
    within = np.empty(n, np.int64)
    within[order] = np.arange(n) - first                     # ballot rank
    dest = start[digits, tile] + warp_base[tile, warp, digits] + within
    out = np.empty_like(sa)
    out[dest] = sa
    return out


def offsets(k: int, nkeys: int = KEYS) -> list:
    return [min(j * k, N) for j in range(nkeys)]


def pass_keys(isa: np.ndarray, n: int, p: np.ndarray, k: int,
              nkeys: int = KEYS, mapping: str = "suffix") -> np.ndarray:
    """(len(p), nkeys) mapped keys: N + ISA[p + off_j] inside the row,
    else N - 1 - p.  The rotation sort's: "cyclic", N + ISA at
    (p + (j k mod n)) mod n; "tie", N + ISA[p], then n - 1 - p."""
    if mapping == "cyclic":
        q = p[:, None] + np.array([(j * k) % max(n, 1)
                                   for j in range(nkeys)])
        return (N + isa[np.where(q >= n, q - n, q)]).astype(np.int64)
    if mapping == "tie":
        out = np.repeat((n - 1 - p)[:, None], nkeys, 1)
        out[:, 0] = N + isa[p]
        return out.astype(np.int64)
    q = p[:, None] + np.array(offsets(k, nkeys))
    inside = q < n
    return np.where(inside, N + isa[np.minimum(q, N - 1)],
                    N - 1 - p[:, None]).astype(np.int64)


def sort_lanes(n: int, digit_columns) -> np.ndarray:
    """The suffix array of [0, n) after the LSD passes; each item of
    digit_columns maps positions to one pass's digits, least significant
    first."""
    sa = np.arange(n, dtype=np.int64)
    for digit_of in digit_columns:
        sa = radix_pass(sa, digit_of(sa))
    return sa


def rank_step(sa, keys, n):
    """(isa (N,), cnt) from the sorted lanes and their key tuples."""
    isa = np.zeros(N, np.int64)
    if n == 0:
        return isa, 0
    start = np.ones(n, bool)
    start[1:] = (keys[1:] != keys[:-1]).any(1)
    slot = np.where(start, np.arange(n), -1)
    T2 = -(-n // RANK_TILE)
    pad = np.full(T2 * RANK_TILE, -1)
    pad[:n] = slot
    tiles = pad.reshape(T2, RANK_TILE)
    agg = tiles.max(1)
    carry = np.concatenate([[-1], np.maximum.accumulate(agg)[:-1]])
    rank = np.maximum(np.maximum.accumulate(tiles, 1),
                      carry[:, None]).ravel()[:n]
    end = np.ones(n, bool)
    end[:-1] = start[1:]
    open_ = ~(start & end)
    isa[sa] = rank
    return isa, int(open_.sum())


def model_pass8(isa: np.ndarray, k: int, n: int, nkeys: int = KEYS,
                mapping: str = "suffix"):
    """A pass as the digit passes run it: ``nkeys`` keys by
    ``mapping`` (``pass_keys``), three digits a key, keys last to
    first."""
    cols = [lambda sa, j=j, s=s: (pass_keys(isa, n, sa, k, nkeys,
                                            mapping)[:, j] >>
                                  (BITS * s)) & (RADIX - 1)
            for j in reversed(range(nkeys)) for s in range(KEY_DIGITS)]
    sa = sort_lanes(n, cols)
    return rank_step(sa, pass_keys(isa, n, sa, k, nkeys, mapping), n)


# -- inputs -----------------------------------------------------------------

def _blocks(kind, seed):
    """Eight rows of one kind, as tests/test_torch_bwt2.py makes them."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        sizes = (1, 2, 9, 100, 1000, 4096, 5000, 8192)
        return [rng.integers(0, 256, n, np.uint8) for n in sizes]
    if kind == "small_alpha":
        sizes = (50, 333, 2048, 6000, 8000, 7, 8191, 4000)
        return [rng.integers(97, 99, n, np.uint8) for n in sizes]
    if kind == "runs":
        out = []
        for n in (500, 201, 3000, 8192, 60, 7777, 1024, 4500):
            vals = rng.integers(0, 256, n // 3 + 1, np.uint8)
            b = np.repeat(vals, rng.integers(1, 9, vals.size))[:n].copy()
            b[-1] ^= 0x55  # keep primitive
            out.append(b)
        return out
    out = []  # deep repeats: long periodic stretches broken near the end
    for n, p in ((5120, 256), (8192, 1000), (6000, 7), (8000, 3),
                 (4096, 2048), (7000, 1), (8192, 4096), (3000, 33)):
        page = rng.integers(0, 256, p, np.uint8)
        b = np.tile(page, n // p + 1)[:n].copy()
        b[-1] ^= 1
        out.append(b)
    return out


def _batch(blocks):
    rot = np.zeros((B, N), np.uint8)
    ns = np.zeros(B, np.int32)
    for i, b in enumerate(blocks):
        if b.size:
            _, m = native.lyndon_prep(b, out=rot[i, :b.size])
            assert m >= 0, "periodic test block"
        ns[i] = b.size
    return rot, ns


def _valid(isa, ns):
    return [isa[r, :ns[r]] for r in range(isa.shape[0])]


def _assert_rows(want_isa, want_cnt, got_isa, got_cnt, ns, who):
    for r, (w, g) in enumerate(zip(_valid(want_isa, ns),
                                   _valid(got_isa, ns))):
        np.testing.assert_array_equal(g, w, f"{who}: row {r}")
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(want_cnt),
                                  f"{who}: counts")


KINDS = ["random", "small_alpha", "runs", "deep_repeats"]


# k = 16: the first pass; 5000: N < j k < 2N for j = 2 (the clamped
# start); 65536: k >= N for j = 1 and p + j k >= 2N for j >= 2 (patched)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [16, 5000, 65536])
def test_pass8_model(kind, k):
    rot, ns = _batch(_blocks(kind, 2))
    isa_j, _ = jbwt2.seed16(jnp.asarray(rot), jnp.asarray(ns))
    isa = np.asarray(isa_j)
    model = [model_pass8(isa[r].astype(np.int64), k, int(ns[r]))
             for r in range(B)]
    m_isa = np.stack([m[0] for m in model])
    m_cnt = np.array([m[1] for m in model], np.int32)
    p_isa, p_cnt = bwt2._pass8_plain(to_torch(isa), k, to_torch(ns))
    j_isa, j_cnt = jbwt2.pass8(isa_j, jnp.int32(k), jnp.asarray(ns))
    _assert_rows(to_numpy(p_isa), to_numpy(p_cnt), m_isa, m_cnt, ns,
                 "model vs plain")
    _assert_rows(np.asarray(j_isa), np.asarray(j_cnt), m_isa, m_cnt, ns,
                 "model vs JAX")


def raw_keys(isa: np.ndarray, k: int, n: int) -> np.ndarray:
    """(n, 8) int64 keys of the valid lanes as JAX's _passx reads them:
    the extended ISA at the clamped start, patched past 2N."""
    p = np.arange(n)
    ext = np.concatenate([np.where(np.arange(N) < n, isa,
                                   n - np.arange(N) - BIG),
                          n - (np.arange(N) + N) - BIG])
    cols = [isa[:n]]
    for j in range(1, KEYS):
        r = ext[p + min(j * k, N)]
        if j >= 2:
            far = p + j * k
            r = np.where(far < 2 * N, r, n - far - BIG)
        cols.append(r)
    return np.stack(cols, 1).astype(np.int64)


def test_mapped_keys_sort_as_raw_keys():
    """On rows of ranks with heavy ties, every k regime: the mapped keys
    order the lanes exactly as JAX's raw int32 keys do, tie for tie, and
    lie in [0, 2N)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 700, 4097, 8191, 8192):
        isa = np.zeros(N, np.int64)
        isa[:n] = rng.integers(0, max(1, n // 50), n)
        for k in (1, 16, 3000, 4096, 5000, 8192, 9000, 65536, 10 ** 6):
            raw = raw_keys(isa, k, n)
            mapped = pass_keys(isa, n, np.arange(n), k)
            assert mapped.min() >= 0 and mapped.max() < 2 * N
            o_raw = np.lexsort(raw.T[::-1])
            o_map = np.lexsort(mapped.T[::-1])
            np.testing.assert_array_equal(o_map, o_raw, f"n={n} k={k}")
            tie_raw = (raw[o_raw][1:] == raw[o_raw][:-1]).all(1)
            tie_map = (mapped[o_map][1:] == mapped[o_map][:-1]).all(1)
            np.testing.assert_array_equal(tie_map, tie_raw)


def test_radix_pass_is_a_stable_counting_sort():
    """The tile rule (digit-major scan over tiles, warp spans in order)
    gives the stable sort by digit, at lengths across tile edges."""
    rng = np.random.default_rng(4)
    for n in (1, 511, 512, 4095, 4096, 4097, 12289):
        for alphabet in (1, 3, 256):
            sa = rng.permutation(n)
            digits = rng.integers(0, alphabet, n)
            got = radix_pass(sa, digits)
            np.testing.assert_array_equal(
                got, sa[np.argsort(digits, kind="stable")])


def test_model_resolve_loop_and_identity_pass():
    """The model's passes from JAX's seed to resolution (and one pass past
    it, which must give back its input) equal JAX's resolved ISA on every
    valid lane."""
    rot, ns = _batch(_blocks("deep_repeats", 5))
    want = np.asarray(jbwt2._resolve_loop(jnp.asarray(rot), jnp.asarray(ns)))
    seed_isa, seed_cnt = jbwt2.seed16(jnp.asarray(rot), jnp.asarray(ns))
    for r in range(B):
        n = int(ns[r])
        isa = np.asarray(seed_isa[r]).astype(np.int64)
        cnt = int(seed_cnt[r])
        k, passes = 16, 0
        while cnt:
            isa, cnt = model_pass8(isa, k, n)
            k, passes = k * 8, passes + 1
        again, cnt2 = model_pass8(isa, k, n)
        assert cnt2 == 0
        np.testing.assert_array_equal(again[:n], isa[:n])
        np.testing.assert_array_equal(isa[:n], want[r, :n], f"row {r}")
        assert passes >= 1
