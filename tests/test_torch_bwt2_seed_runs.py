"""The seed of lbzip2_tpu_torch/csrc/bwt2_sort.cu, row by row in numpy,
against the port's plain ``_seed16_plain`` and JAX's ``_seed16`` on the
CPU.

The model follows the kernels step by step: stage 1 sorts the pairs
(W0, p) of the lanes < n by W0's four 8-bit digits, stably, the word
moving with the lane (W0 the big-endian bytes p .. p + 3, 0 at or past
n); run starts where adjacent words differ and each lane's run start
by a max-scan; a run of one lane takes its slot as its rank; every
other lane gathers W1..W3 into its slot; each run goes to its route by
its size with the pass's bins: up to SEG_SMALL lanes a thread a lane
(the run's first slot plus the lanes with smaller words), up to the
last block capacity a block a run (its slots sorted by the words, the
max-scan of the starts), larger runs to region L, placed there in any
order (the kernels take each run's place and index from one atomic),
sorted by W3, W2, W1 and last the run's index (one digit, or two where
a row may hold more than 256 such runs), the words moving with the
lane, ranked by their classes of equal (run, W1, W2, W3); last the
pad-key rule on the run of W0 = FF FF FF FF alone.  The kernels define
the ISA on lanes < n only, so valid lanes and the counts are compared,
exactly.  Rows come from native.lyndon_prep at the 8192 bucket, B = 8,
as in tests/test_torch_bwt2_kernel.py.
"""

import pathlib
import re

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
BITS, RADIX = 8, 256
FF = 0xFFFFFFFF
BINS = (bwt2.SEG_SMALL, bwt2.SEG_BLOCKS)
TINY = (2, (4, 8, 16))  # every route, region L with two run digits
ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "lbzip2_tpu_torch" / "csrc" / "bwt2_sort.cu"


# -- the kernels' algorithm -------------------------------------------------

def words(row, n, p, cyclic=False):
    """(len(p), 4) uint64: W0..W3 of positions p, bytes at or past n 0
    (``cyclic``, the rotation sort's seed: bytes (p + d) mod n)."""
    q = np.asarray(p, np.int64)[:, None] + np.arange(16)
    if cyclic:
        b = row[q % max(n, 1)].astype(np.uint64)
    else:
        b = np.where(q < n, row[np.minimum(q, N - 1)], 0).astype(np.uint64)
    b = b.reshape(-1, 4, 4)
    return (b[:, :, 0] << 24) | (b[:, :, 1] << 16) | (b[:, :, 2] << 8) | \
        b[:, :, 3]


def digit_pass(digit, *carried):
    """One stable digit pass: every carried column moves with its lane."""
    order = np.argsort(digit, kind="stable")
    return [c[order] for c in carried]


def run_digits(large):
    """The digits of a round's run index: a row holds at most
    N // (large + 1) runs above ``large`` lanes."""
    return 1 if N // (large + 1) <= RADIX else 2


def starts_of(keys):
    st = np.ones(len(keys), bool)
    st[1:] = (keys[1:] != keys[:-1]).any(1)
    return st


def emit(row, n, r, slots, ps, keys_by_slot, isa, large, binned, routes,
         cyclic=False):
    """Round r's runs, as its lanes stand in sorted order at ``slots``
    (consecutive row slots) with positions ``ps``, given their run
    starts: a lone lane's rank is its slot; the others gather
    W_{r+1}..W3 into planes r..2 of their slots (planes below r, equal
    in the run, read 0); each run goes to a bin by its size or, above
    the last block capacity, to the next round."""
    def route(starts):
        first = np.maximum.accumulate(np.where(starts, np.arange(len(ps)),
                                               0))
        end = np.append(starts[1:], True)
        lone = starts & end
        isa[ps[lone]] = slots[lone]
        tied = ~lone
        w = words(row, n, ps[tied], cyclic)[:, 1:]
        w[:, :r] = 0
        keys_by_slot[slots[tied]] = w
        out = []
        for f, t in zip(first[end & tied].tolist(), np.flatnonzero(
                end & tied).tolist()):
            c = t - f + 1
            if c > large:
                out.append((int(slots[f]), c))
            else:
                binned.append((int(slots[f]), c))
            if routes is not None:
                name = "round" if c > large else "bins"
                routes[name] = routes.get(name, 0) + 1
        return out
    return route


def model_seed(row, n, bins=BINS, rng=None, routes=None, cyclic=False):
    """One row's seed: (ISA (N,) int64, 0 past n; cnt).  ``rng`` lists
    each round's runs in a random order (the kernels take their places
    from an atomic); ``routes`` counts the runs each route took.
    ``cyclic``: the rotation sort's seed, words gathered mod n, and the
    pads' key sixteen FF bytes (a lone valid lane of that key counts as
    unresolved when the row has pads; no rank moves)."""
    small, caps = bins
    large = caps[-1]
    isa = np.zeros(N, np.int64)
    if n == 0:
        return isa, 0
    # round 0: (W0, p) by W0's digits, the key carried; its runs
    w0, pos = words(row, n, np.arange(n), cyclic)[:, 0], np.arange(n)
    for d in range(4):
        w0, pos = digit_pass((w0 >> (BITS * d)) & 255, w0, pos)
    slot = np.arange(n)
    keys = np.zeros((n, 3), np.uint64)  # W1..W3 planes, by slot
    binned, cnt = [], 0
    start = np.ones(n, bool)
    start[1:] = w0[1:] != w0[:-1]
    level = emit(row, n, 0, slot, pos, keys, isa, large, binned,
                 routes, cyclic)(start)
    # rounds 1 to 3: the runs above `large` by (run index, W_r)
    for r in (1, 2, 3):
        if not level:
            break
        order = range(len(level)) if rng is None else \
            rng.permutation(len(level))
        runs = [level[i] for i in order]
        at = np.cumsum([0] + [c for _, c in runs])
        t = np.concatenate([f + np.arange(c) for f, c in runs])
        seg = np.concatenate([np.full(c, s) for s, (_, c) in
                              enumerate(runs)])
        lpos = pos[t].copy()
        w, u = keys[t, r - 1].copy(), np.arange(len(t))
        for d in range(4):
            w, u = digit_pass((w >> np.uint64(BITS * d)) & 255, w, u)
        for d in range(run_digits(large)):
            w, u = digit_pass((seg[u] >> (BITS * d)) & 255, w, u)
        s_u = seg[u]
        st = starts_of(np.column_stack([s_u.astype(np.uint64), w]))
        delta = np.array([f for f, _ in runs])[s_u] - at[:-1][s_u]
        new_slot = np.arange(len(u)) + delta
        pos[new_slot] = lpos[u]
        if r == 3:  # equal in all 16 bytes: a class each
            first = np.maximum.accumulate(np.where(st, np.arange(len(u)),
                                                   0))
            isa[lpos[u]] = first + delta
            cnt += int((~(st & np.append(st[1:], True))).sum())
            level = []
        else:
            level = emit(row, n, r, new_slot, lpos[u], keys, isa, large,
                         binned, routes, cyclic)(st)
    # the bins, by W1..W3 of their slots
    for f, c in binned:
        kk = keys[f:f + c]
        if c <= small:  # a thread a lane: count smaller and equal words
            lt = np.zeros((c, c), bool)
            eq = np.ones((c, c), bool)
            for j in range(3):  # lexicographic, word by word
                a, o = kk[:, j][:, None], kk[:, j][None, :]
                lt |= eq & (o < a)
                eq &= o == a
            isa[pos[f:f + c]] = f + lt.sum(1)
            cnt += int((eq.sum(1) > 1).sum())
            route = "small"
        else:  # a block: sort the slots, max-scan the starts
            srt = np.lexsort(kk.T[::-1])
            st = starts_of(kk[srt])
            isa[pos[f + srt]] = f + np.maximum.accumulate(
                np.where(st, np.arange(c), 0))
            cnt += int((~(st & np.append(st[1:], True))).sum())
            route = next(f"block_{cap}" for cap in caps if c <= cap)
        if routes is not None:
            routes[route] = routes.get(route, 0) + 1
    if n < N and cyclic:  # the pads' key: sixteen FF bytes
        ff = slot[w0 == FF]
        allff = (words(row, n, pos[ff], True)[:, 1:] == FF).all(1)
        cnt += int(allff.sum() == 1)
    elif n < N:  # the pads' key FF FF FF FF 0..: the run of W0 = FF alone
        ff = slot[w0 == FF]
        if ff.size:
            rest = words(row, n, pos[ff])[:, 1:].any(1)  # gathered again
            isa[pos[ff[rest]]] += N - n
            cnt += int((~rest).sum() == 1)
    return isa, cnt


# -- inputs -----------------------------------------------------------------

def _repo_text():
    parts = sorted((ROOT / "lbzip2_tpu_torch").rglob("*.py")) + \
        sorted((ROOT / "lbzip2_tpu_torch" / "csrc").glob("*.cu"))
    return np.frombuffer(b"".join(p.read_bytes() for p in parts), np.uint8)


def _f8_row(n=6000, seed=1):
    """16 values, FF FF FF FF 01 first, 00 00 at 1000: the seed leaves no
    tie and ranks the first suffix past the pads (ROADMAP F8)."""
    b = np.random.default_rng(seed).integers(0x40, 0x50, n).astype(np.uint8)
    b[:4] = 0xFF
    b[4] = 1
    b[1000:1002] = 0
    return b


def _blocks(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "text":
        text = _repo_text()
        sizes = (8192, 8000, 5000, 100, 8191, 3000, 1, 2)
        at = rng.integers(0, text.size - 8192, len(sizes))
        return [text[a:a + n].copy() for a, n in zip(at, sizes)]
    if kind == "random":
        sizes = (1, 2, 9, 100, 1000, 4096, 5000, 8192)
        return [rng.integers(0, 256, n, np.uint8) for n in sizes]
    if kind == "two_values":  # 4-byte words tie by the thousand
        sizes = (50, 333, 2048, 6000, 8000, 7, 8191, 4000)
        return [rng.integers(97, 99, n, np.uint8) for n in sizes]
    if kind == "pad_key":
        # FF FF FF FF then a nonzero byte (K > P) or at the row's end
        # (K = P, a tie with the pads), with and without pads; F8's row;
        # a run of FF words above the block bins (K > P and K = P lanes)
        out = [_f8_row()]
        for n, at in ((5000, 100), (4096, "end"), (8192, "end"),
                      (300, "end"), (2, None), (0, None)):
            b = rng.integers(1, 256, n, np.uint8)
            b[:3] = 0
            if at == "end":
                b[-4:] = 0xFF
            elif at is not None:
                b[at:at + 4] = 0xFF
            out.append(b)
        b = np.full(7000, 0xFF, np.uint8)
        b[:2] = 0
        b[3000::97] = 0x10
        out.append(b)
        return out
    if kind == "edges":  # n = 0, 1, 2 and N; a lone K = P lane at n = N
        b = rng.integers(0, 256, N, np.uint8)
        full_ff = rng.integers(1, 256, N, np.uint8)
        full_ff[:3] = 0
        full_ff[-4:] = 0xFF
        return [np.zeros(0, np.uint8), rng.integers(0, 256, 1, np.uint8),
                rng.integers(0, 256, 2, np.uint8), b, full_ff,
                rng.integers(0, 2, 4097, np.uint8),
                rng.integers(0, 256, 3, np.uint8), b[:4096].copy()]
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


def _assert_rows(want_isa, want_cnt, got_isa, got_cnt, ns, who):
    for r in range(B):
        np.testing.assert_array_equal(got_isa[r, :ns[r]],
                                      want_isa[r, :ns[r]], f"{who}: row {r}")
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(want_cnt),
                                  f"{who}: counts")


def _model(rot, ns, bins=BINS, rng=None, routes=None):
    out = [model_seed(rot[r], int(ns[r]), bins, rng, routes)
           for r in range(B)]
    return np.stack([o[0] for o in out]), np.array([o[1] for o in out])


KINDS = ["text", "random", "two_values", "deep_repeats", "pad_key", "edges"]


@pytest.mark.parametrize("bins", [BINS, TINY], ids=["bins", "tiny_bins"])
@pytest.mark.parametrize("kind", KINDS)
def test_seed_model(kind, bins):
    """The model's ISA on lanes < n and its counts equal the plain seed's
    and JAX's, with the kernel's bins and with bins of 2, 4, 8 and 16
    lanes (which send most runs to the block bins and region L); the
    ISA is 0 past n."""
    rot, ns = _batch(_blocks(kind, 1))
    routes = {}
    m_isa, m_cnt = _model(rot, ns, bins, routes=routes)
    p_isa, p_cnt = bwt2._seed16_plain(to_torch(rot), to_torch(ns))
    j_isa, j_cnt = jbwt2.seed16(jnp.asarray(rot), jnp.asarray(ns))
    _assert_rows(to_numpy(p_isa), to_numpy(p_cnt), m_isa, m_cnt, ns,
                 "model vs plain")
    _assert_rows(np.asarray(j_isa), np.asarray(j_cnt), m_isa, m_cnt, ns,
                 "model vs JAX")
    for r in range(B):
        assert not m_isa[r, ns[r]:].any()
    if bins == TINY and kind == "text":  # every route
        assert {"small", "block_4", "block_8", "block_16",
                "round"} <= set(routes), routes
    if bins == TINY and kind in ("deep_repeats", "pad_key"):
        assert routes.get("round"), routes
    if kind == "deep_repeats" and bins == BINS:  # a run above 4096 lanes
        assert routes.get("round"), routes


def test_round_order_does_not_matter():
    """A round's runs take their places and indices from an atomic: any
    order of the runs gives the same ISA and counts."""
    for kind, bins in (("deep_repeats", BINS), ("text", TINY),
                       ("pad_key", TINY)):
        rot, ns = _batch(_blocks(kind, 4))
        want = _model(rot, ns, bins)
        for s in range(3):
            got = _model(rot, ns, bins, np.random.default_rng(s))
            _assert_rows(*want, *got, ns, f"{kind}, order {s}")


def test_pad_key_lanes_lie_in_the_ff_run():
    """Every lane whose 16-byte key is at least the pads' key P = FF FF FF
    FF 00 .. 00 has W0 = FF FF FF FF, and those runs end the sorted
    order: the pad-key rule needs no lane outside the last run."""
    rot, ns = _batch(_blocks("pad_key", 2))
    pad = np.array([FF, 0, 0, 0], np.uint64)
    for r in range(B):
        n = int(ns[r])
        w = words(rot[r], n, np.arange(n))
        at_least = np.array([tuple(x) >= tuple(pad) for x in w], bool)
        np.testing.assert_array_equal(at_least, w[:, 0] == FF)
        order = np.argsort(w[:, 0], kind="stable")
        assert (w[order, 0] == FF).sum() == at_least.sum()
        if at_least.any():
            assert (w[order, 0][-at_least.sum():] == FF).all()


def test_bins_and_routes_match_the_kernel_source():
    """The bins are the kernel's kSmall and kBinCap0..2; a run is routed as
    the model routes it (block_bin up to kLarge, the next round above);
    each of rounds 1 to 3 sorts by one word's four digits and the run
    digits the model takes, and the run index fits them at every width
    the kernels take."""
    src = SRC.read_text()
    small = int(re.search(r"constexpr int kSmall = (\d+);", src).group(1))
    caps = re.search(r"constexpr int kBinCap0 = (\d+), kBinCap1 = (\d+), "
                     r"kBinCap2 = (\d+);", src).groups()
    assert (small, tuple(map(int, caps))) == BINS
    assert "constexpr int kLarge = kBinCap2;" in src
    emit = src[src.index("int emit_lane("):src.index("// seed_runs:")]
    assert re.search(r"if \(c <= kLarge\) \{\s*sb\.runlen\[base \+ first\] "
                     r"= c;\s*return block_bin\(c\);", emit)
    binner = re.search(r"int block_bin\(int c\) \{\s*return (.*?);\s*\}",
                       src, re.S).group(1)
    assert re.sub(r"\s+", " ", binner) == (
        "c <= kSmall || c > kLarge ? -1 : c <= kBinCap0 ? 0 : "
        "c <= kBinCap1 ? 1 : 2")
    assert "constexpr int kWordDigits = 32 / kBits;" in src
    assert "const int run_digits = N / (kLarge + 1) <= kRadix ? 1 : 2;" \
        in src
    assert "const int passes = kWordDigits + run_digits;" in src
    assert "for (int r = 1; r < kSeedWords; ++r) {" in src
    assert run_digits(BINS[1][-1]) == 1 and run_digits(TINY[1][-1]) == 2
    top = (bwt2.MAX_N - 1) // (BINS[1][-1] + 1)
    assert top < RADIX ** 2


def test_seed_run_bins_match_round_0():
    """seed_run_bins sorts round 0's runs into the model's routes: the
    bins' runs and the runs for the later rounds."""
    rot, ns = _batch(_blocks("deep_repeats", 2))
    got = bwt2.seed_run_bins(to_torch(rot), to_torch(ns))
    want = {"small": 0, "block_256": 0, "block_1024": 0, "block_4096": 0,
            "round": 0}
    for r in range(B):
        n = int(ns[r])
        if n == 0:
            continue
        w0 = np.sort(words(rot[r], n, np.arange(n))[:, 0])
        _, sizes = np.unique(w0, return_counts=True)
        for c in sizes[sizes >= 2].tolist():
            name = "small" if c <= BINS[0] else next(
                (f"block_{cap}" for cap in BINS[1] if c <= cap), "round")
            want[name] += 1
    assert [got["small_2_32"][1], got["block_33_256"][1],
            got["block_257_1024"][1], got["block_1025_4096"][1],
            got["rounds_4097_up"][1]] == list(want.values())
    assert want["round"] and got["tied_lanes"] == sum(
        v[0] for name, v in got.items() if name != "tied_lanes")


def test_stage1_carries_the_word():
    """Four stable digit passes with the word carried give the stable sort
    of the lanes by W0, the carried words equal to the words gathered
    again at the sorted lanes (no pass gathers)."""
    rot, ns = _batch(_blocks("text", 3))
    for r in range(B):
        n = int(ns[r])
        w0 = words(rot[r], n, np.arange(n))[:, 0]
        w, p = w0, np.arange(n)
        for d in range(4):
            w, p = digit_pass((w >> (BITS * d)) & 255, w, p)
        np.testing.assert_array_equal(p, np.argsort(w0, kind="stable"))
        np.testing.assert_array_equal(w, words(rot[r], n, p)[:, 0])
