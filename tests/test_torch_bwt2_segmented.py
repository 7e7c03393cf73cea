"""The segmented doubling pass of lbzip2_tpu_torch/csrc/bwt2_sort.cu and
the resolve loop on the card, row by row in numpy, against the port's
plain ``_pass8_plain`` / ``_resolve_loop`` and JAX's ``_pass8`` /
``_resolve_loop`` on the CPU.

The model follows the kernels step by step: the histogram of the ISA
over the lanes < n; the exclusive sums S[v]; each class of two or more
lanes to a dense range (classes above the last block capacity first,
region L, then the others, region A), its lanes in any order (the
kernels place them by atomics); region A's keys 0 to 7 gathered once;
then, with every gather done, the writes in the kernels' order on the
same ISA: the lone lanes to S[v] (after the seed), classes of at most
SEG_SMALL lanes ranked by counting, the block bins by a sort of the
class's slots, region L by stable 8-bit digit passes over its lanes
alone, keys 7 to 0, its ranks S[v] + the sub-class's first slot - the
class's (v read from the lane itself); a row whose previous count is 0
skipped.  The kernels define the ISA on lanes < n only, so valid lanes
and the counts are compared, exactly.  Rows come from
native.lyndon_prep at the 8192 bucket, B = 8, as in
tests/test_torch_bwt2.py.
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
KEYS, KEY_DIGITS, BITS = 8, 3, 8
BINS = (bwt2.SEG_SMALL, bwt2.SEG_BLOCKS)
TINY = (2, (4, 8, 16))  # every route on rows of 8192 lanes
ROOT = pathlib.Path(__file__).resolve().parent.parent


# -- the kernels' algorithm -------------------------------------------------

def mapped_keys(isa, n, p, k, nkeys=KEYS, mapping="suffix"):
    """(len(p), nkeys) keys N + ISA[p + off_j] inside the row, else
    N - 1 - p, off_j = min(j k, N); key 0 is N + ISA[p].  The rotation
    sort's mappings: "cyclic", N + ISA[(p + (j k mod n)) mod n], the
    offset taken mod n in 64 bits; "tie", n - 1 - p past key 0."""
    p = np.asarray(p, np.int64)
    if mapping == "cyclic":
        off = np.array([(j * k) % max(n, 1) for j in range(nkeys)])
        q = p[:, None] + off
        return (N + isa[np.where(q >= n, q - n, q)]).astype(np.int64)
    if mapping == "tie":
        out = np.repeat((n - 1 - p)[:, None], nkeys, 1)
        out[:, 0] = N + isa[p]
        return out.astype(np.int64)
    q = p[:, None] + np.array([min(j * k, N) for j in range(nkeys)])
    inside = q < n
    return np.where(inside, N + isa[np.minimum(q, N - 1)],
                    N - 1 - p[:, None]).astype(np.int64)


def starts_of(keys):
    """Sub-class starts of rows of keys in sorted order."""
    st = np.ones(len(keys), bool)
    st[1:] = (keys[1:] != keys[:-1]).any(1)
    return st


def model_pass(isa, k, n, prev=None, bins=BINS, rng=None, routes=None,
               nkeys=KEYS, mapping="suffix"):
    """One row's pass in place on ``isa`` (N,) int64: returns cnt.  A row
    whose ``prev`` count is 0 is left alone.  ``rng`` shuffles the
    order of the lanes inside every class; ``routes`` (a dict) counts
    the classes each route took.  ``nkeys`` keys (4 or 8: a 4-key pass
    stores keys 4 to 7 as 0 for the 7-key block sorts) by ``mapping``
    (``mapped_keys``)."""
    small, blocks = bins
    large = blocks[-1]
    if prev == 0:
        return 0
    # classify: S[v], region L (classes above `large`) then region A
    count = np.bincount(isa[:n], minlength=N)
    S = np.concatenate([[0], np.cumsum(count)])
    in_l = np.where(count > large, count, 0)
    in_a = np.where((count >= 2) & (count <= large), count, 0)
    n_l = int(in_l.sum())
    end = np.where(in_l > 0, np.cumsum(in_l),
                   np.where(in_a > 0, n_l + np.cumsum(in_a), 0))
    remap = ((count == 1) & (S[:-1] != np.arange(N))).any()
    # compact the tied lanes, in any order, each class to its range
    p = np.arange(n)
    v = isa[:n]
    tied = count[v] >= 2
    order = p[tied] if rng is None else rng.permutation(p[tied])
    by_class = order[np.argsort(v[order], kind="stable")]
    vc = v[by_class]
    first_of = np.searchsorted(vc, vc)
    slot = end[vc] - 1 - (np.arange(len(vc)) - first_of)
    start = end - count  # F after compaction: each class's first slot
    pos = np.zeros(N, np.int64)
    pos[slot] = by_class
    keys = np.zeros((N, KEYS), np.int64)
    a_lanes = slot >= n_l
    keys[slot[a_lanes], :nkeys] = mapped_keys(isa, n, by_class[a_lanes], k,
                                              nkeys, mapping)
    keys[slot[a_lanes], 0] = vc[a_lanes]
    # region L's digit passes gather too: before any write
    lpos = pos[:n_l]
    for j in reversed(range(nkeys)):
        for d in range(KEY_DIGITS):
            digit = (mapped_keys(isa, n, lpos, k, nkeys, mapping)[:, j] >>
                     (BITS * d)) & 255
            lpos = lpos[np.argsort(digit, kind="stable")]
    lkeys = mapped_keys(isa, n, lpos, k, nkeys, mapping)
    # the writes
    cnt = 0
    if remap:
        lone = count[isa[:n]] == 1
        isa[:n][lone] = S[isa[:n][lone]]
    for cls in np.flatnonzero(in_a):
        c, f = count[cls], start[cls]
        kk = keys[f:f + c, 1:]
        if c <= small:  # a thread a lane: count smaller and equal keys
            less = np.array([sum(tuple(o) < tuple(m) for o in kk)
                             for m in kk])
            equal = (kk[:, None] == kk[None]).all(2).sum(1)
            isa[pos[f:f + c]] = S[cls] + less
            cnt += int((equal > 1).sum())
            route = "small"
        else:  # a block: sort the slots by keys 1 to 7, max-scan starts
            srt = np.lexsort(kk.T[::-1])
            st = starts_of(kk[srt])
            first = np.maximum.accumulate(np.where(st, np.arange(c), 0))
            isa[pos[f + srt]] = S[cls] + first
            ends = np.append(st[1:], True)
            cnt += int((~(st & ends)).sum())
            route = next(f"block_{cap}" for cap in blocks if c <= cap)
        if routes is not None:
            routes[route] = routes.get(route, 0) + 1
    if n_l:  # region L: ranks from the sorted lanes
        st = starts_of(lkeys)
        first = np.maximum.accumulate(np.where(st, np.arange(n_l), 0))
        vl = isa[lpos]  # each lane's own v, not yet written
        isa[lpos] = S[vl] + first - start[vl]
        ends = np.append(st[1:], True)
        cnt += int((~(st & ends)).sum())
        if routes is not None:
            routes["radix"] = routes.get("radix", 0) + int(
                (count > large).sum())
    return cnt


def model_loop(seed_isa, ns, bins=BINS):
    """The loop on the card: loop_passes(N) passes in place, a row
    skipped once the pass before left it no tie.  (ISA, passes a row)."""
    isa = seed_isa.astype(np.int64).copy()
    prev = [None] * B
    passes = np.zeros(B, np.int32)
    k = 16
    for _ in range(bwt2.loop_passes(N)):
        for r in range(B):
            passes[r] += prev[r] is None or prev[r] > 0
            prev[r] = model_pass(isa[r], k, int(ns[r]), prev[r], bins)
        k *= 8
    return isa, passes


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
    if kind == "two_values":  # 16-byte prefixes tie by the thousand
        sizes = (50, 333, 2048, 6000, 8000, 7, 8191, 4000)
        return [rng.integers(97, 99, n, np.uint8) for n in sizes]
    if kind == "values_16":
        sizes = (50, 333, 2048, 6000, 8000, 7, 8191, 4000)
        return [rng.integers(0x40, 0x50, n, np.uint8) for n in sizes]
    if kind == "runs":
        out = []
        for n in (500, 201, 3000, 8192, 60, 7777, 1024, 4500):
            vals = rng.integers(0, 256, n // 3 + 1, np.uint8)
            b = np.repeat(vals, rng.integers(1, 9, vals.size))[:n].copy()
            b[-1] ^= 0x55  # keep primitive
            out.append(b)
        return out
    if kind == "pad_key":
        # FF FF FF FF then a nonzero byte (K > P) or at the row's end
        # (K = P, a tie with the pads), with and without pads; F8's row
        out = [_f8_row()]
        for n, at in ((5000, 100), (4096, "end"), (8192, "end"),
                      (8192, 4000), (300, "end"), (2, None), (0, None)):
            b = rng.integers(1, 256, n, np.uint8)
            b[:3] = 0
            if at == "end":
                b[-4:] = 0xFF
            elif at is not None:
                b[at:at + 4] = 0xFF
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


def _assert_rows(want_isa, want_cnt, got_isa, got_cnt, ns, who):
    for r in range(B):
        np.testing.assert_array_equal(got_isa[r, :ns[r]],
                                      want_isa[r, :ns[r]], f"{who}: row {r}")
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(want_cnt),
                                  f"{who}: counts")


def _check_pass(isa, k, ns, bins=BINS, rng=None, routes=None):
    """The model's pass over ``isa`` against the plain pass and JAX's."""
    m_isa = isa.astype(np.int64).copy()
    m_cnt = [model_pass(m_isa[r], k, int(ns[r]), None, bins, rng, routes)
             for r in range(B)]
    p_isa, p_cnt = bwt2._pass8_plain(to_torch(isa), k, to_torch(ns))
    j_isa, j_cnt = jbwt2.pass8(jnp.asarray(isa), jnp.int32(k),
                               jnp.asarray(ns))
    _assert_rows(to_numpy(p_isa), to_numpy(p_cnt), m_isa, m_cnt, ns,
                 f"model vs plain, k={k}")
    _assert_rows(np.asarray(j_isa), np.asarray(j_cnt), m_isa, m_cnt, ns,
                 f"model vs JAX, k={k}")
    return to_numpy(p_isa)


KINDS = ["text", "random", "values_16", "runs", "deep_repeats", "pad_key"]


@pytest.mark.parametrize("kind", KINDS)
def test_pass_model(kind):
    """The first pass on the seed's ISA (k = 16: the lone lanes remapped
    where the seed put them past the pads, the K = P ties), then passes
    at k = 5000 (N < j k < 2N for j = 2: the clamped start) and 65536
    (k >= N, p + j k >= 2N for j >= 2: the patched sentinels) on the
    ISA of one plain pass."""
    rot, ns = _batch(_blocks(kind, 2))
    seed_isa, _ = bwt2._seed16_plain(to_torch(rot), to_torch(ns))
    routes = {}
    after = _check_pass(to_numpy(seed_isa), 16, ns, routes=routes)
    for k in (5000, 65536):
        _check_pass(after, k, ns)
    if kind == "deep_repeats":  # every route at the kernel's own bins
        assert set(routes) == {"small", "block_256", "block_1024",
                               "block_4096", "radix"}, routes


@pytest.mark.parametrize("kind", ["text", "two_values", "deep_repeats"])
def test_pass_model_tiny_bins(kind):
    """Bins of 2, 4, 8 and 16 lanes send most classes to the block bins
    and the digit passes of region L: the same ISA and counts."""
    rot, ns = _batch(_blocks(kind, 3))
    seed_isa, _ = bwt2._seed16_plain(to_torch(rot), to_torch(ns))
    routes = {}
    after = _check_pass(to_numpy(seed_isa), 16, ns, TINY, routes=routes)
    _check_pass(after, 128, ns, TINY, routes=routes)
    assert routes.get("small") and \
        any(r.startswith("block") for r in routes), routes
    if kind != "two_values":  # its classes stay below 16 lanes
        assert routes.get("radix"), routes


def test_order_inside_classes_does_not_matter():
    """The kernels place a class's lanes by atomics: any order inside
    every class gives the same ISA' and counts."""
    for kind, bins in (("deep_repeats", BINS), ("text", TINY),
                       ("two_values", TINY)):
        rot, ns = _batch(_blocks(kind, 4))
        seed = to_numpy(bwt2._seed16_plain(to_torch(rot), to_torch(ns))[0])
        want = seed.astype(np.int64).copy()
        want_cnt = [model_pass(want[r], 16, int(ns[r]), None, bins)
                    for r in range(B)]
        for s in range(3):
            got = seed.astype(np.int64).copy()
            rng = np.random.default_rng(s)
            got_cnt = [model_pass(got[r], 16, int(ns[r]), None, bins, rng)
                       for r in range(B)]
            _assert_rows(want, want_cnt, got, got_cnt, ns,
                         f"{kind}, shuffle {s}")


@pytest.mark.parametrize("kind", KINDS)
def test_loop_model(kind):
    """loop_passes(N) passes, each row skipped once resolved, equal the
    port's plain loop (ISA and each row's passes) on every case, and
    JAX's loop wherever the seed leaves a tie (where it leaves none, JAX
    runs no pass and keeps the seed's ranks past the pads: ROADMAP F8)."""
    rot, ns = _batch(_blocks(kind, 5))
    seed, seed_cnt = bwt2._seed16_plain(to_torch(rot), to_torch(ns))
    m_isa, m_passes = model_loop(to_numpy(seed), ns)
    p_isa = to_numpy(bwt2._resolve_loop(to_torch(rot), to_torch(ns)))
    _assert_rows(p_isa, 0, m_isa, 0, ns, "model loop vs plain loop")
    np.testing.assert_array_equal(m_passes, to_numpy(bwt2.last_passes()))
    if int(seed_cnt.max()) > 0:
        j_isa = np.asarray(jbwt2._resolve_loop(jnp.asarray(rot),
                                               jnp.asarray(ns)))
        _assert_rows(j_isa, 0, m_isa, 0, ns, "model loop vs JAX loop")
    if kind == "deep_repeats":
        assert m_passes.max() == 3 == bwt2.loop_passes(N)


def test_bins_match_the_kernel_source():
    """SEG_SMALL and SEG_BLOCKS are the kernel's kSmall and kBinCap0..2,
    and class_bins sorts the seed's classes into them as the model's
    routes do."""
    src = (ROOT / "lbzip2_tpu_torch" / "csrc" / "bwt2_sort.cu").read_text()
    small = int(re.search(r"constexpr int kSmall = (\d+);", src).group(1))
    caps = re.search(r"constexpr int kBinCap0 = (\d+), kBinCap1 = (\d+), "
                     r"kBinCap2 = (\d+);", src).groups()
    assert (small, tuple(map(int, caps))) == (bwt2.SEG_SMALL,
                                              bwt2.SEG_BLOCKS)
    rot, ns = _batch(_blocks("deep_repeats", 2))
    seed, _ = bwt2._seed16_plain(to_torch(rot), to_torch(ns))
    got = bwt2.class_bins(seed, to_torch(ns))
    routes = {}
    isa = to_numpy(seed).astype(np.int64)
    for r in range(B):
        model_pass(isa[r], 16, int(ns[r]), None, BINS, routes=routes)
    assert got["small_2_32"][1] == routes["small"]
    assert got["block_33_256"][1] == routes["block_256"]
    assert got["block_257_1024"][1] == routes["block_1024"]
    assert got["block_1025_4096"][1] == routes["block_4096"]
    assert got["radix_4097_up"][1] == routes["radix"]
    assert got["tied_lanes"] == sum(v[0] for name, v in got.items()
                                    if name != "tied_lanes")


def test_engine_trace_holds_the_passes(monkeypatch):
    """Every device batch's trace holds the BWT's passes (the most of its
    rows), read by the fetch thread after the batch's event."""
    import bz2

    from lbzip2_tpu_torch.codec import encoder

    monkeypatch.setattr(encoder, "_HOST_STEAL", False)
    data = _repo_text()[:6000].tobytes()  # one block, the 8192 bucket
    out = encoder.compress(data, 9, device="cpu")
    trace = encoder.last_stats["batch_trace"]
    assert trace and all(t["bwt2_passes"] >= 1 for t in trace)
    assert bz2.decompress(out) == data
