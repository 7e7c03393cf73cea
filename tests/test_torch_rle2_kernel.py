"""A numpy model of the RLE2 kernel (lbzip2_tpu_torch/csrc/rle2.cu) held
against the plain ``rle2_hist_plain`` (``_rle2_plain`` + ``_flat_hist``)
and the JAX package's ``_rle2_batch`` and the flat histogram of its
``_chain_mtf2`` (the per-group histogram summed over the groups).

The model runs the kernel's two launches: ``rle2_scan``, its CTAs in
ticket order (tile-major across the rows) one at a time here
(``test_torch_rle2_lookback.py`` interleaves them): tiles of threads * per
lanes, a thread's per lanes summed up as a Run (nonzeros, the zero runs
before the first and after the last nonzero, the digits of the runs
between), the tile's Run published as its aggregate, the tiles before
it combined by the look-back over their descriptors (epoch, kind,
aggregate, inclusive) up to the first inclusive one, its inclusive Run
published, then the tile emitting, thread by thread, the digits of each
run that ends in it and the nonzeros' r + 1 into its buffer, the EOB
from the thread of lane n - 1, the histogram counted as the values are
written into the row's counts, which the row's last CTA moves out; then
``rle2_tail`` zeroing the lanes at and past nm.  Tiles past lane n - 1's
write nothing; the ticket, the counts and the counters end at 0.  It
runs at the kernel's tile (read from the source) and at tiny ones, so
that runs cross many tile edges.  Inputs are made with numpy from seeds;
every comparison is exact.
"""

import itertools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu.ops.rle2 import rle2_batch as j_rle2_batch
from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import chain, mtf_pallas, rle2

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "lbzip2_tpu_torch" / "csrc" / "rle2.cu"
WIDTH = 259
IDENT = (0, 0, 0, 0)  # (nz, lead, trail, inner)


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


# (threads, per): the kernel's own tile, and tiny ones (15 lanes: odd)
CONFIGS = [(_const("kThreads"), _const("kPer")), (4, 4), (5, 3), (2, 1)]


def digits(k: int) -> int:
    return (k + 1).bit_length() - 1


def combine(a, b):
    nz = a[0] + b[0]
    lead = a[1] if a[0] else a[1] + b[1]
    trail = b[2] if b[0] else a[2] + b[2]
    inner = a[3] + b[3] + (digits(a[2] + b[1]) if a[0] and b[0] else 0)
    return nz, lead, trail, inner


def emitted(p) -> int:
    return p[0] + p[3] + (digits(p[1]) if p[0] else 0)


def fold(runs):
    out = IDENT
    for r in runs:
        out = combine(out, r)
    return out


def chunk_run(row, first: int, n: int, per: int):
    nz = lead = inner = run = 0
    for p in range(first, min(first + per, n)):
        if row[p] > 0:
            if nz:
                inner += digits(run)
            else:
                lead = run
            nz += 1
            run = 0
        else:
            run += 1
    return nz, lead if nz else run, run, inner


def tree_scan(xs):
    """Inclusive scan in the kernel's order of combines (shuffle-up steps
    of 1, 2, 4, ...)."""
    xs = list(xs)
    d = 1
    while d < len(xs):
        xs = [combine(xs[i - d], xs[i]) if i >= d else xs[i]
              for i in range(len(xs))]
        d *= 2
    return xs


def put_run(buf, o: int, k: int) -> int:
    v = k + 1
    for j in range(v.bit_length() - 1):
        buf[o + j] = (v >> j) & 1
    return o + v.bit_length() - 1


def wrap32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def in_order(factories):
    """The CTAs one at a time in ticket order: each finds the tile before
    it inclusive."""
    for make in factories:
        for _ in make():
            pass


def window_reduce(vals):
    """Warp 0's combine of a look-back window (lane i holds the tile i
    before the nearest): the shuffle-down tree, a higher lane on the
    left."""
    x = list(vals)
    d = 1
    while d < len(x):
        x = [combine(x[i + d], x[i]) if i + d < len(x) else x[i]
             for i in range(len(x))]
        d *= 2
    return x[0]


def look_back(desc, base, t, epoch, window, seen, combine=combine,
              ident=IDENT, reduce=window_reduce):
    """The prefix of tiles 0 .. t - 1 of a row from their descriptors
    desc[base + j] = (epoch, kind, aggregate, inclusive), a window of
    ``window`` lanes at a time, right to left, until the first inclusive
    one; a lane waits (yields) while its tile has no descriptor of this
    epoch.  ``seen`` collects the kinds read, "|" after each look-back."""
    acc = ident
    top = t - 1
    while True:
        idx = [top - i for i in range(window)]
        while any(j >= 0 and desc[base + j][0] != epoch for j in idx):
            yield  # spin
        kinds = ["P" if j < 0 else desc[base + j][1] for j in idx]
        seen.extend(k for j, k in zip(idx, kinds) if j >= 0)
        vals = [ident if j < 0 else desc[base + j][3 if k == "P" else 2]
                for j, k in zip(idx, kinds)]
        stop = kinds.index("P") if "P" in kinds else window - 1
        acc = combine(reduce(
            [v if i <= stop else ident for i, v in enumerate(vals)]), acc)
        if "P" in kinds:
            seen.append("|")  # this look-back ends
            return acc
        top -= window


def publish(desc, i, epoch, kind, value):
    """A descriptor goes X -> A -> P (tile 0: X -> P), never back."""
    old = desc[i]
    assert (kind, old[1] if old[0] == epoch else "X") in (
        ("A", "X"), ("P", "X"), ("P", "A")), (i, kind, old)
    agg = value if kind == "A" else old[2] if old[0] == epoch else None
    desc[i] = (epoch, kind, agg, value if kind == "P" else None)


def new_state():
    """The kernel's device state between calls: the descriptors (any
    content; epoch-tagged), the ticket and the row counters and
    histograms (0 between calls), the epoch."""
    return {"desc": [], "ticket": 0, "rows": {}, "epoch": 0}


def model(ranks, ns, ninuse, threads: int, per: int, schedule=in_order,
          window: int = 32, state=None, seen=None):
    """The kernel's launches: ``rle2_scan`` (its CTAs interleaved by
    ``schedule``), then ``rle2_tail``.  Returns (mtfv, nm, hist) and the
    runs each tile emitted, (row, tile, lane the run ends at, length)."""
    B, N = ranks.shape
    tile = threads * per
    tiles = max(-(-N // tile), 1)
    slack = _const("kSlack")
    G = -(-(N + 1) // 50)
    st = state if state is not None else new_state()
    st["epoch"] += 1
    epoch = st["epoch"]
    while len(st["desc"]) < B * tiles:
        st["desc"].append((0, "X", None, None))
    seen = [] if seen is None else seen
    mtfv = np.full((B, N + 1), -1, np.int64)
    writes = np.zeros((B, N + 1), np.int64)
    nm_out = np.full(B, -1, np.int64)
    hist = np.full((B, WIDTH), -1, np.int64)
    events = []
    ns_c = [min(max(int(ns[b]), 0), N) for b in range(B)]
    rows = [[int(v) for v in ranks[b, :ns_c[b]]]  # lanes >= n never read
            for b in range(B)]

    def cta(k):
        """A CTA draws ticket k when it starts; its steps run later."""
        assert k == st["ticket"]
        st["ticket"] = 0 if k == B * tiles - 1 else k + 1
        return steps(k)

    def steps(k):
        t, b = divmod(k, B)
        n, row = ns_c[b], rows[b]
        last = n - 1 if n else 0
        tc = last // tile
        if t > tc:
            return  # lanes >= n only
        lane0 = t * tile
        closes = t == tc
        desc, base = st["desc"], b * tiles
        runs = [chunk_run(row, lane0 + j * per, n, per)
                for j in range(threads)]
        incl = tree_scan(runs)
        excl = [IDENT] + incl[:-1]
        total = incl[-1]
        if t == 0:
            publish(desc, base, epoch, "P", total)
            before = IDENT
        else:
            publish(desc, base + t, epoch, "A", total)
            yield
            before = yield from look_back(desc, base, t, epoch, window,
                                          seen)
            publish(desc, base + t, epoch, "P", combine(before, total))
        yield
        whole = combine(before, total)
        nm = emitted(whole) + digits(whole[2]) + 1
        out0 = emitted(before)
        count = emitted(whole) - out0
        if closes:
            count += digits(whole[2]) + 1
        assert count <= tile + slack - 32
        buf = [None] * count
        ends = []
        # the counts as the values are written: the digits and the 2s
        # summed (the kernel's registers), any other value one by one
        counts = np.zeros(WIDTH, np.int64)
        for j in range(threads):
            mine = combine(before, excl[j])
            o, run = emitted(mine) - out0, mine[2]
            first = lane0 + j * per
            for p in range(first, min(first + per, n)):
                if row[p] > 0:
                    o2 = put_run(buf, o, run)
                    counts[:2] += np.bincount(buf[o:o2], minlength=2)
                    o = o2
                    events.append((b, t, p, run))
                    buf[o] = wrap32(row[p] + 1)
                    counts[min(buf[o] & 0xFFFFFFFF, WIDTH - 1)] += 1
                    o += 1
                    run = 0
                else:
                    run += 1
            if closes and first <= last < first + per:
                o2 = put_run(buf, o, run)
                counts[:2] += np.bincount(buf[o:o2], minlength=2)
                o = o2
                events.append((b, t, n, run))
                buf[o] = int(ninuse[b]) + 1
                counts[min(buf[o] & 0xFFFFFFFF, WIDTH - 1)] += 1
                o += 1
            ends.append(o)
        assert None not in buf and max(ends, default=0) == count
        mtfv[b, out0:out0 + count] = buf
        writes[b, out0:out0 + count] += 1
        rs = st["rows"].setdefault(b, np.zeros(WIDTH + 1, np.int64))
        rs[:WIDTH] += counts
        if closes:
            nm_out[b] = nm
            rs[min(int(ninuse[b]) + 2, WIDTH - 1)] += G * 50 - nm
        rs[WIDTH] += 1
        if rs[WIDTH] == tc + 1:  # the row's last CTA
            hist[b] = rs[:WIDTH]
            rs[:] = 0

    schedule([lambda k=k: cta(k) for k in range(B * tiles)])
    for b in range(B):  # rle2_tail
        mtfv[b, nm_out[b]:] = 0
        writes[b, nm_out[b]:] += 1
    assert (writes == 1).all(), "a lane written twice or never"
    assert st["ticket"] == 0 and not any(r.any() for r in
                                         st["rows"].values())
    return (mtfv.astype(np.int32), nm_out.astype(np.int32),
            hist.astype(np.int32)), events


def row_runs(ranks, ns, N):
    """Every zero run of every row, (row, lane it ends at, length): at
    its closing nonzero, or at n."""
    out = []
    for b in range(ranks.shape[0]):
        n = min(max(int(ns[b]), 0), N)
        run = 0
        for p in range(n):
            if ranks[b, p] > 0:
                out.append((b, p, run))
                run = 0
            else:
                run += 1
        out.append((b, n, run))
    return out


def _nonzero(rng, size, lo=1, hi=256):
    return rng.integers(lo, hi, size).astype(np.int32)


def _with_runs(rng, N, lengths):
    """A row of nonzero ranks with zero runs of the given lengths, one
    after another, each after a nonzero."""
    row = _nonzero(rng, N)
    p = int(rng.integers(1, 40))
    for k in lengths:
        if p + k + 1 >= N:
            break
        row[p:p + k] = 0
        p += k + 1 + int(rng.integers(0, 3))
    return row


def _case(name: str):
    """name -> (ranks (B, N), ns, ninuse) int32."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "all_zero":
        N = 4096
        return (np.zeros((4, N), np.int32), np.array([N, N - 1, 4000, 17]),
                np.array([1, 256, 40, 3]))
    if name == "pow2_runs_across_tile_edges":
        N = 8192
        lens = [k for j in range(1, 13) for k in (2 ** j - 2, 2 ** j - 1,
                                                   2 ** j)]
        rows = [_with_runs(rng, N, lens), _with_runs(rng, N, lens[::-1]),
                _with_runs(rng, N, rng.permutation(lens))]
        edge = _nonzero(rng, N)
        edge[4096 - 100:4096 - 100 + 4096] = 0  # 2^12 across the edge
        edge[4096 - 3:4096 + 4094 - 3] = 0
        rows.append(edge)
        return (np.stack(rows), np.full(4, N), np.array([255, 200, 90, 256]))
    if name == "run_over_three_tiles_and_runs_ending_at_n":
        N = 16384
        a = _nonzero(rng, N)
        a[5:5 + 3 * 4096 + 7] = 0
        b = _nonzero(rng, N)
        b[9000:] = 0  # a run that touches n = 12345
        c = _nonzero(rng, N)
        c[N - 4097:] = 0  # a run that ends at n = N
        d = np.zeros(N, np.int32)
        d[0] = 7  # one nonzero, then a run of N - 1 to n
        return (np.stack([a, b, c, d]), np.array([N, 12345, N, N]),
                np.array([255, 255, 255, 8]))
    if name == "n_0_1_and_N":
        N = 2048
        r = np.where(rng.random((6, N)) < 0.6, 0,
                     _nonzero(rng, (6, N))).astype(np.int32)
        r[1, 0], r[3, 0] = 0, 5
        return r, np.array([0, 1, N, 1, 0, 2]), np.array([3, 1, 200, 9, 256,
                                                          2])
    if name == "ninuse_1_and_256":
        N = 3000
        one = np.zeros(N, np.int32)  # one byte value: every rank is 0
        full = np.where(rng.random(N) < 0.3, 0, rng.integers(1, 256, N))
        return (np.stack([one, full.astype(np.int32), one]),
                np.array([N, N, 1000]), np.array([1, 256, 1]))
    if name == "garbage_past_n":
        N = 4096
        r = rng.integers(-2 ** 31, 2 ** 31, (5, N), dtype=np.int64).astype(
            np.int32)
        ns = np.array([100, 4095, 0, 2048, 4097 - 1])
        for b, n in enumerate(ns):
            r[b, :n] = np.where(rng.random(n) < 0.5, 0,
                                rng.integers(1, 256, n))
        r[3, 7] = -3  # a negative rank is no nonzero
        return r, ns, np.array([255, 100, 7, 256, 50])
    if name == "mixed_n":
        N = 8192
        zp = np.array([0.0, 0.5, 0.9, 0.99, 1.0, 0.7, 0.3, 0.95])[:, None]
        r = np.where(rng.random((8, N)) < zp, 0,
                     _nonzero(rng, (8, N))).astype(np.int32)
        return (r, np.array([N, 1, 0, 4097, 4096, 8191, 3, 6000]),
                rng.integers(1, 257, 8))
    raise KeyError(name)


CASES = ["all_zero", "pow2_runs_across_tile_edges",
         "run_over_three_tiles_and_runs_ending_at_n", "n_0_1_and_N",
         "ninuse_1_and_256", "garbage_past_n", "mixed_n"]


def _plain(ranks, ns, ninuse):
    got = rle2.rle2_hist_plain(*(to_torch(np.asarray(a, np.int32))
                                 for a in (ranks, ns, ninuse)))
    return tuple(to_numpy(g) for g in got)


def _jax(ranks, ns, ninuse):
    ranks, ns, ninuse = (jnp.asarray(np.asarray(a, np.int32))
                         for a in (ranks, ns, ninuse))
    mtfv, nm = j_rle2_batch(ranks, ns, ninuse)
    hist_g, _, _ = jchain.group_hist(mtfv, nm, ninuse)
    return (np.asarray(mtfv), np.asarray(nm),
            np.asarray(hist_g.sum(1)).astype(np.int32))


def _check(ranks, ns, ninuse, want):
    for threads, per in CONFIGS:
        got, events = model(ranks, ns, ninuse, threads, per)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{threads}x{per}")
        # a run's digits come from the tile it ends in, once
        tile = threads * per
        assert sorted((b, end, k) for b, _, end, k in events) == \
            sorted(row_runs(ranks, ns, ranks.shape[1]))
        n = np.clip(ns, 1, ranks.shape[1])
        assert all(t == min(end, n[b] - 1) // tile
                   for b, t, end, _ in events)


@pytest.mark.parametrize("name", CASES)
def test_model_against_plain_and_jax(name):
    ranks, ns, ninuse = _case(name)
    want = _plain(ranks, ns, ninuse)
    for w, j in zip(want, _jax(ranks, ns, ninuse)):
        np.testing.assert_array_equal(w, j)
    _check(ranks, ns, ninuse, want)


def test_text_through_mtf_against_jax_chain_mtf2():
    """Text from the repo's own C sources, its BWT by the host C library,
    the MTF ranks by the plain MTF: the model's values, counts and flat
    histogram against the JAX ``chain_mtf2`` of the same BWT rows."""
    src = b"".join(p.read_bytes() for p in sorted(
        (ROOT / "lbzip2_tpu_torch" / "native").glob("*.c")))
    N = 8192
    sizes = [N, 5000, 8191, 1]
    bwt = np.zeros((len(sizes), N), np.uint8)
    cmaps = np.zeros((len(sizes), 256), np.uint8)
    for b, n in enumerate(sizes):
        blk = np.frombuffer(src[b * 9000:b * 9000 + n], np.uint8)
        bwt[b, :n] = native.bwt(blk)[0]
        cmaps[b, np.unique(blk)] = 1
    ns = np.array(sizes, np.int32)
    syms = chain._compact_syms(to_torch(bwt), to_torch(cmaps))
    ranks = to_numpy(mtf_pallas.mtf_ranks_plain(syms, to_torch(ns)))
    ninuse = cmaps.sum(1, dtype=np.int32)
    want = jchain.chain_mtf2(jnp.asarray(bwt), jnp.asarray(ns),
                             jnp.asarray(cmaps))
    want = (np.asarray(want[0]), np.asarray(want[1]), np.asarray(want[2]))
    for p, w in zip(_plain(ranks, ns, ninuse), want):
        np.testing.assert_array_equal(p, w)
    _check(ranks, ns, ninuse, want)


def test_combine_is_associative():
    """The tiles' and threads' Runs may be combined in any grouping: the
    Run of a span is the combine of its pieces' Runs, however cut."""
    rng = np.random.default_rng(11)
    for trial in range(300):
        n = int(rng.integers(0, 60))
        row = np.where(rng.random(n) < rng.random(), 0,
                       rng.integers(1, 5, n)).tolist()
        a, b = sorted(rng.integers(0, n + 1, 2).tolist())
        x, y, z = (chunk_run(row, lo, hi, hi - lo)
                   for lo, hi in ((0, a), (a, b), (b, n)))
        assert combine(combine(x, y), z) == combine(x, combine(y, z)) == \
            chunk_run(row, 0, n, n)


def test_tree_scan_is_the_ordered_fold():
    """The warp's shuffle-up scan gives every thread the same prefix as
    the fold of the Runs before it, in order."""
    rng = np.random.default_rng(12)
    row = np.where(rng.random(999) < 0.8, 0, 3).tolist()
    runs = [chunk_run(row, 16 * j, 999, 16) for j in range(63)]
    assert tree_scan(runs) == list(itertools.accumulate(runs, combine))


def test_tile_constants_and_emit_bound():
    """The kernel's tile and buffer: a tile emits at most kTile + 32
    values (its lanes, plus at most 31 digits of the one run that crosses
    its left edge, plus the EOB), which kSlack covers, and the staging
    buffer the values reuse holds kTile + kSlack (a thread's 16 lanes at
    a 16-byte word of padding every 16 lanes, which spreads a
    quarter-warp's 16-byte reads over all 32 banks)."""
    assert (_const("kThreads"), _const("kPer")) == (256, 16)
    assert _const("kSlack") >= 33
    text = SRC.read_text()
    assert "constexpr int kTile = kThreads * kPer;" in text
    assert "constexpr int kStaged = kTile + kTile / 4;" in text
    assert "return i + ((i >> 4) << 2);" in text
    assert len({(20 * t) % 32 for t in range(8)}) == 8
    assert "int sm[kStaged];" in text
    assert "static_assert(kStaged >= kTile + kSlack" in text
    assert 4096 + 4096 // 4 >= 4096 + _const("kSlack")
    # the worst tile: a run of n - 1 zeros crossing into the last tile
    N = 3 * 4096
    ranks = np.zeros((1, N), np.int32)
    ranks[0, N - 20:] = 1
    ranks[0, 0] = 1
    model(ranks, np.array([N]), np.array([5]), 256, 16)


def test_cpu_wrappers_run_the_plain_version():
    ranks, ns, ninuse = (to_torch(np.asarray(a, np.int32))
                         for a in _case("mixed_n"))
    before = rle2.launches
    want = rle2.rle2_hist_plain(ranks, ns, ninuse)
    for g, w in zip(rle2.rle2_hist_rows(ranks, ns, ninuse), want):
        assert g.equal(w)
    for g, w in zip(rle2._rle2_batch(ranks, ns, ninuse), want):
        assert g.equal(w)
    assert rle2.launches == before
