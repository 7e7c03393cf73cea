"""Numpy models of the BWT's emit kernels (lbzip2_tpu_torch/csrc/
bwt2_emit.cu) held against the port's plain ``_emit_bytes`` /
``_tokens_plain`` / ``_emit2`` and the JAX package's ``emit_bytes`` and
``emit2``.

``emit_bytes`` is a scatter: on the lanes < n the ISA the resolve loop
hands over is a permutation of [0, n), so bwt[ISA[p]] = prev[p] (prev[0]
the row's last byte), lanes >= n are 0 and the primary index is
ISA[m ? n - m : 0].  It runs in two launches over buckets of S
destinations: ``emit_bin`` sorts a tile of T lanes by bucket in shared
memory and reserves a run of each bucket's region of a scratch with one
atomic a bucket, storing (ISA mod S) << 8 | byte; ``emit_place`` puts a
bucket's bytes into an S-byte buffer and stores it whole.  The model
(``emit_bytes_model``) runs the CTAs of both launches in a random order
(the atomics' order is the hardware's) and checks the precondition,
that every region is filled exactly, that every staging slot, scratch
entry and destination is written once, and that the output is the same
whatever the order.  The tokens are one pass, ``tok_scan``, over tiles of
threads * per lanes, its CTAs by ticket (tile-major across the rows; in
ticket order here, ``test_torch_tokens_lookback.py`` interleaves them):
the tile and a halo past it staged, each thread's lanes summed up as a
span (first and last change, the starts from the first change on), the
spans scanned in the kernel's order of combines, the tile's span
published as its aggregate, the look-back over the row's descriptors to
the first inclusive one; each thread's starts (its changes and the split
of the run open at its left in its leading stretch) put at their indices
in the tile's list of start lanes, then a token a thread, its length to
the next start (the tile's last from the first change in the halo,
p + 255 or n), stored below the capacity N / 4, and the count from the
CTA of lane n - 1; then ``tok_tail`` zeroing the slots from the count to
the capacity.  The model runs at the kernel's tile (read from the
source) and at tiny ones, so that runs cross many tile edges, and checks
that every token slot is written once.  Inputs are made with numpy from
seeds; every comparison is exact.
"""

import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2
from test_torch_bwt2 import TOKEN_KINDS, _batch, _token_blocks
from test_torch_rle2_kernel import in_order, look_back, publish

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "lbzip2_tpu_torch" / "csrc" / "bwt2_emit.cu"
MAXLEN = 255
UNSET = 0xBEEF


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


# JAX's resolve loop, compiled once (it runs inside JAX's jitted
# bwt2_tokens / bwt2_bytes on its main path)
_j_resolve_loop = jax.jit(jbwt2._resolve_loop)

# (threads, per): the kernel's tile, and tiny ones (16 and 2 lanes)
CONFIGS = [(_const("kThreads"), _const("kPer")), (4, 4), (2, 1)]
HALO = _const("kHalo")  # lanes the scan stages past its tile
# emit_bytes' buckets of destinations and tiles of lanes
BUCKET = 1 << _const("kBucketLog")
BIN_TILE = _const("kBinThreads") * _const("kBinPer")


def emit_bytes_model(blocks, isa, ns, ms, S: int = BUCKET, T: int = BIN_TILE,
                     rng=None, check: bool = True):
    """The emit_bytes kernels at buckets of S destinations and tiles of T
    lanes, their CTAs in rng's order (launch order without one): (bwt,
    primary).  check: the ISA must be a permutation of [0, n)."""
    B, N = blocks.shape
    nb = -(-N // S)
    shift = S.bit_length() - 1
    assert 1 << shift == S
    entries = np.full((B, N), -1, np.int64)  # the uninitialised scratch
    cursors = np.zeros((B, nb), np.int64)
    primary = np.zeros(B, np.int32)
    lanes_of = np.arange(N)

    def order(items):
        return [items[i] for i in rng.permutation(len(items))] \
            if rng is not None else items

    for b in range(B) if check else ():
        n = max(0, min(int(ns[b]), N))
        assert np.array_equal(np.sort(isa[b, :n]), np.arange(n)), \
            f"row {b}: the ISA is no permutation of [0, n)"
    # launch 1: emit_bin, a CTA a (row, tile)
    for b, t in order([(b, t) for b in range(B) for t in range(-(-N // T))]):
        n = max(0, min(int(ns[b]), N))
        if t == 0:
            m = int(ms[b])
            primary[b] = isa[b, min(max(0 if m == 0 else n - m, 0), N - 1)]
        lo = t * T
        if lo >= n:
            continue
        p = lanes_of[lo:min(lo + T, n)]
        d = isa[b, p].astype(np.int64) & 0xFFFFFFFF  # unsigned
        keep = d < n
        p, d = p[keep], d[keep]
        v = d << 8 | blocks[b, np.where(p > 0, p - 1, n - 1)]
        k = d >> shift
        # a lane's rank among the tile's lanes of its bucket: the order
        # in which the shared atomics land
        landed = rng.permutation(p.size) if rng is not None \
            else np.arange(p.size)
        by = np.lexsort((landed, k))
        cnt = np.bincount(k, minlength=nb)
        off = np.cumsum(cnt) - cnt  # bin_scan
        r = np.empty(p.size, np.int64)
        r[by] = np.arange(p.size) - off[k[by]]
        staged = np.full(int(cnt.sum()), -1, np.int64)
        assert (staged[off[k] + r] == -1).all()
        staged[off[k] + r] = v
        assert np.unique(off[k] + r).size == p.size, "staging slot reused"
        base = np.zeros(nb, np.int64)
        for kk in order(list(np.flatnonzero(cnt))):  # one atomic a bucket
            base[kk] = cursors[b, kk]
            cursors[b, kk] += cnt[kk]
        i = np.arange(staged.size)
        kk = staged >> (shift + 8)
        dst = kk * S + base[kk] + (i - off[kk])
        ok = dst < np.minimum((kk + 1) * S, n)
        assert (entries[b, dst[ok]] == -1).all(), "scratch entry written twice"
        entries[b, dst[ok]] = staged[ok] & ((1 << (shift + 8)) - 1)
    # launch 2: emit_place, a CTA a (row, bucket)
    out = np.full((B, N), -1, np.int64)
    for b, k in order([(b, k) for b in range(B) for k in range(nb)]):
        n = max(0, min(int(ns[b]), N))
        lo = k * S
        length = min(S, N - lo)
        region = max(min(S, n - lo), 0)
        if check:
            assert cursors[b, k] == region, "a region not filled exactly"
        cnt = min(int(cursors[b, k]), region)
        buf = np.zeros(S, np.int64)
        e = entries[b, lo:lo + cnt]
        assert (e >= 0).all(), "an entry read before it was written"
        buf[e >> 8] = e & 255
        if check:
            assert np.array_equal(np.sort(e >> 8), np.arange(cnt)), \
                "a destination written twice or never"
        assert (out[b, lo:lo + length] == -1).all()
        out[b, lo:lo + length] = buf[:length]
    assert (out >= 0).all(), "a lane of the output never written"
    return out.astype(np.uint8), primary


NONE = 2 ** 31 - 1
EMPTY = (-1, -1, 0, -1)  # the empty span: (fc, lc, cnt, hi)


def splits(r: int, x: int, y: int) -> int:
    """The lanes p in [x, y) with (p - r) % 255 == 0, r < x."""
    return (y - 1 - r) // MAXLEN - (x - 1 - r) // MAXLEN if y > x else 0


def seg_combine(a, b):
    """The kernel's combine of two adjacent spans (fc, lc, cnt, hi): fc
    and lc the first and last change (-1: none), cnt the starts in
    [fc, hi); hi = -1 the empty span."""
    if b[3] < 0:
        return a
    if a[3] < 0 or a[0] < 0:
        return b
    if b[0] < 0:
        return a[0], a[1], a[2] + splits(a[1], a[3], b[3]), b[3]
    return a[0], b[1], a[2] + splits(a[1], a[3], b[0]) + b[2], b[3]


def seg_tree_scan(xs):
    """Inclusive scan in the kernel's order of combines (shuffle-up steps
    of 1, 2, 4, ...)."""
    xs = list(xs)
    d = 1
    while d < len(xs):
        xs = [seg_combine(xs[i - d], xs[i]) if i >= d else xs[i]
              for i in range(len(xs))]
        d *= 2
    return xs


def seg_window_reduce(vals):
    """Warp 0's combine of a look-back window (lane i holds the tile i
    before the nearest): the shuffle-down tree, a higher lane on the
    left."""
    x = list(vals)
    d = 1
    while d < len(x):
        x = [seg_combine(x[i + d], x[i]) if i + d < len(x) else x[i]
             for i in range(len(x))]
        d *= 2
    return x[0]


def cta_scan(segs, warp: int = 32):
    """The kernel's cta_exclusive: each warp's shuffle-up scan, then the
    warps' totals scanned; (exclusive Seg a thread, the CTA's Seg)."""
    incl = []
    for w0 in range(0, len(segs), warp):
        incl += seg_tree_scan(segs[w0:w0 + warp])
    wincl = seg_tree_scan([incl[min(w0 + warp, len(segs)) - 1]
                           for w0 in range(0, len(segs), warp)])
    excl = []
    for j in range(len(segs)):
        w, lane = divmod(j, warp)
        before = wincl[w - 1] if w else EMPTY
        excl.append(seg_combine(before, incl[j - 1]) if lane else before)
    return excl, wincl[-1]


def new_token_state():
    """The scan's device state between calls: the tile descriptors (any
    content; epoch-tagged), the ticket (0 between calls), the epoch."""
    return {"desc": [], "ticket": 0, "epoch": 0}


def tokens_model(bwt, ns, threads: int, per: int, schedule=in_order,
                 window: int = 32, state=None, seen=None):
    """The token kernels at tiles of threads * per lanes: ``tok_scan``,
    its CTAs interleaved by ``schedule``, then ``tok_tail``.  Returns
    (tokens (B, N // 8) int32, run_counts (B,) int32)."""
    B, N = bwt.shape
    cap = N // 4
    T = threads * per
    tiles = max(-(-N // T), 1)
    st = state if state is not None else new_token_state()
    st["epoch"] += 1
    epoch = st["epoch"]
    while len(st["desc"]) < B * tiles:
        st["desc"].append((0, "X", None, None))
    seen = [] if seen is None else seen
    tok = np.full((B, cap), UNSET, np.uint16)
    counts = np.full(B, -1, np.int64)
    ns_c = [min(max(int(ns[b]), 0), N) for b in range(B)]
    rows = [bwt[b].astype(np.int64) for b in range(B)]

    def cta(k):
        """A CTA draws ticket k when it starts; its steps run later."""
        assert k == st["ticket"]
        st["ticket"] = 0 if k == B * tiles - 1 else k + 1
        return steps(k)

    def steps(k):
        t, b = divmod(k, B)
        n, row = ns_c[b], rows[b]
        tc = (n - 1 if n else 0) // T
        if t > tc:
            return  # lanes >= n only
        lo = t * T
        # the staging: the tile and HALO lanes past it, lanes < n only
        live = max(min(n - lo, T + HALO), 0)
        sb = np.zeros(T + HALO, np.int64)
        sb[:live] = row[lo:lo + live]
        pre = int(row[lo - 1]) if lo > 0 else -1
        # the first change in the halo's first 255 lanes
        halo = next((lo + T + i for i in range(MAXLEN)
                     if lo + T + i < n and sb[T + i] != sb[T + i - 1]), NONE)
        prev = np.concatenate([[pre], sb[:T - 1]])
        lanes = lo + np.arange(T)
        chg = (lanes < n) & ((lanes == 0) | (sb[:T] != prev))
        segs, changes = [], []
        for j in range(threads):
            first = lo + j * per
            hi = min(first + per, n)
            cs = [int(p) for p in lanes[j * per:(j + 1) * per][
                chg[j * per:(j + 1) * per]]]
            changes.append(cs)
            segs.append((cs[0], cs[-1], len(cs), hi) if cs else
                        (-1, -1, 0, hi))
        excl, tile = cta_scan(segs)
        desc, base = st["desc"], b * tiles
        if t == 0:
            publish(desc, base, epoch, "P", tile)
            before = EMPTY
        else:
            publish(desc, base + t, epoch, "A", tile)
            yield
            before = yield from look_back(desc, base, t, epoch, window, seen,
                                          seg_combine, EMPTY,
                                          seg_window_reduce)
            publish(desc, base + t, epoch, "P", seg_combine(before, tile))
        yield
        whole = seg_combine(before, tile)
        out0 = before[2]
        count = whole[2] - out0
        if t == tc:
            assert counts[b] == -1, "a row's count written twice"
            counts[b] = whole[2]
        # each start's index: the starts before its thread, its rank in it
        sp = [None] * T
        for j in range(threads):
            first = lo + j * per
            hi = min(first + per, n)
            starts = list(changes[j])
            opened = seg_combine(before, excl[j])
            if opened[3] >= 0 and first < hi:
                lead = changes[j][0] - first if changes[j] else hi - first
                d = (first - opened[1]) % MAXLEN
                q = MAXLEN - d if d else 0
                if q < lead:
                    starts.append(first + q)
            i = opened[2] - out0
            for p in sorted(starts):
                assert sp[i] is None, "a start's slot taken twice"
                sp[i] = p - lo
                i += 1
        assert all(v is not None for v in sp[:count]) and \
            all(v is None for v in sp[count:])
        yield
        # a thread a token: the length to the next start's lane
        for i in range(max(min(count, cap - out0), 0)):
            p = sp[i]
            nxt = sp[i + 1] if i + 1 < count else \
                min(halo, lo + p + MAXLEN, n) - lo
            ln = nxt - p
            assert 1 <= ln <= MAXLEN
            assert tok[b, out0 + i] == UNSET, "slot written twice"
            tok[b, out0 + i] = sb[p] << 8 | ln

    schedule([lambda k=k: cta(k) for k in range(B * tiles)])
    assert st["ticket"] == 0
    # tok_tail: the slots from the row's count up to the capacity
    for b in range(B):
        rest = tok[b, min(int(counts[b]), cap):]
        assert (rest == UNSET).all(), "slot written twice"
        rest[:] = 0
    assert not (tok == UNSET).any(), "a token slot never written"
    return tok.view(np.int32), counts.astype(np.int32)


def _smoke():
    """chip_smoke.py as a module: its emit_inputs makes the emits' inputs
    for designed rows on the card too."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _assert_tokens(got, want, ns):
    """(tokens, run_counts) pairs equal on the counts and on the tokens
    below min(count, N / 4)."""
    tg, cg = got
    tw, cw = want
    np.testing.assert_array_equal(cg, cw)
    cap = tw.shape[1] * 2
    for b in range(len(ns)):
        c = min(int(cw[b]), cap)
        np.testing.assert_array_equal(tg.view(np.uint16)[b, :c],
                                      tw.view(np.uint16)[b, :c], f"row {b}")


def _edge_blocks():
    """n = 0, 1 and 2 beside a full row, at the 8192 bucket."""
    rng = np.random.default_rng(30)
    sizes = (0, 1, 2, 8192, 3, 700, 0, 5000)
    return [rng.integers(0, 256, n, np.uint8) for n in sizes]


def _lyndon(blocks):
    """(rot, ns, ms) like test_torch_bwt2._batch, empty blocks as n = 0."""
    keep = [b if b.size else np.zeros(1, np.uint8) for b in blocks]
    rot, ns, ms = _batch(keep)
    for i, b in enumerate(blocks):
        if not b.size:
            rot[i] = 0
            ns[i] = ms[i] = 0
    return rot, ns, ms


@pytest.mark.skipif(not native.native_available(),
                    reason="needs native lyndon_prep")
@pytest.mark.parametrize("kind", TOKEN_KINDS + ["n_0_1_2"])
def test_emit_models_against_plain_and_jax(kind):
    """The models of both emits on the ISA of JAX's resolve loop, against
    the port's plain emits and JAX's emit_bytes and emit2, lanes < n."""
    blocks = _edge_blocks() if kind == "n_0_1_2" else _token_blocks(kind, 9)
    rot, ns, ms = _lyndon(blocks)
    isa = np.asarray(_j_resolve_loop(jnp.asarray(rot), jnp.asarray(ns)))
    bwt_m, prim_m = emit_bytes_model(rot, isa, ns, ms,
                                     rng=np.random.default_rng(33))
    bwt_p, prim_p = (to_numpy(t) for t in bwt2._emit_bytes(
        to_torch(rot), to_torch(isa), to_torch(ns), to_torch(ms)))
    bwt_j, prim_j = (np.asarray(a) for a in jbwt2.emit_bytes(
        jnp.asarray(rot), jnp.asarray(isa), jnp.asarray(ns),
        jnp.asarray(ms)))
    np.testing.assert_array_equal(prim_m, prim_p)
    np.testing.assert_array_equal(prim_m, prim_j)
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(bwt_m[b, :n], bwt_p[b, :n])
        np.testing.assert_array_equal(bwt_m[b, :n], bwt_j[b, :n])
        assert not bwt_m[b, n:].any()
    tok_m = tokens_model(bwt_m, ns, *CONFIGS[0])
    tok_p, raw_p, cnt_p, prim2_p = (to_numpy(t) for t in bwt2._emit2(
        to_torch(rot), to_torch(isa), to_torch(ns), to_torch(ms)))
    tok_j, raw_j, cnt_j, prim2_j = (np.asarray(a) for a in jbwt2.emit2(
        jnp.asarray(rot), jnp.asarray(isa), jnp.asarray(ns),
        jnp.asarray(ms)))
    _assert_tokens(tok_m, (tok_p, cnt_p), ns)
    _assert_tokens(tok_m, (tok_j, cnt_j), ns)
    np.testing.assert_array_equal(prim2_p, prim_m)
    np.testing.assert_array_equal(prim2_j, prim_m)
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(raw_p.view(np.uint8)[b, :n],
                                      bwt_m[b, :n])
        np.testing.assert_array_equal(raw_j.view(np.uint8)[b, :n],
                                      bwt_m[b, :n])


def designed_rows(kind: str, N: int, T: int):
    """BWT rows (B, N) uint8 and ns for the token kernels at tiles of T
    lanes: runs of 254, 255, 256, 510 and 511 across tile edges at
    several offsets, one run of the whole row, a run that touches n, a
    run from a tile's first lane, n = 0 and 1; or random rows whose run
    counts pass N / 4."""
    rng = np.random.default_rng(31)
    D = rng.integers(0, 256, (6, N), dtype=np.uint8)
    if kind == "over_capacity":
        D[1] = rng.integers(0, 2, N) + 60
        return D, np.array([N, N, N - 5, 1, 0, N // 2], np.int32)
    i, p = 0, 1
    while True:  # row 0: runs across the tile edges, one after another
        L = (254, 255, 256, 510, 511, 1)[i % 6]
        edge = (p // T + 1) * T
        lo = max(p, edge - (0, 1, 7, 254, 255, 300)[i % 6])
        if lo + L + 1 >= N:
            break
        D[0, lo:lo + L] = D[0, lo - 1] ^ 1
        D[0, lo + L] = D[0, lo] ^ 2
        p, i = lo + L + 1, i + 1
    D[1] = 7  # one run of the whole row
    D[2, N - 700:] = 3  # a run that touches n = N - 100
    D[3, T:T + 2 * MAXLEN + 1] = 9  # from a tile's first lane
    return D, np.array([N, N, N - 100, N, 0, 1], np.int32)


@pytest.mark.parametrize("config", CONFIGS,
                         ids=[f"{t}x{p}" for t, p in CONFIGS])
@pytest.mark.parametrize("kind", ["tile_edges", "over_capacity"])
def test_tokens_model_on_designed_rows(config, kind):
    """The token model at each tile against the port's plain emit and
    JAX's emit2 on rows made to cross its tile edges, and the emit_bytes
    model under the random permutations of chip_smoke.py's emit_inputs,
    which must write the designed rows."""
    threads, per = config
    N = 32768 if threads * per > 64 else 1024
    D, ns = designed_rows(kind, N, threads * per)
    blocks, isa, ns, ms = _smoke().emit_inputs(D, ns,
                                               np.random.default_rng(32))
    bwt_m, prim_m = emit_bytes_model(blocks, isa, ns, ms,
                                     rng=np.random.default_rng(34))
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(bwt_m[b, :n], D[b, :n])
    got = tokens_model(bwt_m, ns, threads, per)
    tok_p, cnt_p = (to_numpy(t) for t in bwt2._tokens_plain(
        to_torch(bwt_m), to_torch(ns)))
    _assert_tokens(got, (tok_p, cnt_p), ns)
    tok_j, _, cnt_j, prim_j = (np.asarray(a) for a in jbwt2.emit2(
        jnp.asarray(blocks), jnp.asarray(isa), jnp.asarray(ns),
        jnp.asarray(ms)))
    _assert_tokens(got, (tok_j, cnt_j), ns)
    np.testing.assert_array_equal(prim_j, prim_m)
    if kind == "over_capacity":
        assert (got[1][:3] > N // 4).all()
    else:
        assert got[1][1] == -(-N // MAXLEN)  # one run of N: split at 255


def test_model_constants_match_the_source():
    """The kernel's tile, halo and token length as the model takes them:
    the halo holds the next start after a tile's last one, and its first
    kMaxLen lanes are checked a thread a lane; emit_bytes'
    buckets and tiles: a row of MAX_N lanes has at most kMaxBuckets
    buckets, one a thread of bin_scan, a staged ISA << 8 | byte fits 31
    bits, and an entry's offset and byte fill its kEntry bits."""
    src = SRC.read_text()
    assert _const("kMaxLen") == MAXLEN <= CONFIGS[0][0]
    assert "constexpr int kTile = kThreads * kPer;" in src
    assert "const bool hit = tid < kMaxLen && q < n" in src
    assert MAXLEN <= HALO and HALO % 16 == 0 and CONFIGS[0][1] < MAXLEN
    assert "constexpr int kBinTile = kBinThreads * kBinPer;" in src
    assert "constexpr int kBucket = 1 << kBucketLog;" in src
    assert "constexpr unsigned kEntry = (1u << (kBucketLog + 8)) - 1u;" in src
    assert bwt2.MAX_N // BUCKET == _const("kMaxBuckets") <= \
        _const("kBinThreads")
    assert (bwt2.MAX_N - 1) << 8 | 255 < 2 ** 31
    assert "const int k = (int)(e >> (kBucketLog + 8));" in src
    assert "buf[x >> 8] = (uint8_t)x;" in src


@pytest.mark.parametrize("fn", ["_emit_bytes", "_emit2"])
def test_emit_wrappers_raise_for_a_cuda_tensor_without_nvcc(
        fn, tmp_path, monkeypatch):
    """A CUDA tensor (a fake one: no card here) reaches the emit kernels'
    build and raises; nothing falls back to the plain versions and no
    launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lbzip2_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    calls = []
    for name in ("_emit_bytes_plain", "_emit2_plain", "_tokens_plain"):
        monkeypatch.setattr(bwt2, name, lambda *a, _n=name: calls.append(_n))
    with FakeTensorMode():
        blocks = torch.zeros((2, 64), dtype=torch.uint8, device="cuda")
        isa = torch.zeros((2, 64), dtype=torch.int32, device="cuda")
        ns = torch.full((2,), 64, dtype=torch.int32, device="cuda")
        ms = torch.zeros(2, dtype=torch.int32, device="cuda")
    before = bwt2.emit_launches, bwt2.token_launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(bwt2, fn)(blocks, isa, ns, ms)
    assert (bwt2.emit_launches, bwt2.token_launches) == before
    assert not calls
    meta = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(bwt2, fn)(meta, isa, ns, ms)
