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
whatever the order.  The token kernels run in three launches over tiles of
threads * per lanes: each tile's last byte change; each tile's count of
token starts from the run start open at its left (the tiles before it,
then the threads before in it); then every start's token index (the
counts of the tiles before, the threads before) and length
min(next change, p + 255, n) - p (the first change right of a thread from
the threads after it and a halo of 255 lanes past the tile), stored when
below the capacity N / 4, the slots from the count to the capacity
zeroed a share a tile.  The model runs at the kernel's tile (read from
the source) and at tiny ones, so that runs cross many tile edges, and
checks that every token slot is written once.  Inputs are made with
numpy from seeds; every comparison is exact.
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


def tokens_model(bwt, ns, threads: int, per: int):
    """The token kernels row by row at tiles of threads * per lanes:
    (tokens (B, N // 8) int32, run_counts (B,) int32)."""
    B, N = bwt.shape
    cap = N // 4
    T = threads * per
    tiles = -(-N // T)
    tok = np.full((B, cap), UNSET, np.uint16)
    counts = np.zeros(B, np.int32)
    for b in range(B):
        row = bwt[b].astype(np.int32)
        n = max(0, min(int(ns[b]), N))
        isc = np.zeros(N, bool)  # byte changes, lanes < n only
        isc[:n] = True
        isc[1:n] = row[1:n] != row[:max(n - 1, 0)]
        C = np.flatnonzero(isc)

        def last_in(lo, hi):  # the last change in [lo, hi), or -1
            i = int(np.searchsorted(C, hi)) - 1
            return int(C[i]) if i >= 0 and C[i] >= lo else -1

        def first_in(lo, hi, none):  # the first change in [lo, hi)
            i = int(np.searchsorted(C, lo))
            return int(C[i]) if i < C.size and C[i] < hi else none

        def lanes(t, j):  # thread j's lanes of tile t below n
            first = t * T + j * per
            return range(first, min(first + per, t * T + T, n))

        def starts(t, j, rs):  # rs: the run start open at its left
            out = []
            for p in lanes(t, j):
                if isc[p]:
                    rs = p
                    out.append(p)
                elif (p - rs) % MAXLEN == 0:
                    out.append(p)
            return out

        def open_runs(t):  # the tiles before, then the threads before
            carry, out = max(last[:t], default=-1), []
            for j in range(threads):
                out.append(carry)
                carry = max(carry, last_in(t * T + j * per,
                                           t * T + (j + 1) * per))
            return out

        # launch 1: each tile's last change
        last = [last_in(t * T, t * T + T) for t in range(tiles)]
        # launch 2: each tile's starts
        cnt = []
        for t in range(tiles):
            rs = open_runs(t)
            cnt.append(sum(len(starts(t, j, rs[j])) for j in range(threads)))
        total = sum(cnt)
        counts[b] = total
        # launch 3: the tokens, then a share of [total, cap) zeroed a tile
        share = -(-max(cap - total, 0) // tiles)
        for t in range(tiles):
            if t * T < n:
                rs = open_runs(t)
                halo = first_in(t * T + T, t * T + T + MAXLEN, n)
                idx = sum(cnt[:t])
                for j in range(threads):
                    end = t * T + (j + 1) * per
                    right = first_in(end, t * T + T, halo)
                    for p in starts(t, j, rs[j]):
                        ln = min(first_in(p + 1, end, right), p + MAXLEN,
                                 n) - p
                        assert 1 <= ln <= MAXLEN
                        if idx < cap:
                            assert tok[b, idx] == UNSET, "slot written twice"
                            tok[b, idx] = row[p] << 8 | ln
                        idx += 1
            z0 = total + t * share
            zeroed = tok[b, z0:min(z0 + share, cap)]
            assert (zeroed == UNSET).all(), "slot written twice"
            zeroed[:] = 0
        assert not (tok[b] == UNSET).any(), "a token slot never written"
    return tok.view(np.int32), counts


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
    """The kernel's tile and token length as the model takes them, and a
    halo of kMaxLen lanes needs no more than a CTA's threads; emit_bytes'
    buckets and tiles: a row of MAX_N lanes has at most kMaxBuckets
    buckets, one a thread of bin_scan, a staged ISA << 8 | byte fits 31
    bits, and an entry's offset and byte fill its kEntry bits."""
    src = SRC.read_text()
    assert _const("kMaxLen") == MAXLEN <= CONFIGS[0][0]
    assert "constexpr int kTile = kThreads * kPer;" in src
    assert "if (tid < kMaxLen && q < n" in src
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
