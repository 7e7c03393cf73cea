"""Port's entropy chain (lbzip2_tpu_torch/ops/{chain,rle2,huffenc}.py) vs
the JAX ops and the native C encoder.

Inputs are made with numpy from seeds and go through both packages via
lbzip2_tpu_torch.interop.  Tolerance: exact equality (integer outputs
and byte-identical payloads).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.core.constants import MAX_TREES
from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu.ops import huffenc as jhuff
from lbzip2_tpu.ops.rle2 import rle2_batch as j_rle2_batch
from lbzip2_tpu.ref.huffman import generate_initial_trees, num_trees_for
from lbzip2_tpu.ref.rle1 import transform_span
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import chain, huffenc
from lbzip2_tpu_torch.ops.rle2 import _rle2_batch

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")

WIDTH = chain.WIDTH


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _text(n, seed):
    """Word-level text from a fixed generated vocabulary."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 9, 300)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8)) + b" "
             for k in lens]
    p = 1.0 / np.arange(1, 301)
    idx = rng.choice(300, n // 3 + 10, p=p / p.sum())
    return np.frombuffer(b"".join(words[i] for i in idx)[:n], np.uint8)


def _raw(kind, n, rng):
    if kind == "text":
        return _text(n, int(rng.integers(1 << 30)))
    if kind == "narrow":
        return rng.integers(0, 4, n, dtype=np.uint8)
    if kind == "runs":
        return np.repeat(rng.integers(0, 255, n // 60 + 1, dtype=np.uint8),
                         60)[:n]
    if kind == "binary":
        return np.where(rng.random(n) < 0.93, 65, 66).astype(np.uint8)
    if kind == "skew3":
        return rng.choice(np.array([10] * 6 + [200, 201], np.uint8), n)
    return rng.integers(0, 256, n, dtype=np.uint8)


def _mk_blocks(specs, N=8192, seed=7):
    """specs: (n, kind) -> (bwt rows, ns, cmaps, idxs, crcs)."""
    B = len(specs)
    bwts = np.zeros((B, N), np.uint8)
    ns = np.zeros(B, np.int32)
    cmaps = np.zeros((B, 256), np.uint8)
    idxs = np.zeros(B, np.int32)
    crcs = np.zeros(B, np.uint32)
    rng = np.random.default_rng(seed)
    for i, (n, kind) in enumerate(specs):
        raw = _raw(kind, n, rng)
        blk, cmap = transform_span(raw)
        brow, bidx = native.bwt(blk)
        bwts[i, :blk.size] = brow
        ns[i] = blk.size
        cmaps[i] = np.asarray(cmap, np.uint8)
        idxs[i] = bidx
        crcs[i] = (native.crc32_block(raw) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    return bwts, ns, cmaps, idxs, crcs


MIXED = [(8000, "narrow"), (8000, "random"), (8000, "runs"),
         (5000, "text"), (4000, "binary"), (7001, "skew3"), (30, "text"),
         (2, "random")]


def test_compact_syms():
    rng = np.random.default_rng(1)
    bwt = rng.integers(0, 256, (4, 1000), dtype=np.uint8)
    cmaps = (rng.random((4, 256)) < [[0.9], [0.1], [0.5], [1.0]]).astype(
        np.uint8)
    _eq(chain._compact_syms(to_torch(bwt), to_torch(cmaps)),
        jchain._compact_syms(jnp.asarray(bwt), jnp.asarray(cmaps)))


@pytest.mark.parametrize("zero_p", [0.0, 0.5, 0.95, 1.0])
def test_rle2_batch(zero_p):
    rng = np.random.default_rng(2)
    B, N = 5, 4096
    ranks = np.where(rng.random((B, N)) < zero_p, 0,
                     rng.integers(1, 255, (B, N))).astype(np.int32)
    ns = np.array([N, 1, 0, 3333, 4095], np.int32)
    ninuse = np.array([255, 3, 1, 40, 200], np.int32)
    got = _rle2_batch(to_torch(ranks), to_torch(ns), to_torch(ninuse))
    want = j_rle2_batch(jnp.asarray(ranks), jnp.asarray(ns),
                        jnp.asarray(ninuse))
    for g, w in zip(got, want):
        _eq(g, w)


def _mtf_batch():
    bwts, ns, cmaps, _, _ = _mk_blocks(MIXED)
    return bwts, ns, cmaps


def test_chain_mtf2_and_group_hist():
    bwts, ns, cmaps = _mtf_batch()
    got = chain._chain_mtf2(to_torch(bwts), to_torch(ns), to_torch(cmaps))
    want = jchain.chain_mtf2(jnp.asarray(bwts), jnp.asarray(ns),
                             jnp.asarray(cmaps))
    for g, w in zip(got, want):  # mtfv, nm, hist, hist_g, ngroups
        _eq(g, w)
    mtfv, nm = got[0], got[1]
    ninuse = cmaps.sum(1, dtype=np.int32)
    got_g = chain._group_hist(mtfv, nm, to_torch(ninuse))
    want_g = jchain.group_hist(jnp.asarray(to_numpy(mtfv)),
                               jnp.asarray(to_numpy(nm)),
                               jnp.asarray(ninuse))
    for g, w in zip(got_g, want_g):  # hist, groups, ngroups
        _eq(g, w)


@pytest.mark.parametrize("maxlen", [20, 30])
def test_em_estep_hist(maxlen):
    """maxlen 30 overflows the 10-bit lanes: the wrap and the lane-2
    carry across the two words must match the JAX packing."""
    bwts, ns, cmaps = _mtf_batch()
    _, _, _, hist_g, ngroups = chain._chain_mtf2(
        to_torch(bwts), to_torch(ns), to_torch(cmaps))
    rng = np.random.default_rng(3)
    B = bwts.shape[0]
    lengths = rng.integers(1, maxlen + 1, (B, MAX_TREES, WIDTH)).astype(
        np.int32)
    nt = rng.integers(1, MAX_TREES + 1, B).astype(np.int32)
    got = chain._em_estep_hist(hist_g, ngroups, to_torch(nt),
                               to_torch(lengths))
    want = jchain.em_estep_hist(jnp.asarray(to_numpy(hist_g)),
                                jnp.asarray(to_numpy(ngroups)),
                                jnp.asarray(nt), jnp.asarray(lengths))
    for g, w in zip(got, want):
        _eq(g, w)


def _fib(limit):
    fib = [1, 1]
    while fib[-1] + fib[-2] < limit:
        fib.append(fib[-1] + fib[-2])
    return fib


def _code_length_case(case):
    """freqs (B, 6, WIDTH) uint32 and as (B,) int32: a row is one tree,
    its alphabet size that of its block."""
    if isinstance(case, int):  # ties (even) and spreads (odd)
        rng = np.random.default_rng(10 + case)
        B = 6
        as_arr = rng.integers(3, 259, B).astype(np.int32)
        as_arr[0] = 3 if case % 2 else 258
        freqs = np.zeros((B, MAX_TREES, WIDTH), np.uint32)
        hi = 6 if case % 2 == 0 else 100000
        for b in range(B):
            freqs[b, :, :as_arr[b]] = rng.integers(0, hi, (MAX_TREES,
                                                           as_arr[b]))
        return freqs, as_arr
    rng = np.random.default_rng(77)
    edge_as = np.array([0, 1, 2, 3, 4, 257, 258, 258], np.int32)
    if case == "small_and_full_alphabets":
        return rng.integers(0, 900000, (8, MAX_TREES, WIDTH)), edge_as
    if case == "all_equal":  # every comparison is a tie
        return np.full((8, MAX_TREES, WIDTH), 7), edge_as
    if case == "dead_rows":  # trees >= nt: no symbol counted
        return np.zeros((8, MAX_TREES, WIDTH)), edge_as
    if case == "wrap_at_256_leaves":  # the key keeps nleaf mod 256
        return rng.integers(0, 3, (4, MAX_TREES, WIDTH)), \
            np.array([256, 257, 258, 258], np.int32)
    assert case == "fibonacci"  # the deepest trees: the clamp at 30
    fib = _fib(2 ** 22)  # f << 9 stays below 2^31
    freqs = np.ones((4, MAX_TREES, WIDTH), np.int64)
    freqs[0, :, :len(fib)] = fib
    freqs[1, :, :len(fib)] = fib[::-1]
    freqs[2, :, 100:100 + len(fib)] = fib
    freqs[3] = 2 ** 20 - 1
    return freqs, np.array([len(fib), 258, 258, 258], np.int32)


@pytest.mark.parametrize("trial", [
    0, 1, 2, 3, "small_and_full_alphabets", "all_equal", "dead_rows",
    "wrap_at_256_leaves", "fibonacci"])
def test_make_code_lengths_rows(trial):
    """The plain version (what the CUDA kernel is held to on the card)
    against the JAX op and native/huffman2.c, exactly: ties, spreads
    and the edges (alphabets of 0 to 4, 257 and 258 symbols, all-equal
    and all-zero frequencies, the deepest trees)."""
    freqs, as_arr = _code_length_case(trial)
    freqs = np.asarray(freqs, np.uint32)
    B = freqs.shape[0]
    rows = freqs.reshape(-1, WIDTH).astype(np.int32)
    as_rows = np.repeat(as_arr, MAX_TREES).astype(np.int32)
    got = to_numpy(huffenc.make_code_lengths_rows(to_torch(rows),
                                                  to_torch(as_rows)))
    np.testing.assert_array_equal(
        got, np.asarray(jhuff.make_code_lengths_rows(rows, as_rows)))
    assert got.max() <= 30 and (trial != "fibonacci" or got.max() == 30)
    assert not got[np.arange(WIDTH)[None] >= as_rows[:, None]].any()
    ok = as_arr >= 2  # the C routine's domain
    lengths = np.ones((int(ok.sum()), MAX_TREES, WIDTH), np.uint8)
    native.em_mstep(freqs[ok], as_arr[ok],
                    np.full(int(ok.sum()), MAX_TREES, np.int32), lengths)
    got = got.reshape(B, MAX_TREES, WIDTH)[ok]
    for b, n in enumerate(as_arr[ok]):
        np.testing.assert_array_equal(got[b, :, :n], lengths[b, :, :n])


def test_make_code_lengths_wrapper_refuses_other_devices():
    """CPU tensors take the plain version; a CUDA tensor would launch
    the kernel; anything else raises (nothing falls back silently)."""
    with pytest.raises(ValueError, match="unsupported device"):
        huffenc.make_code_lengths_rows(
            torch.zeros((1, WIDTH), dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        huffenc.make_code_lengths_cuda(
            torch.zeros((1, WIDTH), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("cf", [1, 2, 8])
def test_em_chain(cf):
    bwts, ns, cmaps = _mtf_batch()
    mtfv, nm, hist, hist_g, ngroups = chain._chain_mtf2(
        to_torch(bwts), to_torch(ns), to_torch(cmaps))
    B = bwts.shape[0]
    nm_h = to_numpy(nm)
    as_arr = cmaps.sum(1, dtype=np.int32) + 2
    nt = np.array([num_trees_for(int(v)) for v in nm_h], np.int32)
    hist_h = np.where(np.arange(WIDTH)[None] < as_arr[:, None],
                      to_numpy(hist), 0)
    lengths = np.ones((B, MAX_TREES, WIDTH), np.int32)
    for b in range(B):
        lengths[b] = generate_initial_trees(hist_h[b].astype(np.int64),
                                            int(nm_h[b]), int(nt[b]))
        lengths[b, :, as_arr[b]:] = 0
    got = huffenc._em_chain(hist_g, ngroups, to_torch(nt),
                            to_torch(as_arr), to_torch(lengths), cf)
    want = jhuff.em_chain(jnp.asarray(to_numpy(hist_g)),
                          jnp.asarray(to_numpy(ngroups)), jnp.asarray(nt),
                          jnp.asarray(as_arr), jnp.asarray(lengths), cf)
    for g, w in zip(got, want):  # sel, freqs, lengths, iters
        _eq(g, w)


@pytest.mark.parametrize("W", [4096, 40])
def test_pack_groups(W):
    """W = 40 overflows: contributions past W land in the dump slot."""
    rng = np.random.default_rng(4)
    B, NP = 4, 2001
    ninuse = np.array([250, 3, 60, 17], np.int32)
    nm = np.array([2001, 57, 1000, 1], np.int32)
    mtfv = np.zeros((B, NP), np.int32)
    for b in range(B):
        mtfv[b, :nm[b] - 1] = rng.integers(0, ninuse[b] + 1, nm[b] - 1)
        mtfv[b, nm[b] - 1] = ninuse[b] + 1
    ngroups = (nm + 49) // 50
    G = (NP + 49) // 50
    sel = rng.integers(0, MAX_TREES, (B, G)).astype(np.int32)
    lens = rng.integers(1, 21, (B, MAX_TREES, WIDTH)).astype(np.int32)
    for b in range(B):
        lens[b, :, ninuse[b] + 2:] = 0
    codes = (rng.integers(0, 1 << 20, lens.shape) &
             ((1 << lens) - 1)).astype(np.uint32)
    start_bit = rng.integers(0, 32, B).astype(np.int32)
    words, total = chain._pack_groups(
        to_torch(mtfv), to_torch(nm), to_torch(ninuse), to_torch(ngroups),
        to_torch(sel), to_torch(codes), to_torch(lens),
        to_torch(start_bit), W)
    w_j, t_j = jchain.pack_groups(
        jnp.asarray(mtfv), jnp.asarray(nm), jnp.asarray(ninuse),
        jnp.asarray(ngroups), jnp.asarray(sel), jnp.asarray(codes),
        jnp.asarray(lens), jnp.asarray(start_bit), W)
    np.testing.assert_array_equal(to_numpy(words, like=np.uint32),
                                  np.asarray(w_j))
    _eq(total, t_j)


@pytest.mark.parametrize("F,base", [(1000, 0), (512, 700), (64, 5000)])
def test_flatten_words(F, base):
    rng = np.random.default_rng(5)
    B, W = 5, 300
    words = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(
        np.uint32)
    ends = np.cumsum(np.array([300, 0, 17, 250, 1], np.int32)).astype(
        np.int32)
    got = chain._flatten_words(to_torch(words), to_torch(ends), F, base)
    want = jchain._flatten_words(jnp.asarray(words), jnp.asarray(ends),
                                 F, base)
    np.testing.assert_array_equal(to_numpy(got, like=np.uint32),
                                  np.asarray(want))


SPECS = {
    "mixed": MIXED,
    "text": [(8192, "text"), (6000, "text"), (1, "text"), (777, "text")],
    "low_diversity": [(4000, "binary"), (7001, "binary"), (6000, "skew3"),
                      (8191, "binary")],
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_chain_payloads(name):
    """Port == JAX chain == native.encode_payload, byte for byte."""
    bwts, ns, cmaps, idxs, crcs = _mk_blocks(SPECS[name])
    got = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs)
    want_j = jchain.chain_payloads(jnp.asarray(bwts), ns, cmaps, idxs,
                                   crcs)
    assert got == want_j
    for i in range(len(got)):
        want = native.encode_payload(bwts[i, :ns[i]], cmaps[i],
                                     int(idxs[i]), int(crcs[i]), 8)
        assert got[i] == want, f"row {i}"


def test_chain_payloads_full_pack_and_overflow():
    bwts, ns, cmaps, idxs, crcs = _mk_blocks([(8000, "random"),
                                              (5000, "text")])
    full = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs,
                                _force_full_pack=True)
    times = {}
    small = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs,
                                 times=times)
    assert full == small
    assert {"wait_mtf", "wait_em", "finish_c", "wait_pack"} <= set(times)
    over = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs,
                                pack_w=64)
    assert over[0] is None and over[1] is None


def test_chain_padding_trigger_row():
    """The pinned late-heavy row whose padding-polluted initial split
    once diverged from the host encoder (tests/data)."""
    row = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "chain_padding_trigger.npy"))
    rows = np.zeros((1, 8192), np.uint8)
    rows[0, :row.size] = row
    cmaps = np.zeros((1, 256), np.uint8)
    cmaps[0, :6] = 1
    got = chain.chain_payloads(to_torch(rows),
                               np.array([row.size], np.int32), cmaps,
                               np.array([3], np.int32),
                               np.array([0xABCD1234], np.uint32))
    assert got[0] == native.encode_payload(row, cmaps[0], 3, 0xABCD1234, 8)
