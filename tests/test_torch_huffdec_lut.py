"""A numpy model of the Huffman group-decode kernel
(lbzip2_tpu_torch/csrc/huffdec.cu) against the plain version and JAX.

The kernel keeps the JAX step (20 compares for the code length, a
signed shift for the slot) only as an escape: a table of each tree's
10-bit prefixes holds (length, symbol) wherever both agree at the two
ends of the prefix's range, and each group reads its bits through a
64-bit buffer refilled a word at a time, the last word repeated past the
window.  The model does the same, row for row, and must equal
``decode_groups_plain`` and the JAX ``decode_groups`` on every lane:
real blocks of bzip2's and lbzip2's layout, a block whose trees use all
20 code lengths, unordered arbitrary tables, cursors past the window
and negative starts.  The kernel itself is held against the plain
version on the card by chip_smoke.py.
"""

import bz2
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.ops import huffdec as jhuff
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch.ops import huffdec
from lbzip2_tpu_torch.parallel.decode import block_payloads

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")

M32 = 0xFFFFFFFF
K = huffdec.LUT_BITS
SPAN = 20 - K
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _length_slot(v, t, base, count):
    """The JAX step: (k, slot) of the 20-bit windows v (int64) under the
    trees t; the slot in int64, the difference shifted as int32."""
    b = base.view(np.uint32).astype(np.int64)[t]              # (n, 22)
    k = 1 + (v[:, None] >= b[:, 2:]).sum(1)
    d = (v - b[np.arange(v.size), k]) & M32
    d = d - ((d >> 31) << 32)
    return k, count.astype(np.int64)[t, k] + (d >> (20 - k))


def lut_table(base, count, perm):
    """The kernel's huff_lut: (nt, 2^K) uint16 entries, symbol << 5 |
    length where (length, slot) agree at both ends of the entry's range
    and the symbol fits 11 bits, else 0 (escape)."""
    nt = base.shape[0]
    e = np.tile(np.arange(1 << K, dtype=np.int64), nt)
    t = np.repeat(np.arange(nt), 1 << K)
    lo = e << SPAN
    k_lo, s_lo = _length_slot(lo, t, base, count)
    k_hi, s_hi = _length_slot(lo + (1 << SPAN) - 1, t, base, count)
    sym = perm.astype(np.int64)[t, np.clip(s_lo, 0, 257)]
    ok = (k_lo == k_hi) & (s_lo == s_hi) & (sym >= 0) & (sym < 2048)
    return np.where(ok, sym << 5 | k_lo, 0).astype(np.uint16).reshape(
        nt, 1 << K)


def _decode_v(v, t, lut, base, count, perm):
    """(k, sym) of windows v: the table, or the JAX step on escapes."""
    e = lut[t, v >> SPAN].astype(np.int64)
    k, sym = e & 31, e >> 5
    esc = e == 0
    if esc.any():
        ke, se = _length_slot(v[esc], t[esc], base, count)
        k[esc] = ke
        sym[esc] = perm.astype(np.int64)[t[esc], np.clip(se, 0, 257)]
    return k, sym


def lut_decode(words, starts, trees, base, count, perm):
    """The kernel's huffdec, all groups at once: a bit buffer a group
    for starts >= 0, the clipped two-word read of every step for the
    rest.  Returns (syms (G, 50) int32, end (G,) int32, escapes)."""
    lut = lut_table(base, count, perm)
    W = words.size
    w = words.view(np.uint32).astype(np.uint64)
    nt = base.shape[0]
    t = np.clip(trees.astype(np.int64), 0, nt - 1)
    p = starts.astype(np.int64)
    fast = p >= 0

    def word(i):
        return w[np.minimum(i, W - 1)]

    q = np.where(fast, p >> 5, 0)
    o = (p & 31).astype(np.uint64)
    buf = (word(q) << np.uint64(32) | word(q + 1)) << o
    nb = 64 - (p & 31)
    ahead = word(q + 2)
    nxt = q + 3
    syms = np.empty((p.size, 50), np.int64)
    escapes = 0
    for s in range(50):
        v = (buf >> np.uint64(44)).astype(np.int64)
        # the clipped read (negative starts): each index clipped alone
        oc = (p & 31).astype(np.uint64)
        w0 = w[np.clip(p >> 5, 0, W - 1)]
        w1 = w[np.clip((p >> 5) + 1, 0, W - 1)]
        vc = np.where(oc == 0, w0, ((w0 << oc) | (w1 >> (np.uint64(32) - oc)))
                      & np.uint64(M32)) >> np.uint64(12)
        v = np.where(fast, v, vc.astype(np.int64))
        escapes += int((lut[t, v >> SPAN] == 0).sum())
        k, syms[:, s] = _decode_v(v, t, lut, base, count, perm)
        buf = buf << k.astype(np.uint64)
        nb = nb - k
        p = p + k
        refill = nb < 32
        buf = np.where(refill, buf | ahead << (32 - nb).clip(0).astype(
            np.uint64), buf)
        nb = np.where(refill, nb + 32, nb)
        ahead = np.where(refill, word(nxt), ahead)
        nxt = np.where(refill, nxt + 1, nxt)
    return syms.astype(np.int32), p.astype(np.int32), escapes


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _text(n, seed=5):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(2, 9, 300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 4))[:n]


def _stream(kind):
    rng = np.random.default_rng(0)
    if kind == "deep_codes":  # six trees, every code length 1 to 20
        return _smoke().deep_codes_stream(0)[0]
    if kind == "long_codes":
        vals = np.where(rng.random(80000) < 0.995, 120,
                        rng.integers(0, 256, 80000)).astype(np.uint8)
        return bz2.compress(vals.tobytes(), 9)
    if kind == "uniform_bytes":  # an alphabet of 258, codes of 8 and 9
        return bz2.compress(rng.integers(0, 256, 60000,
                                         dtype=np.uint8).tobytes(), 9)
    if kind == "one_symbol":
        return bz2.compress(b"zzz", 9)
    if kind == "lbzip2_text":  # lbzip2's byte-aligned layout
        return compress_parallel(_text(200000), 9)
    return bz2.compress(_text(200000), 9)  # bzip2's own layout


def _jax(inputs):
    words, starts, trees, base, count, perm = inputs
    s, e = jhuff.decode_groups(words.view(np.uint32), starts, trees,
                               base.view(np.uint32), count, perm)
    return np.asarray(s), np.asarray(e)


def _plain(inputs):
    s, e = huffdec.decode_groups_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs))
    return s.numpy(), e.numpy()


def _check(inputs):
    """Model == plain == JAX on every lane; returns the escapes."""
    m_syms, m_end, esc = lut_decode(*inputs)
    for syms, end in (_plain(inputs), _jax(inputs)):
        np.testing.assert_array_equal(m_syms, syms)
        np.testing.assert_array_equal(m_end, end)
    return esc


@pytest.mark.parametrize("kind", ["bz2_text", "lbzip2_text", "long_codes",
                                  "uniform_bytes", "one_symbol",
                                  "deep_codes"])
def test_model_matches_plain_and_jax_on_real_blocks(kind):
    blob = _stream(kind)
    arr = np.frombuffer(blob, np.uint8)
    for pos in block_payloads(blob):
        err, _, meta, inputs = huffdec.group_inputs(arr, arr.size * 8, pos)
        assert err == 0
        esc = _check(inputs)
        if kind.endswith("text"):  # short codes: the table decodes them
            assert esc < 0.01 * meta["ngroups"] * 50, esc


def test_deep_codes_stream_uses_every_length_and_six_trees():
    blob, data = _smoke().deep_codes_stream(0)
    assert bz2.decompress(blob) == data
    arr = np.frombuffer(blob, np.uint8)
    err, _, meta, inputs = huffdec.group_inputs(arr, arr.size * 8, 112)
    assert err == 0 and meta["ntrees"] == 6
    words, starts, trees, base, count, perm = inputs
    # the lengths each group's symbols took: the cursor steps
    lengths = set()
    p = starts.astype(np.int64)
    syms, _, _ = lut_decode(*inputs)
    for s in range(50):
        w = words.view(np.uint32).astype(np.uint64)
        c = np.clip(p >> 5, 0, words.size - 1)
        o = (p & 31).astype(np.uint64)
        v = np.where(o == 0, w[c], ((w[c] << o) | (w[np.minimum(
            c + 1, words.size - 1)] >> (np.uint64(32) - o))) & np.uint64(
            M32)) >> np.uint64(12)
        k, _ = _length_slot(v.astype(np.int64), trees.astype(np.int64),
                            base, count)
        live = np.arange(p.size) * 50 + s < meta["nsyms"]
        lengths |= {(int(t), int(x)) for t, x in zip(trees[live], k[live])}
        p = p + k
    assert lengths == {(t, k) for t in range(6) for k in range(1, 21)}


@pytest.mark.parametrize("seed", [0, 1])
def test_model_on_unordered_arbitrary_tables(seed):
    """The tables of test_arbitrary_tables_match_jax: lanes where
    v < base (the signed shift), slots clipped at both ends; most
    entries escape, and those that do not still decode exactly.  Some
    starts are negative, down to -3000: their two words are clipped
    into the window each on its own."""
    rng = np.random.default_rng(seed)
    nt, G, W = 6, 512, 300
    base = rng.integers(0, 2**20 + 2**18, (nt, 22)).astype(np.uint32)
    base[:, 21] = 2**20
    starts = rng.integers(0, 32 * W, G).astype(np.int32)
    starts[::7] = -rng.integers(1, 3000, starts[::7].size)
    inputs = (rng.integers(0, 2**32, W, dtype=np.uint64).astype(
        np.uint32).view(np.int32), starts,
        rng.integers(0, nt, G).astype(np.int32), base.view(np.int32),
        rng.integers(-300, 300, (nt, 22)).astype(np.int32),
        rng.integers(0, 258, (nt, 258)).astype(np.int32))
    _check(inputs)


@pytest.mark.parametrize("seed", [0, 1])
def test_table_entries_hold_over_their_whole_range(seed):
    """Every entry that does not escape gives the JAX step's length and
    symbol for each of the 2^10 windows it covers (all 2^20 windows of
    six trees, ordered real tables and unordered random ones)."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        arr = np.frombuffer(_stream("deep_codes"), np.uint8)
        _, _, _, (_, _, _, base, count, perm) = huffdec.group_inputs(
            arr, arr.size * 8, 112)
    else:
        base = rng.integers(0, 2**20 + 2**18, (6, 22)).astype(
            np.uint32).view(np.int32)
        base.view(np.uint32)[:, 21] = 2**20
        count = rng.integers(-300, 300, (6, 22)).astype(np.int32)
        perm = rng.integers(0, 2100, (6, 258)).astype(np.int32)
    lut = lut_table(base, count, perm)
    for t in range(6):
        hits = 0
        for v in np.arange(1 << 20, dtype=np.int64).reshape(16, -1):
            k, slot = _length_slot(v, np.full(v.size, t), base, count)
            sym = perm.astype(np.int64)[t, np.clip(slot, 0, 257)]
            e = lut[t, v >> SPAN].astype(np.int64)
            hit = e != 0
            np.testing.assert_array_equal(e[hit] & 31, k[hit])
            np.testing.assert_array_equal(e[hit] >> 5, sym[hit])
            hits += int(hit.sum())
        assert 0 < hits < 1 << 20  # both kinds of entry occur


def test_model_on_cursors_past_the_window_and_negative_starts():
    """Starts near and past the window's end read the last word
    repeated (JAX's clipped gathers), offset 0 takes one word, and a
    negative start takes the clipped read of every step."""
    rng = np.random.default_rng(8)
    arr = np.frombuffer(_stream("bz2_text"), np.uint8)
    _, _, _, (words, starts, trees, base, count, perm) = \
        huffdec.group_inputs(arr, arr.size * 8, 112)
    W = words.size
    starts = np.concatenate([
        rng.integers(0, 32 * W + 4000, 64),
        [0, 32, 32 * W - 1, 32 * W, 32 * W + 31, -1, -33, -1000]]).astype(
        np.int32)
    trees = rng.integers(0, int(trees.max()) + 1, starts.size).astype(
        np.int32)
    _check((words, starts, trees, base, count, perm))
