"""A numpy model of the one-launch bit packer (csrc/bitpack.cu behind
lbzip2_tpu_torch/ops/bitpack.py) held against the JAX package's
pack_bits_device on the CPU, tolerance 0.

The model reads the wrapper's constants, the values the kernel is
launched with: tiles of ``_TILE`` = ``_THREADS`` x ``_PER`` fields (and
tiny tiles, to cross many), only the tiles up to field nf - 1's; each
tile's start bit the sum of the earlier tiles' bits (the look-back's
result); a thread's ``_PER`` fields packed MSB first through a 64-bit
accumulator into the tile's words from bit 32 of a zero word, before the
start bit is known (a word the thread covers whole stored, its edge
words ORed); the tile's words out, shifted by the start bit's offset in
its word, in any order of the tiles: a word the tile covers whole stored
once (asserted: no other tile writes it), a shared edge word ORed, only
when it holds a set bit; the total from the last tile.  Every JAX
function is jitted once, at N = 8192 fields.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.bitpack import pack_bits_device as j_pack
from lbzip2_tpu_torch.ops import bitpack

N = 8192
CSRC = (pathlib.Path(bitpack.__file__).resolve().parent.parent / "csrc"
        / "bitpack.cu")
M32 = 0xFFFFFFFF


def model_pack(values, lens, nf, threads=bitpack._THREADS,
               per=bitpack._PER, order_seed=None):
    """(words (N,) int64, total) as the kernel writes them; the tiles in
    ticket order, or shuffled by ``order_seed``."""
    n = values.size
    nf = min(max(nf, 0), n)
    tile = threads * per
    tiles = -(-nf // tile) if nf else 1
    pad = max(tiles * tile, n)  # the tiles' fields, 0 past n
    ln = np.zeros(pad, np.int64)
    ln[:nf] = lens[:nf]
    vals = np.zeros(pad, np.int64)
    vals[:n] = values.astype(np.int64) & M32
    ln, vals = ln[:tiles * tile], vals[:tiles * tile]
    sums = ln.reshape(tiles, tile).sum(1)
    starts = np.concatenate([[0], np.cumsum(sums)[:-1]])  # the look-back's
    words = np.zeros(n, np.int64)
    stored = np.zeros(n, bool)
    order = np.arange(tiles)
    if order_seed is not None:
        np.random.default_rng(order_seed).shuffle(order)
    for c in order:
        base, total = int(starts[c]), int(sums[c])
        sw = np.zeros(tile + 2, np.int64)  # 0, then the tile's bits
        covered = np.zeros(tile + 2, np.int64)  # threads storing a word
        tl = ln[c * tile:(c + 1) * tile].reshape(threads, per)
        tv = vals[c * tile:(c + 1) * tile].reshape(threads, per)
        offs = np.concatenate([[0], np.cumsum(tl.sum(1))[:-1]])
        for t in range(threads):  # packed from bit 32, before the start
            bits = int(tl[t].sum())  # bit is known
            if not bits:
                continue
            start = 32 + int(offs[t])
            w, nb, whole, acc = start >> 5, start & 31, start & 31 == 0, 0
            for L, v in zip(tl[t].tolist(), tv[t].tolist()):
                if L > 0:
                    acc = (acc << L) | (v & ((1 << L) - 1))
                    nb += L
                    if nb >= 32:
                        nb -= 32
                        word = (acc >> nb) & M32
                        if whole:
                            covered[w] += 1
                            sw[w] = word
                        else:
                            sw[w] |= word
                        w += 1
                        whole = True
            if nb:
                sw[w] |= (acc << (32 - nb)) & M32
        assert (covered <= 1).all(), "a thread stored a word twice"
        assert sw[0] == 0
        o = base & 31  # the words out, shifted right by o
        end = o + total
        for j in range((end + 31) >> 5):
            gw = (base >> 5) + j
            v = ((sw[j] << (32 - o)) & M32) | (sw[j + 1] >> o) if o else \
                sw[j + 1]
            if 32 * j >= o and 32 * j + 32 <= end:
                assert not stored[gw], f"word {gw} stored twice"
                assert words[gw] == 0, f"word {gw} stored over an OR"
                stored[gw] = True
                words[gw] = v
            elif v:
                assert not stored[gw], f"word {gw} ORed into a stored one"
                words[gw] |= v
    return words, int(starts[-1] + sums[-1])


def _jax(values, lens, nf):
    w, t = j_pack(jnp.asarray(values.astype(np.uint32)), jnp.asarray(lens),
                  jnp.int32(nf))
    return np.asarray(w).astype(np.int64), int(t)


def _random(seed, lo=0, hi=33):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, N).astype(np.int32)
    values = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.int64)
    return values, lens


def _case(name):
    tile = bitpack._TILE
    values, lens = _random(len(name))
    nf = N
    if name == "mid_word":  # every tile edge 7 bits into a word
        lens[:] = 5
        lens[0] = 7
    elif name == "word_edge":  # every tile edge on a word edge
        lens[:] = 5
    elif name == "zero_at_tile_ends":
        for c in range(1, N // tile):
            lens[c * tile - 5:c * tile + 5] = 0
        lens[:3] = 0
        lens[-3:] = 0
    elif name == "empty_tile":  # a tile of no bits: a word shared by three
        lens[tile:2 * tile] = 0
        lens[tile - 1] = 3
        lens[2 * tile] = 3
    elif name == "all_32_bits":
        lens[:] = 32
    elif name == "nf_below_n":
        nf = 3 * tile + 77
    elif name == "one_field":
        nf = 1
        lens[0] = 13
    elif name == "nf_zero":
        nf = 0
    return values, lens, nf


NAMES = ["mid_word", "word_edge", "zero_at_tile_ends", "empty_tile",
         "all_32_bits", "nf_below_n", "one_field", "nf_zero"]
TILES = {"kernel": (bitpack._THREADS, bitpack._PER), "tiny": (4, 2)}


@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("name", NAMES)
def test_model_against_jax(name, tiles):
    """The model (tiles in a shuffled order), the plain version and JAX
    agree on words and total bits."""
    values, lens, nf = _case(name)
    want_w, want_t = _jax(values, lens, nf)
    got_w, got_t = model_pack(values, lens, nf, *TILES[tiles],
                              order_seed=len(name))
    assert got_t == want_t
    np.testing.assert_array_equal(got_w, want_w)
    words, total = bitpack.pack_bits_device(
        torch.from_numpy(values), torch.from_numpy(lens), nf)
    assert int(total) == want_t
    np.testing.assert_array_equal(words.numpy(), want_w)


def _huffman_fields():
    """Every field that the reference encoder writes for a small text
    block (the 48-bit magic as 16 + 32 bits), and the block's bytes."""
    from lbzip2_tpu_torch.ref import encoder

    fields = []

    class Recorder(encoder.BitWriter):
        def put(self, value, nbits):
            super().put(value, nbits)
            if nbits > 32:
                fields.append((value >> 32, nbits - 32))
                value, nbits = value & M32, 32
            fields.append((value, nbits))

        def put_arrays(self, values, lengths):
            super().put_arrays(values, lengths)
            fields.extend(zip(np.asarray(values).tolist(),
                              np.asarray(lengths).tolist()))

    text = pathlib.Path(__file__).read_bytes()[:3000]
    block = np.frombuffer(text, np.uint8)
    cmap = np.zeros(256, bool)
    cmap[np.unique(block)] = True
    saved = encoder.BitWriter
    encoder.BitWriter = Recorder
    try:
        out = encoder.encode_block(block, cmap, 0x12345678)
    finally:
        encoder.BitWriter = saved
    values = np.array([v for v, _ in fields], np.int64)
    lens = np.array([n for _, n in fields], np.int32)
    return values, lens, out


@pytest.mark.parametrize("tiles", list(TILES))
def test_huffman_fields_of_a_text_block(tiles):
    """The fields of one text block, padded to N with garbage past nf:
    the model, the plain version and JAX give the block's bytes."""
    values, lens, out = _huffman_fields()
    nf = values.size
    assert 1000 < nf <= N
    gv, gl = _random(11)
    gv[:nf], gl[:nf] = values, lens
    want_w, want_t = _jax(gv, gl, nf)
    got_w, got_t = model_pack(gv, gl, nf, *TILES[tiles])
    assert got_t == want_t == 8 * len(out)
    np.testing.assert_array_equal(got_w, want_w)
    assert (got_w[:want_t // 32 + 1].astype(">u4").tobytes()
            [:len(out)]) == out


def test_kernel_constants_match_the_wrapper():
    """csrc/bitpack.cu's constants are the wrapper's (the launch checks
    both); the scan keeps no (N,) scratch and no second pass."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") == bitpack._THREADS
    assert const("kPer") == bitpack._PER
    for gone in ("scan_totals", "scan_blocks", "place_fields", "void* incl",
                 "void* sums"):
        assert gone not in src
