"""A numpy model of the one-launch CRC kernel (csrc/crc32.cu behind
lbzip2_tpu_torch/ops/crc.py) held against the JAX package's
crc32_device on the CPU, tolerance 0.

The model reads the wrapper's constants and tables, the values the
kernel is launched with: the tables built from the wrapper's matrices
and bit images (each entry the XOR of its byte's set bits' entries); the
block in virtual coordinates q = p + a (a its address mod 16, the bytes
before q = a zeros), the body below Eb = (a + n) & ~15 cut into segments
of ``crc._seg_bytes(n)`` from its end back, each segment in rounds of
warp chunks whose lanes take the vectors at 16 l and 512 + 16 l (a
32-byte leaf, its register from the positional tables), a lane's leaves
folded over the rounds, each lane's register taken to its warp chunk's
end by its own matrix and the warp's lanes XORed, each warp's register
advanced to the end by the matrices of its distance's
nonzero hex digits, the registers XORed with the tail's.  Every JAX
function is jitted once, at N = 1 MiB.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.crc import crc32_device as j_crc
from lbzip2_tpu_torch.ops import crc

N = 1 << 20
CSRC = pathlib.Path(crc.__file__).resolve().parent.parent / "csrc" / "crc32.cu"


def _span(words, v):
    """The XOR of words[..., i] over the set bits i of v."""
    bits = (v[..., None] >> np.arange(words.shape[-1])) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, words, 0), axis=-1)


def _one_digit(d):
    """(p, v) with d = v 16^p, v < 16."""
    p = (d.bit_length() - 1) // 4
    assert d == (d >> (4 * p)) << (4 * p) and d >> (4 * p) < 16
    return p, d >> (4 * p)


def _tables():
    """The tables the kernel builds in shared memory from the wrapper's
    4 KB: each entry the XOR of its byte's set bits' entries (the
    positional tables from the places' bit images, the byte tables of
    S^(16 << s) and S^(_ROUND) from the matrices' columns)."""
    t = crc._kernel_tables()
    nmat = crc._DIGITS * 15 * 32
    mats = t[:nmat].reshape(crc._DIGITS, 15, 32)
    basis = t[nmat:nmat + 256].reshape(32, 8)
    lane_mats = t[nmat + 256:].reshape(32, 32)             # [k, lane]
    v = np.arange(256, dtype=np.uint32)
    pos = _span(basis[None, :, :], v[:, None])            # (256, 32)
    p, d = _one_digit(crc._ROUND)  # S^(_ROUND) as one hex digit
    stride = _span(mats[p, d - 1].reshape(4, 8)[:, None, :], v[None, :])
    assert (pos == crc._leaf_tables().T).all()
    return (pos.astype(np.uint32), stride.astype(np.uint32), mats,
            lane_mats)


def _advance(tab, x):
    return (tab[0][x & 0xFF] ^ tab[1][(x >> 8) & 0xFF]
            ^ tab[2][(x >> 16) & 0xFF] ^ tab[3][x >> 24])


def _matrix_advance(mats, x, d):
    """x advanced by d zero bytes: the matrix of each nonzero hex digit
    of d, a column a set bit of x (the warp's XOR reduction)."""
    x = x.copy()
    lanes = np.arange(32, dtype=np.uint32)
    assert (d >> (4 * crc._DIGITS) == 0).all()
    for p in range(crc._DIGITS):
        v = (d >> (4 * p)) & 15
        bits = ((x[..., None] >> lanes) & 1).astype(bool)
        moved = np.bitwise_xor.reduce(
            np.where(bits, mats[p, np.maximum(v, 1) - 1], 0), axis=-1)
        x = np.where(v > 0, moved, x).astype(np.uint32)
    return x


def model_crc(block: np.ndarray, n: int, a: int) -> int:
    """The kernel's register of block[:n] for a block at address a mod
    16."""
    pos, stride, mats, lane_mats = _tables()
    E = a + n
    Eb, t = E & ~15, E & 15
    virtual = np.zeros(E, np.uint8)
    virtual[a:] = block[:n]
    seg = crc._seg_bytes(n)
    nsegs = max(1, -(-Eb // seg))
    assert nsegs <= crc._max_segments(n)
    warps, rounds = crc._THREADS // 32, seg // crc._ROUND
    lane, j = np.arange(32)[:, None], np.arange(32)[None, :]
    place = np.where(j < 16, 16 * lane + j, crc._HALF + 16 * lane + j - 16)
    off = (np.arange(rounds)[:, None, None, None] * crc._ROUND
           + np.arange(warps)[None, :, None, None] * crc._WARP_BYTES
           + place[None, None])                       # (R, W, lane, j)
    c = np.arange(nsegs)
    q = (Eb - (c + 1) * seg)[:, None, None, None, None] + off[None]
    assert q.max() < Eb
    data = np.where(q >= 0, virtual[np.clip(q, 0, max(E - 1, 0))]
                    if E else 0, 0).astype(np.intp)
    leaf = np.bitwise_xor.reduce(pos[data, np.arange(32)], axis=-1)
    acc = leaf[:, 0]                                   # (C, W, lane)
    for r in range(1, rounds):
        acc = _advance(stride, acc) ^ leaf[:, r]
    # lane l's matrix takes its register to the warp chunk's end, the
    # warp sums its lanes
    acc = np.bitwise_xor.reduce(_span(lane_mats.T, acc), axis=-1)
    d = (c[:, None] * seg + t
         + crc._WARP_BYTES * (warps - 1 - np.arange(warps))[None, :])
    reg = np.bitwise_xor.reduce(_matrix_advance(mats, acc, d), axis=None)
    for k in range(t):  # the tail, at distance t - 1 - k from the end
        if Eb + k >= a:
            reg ^= pos[virtual[Eb + k], 32 - t + k]
    return int(reg)


def _buffer(seed, size):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8)


S0 = crc._seg_bytes(N)
CASES = [(0, 0), (1, 0), (15, 0), (16, 0), (17, 0), (5 * S0 - 1, 0),
         (5 * S0, 0), (5 * S0 + 1, 0), (N, 0), (700001, 0), (17, 3),
         (5 * S0 + 1, 3), (N, 3)]


@pytest.mark.parametrize("n,a", CASES, ids=[f"n{n}_a{a}" for n, a in CASES])
def test_model_against_jax(n, a):
    """The model, the plain version (on the block as a view at offset a
    of a larger buffer) and JAX agree; bytes at and past n are random."""
    buf = _buffer(n + a, N + 16)
    block = buf[a:a + N]
    want = int(j_crc(jnp.asarray(block), n))
    assert model_crc(block, n, a) == want
    view = torch.from_numpy(buf)[a:a + N]
    assert int(crc.crc32_device(view, n)) == want


def test_garbage_past_n_is_ignored():
    """The same n over two blocks that differ only past n."""
    n = 3 * S0 + 5
    one = _buffer(7, N)
    two = one.copy()
    two[n:] = _buffer(8, N - n)
    assert model_crc(one, n, 0) == model_crc(two, n, 0) == \
        int(j_crc(jnp.asarray(two), n))


def test_leaf_rotation_reads_each_byte_at_its_place():
    """The kernel's leaf_crc in numpy: the leaf rotated by l bytes (words
    by l >> 2, bytes by l & 3 through a funnel shift), step i reading
    the rotated byte i at position (l + i) & 31: every lane reads each
    byte of its leaf once at its own position, and the 32 lanes of a
    step read 32 different banks."""
    pos = _tables()[0]
    rng = np.random.default_rng(3)
    leaves = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    banks = np.zeros((32, 32), np.int64)
    for lane in range(32):
        w = leaves[lane].view("<u4").astype(np.uint64)
        v, u = lane >> 2, 8 * (lane & 3)
        w = np.roll(w, -v)
        r = ((w | (np.roll(w, -1) << np.uint64(32))) >> np.uint64(u)) & \
            np.uint64(0xFFFFFFFF)
        acc, seen = 0, []
        for i in range(32):
            b = int(r[i >> 2] >> np.uint64(8 * (i & 3))) & 0xFF
            place = (lane + i) & 31
            assert b == leaves[lane, place]
            seen.append(place)
            acc ^= int(pos[b, place])
            banks[i, lane] = (b * 32 + place) % 32
        assert sorted(seen) == list(range(32))
        assert acc == int(np.bitwise_xor.reduce(
            pos[leaves[lane].astype(np.intp), np.arange(32)]))
    assert all(len(set(step)) == 32 for step in banks)


def test_segments_and_slots():
    """Whole rounds a segment, about _SEGMENTS segments at the 8 MiB
    limit, and slots enough at every alignment."""
    for n in (0, 1, 8191, 8192, 901120, N, 2 * N + 1, 8 << 20):
        seg = crc._seg_bytes(n)
        assert seg % crc._ROUND == 0 and seg >= crc._ROUND
        for a in range(16):
            Eb = (a + n) & ~15
            assert max(1, -(-Eb // seg)) <= crc._max_segments(n)
    assert crc._max_segments(8 << 20) <= crc._SEGMENTS + 1
    assert crc._seg_bytes(901120) == crc._ROUND
    assert 16 ** crc._DIGITS > (8 << 20) + 15  # every distance


def test_kernel_constants_match_the_wrapper():
    """csrc/crc32.cu's constants are the wrapper's (the launch checks the
    threads; the tables' layout is checked by their size at load)."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") == crc._THREADS
    assert const("kChunk") == crc._WARP_BYTES
    assert const("kDigits") == crc._DIGITS
    assert "crc_combine" not in src
