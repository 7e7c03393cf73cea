"""Port's Huffman group decode (lbzip2_tpu_torch/ops/huffdec.py) vs the
JAX ops on the CPU.

``decode_groups_plain`` must equal the JAX ``decode_groups`` on every
lane of syms and end (garbage lanes past EOB included), and the port's
``decode_block_device(..., device="cpu")`` must equal the JAX
``decode_block_device`` and ``native.retrieve_block``, error codes
included; all exact.  The CUDA kernel is held against the plain version
on the card by chip_smoke.py.
"""

import bz2

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

CPU = torch.device("cpu")


def _text(n, seed=5):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(2, 9, 300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 4))[:n]


def _stream(kind):
    rng = np.random.default_rng(0)
    if kind == "narrow_alphabet":
        return bz2.compress(bytes(rng.integers(97, 101, 50000,
                                               dtype=np.uint8)), 9)
    if kind == "long_codes":  # skewed: deep codes, the >10-bit path
        vals = np.where(rng.random(80000) < 0.995, 120,
                        rng.integers(0, 256, 80000)).astype(np.uint8)
        return bz2.compress(vals.tobytes(), 9)
    if kind == "runs_multi_tree":
        data = np.repeat(rng.integers(0, 256, 4000, dtype=np.uint8),
                         rng.integers(1, 40, 4000))
        return bz2.compress(data.tobytes(), 9)
    if kind == "tiny":
        return bz2.compress(b"abracadabra", 9)
    if kind == "one_symbol":
        return bz2.compress(b"zzz", 9)
    if kind == "compress_parallel_text":  # lbzip2's byte-aligned layout
        return compress_parallel(_text(60000), 9)
    return bz2.compress(_text(60000), 9)  # bzip2's own layout


KINDS = ["narrow_alphabet", "long_codes", "runs_multi_tree", "tiny",
         "one_symbol", "compress_parallel_text", "bz2_text"]


@pytest.mark.parametrize("kind", KINDS)
def test_decode_groups_plain_matches_jax(kind):
    blob = _stream(kind)
    arr = np.frombuffer(blob, np.uint8)
    pos = block_payloads(blob)[0]
    err, _, meta, inputs = huffdec.group_inputs(arr, arr.size * 8, pos)
    assert err == 0
    words, starts, trees, base, count, perm = inputs
    j_syms, j_end = jhuff.decode_groups(
        words.view(np.uint32), starts, trees, base.view(np.uint32), count,
        perm)
    p_syms, p_end = huffdec.decode_groups(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs))
    assert p_syms.shape == (meta["ngroups"], huffdec.GROUP_SIZE)
    np.testing.assert_array_equal(p_syms.numpy(), np.asarray(j_syms))
    np.testing.assert_array_equal(p_end.numpy(), np.asarray(j_end))


@pytest.mark.parametrize("kind", KINDS)
def test_decode_block_device_matches_jax_and_host(kind):
    blob = _stream(kind)
    arr = np.frombuffer(blob, np.uint8)
    for pos in block_payloads(blob):
        got = huffdec.decode_block_device(arr, arr.size * 8, pos, CPU)
        jax_ = jhuff.decode_block_device(arr, arr.size * 8, pos)
        host = native.retrieve_block(arr, arr.size * 8, pos)
        assert got[0] == 0
        for want in (jax_, host):
            assert (got[0], got[1], got[3], got[4]) == \
                (want[0], want[1], want[3], want[4])
            np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("offset", [14, 30, 60, 400, 2000, 9000])
def test_corrupt_block_error_matches_jax(offset):
    blob = bytearray(_stream("bz2_text"))
    blob[offset] ^= 0x10
    arr = np.frombuffer(bytes(blob), np.uint8)
    got = huffdec.decode_block_device(arr, arr.size * 8, 112, CPU)
    want = jhuff.decode_block_device(arr, arr.size * 8, 112)
    assert (got[0], got[1], got[3], got[4]) == \
        (want[0], want[1], want[3], want[4])
    if got[0] == 0:
        np.testing.assert_array_equal(got[2], want[2])


def test_garbage_cursors_past_the_window():
    """Cursors starting near and past the window's end read the last
    word (JAX's clipped gathers), and offset 0 takes one word."""
    rng = np.random.default_rng(8)
    blob = _stream("bz2_text")
    arr = np.frombuffer(blob, np.uint8)
    _, _, _, (words, starts, trees, base, count, perm) = \
        huffdec.group_inputs(arr, arr.size * 8, 112)
    W = words.size
    starts = np.concatenate([
        rng.integers(0, 32 * W + 4000, 64), [0, 32, 32 * W - 1, 32 * W,
                                             32 * W + 31]]).astype(np.int32)
    trees = rng.integers(0, int(trees.max()) + 1, starts.size).astype(
        np.int32)
    j_syms, j_end = jhuff.decode_groups(
        words.view(np.uint32), starts, trees, base.view(np.uint32), count,
        perm)
    p_syms, p_end = huffdec.decode_groups_plain(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (words, starts, trees, base, count, perm)))
    np.testing.assert_array_equal(p_syms.numpy(), np.asarray(j_syms))
    np.testing.assert_array_equal(p_end.numpy(), np.asarray(j_end))


@pytest.mark.parametrize("seed", [0, 1])
def test_arbitrary_tables_match_jax(seed):
    """Unordered bases: v < base[k] on many lanes, where JAX shifts the
    wrapped difference as a negative int32 (u32 >> int32 promotes to
    int32) and clips the slot.  base[21] = 2^20 keeps k in 1..20, as the
    boundary walk's tables do."""
    rng = np.random.default_rng(seed)
    nt, G, W = 6, 512, 300
    words = rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
    base = rng.integers(0, 2**20 + 2**18, (nt, 22)).astype(np.uint32)
    base[:, 21] = 2**20
    count = rng.integers(-300, 300, (nt, 22)).astype(np.int32)
    perm = rng.integers(0, 258, (nt, 258)).astype(np.int32)
    starts = rng.integers(0, 32 * W, G).astype(np.int32)
    trees = rng.integers(0, nt, G).astype(np.int32)
    j_syms, j_end = jhuff.decode_groups(words, starts, trees, base, count,
                                        perm)
    p_syms, p_end = huffdec.decode_groups_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            words.view(np.int32), starts, trees, base.view(np.int32), count,
            perm)))
    np.testing.assert_array_equal(p_syms.numpy(), np.asarray(j_syms))
    np.testing.assert_array_equal(p_end.numpy(), np.asarray(j_end))


def test_wrapper_refuses_other_devices_and_counts_no_cpu_launch():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        huffdec.decode_groups(z, z, z, z, z, z)
    with pytest.raises(ValueError):
        huffdec.decode_groups_cuda(z, z, z, z, z, z)
    before = huffdec.launches
    blob = _stream("tiny")
    arr = np.frombuffer(blob, np.uint8)
    assert huffdec.decode_block_device(arr, arr.size * 8, 112, CPU)[0] == 0
    assert huffdec.launches == before
