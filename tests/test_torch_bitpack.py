"""The port's bit packer (lbzip2_tpu_torch/ops/bitpack.py, kernel
csrc/bitpack.cu) against the JAX package's pack_bits_device and the
host BitWriter oracle, through the plain version on the CPU, at
tests/test_ops_bitpack.py's cases.  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.bitpack import pack_bits_device as j_pack
from lbzip2_tpu.ops.bitpack import pack_bits_host as j_pack_host
from lbzip2_tpu_torch.core.bits import pack_bits_be
from lbzip2_tpu_torch.ops import bitpack


def _check(values, lens, nf=None):
    values = np.asarray(values, np.uint32)
    lens = np.asarray(lens, np.int32)
    k = values.size if nf is None else nf
    ref = pack_bits_be(values[:k].astype(np.uint64),
                       lens[:k].astype(np.int64))
    got = bitpack.pack_bits_host(values, lens, nf, device="cpu")
    assert got == ref == j_pack_host(values, lens, nf)
    words, total = bitpack.pack_bits_device(
        torch.from_numpy(values.astype(np.int64)), torch.from_numpy(lens),
        k)
    jw, jt = j_pack(jnp.asarray(values), jnp.asarray(lens), jnp.int32(k))
    assert int(total) == int(jt) and words.dtype == torch.int64
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jw).astype(np.int64))


def test_simple_fields():
    _check([0b101, 0b1, 0b11110000], [3, 1, 8])


def test_zero_length_fields():
    _check([7, 0, 5, 0, 1], [3, 0, 3, 0, 1])


def test_full_width_words():
    _check([0xDEADBEEF, 0x12345678, 0xFFFFFFFF], [32, 32, 32])


def test_byte_padding_tail():
    _check([0x1FFF], [13])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_streams(seed):
    rng = np.random.default_rng(seed)
    n = 500
    lens = rng.integers(0, 25, n)
    values = np.array([rng.integers(0, 1 << m) if m else 0 for m in lens],
                      np.uint32)
    _check(values, lens)


def test_high_bits_above_the_length_are_dropped():
    """A value wider than its field keeps only its low nbits, as JAX's
    per-bit shift does."""
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 33, 3000)
    values = rng.integers(0, 1 << 32, 3000, dtype=np.uint64).astype(
        np.uint32)
    _check(values, lens)


def test_padded_capacity():
    """Fields beyond nf are ignored regardless of garbage contents."""
    _check([0b101, 0xFFFFFFFF, 0xFFFFFFFF], [3, 32, 32], nf=1)


def test_huffman_like_block():
    """~20k codes of 2..20 bits, a block payload's profile."""
    rng = np.random.default_rng(3)
    n = 20000
    lens = rng.integers(2, 21, n)
    values = (rng.integers(0, 1 << 20, n) & ((1 << lens) - 1)).astype(
        np.uint32)
    _check(values, lens)
