"""Two host faults the port copied from the JAX package's native wrapper,
repaired in lbzip2_tpu_torch/native/__init__.py (ROADMAP F9):
``itb_bwt_rot`` met itbwt.c's -7 (a row past 2^23 - 1 bytes) with an
assert, and ``_CollectArena.ensure`` reallocated every buffer, and could
shrink the output buffer, when only the block count grew."""

import numpy as np
import pytest

from lbzip2_tpu import native as jnative
from lbzip2_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs the native library")


def test_itb_bwt_rot_raises_for_a_row_past_23_bits():
    """A row of 2^23 bytes cannot be packed: a ValueError that says so,
    where the JAX package's wrapper stops on its assert.  Runs of 32
    bytes keep the B* suffixes few enough for itbwt.c to get that far."""
    vals = np.random.default_rng(1).integers(0, 256, 1 << 18, np.uint8)
    R = np.repeat(vals, 32)
    with pytest.raises(ValueError, match="23 bits"):
        native.itb_bwt_rot(R)
    with pytest.raises(AssertionError):
        jnative.itb_bwt_rot(R)


def test_itb_bwt_rot_still_matches_sais_and_raises_without_b_star():
    rng = np.random.default_rng(2)
    T = rng.integers(0, 4, 5000, np.uint8)
    R = np.empty_like(T)
    m = native.lyndon_prep(T, out=R)[1]
    want = (T.size - m) % T.size
    got, got_idx = native.itb_bwt_rot(R, want)
    exp, exp_idx = native.bwt_sais_rot(R, want)
    np.testing.assert_array_equal(got, exp)
    assert got_idx == exp_idx
    with pytest.raises(ValueError, match="no B"):
        native.itb_bwt_rot(np.full(10, 7, np.uint8))


def _arena():
    a = native._CollectArena()
    a.ensure(1000, 10)
    return a


@pytest.mark.parametrize("out_cap", [1000, 400])
def test_arena_grows_the_block_buffers_alone(out_cap):
    """More blocks, the same or a smaller output: the output buffer (and
    its warm pages) stays; the block buffers grow."""
    a = _arena()
    out = a.out_buf
    a.ensure(out_cap, 50)
    assert a.out_buf is out and a.out_buf.size == 1000
    assert a.starts.size == a.ends.size == a.out_lens.size == 50
    assert a.cmaps.size == 50 * 256


def test_arena_grows_the_output_alone_and_never_shrinks():
    a = _arena()
    starts = a.starts
    a.ensure(5000, 4)
    assert a.out_buf.size == 5000 and a.starts is starts
    out = a.out_buf
    a.ensure(10, 2)
    assert a.out_buf is out and a.starts is starts


def test_collect_through_a_grown_arena_equals_owning_copies():
    """A small-granule call (many blocks, little output) after a large
    one, through the thread's arena: the same blocks as owning copies."""
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, 300000, np.uint8)
    small = np.frombuffer(b"ab" * 20000, np.uint8)
    native.rle1_collect(big, 100000, 100000, reuse_arena=True)
    out = native._collect_arena.out_buf
    got = native.rle1_collect(small, 100000, 1000, reuse_arena=True)
    assert native._collect_arena.out_buf is out
    want = native.rle1_collect(small, 100000, 1000)
    assert len(got) == len(want) > 10
    for (s1, e1, b1, c1), (s2, e2, b2, c2) in zip(got, want):
        assert (s1, e1) == (s2, e2)
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(c1, c2)
