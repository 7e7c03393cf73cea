"""The bucketed emit of the BWT bytes (lbzip2_tpu_torch/csrc/bwt2_emit.cu:
``emit_bin`` then ``emit_place``) as a numpy model, held exactly against
the port's plain ``_emit_bytes`` and the JAX package's ``emit_bytes``.

The model (``test_torch_emit_kernel.emit_bytes_model``) runs the
kernels' CTAs in a random order: ``emit_bin`` ranks a tile's lanes in
their bucket in the order its shared atomics land, scans the counts,
stages the lanes, reserves a run of each bucket's region with one
atomic and stores ``(ISA mod S) << 8 | byte``; ``emit_place`` puts a
bucket's bytes into a zeroed buffer of S and stores it whole.  It runs
at the kernel's bucket S and tile T (read from the source) and at tiny
ones, so that rows cross many bucket and tile edges, on rows of n = 0,
1, 2, S - 1, S, S + 1, 2S + 17 and N under random permutations, on the
port's resolve loop's ISA of F8's row (16 values, FF FF FF FF 01 first)
and of rows of the 8192 bucket, and on a row of 8192 buckets.  It asserts
that every region is filled exactly, that every destination is written
once, the primaries, and that an ISA which is no permutation never has
an entry stored outside its bucket's region.  Inputs are made with
numpy from seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2
from test_torch_emit_kernel import (BIN_TILE, BUCKET, _lyndon, _smoke,
                                    emit_bytes_model)

# (S, T): the kernel's buckets and tiles, and tiny ones
SIZES = {"kernel": (BUCKET, BIN_TILE), "tiny": (16, 8)}


def _edge_rows(S: int, seed: int):
    """Random BWT rows (B, N) and ns at the bucket edges: n = 0, 1, 2,
    S - 1, S, S + 1, 2S + 17 and N = 3S + 8 (the last bucket partial)."""
    N = 3 * S + 8
    rng = np.random.default_rng(seed)
    D = rng.integers(0, 256, (8, N), dtype=np.uint8)
    ns = np.array([0, 1, 2, S - 1, S, S + 1, 2 * S + 17, N], np.int32)
    return D, ns


def _f8_and_bucket_rows():
    """Eight blocks for the resolve loop: F8's row (16 values, FF FF FF
    FF 01 first, 00 00 at 1000) and rows of the 8192 bucket, n = 0, 1,
    2, 8192, 100, 8191 and 3."""
    rng = np.random.default_rng(40)
    ff = (rng.integers(0, 16, 6000) + 0x40).astype(np.uint8)
    ff[:5] = (0xFF, 0xFF, 0xFF, 0xFF, 1)
    ff[1000:1002] = 0
    return [ff] + [rng.integers(0, 256, n, np.uint8)
                   for n in (0, 1, 2, 8192, 100, 8191, 3)]


def _inputs(kind: str, S: int):
    """(blocks, isa, ns, ms) on the host, and the designed rows (or
    None where the ISA comes from the resolve loop)."""
    if kind == "bucket_edges":
        D, ns = _edge_rows(S, 41)
        return _smoke().emit_inputs(D, ns, np.random.default_rng(42)), D
    rot, ns, ms = _lyndon(_f8_and_bucket_rows())
    # the port's loop: one pass always, so F8's row leaves it resolved
    # (JAX's loop leaves that row's first suffix past the pads)
    isa = to_numpy(bwt2._resolve_loop(to_torch(rot), to_torch(ns)))
    return (rot, isa, ns, ms), None


def _plain_and_jax(blocks, isa, ns, ms):
    got_p = tuple(to_numpy(t) for t in bwt2._emit_bytes_plain(
        *(to_torch(a) for a in (blocks, isa, ns, ms))))
    got_j = tuple(np.asarray(a) for a in jbwt2.emit_bytes(
        *(jnp.asarray(a) for a in (blocks, isa, ns, ms))))
    return got_p, got_j


@pytest.mark.skipif(not native.native_available(),
                    reason="needs native lyndon_prep")
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind", ["bucket_edges", "f8_and_8192_rows"])
def test_bucket_model_against_plain_and_jax(kind, size):
    """The model at each size against the plain emit and JAX's on the
    lanes < n, zeros past n, the primaries; designed rows come back."""
    S, T = SIZES[size]
    (blocks, isa, ns, ms), D = _inputs(kind, S)
    got, prim = emit_bytes_model(blocks, isa, ns, ms, S, T,
                                 np.random.default_rng(43))
    (bwt_p, prim_p), (bwt_j, prim_j) = _plain_and_jax(blocks, isa, ns, ms)
    np.testing.assert_array_equal(prim, prim_p)
    np.testing.assert_array_equal(prim, prim_j)
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(got[b, :n], bwt_p[b, :n], f"row {b}")
        np.testing.assert_array_equal(got[b, :n], bwt_j[b, :n], f"row {b}")
        assert not got[b, n:].any()
        if D is not None:
            np.testing.assert_array_equal(got[b, :n], D[b, :n])
    if kind == "bucket_edges":
        assert ns[-1] % S and ns[-1] // S == 3  # a partial last bucket


@pytest.mark.parametrize("size", list(SIZES))
def test_bucket_model_output_does_not_follow_the_order(size):
    """Three orders of the CTAs and the atomics (launch order and two
    random ones) give the same bytes and primaries."""
    S, T = SIZES[size]
    D, ns = _edge_rows(S, 44)
    blocks, isa, ns, ms = _smoke().emit_inputs(D, ns,
                                               np.random.default_rng(45))
    want = emit_bytes_model(blocks, isa, ns, ms, S, T)
    for seed in (46, 47):
        got = emit_bytes_model(blocks, isa, ns, ms, S, T,
                               np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_bucket_model_on_a_row_of_8192_buckets():
    """A row of 8192 tiny buckets (S = 16) and 16384 tiles (T = 8), n a
    lane short of N, against the plain emit."""
    S, T, N = 16, 8, 8192 * 16
    rng = np.random.default_rng(48)
    D = rng.integers(0, 256, (1, N), dtype=np.uint8)
    ns = np.array([N - 1], np.int32)
    blocks, isa, ns, ms = _smoke().emit_inputs(D, ns, rng)
    got, prim = emit_bytes_model(blocks, isa, ns, ms, S, T, rng)
    assert -(-N // S) == 8192
    np.testing.assert_array_equal(got[0, :N - 1], D[0, :N - 1])
    assert got[0, N - 1] == 0
    bwt_p, prim_p = (to_numpy(t) for t in bwt2._emit_bytes_plain(
        *(to_torch(a) for a in (blocks, isa, ns, ms))))
    np.testing.assert_array_equal(got[0, :N - 1], bwt_p[0, :N - 1])
    np.testing.assert_array_equal(prim, prim_p)


@pytest.mark.parametrize("size", list(SIZES))
def test_no_permutation_stays_inside_the_regions(size):
    """An ISA with repeated and out-of-range destinations (no
    permutation: outside the kernel's precondition) never has an entry
    stored outside its bucket's region nor a byte outside [0, N): the
    kernels stay in their buffers, whatever the output."""
    S, T = SIZES[size]
    N = 3 * S + 8
    rng = np.random.default_rng(49)
    blocks = rng.integers(0, 256, (3, N), dtype=np.uint8)
    isa = rng.integers(0, S + 3, (3, N)).astype(np.int32)  # many repeats
    isa[1, ::7] = -5
    isa[2, ::3] = N + 9
    ns = np.array([N, 2 * S + 1, N - 3], np.int32)
    ms = np.array([0, 5, N - 4], np.int32)
    got, prim = emit_bytes_model(blocks, isa, ns, ms, S, T, rng,
                                 check=False)
    assert got.shape == (3, N)
    for b, n in enumerate(ns):
        assert not got[b, n:].any()
    np.testing.assert_array_equal(prim, [isa[0, 0], isa[1, 2 * S + 1 - 5],
                                         isa[2, 1]])
