"""The port's v1 rotation sort (lbzip2_tpu_torch/ops/bwt.py) against
JAX's lbzip2_tpu/ops/bwt.py on the CPU: ``bwt_batched``,
``bwt_masked``, ``bwt_batched_uniform``, ``pack_u8_rows`` and the plain
twins ``_doubling_pass`` and ``_shift_cyclic``, plus the card's route
(the cyclic seed, passes and tie-break, then the emit) through its plain
versions.  Rows at the 8192 bucket, zero past n, from seeds: n = 1, 2,
5, 15, 17 and N, values over 2, 4 and 256, fully periodic rows, a
16-byte run of FF and text.  Rows and primaries exactly; each JAX
function is jitted once by this module, at one shape."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops import bwt as jbwt
from lbzip2_tpu_torch.ops import bwt

N, B = 8192, 8
ROOT = pathlib.Path(__file__).resolve().parent.parent

_J_BATCHED = jax.jit(jax.vmap(lambda blk, n: jbwt.bwt_masked(blk, n)))
_J_MASKED = jax.jit(lambda blk, n: jbwt.bwt_masked(blk, n))
_J_UNIFORM = jax.jit(jbwt.bwt_batched_uniform)
_J_DOUBLING = jax.jit(jbwt._doubling_pass)
_J_SHIFT = jax.jit(jbwt._shift_cyclic)


def _text():
    parts = sorted((ROOT / "lbzip2_tpu_torch" / "csrc").glob("*.cu"))
    return np.frombuffer(b"".join(p.read_bytes() for p in parts), np.uint8)


def blocks_of(kind, seed=0):
    """Eight rows of one kind (lists of uint8 arrays)."""
    rng = np.random.default_rng(seed)
    if kind == "edges":
        return [rng.integers(0, 256, n, np.uint8)
                for n in (1, 2, 5, 15, 17, N, 3000, 100)]
    if kind in ("values_2", "values_4"):
        v = 2 if kind == "values_2" else 4
        return [rng.integers(0, v, n, np.uint8)
                for n in (2, 3, 17, 500, 4096, 6000, 8191, N)]
    if kind == "periodic":
        out = []
        for n, p in ((2, 1), (900, 1), (999, 3), (N, 2), (7000, 7),
                     (6000, 1500), (4096, 4096 // 2), (17, 17)):
            out.append(np.tile(rng.integers(0, 256, p, np.uint8),
                               n // p + 1)[:n].copy())
        return out
    if kind == "ff_runs":  # 16 and more FF bytes: the seed's FF class
        out = []
        for n, at in ((5000, 100), (N, 8000), (300, 290), (16, 0),
                      (17, 0), (40, 30), (4000, 0), (6000, 2000)):
            b = rng.integers(0, 256, n, np.uint8)
            b[at:at + 16] = 255
            out.append(b)
        return out
    text = _text()
    at = rng.integers(0, text.size - N, B)
    return [text[a:a + n].copy() for a, n in
            zip(at, (N, 8000, 5000, 100, 8191, 3000, 1, 2))]


def batch(blocks):
    rows = np.zeros((len(blocks), N), np.uint8)
    ns = np.array([b.size for b in blocks], np.int32)
    for i, b in enumerate(blocks):
        rows[i, :b.size] = b
    return rows, ns


KINDS = ["edges", "values_2", "values_4", "periodic", "ff_runs", "text"]


@pytest.mark.parametrize("kind", KINDS)
def test_bwt_batched_matches_jax(kind):
    """The whole rows (zeros past n) and primaries, by the plain twin
    and by the card's route on its plain versions."""
    rows, ns = batch(blocks_of(kind))
    w_out, w_prim = (np.asarray(a) for a in _J_BATCHED(rows, ns))
    t_rows, t_ns = torch.from_numpy(rows), torch.from_numpy(ns)
    out, prim = bwt.bwt_batched(t_rows, t_ns)
    np.testing.assert_array_equal(out.numpy(), w_out)
    np.testing.assert_array_equal(prim.numpy(), w_prim)
    packed, prim2 = bwt._emit_sparse_plain(
        t_rows, bwt._cyclic_loop(t_rows, t_ns), t_ns)
    np.testing.assert_array_equal(packed.view(torch.uint8).view(B, N),
                                  w_out)
    np.testing.assert_array_equal(prim2.numpy(), w_prim)


@pytest.mark.parametrize("n", [1, 2, 17, N])
def test_bwt_masked_matches_jax(n):
    rng = np.random.default_rng(n)
    block = np.zeros(N, np.uint8)
    block[:n] = rng.integers(0, 3, n, np.uint8)
    w_out, w_prim = _J_MASKED(block, np.int32(n))
    out, prim = bwt.bwt_masked(torch.from_numpy(block), n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    assert int(prim) == int(w_prim) and prim.dtype == torch.int32


@pytest.mark.parametrize("n", [2, 15, 5000, N])
def test_bwt_batched_uniform_matches_jax(n):
    """Every row of length n: random, two values, one byte, a period."""
    rng = np.random.default_rng(n + 1)
    rows = np.zeros((B, N), np.uint8)
    for r in range(B):
        rows[r, :n] = (rng.integers(0, 256, n), rng.integers(0, 2, n),
                       np.full(n, 7), np.tile([1, 2, 3], n)[:n])[r % 4]
    w_out, w_prim = _J_UNIFORM(rows, np.int32(n))
    out, prim = bwt.bwt_batched_uniform(torch.from_numpy(rows), n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(w_prim))
    # the card's route (ns all n) on its plain versions gives the same
    t_rows = torch.from_numpy(rows)
    ns = torch.full((B,), n, dtype=torch.int32)
    packed, prim2 = bwt._emit_sparse_plain(
        t_rows, bwt._cyclic_loop(t_rows, ns), ns)
    np.testing.assert_array_equal(packed.view(torch.uint8).view(B, N),
                                  np.asarray(w_out))
    np.testing.assert_array_equal(prim2.numpy(), np.asarray(w_prim))


def test_doubling_pass_matches_jax():
    """One round on dense ranks of a row with ties, k below and past
    n / 2, the lanes >= n masked."""
    rng = np.random.default_rng(3)
    idx = np.arange(N, dtype=np.int32)
    for n, k in ((N, 4), (5000, 8), (5000, 4096), (17, 16)):
        rank = rng.integers(0, 40, N).astype(np.int32)
        want = np.asarray(_J_DOUBLING(rank, np.int32(k), np.int32(n), idx))
        got = bwt._doubling_pass(torch.from_numpy(rank), k, n,
                                 torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


def test_shift_cyclic_and_pack_match_jax():
    rng = np.random.default_rng(4)
    rank = rng.integers(0, 1000, (B, N)).astype(np.int32)
    for n, k in ((N, 0), (N, 3), (5000, 4999), (5000, 5000), (2, 3),
                 (100, N)):
        want = np.asarray(_J_SHIFT(rank, np.int32(k), np.int32(n)))
        got = bwt._shift_cyclic(torch.from_numpy(rank), k, n)
        np.testing.assert_array_equal(got.numpy(), want)
    out = rng.integers(0, 256, (B, N)).astype(np.uint8)
    want = np.asarray(jbwt.pack_u8_rows(jnp.asarray(out)))
    got = bwt.pack_u8_rows(torch.from_numpy(out))
    assert got.dtype == torch.int32 and got.shape == (B, N // 4)
    np.testing.assert_array_equal(got.numpy(), want)
