"""The port's sparse rotation sort (lbzip2_tpu_torch/ops/bwt.py:
``_seed_sparse``, ``_sparse_level``, ``_emit_sparse``, ``SparseBwtTask``
and ``bwt_batched_sparse``) against JAX's on the CPU, step by step: the
seed's ISA on every lane and its counts, one level at a stated capacity
(the ISA, k, the counts, the working set as a set of (rank, position)
pairs: JAX's compaction sort is not stable), the tie-break level, the
emit, and the whole task (rows, primaries and its final ISA, also
against the card's route on its plain versions).  Rows as in
tests/test_torch_bwt_v1.py.  JAX's functions are jitted once by this
module at one shape (a second shape once made ``_seed_sparse_jit``
fail intermittently)."""

import jax
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops import bwt as jbwt
from lbzip2_tpu_torch.ops import bwt

from test_torch_bwt_v1 import B, KINDS, N, batch, blocks_of

_J_SEED = jax.jit(jbwt._seed_sparse)
_J_LEVEL = jax.jit(jbwt._sparse_level, static_argnames=("tie_break",))
_J_EMIT = jax.jit(jbwt._emit_sparse.__wrapped__)


def _pairs(r1, wpos, cnt):
    """Each row's working set as sorted (rank, position) pairs."""
    r1, wpos = np.asarray(r1), np.asarray(wpos)
    return [sorted(zip(r1[r, :c].tolist(), wpos[r, :c].tolist()))
            for r, c in enumerate(np.asarray(cnt).tolist())]


def _seeds(kind):
    rows, ns = batch(blocks_of(kind))
    want = [np.asarray(a) for a in _J_SEED(rows, ns)]
    got = bwt._seed_sparse(torch.from_numpy(rows), torch.from_numpy(ns))
    return rows, ns, want, got


@pytest.mark.parametrize("kind", KINDS)
def test_seed_matches_jax(kind):
    rows, ns, (w_isa, w_r1, w_wpos, w_cnt), (isa, r1, wpos, cnt) = \
        _seeds(kind)
    np.testing.assert_array_equal(isa.numpy(), w_isa)
    np.testing.assert_array_equal(cnt.numpy(), w_cnt)
    assert _pairs(r1, wpos, cnt) == _pairs(w_r1, w_wpos, w_cnt)
    live = np.arange(N)[None] >= cnt.numpy()[:, None]
    assert (r1.numpy()[live] == bwt._INF).all()
    assert (wpos.numpy()[live] == N).all()
    # the card's seed, on the CPU its plain version: the same ISA and cnt
    isa2, cnt2 = bwt._seed_cyclic(torch.from_numpy(rows),
                                  torch.from_numpy(ns))
    assert torch.equal(isa2, isa) and torch.equal(cnt2, cnt)


@pytest.mark.parametrize("which", ["floor", "task"])
def test_sparse_level_matches_jax(which):
    """One level from the seed at the least capacity, 2048 (the
    two-value rows), and at the one the task takes, the power of two
    above the largest count (the periodic rows: a row of N lanes tied)."""
    rows, ns, w, got = _seeds("values_2" if which == "floor"
                              else "periodic")
    cap = 2048 if which == "floor" else min(
        jbwt._pow2ceil(int(w[3].max())), N)
    assert cap > 2048 or which == "floor"
    k = 4 * jbwt._SEED_KEYS
    want = [np.asarray(a) for a in _J_LEVEL(
        w[0], w[1][:, :cap], w[2][:, :cap], np.int32(k), w[3], ns,
        tie_break=False)]
    isa, r1, wpos, k2, cnt = bwt._sparse_level(
        got[0], got[1][:, :cap], got[2][:, :cap], k, got[3],
        torch.from_numpy(ns), tie_break=False)
    np.testing.assert_array_equal(isa.numpy(), want[0])
    assert k2 == int(want[3]) and k2 > k  # the level ran passes
    np.testing.assert_array_equal(cnt.numpy(), want[4])
    assert _pairs(r1, wpos, cnt) == _pairs(want[1], want[2], want[4])


def test_tie_break_level_matches_jax():
    """Periodic rows run to k >= max(n), then the tie-break level: the
    classes of equal rotations by descending start."""
    rows, ns, w, got = _seeds("periodic")
    t_ns = torch.from_numpy(ns)
    k = 4 * jbwt._SEED_KEYS
    isa, r1, wpos, cnt = got
    while k < int(ns.max()) and int(w[3].max()) > 0:
        w = [np.asarray(a) for a in _J_LEVEL(w[0], w[1], w[2], np.int32(k),
                                              w[3], ns, tie_break=False)]
        w = [w[0], w[1], w[2], w[4]]
        isa, r1, wpos, k, cnt = bwt._sparse_level(isa, r1, wpos, k, cnt,
                                                  t_ns, tie_break=False)
        np.testing.assert_array_equal(isa.numpy(), w[0])
    assert int(cnt.max()) > 0  # equal rotations are left
    want = [np.asarray(a) for a in _J_LEVEL(w[0], w[1], w[2], np.int32(k),
                                            w[3], ns, tie_break=True)]
    isa, r1, wpos, k2, cnt = bwt._sparse_level(isa, r1, wpos, k, cnt, t_ns,
                                               tie_break=True)
    np.testing.assert_array_equal(isa.numpy(), want[0])
    np.testing.assert_array_equal(cnt.numpy(), want[4])
    assert int(cnt.max()) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_task_matches_jax(kind):
    """The task driven by step on the CPU (JAX's steps) against JAX's
    task: the packed rows, the primaries, the final ISA on the lanes
    < n; and the card's route on its plain versions to the same ISA."""
    rows, ns = batch(blocks_of(kind))
    jt = jbwt.SparseBwtTask(rows, ns)
    w_packed, w_prim = jt.result()
    t = bwt.SparseBwtTask(rows, ns, device="cpu")
    steps = 0
    while not t.step():
        assert t.ready()
        steps += 1
    packed, prim = t.result()
    np.testing.assert_array_equal(packed, w_packed)
    np.testing.assert_array_equal(prim, w_prim)
    lanes = np.arange(N)[None] < ns[:, None]
    w_isa = np.asarray(jt.ISA)
    np.testing.assert_array_equal(t.plain.ISA.numpy()[lanes], w_isa[lanes])
    loop = bwt._cyclic_loop(torch.from_numpy(rows), torch.from_numpy(ns))
    np.testing.assert_array_equal(loop.numpy()[lanes], w_isa[lanes])


def test_bwt_batched_sparse_and_emit_match_jax():
    """A scalar n for every row, and the emit of a final ISA."""
    rows, _ = batch(blocks_of("text"))
    rows[:, 3000:] = 0
    out, prim = bwt.bwt_batched_sparse(rows, 3000, device="cpu")
    w_out, w_prim = jbwt.bwt_batched_sparse(rows, 3000)
    np.testing.assert_array_equal(out, w_out)
    np.testing.assert_array_equal(prim, w_prim)
    ns = np.full(B, 3000, np.int32)
    jt = jbwt.SparseBwtTask(rows, ns)
    jt.result()
    w_packed, w_p = (np.asarray(a) for a in _J_EMIT(rows, jt.ISA, ns))
    packed, p = bwt._emit_sparse(torch.from_numpy(rows),
                                 torch.from_numpy(np.array(jt.ISA)),
                                 torch.from_numpy(ns))
    np.testing.assert_array_equal(packed.numpy(), w_packed)
    np.testing.assert_array_equal(p.numpy(), w_p)


def test_unique_ff_prefix_counts_as_unresolved_with_pads():
    """A row whose one lane starts sixteen FF bytes: JAX forms the seed's
    classes over the four words, so with pads (n < N) the lane shares
    the pads' class and counts; without pads (n = N) it does not."""
    rng = np.random.default_rng(9)
    rows = np.zeros((B, N), np.uint8)
    ns = np.array([5000, N, 16, 300, 5000, N, 40, 7000], np.int32)
    for r, n in enumerate(ns):
        rows[r, :n] = rng.integers(0, 200, n)
        rows[r, 10:26] = 255  # one lane of sixteen FF (n > 16)
    rows[2, :16] = 255  # n = 16, every byte FF: one class of 16
    want = [np.asarray(a) for a in _J_SEED(rows, ns)]
    isa, _, _, cnt = bwt._seed_sparse(torch.from_numpy(rows),
                                      torch.from_numpy(ns))
    np.testing.assert_array_equal(cnt.numpy(), want[3])
    np.testing.assert_array_equal(isa.numpy(), want[0])
    assert cnt[0] >= 1 and cnt[1] == 0 and cnt[2] == 16
