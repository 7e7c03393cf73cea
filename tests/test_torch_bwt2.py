"""Port's batched BWT (lbzip2_tpu_torch/ops/bwt2.py) vs the JAX ops.

Rows come from native.lyndon_prep at the 8192 device bucket with
B = 8, generated from seeds.  _seed16 and _pass8 are compared with
JAX lane for lane (ISA and unresolved counts, pad lanes included);
bwt2_bytes also against the host oracle lbzip2_tpu.ref.bwt.  Exact
equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu.ref.bwt import bwt as ref_bwt
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native lyndon_prep")

N, B = 8192, 8


def _blocks(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        sizes = (1, 2, 9, 100, 1000, 4096, 5000, 8192)
        return [rng.integers(0, 256, n, np.uint8) for n in sizes]
    if kind == "small_alpha":
        sizes = (50, 333, 2048, 6000, 8000, 7, 8191, 4000)
        return [rng.integers(97, 99, n, np.uint8) for n in sizes]
    if kind == "runs":
        out = []
        for n in (500, 201, 3000, 8192, 60, 7777, 1024, 4500):
            vals = rng.integers(0, 256, n // 3 + 1, np.uint8)
            b = np.repeat(vals, rng.integers(1, 9, vals.size))[:n].copy()
            b[-1] ^= 0x55  # keep primitive
            out.append(b)
        return out
    # deep repeats: long periodic stretches broken only near the end
    out = []
    for n, p in ((5120, 256), (8192, 1000), (6000, 7), (8000, 3),
                 (4096, 2048), (7000, 1), (8192, 4096), (3000, 33)):
        page = rng.integers(0, 256, p, np.uint8)
        b = np.tile(page, n // p + 1)[:n].copy()
        b[-1] ^= 1
        out.append(b)
    return out


def _batch(blocks):
    rot = np.zeros((B, N), np.uint8)
    ns = np.empty(B, np.int32)
    ms = np.empty(B, np.int32)
    for i, b in enumerate(blocks):
        _, m = native.lyndon_prep(b, out=rot[i, :b.size])
        assert m >= 0, "periodic test block"
        ns[i] = b.size
        ms[i] = m
    return rot, ns, ms


KINDS = ["random", "small_alpha", "runs", "deep_repeats"]


@pytest.mark.parametrize("kind", KINDS)
def test_seed16_lane_for_lane(kind):
    rot, ns, ms = _batch(_blocks(kind, 1))
    isa_j, cnt_j = jbwt2.seed16(jnp.asarray(rot), jnp.asarray(ns))
    isa_t, cnt_t = bwt2._seed16(to_torch(rot), to_torch(ns))
    np.testing.assert_array_equal(to_numpy(isa_t), np.asarray(isa_j))
    np.testing.assert_array_equal(to_numpy(cnt_t), np.asarray(cnt_j))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [16, 2048, 16 * 8 ** 4])
def test_pass8_lane_for_lane(kind, k):
    """k = 16 is the first pass; 2048 and 65536 exercise the clamped
    window reads (j * k >= N) and the patched sentinel lanes."""
    rot, ns, ms = _batch(_blocks(kind, 2))
    isa_j, _ = jbwt2.seed16(jnp.asarray(rot), jnp.asarray(ns))
    out_j = jbwt2.pass8(isa_j, jnp.int32(k), jnp.asarray(ns))
    out_t = bwt2._pass8(to_torch(np.asarray(isa_j)), k, to_torch(ns))
    for got, want in zip(out_t, out_j):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_bwt2_bytes_matches_jax_and_oracle(kind):
    blocks = _blocks(kind, 3)
    rot, ns, ms = _batch(blocks)
    bwt_j, prim_j = jbwt2.bwt2_bytes(jnp.asarray(rot), jnp.asarray(ns),
                                     jnp.asarray(ms))
    bwt_t, prim_t = bwt2.bwt2_bytes(to_torch(rot), to_torch(ns),
                                    to_torch(ms))
    got, prim = to_numpy(bwt_t), to_numpy(prim_t)
    np.testing.assert_array_equal(got, np.asarray(bwt_j))
    np.testing.assert_array_equal(prim, np.asarray(prim_j))
    for i, b in enumerate(blocks):
        exp_bwt, exp_idx = ref_bwt(b)
        np.testing.assert_array_equal(got[i, :b.size], exp_bwt)
        assert int(prim[i]) == exp_idx, f"row {i}"


def test_lex_sort_packs_signed_keys():
    """The int64 packing keeps signed lexicographic order on both keys
    (extremes included) and the sort is stable across equal tuples."""
    rng = np.random.default_rng(4)
    ext = np.array([-2 ** 31, -1, 0, 1, 2 ** 31 - 1], np.int32)
    k0 = rng.choice(ext, (2, 64)).astype(np.int32)
    k1 = rng.choice(ext, (2, 64)).astype(np.int32)
    _, perm = bwt2._lex_sort([to_torch(k0), to_torch(k1)])
    for r in range(2):
        want = np.lexsort((np.arange(64), k1[r], k0[r]))
        np.testing.assert_array_equal(to_numpy(perm)[r], want)


def _token_blocks(kind, seed):
    """Eight blocks of one kind, sizes up to the 8192 bucket."""
    rng = np.random.default_rng(seed)
    sizes = (8192, 5000, 4096, 1000, 300, 100, 9, 2)
    out = []
    for n in sizes:
        if kind == "text":
            words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
                     for k in rng.integers(2, 9, 100)]
            b = np.frombuffer(b" ".join(
                words[i] for i in rng.integers(0, 100, n))[:n], np.uint8)
        elif kind == "digits":
            b = rng.integers(48, 58, n, np.uint8)
        elif kind == "abcd_runs":
            b = np.repeat(np.frombuffer(b"abcd", np.uint8), -(-n // 4))[:n]
        elif kind == "long_run":  # runs of 255+ split into several tokens
            b = np.full(n, 120, np.uint8)
            b[rng.integers(0, n, max(1, n // 700))] = 7
        else:  # random bytes: ~n runs, over the N // 4 token capacity
            b = rng.integers(0, 256, n, np.uint8)
        b = b.copy()
        b[-1] ^= 0x5A  # keep primitive
        out.append(b)
    return out


TOKEN_KINDS = ["text", "digits", "abcd_runs", "long_run", "random"]


def _assert_tokens_equal(got, want, ns):
    """tokens on [:run_counts] (capped at capacity), raw on [:n], run
    counts and primary; both as JAX-layout numpy arrays."""
    tok_t, raw_t, cnt_t, prim_t = got
    tok_j, raw_j, cnt_j, prim_j = want
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(prim_t, prim_j)
    assert tok_t.shape == tok_j.shape and raw_t.shape == raw_j.shape
    cap = tok_j.shape[1] * 2
    tt, tj = tok_t.view(np.uint16), tok_j.view(np.uint16)
    rt, rj = raw_t.view(np.uint8), raw_j.view(np.uint8)
    for r in range(cnt_j.shape[0]):
        c = min(int(cnt_j[r]), cap)
        np.testing.assert_array_equal(tt[r, :c], tj[r, :c], f"row {r}")
        np.testing.assert_array_equal(rt[r, :ns[r]], rj[r, :ns[r]])


@pytest.mark.parametrize("kind", TOKEN_KINDS)
def test_emit2_matches_jax(kind):
    rot, ns, ms = _batch(_token_blocks(kind, 5))
    isa = np.asarray(jbwt2._resolve_loop(jnp.asarray(rot), jnp.asarray(ns)))
    want = jbwt2.emit2(jnp.asarray(rot), jnp.asarray(isa), jnp.asarray(ns),
                       jnp.asarray(ms))
    got = bwt2._emit2(to_torch(rot), to_torch(isa), to_torch(ns),
                      to_torch(ms))
    _assert_tokens_equal([to_numpy(t) for t in got],
                         [np.asarray(a) for a in want], ns)


@pytest.mark.parametrize("kind", TOKEN_KINDS)
def test_bwt2_tokens_matches_jax_and_oracle(kind):
    blocks = _token_blocks(kind, 6)
    rot, ns, ms = _batch(blocks)
    want = [np.asarray(a) for a in jbwt2.bwt2_tokens(
        jnp.asarray(rot), jnp.asarray(ns), jnp.asarray(ms))]
    got = [to_numpy(t) for t in bwt2.bwt2_tokens(
        to_torch(rot), to_torch(ns), to_torch(ms))]
    _assert_tokens_equal(got, want, ns)
    tok, raw, counts, prim = got
    overflow = counts > tok.shape[1] * 2
    if kind == "random":
        assert overflow.any()
    elif kind in ("abcd_runs", "long_run"):
        assert not overflow.any()
    for i, b in enumerate(blocks):
        exp_bwt, exp_idx = ref_bwt(b)
        if overflow[i]:
            row = raw.view(np.uint8)[i, :b.size]
        else:
            t = tok.view(np.uint16)[i, :counts[i]]
            assert (t & 0xFF).max() <= 255 and (t & 0xFF).min() >= 1
            row = np.repeat((t >> 8).astype(np.uint8), t & 0xFF)
        np.testing.assert_array_equal(row, exp_bwt)
        assert int(prim[i]) == exp_idx


def test_bwt2_full_matches_jax():
    rot, ns, ms = _batch(_token_blocks("text", 7))
    raw_j, prim_j = jbwt2.bwt2_full(jnp.asarray(rot), jnp.asarray(ns),
                                    jnp.asarray(ms))
    raw_t, prim_t = bwt2.bwt2_full(to_torch(rot), to_torch(ns), to_torch(ms))
    rt, rj = to_numpy(raw_t).view(np.uint8), np.asarray(raw_j).view(np.uint8)
    for r in range(B):
        np.testing.assert_array_equal(rt[r, :ns[r]], rj[r, :ns[r]])
    np.testing.assert_array_equal(to_numpy(prim_t), np.asarray(prim_j))


@pytest.mark.parametrize("kind", ["text", "deep_repeats", "random"])
def test_bwt2_batch_matches_jax_and_oracle(kind):
    """The synchronous token-mode batch: rows from the tokens, or from
    the raw rows once a row overflows the token capacity (random)."""
    blocks = (_blocks(kind, 8) if kind == "deep_repeats"
              else _token_blocks(kind, 8))
    rot, ns, ms = _batch(blocks)
    out_t, prim_t = bwt2.bwt2_batch(rot, ns, ms, device="cpu")
    out_j, prim_j = jbwt2.bwt2_batch(rot, ns, ms)
    np.testing.assert_array_equal(prim_t, np.asarray(prim_j))
    for i, b in enumerate(blocks):
        exp_bwt, exp_idx = ref_bwt(b)
        np.testing.assert_array_equal(out_t[i, :b.size], exp_bwt)
        np.testing.assert_array_equal(out_t[i, :b.size], out_j[i, :b.size])
        assert int(prim_t[i]) == exp_idx


@pytest.mark.parametrize("emit", ["tokens", "bytes"])
def test_bwt2_task_stepping(emit):
    """ready()/step() until done, one pass a step, then the result of
    the task's emit mode; equal to JAX's task and to the oracle."""
    blocks = _blocks("deep_repeats", 9)
    rot, ns, ms = _batch(blocks)
    task = bwt2.Bwt2Task(rot, ns, ms, emit=emit, device="cpu")
    steps = 0
    while not task.step():
        assert task.ready()
        steps += 1
        assert steps < 50
    assert task.done and steps >= 2
    if emit == "bytes":
        bwt_t, prim_t = task.result_device()
        rows = [to_numpy(bwt_t)[i, :b.size] for i, b in enumerate(blocks)]
        prim_t = to_numpy(prim_t)
        with pytest.raises(ValueError):
            task.result()
        jt = jbwt2.Bwt2Task(rot, ns, ms, emit="bytes")
        bwt_j, prim_j = jt.result_device()
        for i, b in enumerate(blocks):
            np.testing.assert_array_equal(rows[i],
                                          np.asarray(bwt_j)[i, :b.size])
    else:
        rows, prim_t = task.result()
        with pytest.raises(ValueError):
            task.result_device()
        rows_j, prim_j = jbwt2.Bwt2Task(rot, ns, ms).result()
        for r, rj in zip(rows, rows_j):
            np.testing.assert_array_equal(r, rj)
    np.testing.assert_array_equal(prim_t, np.asarray(prim_j))
    for i, b in enumerate(blocks):
        exp_bwt, exp_idx = ref_bwt(b)
        np.testing.assert_array_equal(rows[i], exp_bwt)
        assert int(prim_t[i]) == exp_idx
