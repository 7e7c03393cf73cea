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
