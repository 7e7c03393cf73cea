"""The port's block sharding (lbzip2_tpu_torch/parallel/sharding.py and
chain_payloads(mesh_axis=...)) against the JAX package's shard_map
functions on tests/conftest.py's virtual 8-device CPU mesh.  The port's
mesh is a list of logical CPU devices, 1, 3 or 8 of them: uneven shards,
no pad rows.  Inputs come from seeds; tolerance 0 (a lossless codec)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu.parallel import sharding as J
from lbzip2_tpu.ref.rle1 import transform_span
from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.ops import chain
from lbzip2_tpu_torch.parallel import sharding as S

SHARDS = [1, 3, 8]


def _lyndon_batch(B, N, seed, hi=200):
    """B Lyndon-prepped rows of random bytes below ``hi`` (lengths 50 to
    N): (rotated rows, ns, ms)."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((B, N), np.uint8)
    ns = np.empty(B, np.int32)
    ms = np.empty(B, np.int32)
    for b in range(B):
        n = int(rng.integers(50, N))
        raw = rng.integers(0, 4 if b % 3 == 0 else hi, n, dtype=np.uint8)
        _, ms[b] = native.lyndon_prep(raw, out=blocks[b, :n])
        assert ms[b] >= 0
        ns[b] = n
    return blocks, ns, ms


@pytest.fixture(scope="module")
def v2_case():
    blocks, ns, ms = _lyndon_batch(11, 2048, 0)
    return (blocks, ns, ms), J.encode_batch_sharded_v2(blocks, ns, ms,
                                                       J.make_mesh(8))


@pytest.mark.parametrize("k", SHARDS)
def test_encode_batch_sharded_v2(v2_case, k):
    (blocks, ns, ms), (want, wprim) = v2_case
    got, prim = S.encode_batch_sharded_v2(blocks, ns, ms,
                                          S.make_mesh(k, "cpu"))
    assert got.shape == want.shape and got.dtype == np.uint8
    for b in range(len(ns)):
        np.testing.assert_array_equal(got[b, :ns[b]], want[b, :ns[b]])
    np.testing.assert_array_equal(prim, wprim)


@pytest.fixture(scope="module")
def tokens_case():
    blocks, ns, ms = _lyndon_batch(11, 2048, 1, hi=3)
    return (blocks, ns, ms), J.encode_batch_sharded_tokens(
        blocks, ns, ms, J.make_mesh(8))


@pytest.mark.parametrize("k", SHARDS)
def test_encode_batch_sharded_tokens(tokens_case, k):
    (blocks, ns, ms), (wtok, wcnt, wraw, wprim) = tokens_case
    tok, cnt, raw, prim = S.encode_batch_sharded_tokens(
        blocks, ns, ms, S.make_mesh(k, "cpu"))
    assert tok.shape == wtok.shape and tok.dtype == np.uint16
    np.testing.assert_array_equal(cnt, wcnt)
    np.testing.assert_array_equal(prim, wprim)
    assert (cnt <= tok.shape[1]).any()
    for b in range(len(ns)):
        c = min(int(cnt[b]), tok.shape[1])
        np.testing.assert_array_equal(tok[b, :c], wtok[b, :c])
        np.testing.assert_array_equal(raw[b, :ns[b]], wraw[b, :ns[b]])


def _stage_blocks(B, N, seed):
    """Raw padded blocks as tests/test_sharding.py makes them, with a
    fully periodic row and a row of one byte."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((B, N), np.uint8)
    ns = np.empty(B, np.int32)
    for b in range(B):
        n = int(rng.integers(10, N))
        blocks[b, :n] = rng.integers(0, 50, n, dtype=np.uint8)
        ns[b] = n
    ns[1] = 600
    blocks[1, :600] = np.tile(np.frombuffer(b"abc", np.uint8), 200)
    ns[2] = 1
    return blocks, ns


@pytest.fixture(scope="module")
def stage_case():
    blocks, ns = _stage_blocks(9, 1024, 3)
    mesh = J.make_mesh(8)
    bwt, idx, ranks = J.encode_batch_sharded(blocks, ns, mesh)
    plains = J.decode_batch_sharded(bwt, ns, idx.astype(np.int32), mesh)
    return (blocks, ns), (bwt, idx, ranks, plains)


@pytest.mark.parametrize("k", SHARDS)
def test_encode_batch_sharded(stage_case, k):
    """The v1 stage (BWT + MTF ranks): the whole rows, zeros past n."""
    (blocks, ns), (bwt, idx, ranks, _) = stage_case
    got = S.encode_batch_sharded(blocks, ns, S.make_mesh(k, "cpu"))
    for g, w in zip(got, (bwt, idx, ranks)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", SHARDS)
def test_decode_batch_sharded(stage_case, k):
    (blocks, ns), (bwt, idx, _, plains) = stage_case
    got = S.decode_batch_sharded(bwt, ns, idx.astype(np.int32),
                                 S.make_mesh(k, "cpu"))
    for b in range(len(ns)):
        np.testing.assert_array_equal(got[b, :ns[b]], plains[b, :ns[b]])
        np.testing.assert_array_equal(got[b, :ns[b]], blocks[b, :ns[b]])


def _chain_inputs(seed=11):
    rng = np.random.default_rng(seed)
    specs = [6000, 30, 8000, 2, 5000]
    B, N = len(specs), 8192
    bwts = np.zeros((B, N), np.uint8)
    ns = np.zeros(B, np.int32)
    cmaps = np.zeros((B, 256), np.uint8)
    idxs = np.zeros(B, np.int32)
    crcs = np.zeros(B, np.uint32)
    for i, n in enumerate(specs):
        raw = rng.integers(0, 256 if i == 2 else 12, n, dtype=np.uint8)
        blk, cmap = transform_span(raw)
        bwts[i, :blk.size], idxs[i] = native.bwt(blk)
        ns[i] = blk.size
        cmaps[i] = np.asarray(cmap, np.uint8)
        crcs[i] = (native.crc32_block(raw) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    return bwts, ns, cmaps, idxs, crcs


@pytest.mark.parametrize("k", [2, 8])
def test_chain_payloads_sharded(k):
    """Sharded == unsharded port == JAX on its mesh == native.encode_payload;
    the rows may come as a host array or a tensor, and each shard's
    stage times come back."""
    bwts, ns, cmaps, idxs, crcs = _chain_inputs()
    mesh = S.make_mesh(k, "cpu")
    times = {}
    got = chain.chain_payloads(bwts, ns, cmaps, idxs, crcs,
                               mesh_axis=(mesh, S.AXIS), times=times)
    assert len(times["shards"]) == min(k, len(ns))
    assert got == chain.chain_payloads(torch.from_numpy(bwts), ns, cmaps,
                                       idxs, crcs, mesh_axis=(mesh, "x"))
    assert got == chain.chain_payloads(torch.from_numpy(bwts), ns, cmaps,
                                       idxs, crcs)
    jmesh = J.make_mesh(8)
    B = len(ns)
    pad = (-B) % 8  # JAX's mesh needs a multiple of 8 rows
    sh = NamedSharding(jmesh, PartitionSpec("blocks", None))
    rows = np.concatenate([bwts, np.zeros((pad, bwts.shape[1]), np.uint8)])
    want = jchain.chain_payloads(
        jax.device_put(jnp.asarray(rows), sh),
        np.r_[ns, np.ones(pad, np.int32)],
        np.concatenate([cmaps, np.repeat(cmaps[:1], pad, 0)]),
        np.r_[idxs, np.zeros(pad, np.int32)],
        np.r_[crcs, np.zeros(pad, np.uint32)],
        mesh_axis=(jmesh, "blocks"))[:B]
    assert got == want
    for i in range(B):
        assert got[i] == native.encode_payload(
            bwts[i, :ns[i]], cmaps[i], int(idxs[i]), int(crcs[i]), 8)


def test_make_mesh_and_row_splits():
    assert S.make_mesh(None, "cpu") == [torch.device("cpu")]
    assert S.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            S.make_mesh(1, "cuda")
    assert S.row_splits(11, 8) == [(0, 2), (2, 4), (4, 6), (6, 7), (7, 8),
                                   (8, 9), (9, 10), (10, 11)]
    assert S.row_splits(2, 3) == [(0, 1), (1, 2), (2, 2)]


def test_run_shards_order_and_errors():
    """Results in row order whatever order the threads finish in; an
    empty shard runs nothing; a shard's error is raised after all
    ended."""
    import time

    mesh = S.make_mesh(4, "cpu")
    seen = []

    def fn(dev, rows):
        time.sleep(0.05 * (5 - int(rows[0])))  # the first finishes last
        seen.append(int(rows[0]))
        return rows.tolist()

    assert S.run_shards(mesh, fn, np.arange(3)) == [[0], [1], [2]]
    assert sorted(seen) == [0, 1, 2]

    def bad(dev, rows):
        if rows[0] == 2:
            raise ValueError("shard 2")
        seen.append(-1)
        return rows

    seen.clear()
    with pytest.raises(ValueError, match="shard 2"):
        S.run_shards(mesh, bad, np.arange(4))
    assert seen == [-1, -1, -1]
