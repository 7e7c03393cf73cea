"""The primary index of a block whose 16-byte suffix prefixes are all
distinct and whose first suffix starts FF FF FF FF, then a larger byte.

The seed's pad lanes carry the key FF FF FF FF 00 .. 00, so such a
suffix sorts after the N - n pads and its seed rank lies past them.
JAX skips every pass when the seed leaves no tie and reads the primary
index from that rank (lbzip2_tpu/ops/bwt2.py:247), which is then N - 1
for a row of n < N: its stream does not decode.  The port runs at least
one pass after the seed (ops/bwt2.py::_resolve_loop, Bwt2Task), which
gives every lane its slot among the valid ones; the rows are the same.
"""

import bz2

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu.ref.bwt import bwt as ref_bwt
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native lyndon_prep")

N = 8192


def _block(n=6000, seed=1):
    """16 byte values, FF FF FF FF 01 first, 00 00 at 1000 (so the least
    rotation starts there and the FF run is not the row's end)."""
    b = np.random.default_rng(seed).integers(0x40, 0x50, n).astype(np.uint8)
    b[:4] = 0xFF
    b[4] = 1
    b[1000:1002] = 0
    return b


def _row(b):
    rot = np.zeros((1, N), np.uint8)
    _, m = native.lyndon_prep(b, out=rot[0, :b.size])
    return rot, np.array([b.size], np.int32), np.array([m], np.int32)


def test_seed_leaves_no_tie_and_jax_misses_the_primary():
    b = _block()
    rot, ns, ms = _row(b)
    _, cnt = bwt2._seed16(to_torch(rot), to_torch(ns))
    assert int(cnt[0]) == 0  # the seed resolves the row: no JAX pass
    want_row, want_idx = ref_bwt(b)
    got_j, prim_j = jbwt2.bwt2_bytes(jnp.asarray(rot), jnp.asarray(ns),
                                     jnp.asarray(ms))
    np.testing.assert_array_equal(np.asarray(got_j)[0, :b.size], want_row)
    assert int(prim_j[0]) == N - 1 != want_idx


@pytest.mark.parametrize("path", ["bytes", "tokens", "task_bytes",
                                  "task_tokens"])
def test_port_primary_matches_the_oracle(path):
    b = _block(seed=2)
    rot, ns, ms = _row(b)
    want_row, want_idx = ref_bwt(b)
    if path == "bytes":
        row, prim = bwt2.bwt2_bytes(to_torch(rot), to_torch(ns),
                                    to_torch(ms))
        row, prim = to_numpy(row)[0, :b.size], int(prim[0])
    elif path == "tokens":
        _, raw, _, prim = bwt2.bwt2_tokens(to_torch(rot), to_torch(ns),
                                           to_torch(ms))
        row = to_numpy(raw).view(np.uint8)[0, :b.size]
        prim = int(prim[0])
    elif path == "task_bytes":
        task = bwt2.Bwt2Task(rot, ns, ms, emit="bytes", device="cpu")
        row, prim = task.result_device()
        row, prim = to_numpy(row)[0, :b.size], int(prim[0])
    else:
        rows, prim = bwt2.Bwt2Task(rot, ns, ms, device="cpu").result()
        row, prim = rows[0], int(prim[0])
    np.testing.assert_array_equal(row, want_row)
    assert prim == want_idx


def test_compress_of_such_a_block_decodes(monkeypatch):
    """The block on the device path (the 8192 bucket, chain mode, no
    host stealing) through compress: bz2 reads it back."""
    monkeypatch.setattr(encoder, "_HOST_STEAL", False)
    data = _block().tobytes()
    out = encoder.compress(data, 9, device="cpu")
    assert encoder.last_stats["device_blocks"] == 1
    assert bz2.decompress(out) == data
