"""Port's inverse BWT (lbzip2_tpu_torch/ops/ibwt.py) vs the JAX ops.

On a CPU tensor ``ibwt_rows`` runs the plain PyTorch version; it must
equal the JAX ``ibwt_masked`` / ``ibwt_batched`` on every lane (zeros
past n included) and the sequential oracle ``ref.decoder.ibwt``,
exactly.  The CUDA kernel is held against the plain version on the card
by chip_smoke.py.
"""

import bz2

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.ops.ibwt import ibwt_batched, ibwt_masked
from lbzip2_tpu.ref import bwt as ref_bwt
from lbzip2_tpu.ref.decoder import ibwt as oracle_ibwt
from lbzip2_tpu_torch.ops import ibwt


def _port(rows, ns, idxs):
    return ibwt.ibwt_rows(torch.from_numpy(rows),
                          torch.from_numpy(np.asarray(ns, np.int32)),
                          torch.from_numpy(np.asarray(idxs, np.int32)))


@pytest.mark.parametrize("seed,n,hi", [
    (0, 1, 256), (1, 2, 256), (2, 777, 256), (3, 2048, 4), (4, 1500, 2),
])
def test_single_row_matches_jax_and_oracle(seed, n, hi):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, hi, n, dtype=np.uint8)
    bw, idx = ref_bwt.bwt(data)
    N = 2048
    padded = np.zeros(N, np.uint8)
    padded[:n] = bw
    got = _port(padded[None], [n], [idx])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(ibwt_masked(padded, n,
                                                              idx)))
    np.testing.assert_array_equal(got[:n], data)
    np.testing.assert_array_equal(got[:n], oracle_ibwt(bw, idx))


def test_batched_rows_match_jax():
    rng = np.random.default_rng(7)
    N = 1024
    blocks, ns, idxs, raws = [], [], [], []
    for n in [5, 300, 1024, 700]:
        raw = rng.integers(0, 10, n, dtype=np.uint8)
        bw, idx = ref_bwt.bwt(raw)
        p = np.zeros(N, np.uint8)
        p[:n] = bw
        blocks.append(p)
        ns.append(n)
        idxs.append(idx)
        raws.append(raw)
    rows = np.stack(blocks)
    got = _port(rows, ns, idxs).numpy()
    want = np.asarray(ibwt_batched(rows, np.asarray(ns, np.int32),
                                   np.asarray(idxs, np.int32)))
    np.testing.assert_array_equal(got, want)
    for i, raw in enumerate(raws):
        np.testing.assert_array_equal(got[i, :ns[i]], raw)


def test_full_width_rows_match_jax_and_oracle():
    """(2, 901120): a real 900 kB block's BWT and primary, and uniform
    random bytes at the full width (not a BWT, but the same chase)."""
    if not native.native_available():
        pytest.skip("needs C toolchain")
    rng = np.random.default_rng(9)
    N = 901120
    text = np.repeat(rng.integers(97, 123, 600_000, dtype=np.uint8),
                     rng.integers(1, 3, 600_000))[:890_000]
    blob = bz2.compress(text.tobytes(), 9)
    arr = np.frombuffer(blob, np.uint8)
    err, _, bw, idx, rnd = native.retrieve_block(arr, arr.size * 8, 112)
    assert err == 0 and not rnd
    rows = np.zeros((2, N), np.uint8)
    rows[0, :bw.size] = bw
    rows[1] = rng.integers(0, 256, N, dtype=np.uint8)
    ns = np.array([bw.size, N], np.int32)
    idxs = np.array([idx, rng.integers(0, N)], np.int32)
    got = _port(rows, ns, idxs).numpy()
    np.testing.assert_array_equal(got, np.asarray(ibwt_batched(rows, ns,
                                                               idxs)))
    np.testing.assert_array_equal(got[0, :bw.size], oracle_ibwt(bw, idx))


def test_wrapper_refuses_other_devices_and_counts_no_cpu_launch():
    z8 = torch.zeros((1, 8), dtype=torch.uint8, device="meta")
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ibwt.ibwt_rows(z8, z, z)
    with pytest.raises(ValueError):
        ibwt.ibwt_cuda(z8, z, z)
    before = ibwt.launches
    _port(np.zeros((1, 8), np.uint8), [1], [0])
    assert ibwt.launches == before
