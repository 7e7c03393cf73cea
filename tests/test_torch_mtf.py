"""Port's MTF ranks (lbzip2_tpu_torch/ops/mtf_pallas.py) vs the JAX ops.

On a CPU tensor ``mtf_ranks_rows`` runs the plain PyTorch version; it
must equal the Pallas kernel in interpret mode and the lax.scan form,
exactly (integer ranks, tolerance 0).  The CUDA kernel itself is
compared with the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.mtf import mtf_ranks
from lbzip2_tpu.ops.mtf_pallas import mtf_ranks_pallas
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import mtf_pallas

N = 2048


def _port(syms, ns):
    return to_numpy(mtf_pallas.mtf_ranks_rows(to_torch(syms), to_torch(ns)))


@pytest.mark.parametrize("seed,n,hi", [
    (0, 256, 4), (1, 1000, 256), (2, 2048, 16), (3, 700, 2),
    (4, 0, 8), (5, N, 1),
])
def test_single_row_matches_jax(seed, n, hi):
    rng = np.random.default_rng(seed)
    padded = np.zeros(N, np.int32)
    padded[:n] = rng.integers(0, hi, n, dtype=np.int32)
    got = _port(padded[None], np.array([n], np.int32))[0]
    np.testing.assert_array_equal(got, np.asarray(mtf_ranks(padded, n)))
    np.testing.assert_array_equal(
        got, np.asarray(mtf_ranks_pallas(padded, n, interpret=True)))


def test_batched_rows_match_jax():
    rng = np.random.default_rng(6)
    B, W = 6, 4096
    his = (2, 256, 40, 1, 256, 7)
    syms = np.stack([rng.integers(0, h, W, dtype=np.int32) for h in his])
    ns = np.array([W, 3000, 0, 1, 4095, 2048], np.int32)
    got = _port(syms, ns)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b], np.asarray(mtf_ranks(syms[b], ns[b])), err_msg=f"{b}")


def test_wrapper_refuses_other_devices():
    syms = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    ns = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mtf_pallas.mtf_ranks_rows(syms, ns)
    with pytest.raises(ValueError):
        mtf_pallas.mtf_ranks_cuda(syms, ns)


def test_cpu_path_does_not_count_launches():
    before = mtf_pallas.launches
    mtf_pallas.mtf_ranks_rows(torch.zeros((1, 64), dtype=torch.int32),
                              torch.tensor([64], dtype=torch.int32))
    assert mtf_pallas.launches == before
