"""The port's single-row standalone ops against the JAX package's,
through their plain versions on the CPU: the MTF ranks (ops/mtf.py) and
the RLE2 (ops/rle2.py::rle2_from_ranks), at the JAX tests' shapes
(tests/test_ops_bwt_mtf.py, test_ops_rle2.py).  The device CRC is in
test_torch_crc.py, the bit packer in test_torch_bitpack.py.
Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.mtf import mtf_ranks as j_mtf_ranks
from lbzip2_tpu.ops.rle2 import rle2_from_ranks as j_rle2
from lbzip2_tpu_torch.ops import mtf, rle2


@pytest.mark.parametrize("seed,n,hi", [
    (0, 512, 4), (1, 1000, 256), (2, 3000, 16), (3, 4096, 2), (4, 513, 250),
])
def test_mtf_ranks(seed, n, hi):
    rng = np.random.default_rng(seed)
    syms = np.zeros(4608, np.int32)
    syms[:n] = rng.integers(0, hi, n, dtype=np.int32)
    syms[n:] = rng.integers(0, hi, 4608 - n)  # garbage past n
    got = mtf.mtf_ranks(torch.from_numpy(syms), n)
    want = np.asarray(j_mtf_ranks(jnp.asarray(syms), n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mtf.mtf_ranks(torch.from_numpy(syms[:1000]), 10)


@pytest.mark.parametrize("seed,n,zero_frac", [
    (0, 100, 0.5), (1, 1000, 0.8), (2, 5000, 0.95), (3, 17, 0.0),
    (4, 2000, 1.0),
])
def test_rle2_from_ranks(seed, n, zero_frac):
    rng = np.random.default_rng(seed)
    ranks = np.where(rng.random(n) < zero_frac, 0,
                     rng.integers(1, 30, n)).astype(np.int32)
    if zero_frac == 0.0:
        ranks[ranks == 0] = 1
    padded = np.zeros(8192, np.int32)
    padded[:n] = ranks
    mtfv, nm = rle2.rle2_from_ranks(torch.from_numpy(padded), n, 40)
    jm, jn = j_rle2(jnp.asarray(padded), n, 40)
    assert int(nm) == int(jn) and nm.shape == ()
    np.testing.assert_array_equal(mtfv.numpy(), np.asarray(jm))
