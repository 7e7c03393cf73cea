"""The port's device CRC (lbzip2_tpu_torch/ops/crc.py, kernel
csrc/crc32.cu) against the JAX package's crc32_device and
crc32_block_device and the host CRC, through the plain version on the
CPU, at tests/test_ops_crc.py's shapes.  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.crc import crc32_block_device as j_crc_block
from lbzip2_tpu.ops.crc import crc32_device as j_crc
from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.ops import crc


def _padded(n, N, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    padded = np.zeros(N, np.uint8)
    padded[:n] = data
    return data, padded


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4096, 9999])
def test_crc_block_device(n):
    data, padded = _padded(n, 16384, n)
    got = crc.crc32_block_device(padded, n, device="cpu")
    assert got == j_crc_block(padded, n) == crc32.crc_of(data)


@pytest.mark.parametrize("n,N", [(96, 96), (900000, 901632), (70, 96)])
def test_crc_odd_chunk_counts(n, N):
    data, padded = _padded(n, N, n)
    reg = crc.crc32_device(torch.from_numpy(padded), n)
    assert reg.dtype == torch.int64 and reg.shape == ()
    assert int(reg) == int(j_crc(jnp.asarray(padded), n))
    assert crc.crc32_block_device(padded, n, device="cpu") == \
        crc32.crc_of(data)


def test_crc_register_edges_and_checks():
    """n = 0 and n = N, garbage past n ignored; the register alone (no
    init part) as JAX returns it; bad shapes refused."""
    rng = np.random.default_rng(9)
    block = rng.integers(0, 256, 4096, dtype=np.uint8)
    for n in (0, 4096, 2049):
        got = int(crc.crc32_device(torch.from_numpy(block), n))
        assert got == int(j_crc(jnp.asarray(block), n))
    assert int(crc.crc32_device(torch.from_numpy(block), 0)) == 0
    with pytest.raises(ValueError):
        crc.crc32_device(torch.zeros(100, dtype=torch.uint8), 10)
    with pytest.raises(ValueError):
        crc.crc32_device(torch.zeros(64, dtype=torch.uint8), 65)
    with pytest.raises(TypeError):
        crc.crc32_device(torch.zeros(64, dtype=torch.int32), 1)
