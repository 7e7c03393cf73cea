"""The flat symbol histogram of the padded groups, counted from the symbols
(lbzip2_tpu_torch/ops/rle2.py::_flat_hist, the plain half of the RLE2
kernel's twin), against the sum of the per-group histogram it replaces
on the card's path and against the JAX package's.
Inputs are made with numpy from seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import chain, rle2
from test_torch_em_kernel import CASES, G, _rows


@pytest.mark.parametrize("name", ["text_8_rows", "as_2_and_258", "rows_1"])
def test_flat_hist_counts_what_the_group_histogram_sums_to(name):
    """_flat_hist, the histogram half of the RLE2 kernel's plain twin,
    against hist_g.sum(1): the pads at lane `as` and symbols clamped to
    lane 258 included."""
    mtfv, nm, ninuse = _rows(CASES[name][0], seed=len(name))
    mtfv[0, 0] = 300  # out of range: lands in lane 258 in both
    args = [to_torch(a) for a in (mtfv, nm, ninuse)]
    got = to_numpy(rle2._flat_hist(*args))
    np.testing.assert_array_equal(
        got, to_numpy(chain._group_hist(*args)[0].sum(1).int()))
    hist_g, _, _ = jchain.group_hist(*(jnp.asarray(a) for a in (
        mtfv, nm, ninuse)))
    np.testing.assert_array_equal(got, np.asarray(hist_g.sum(1)).astype(
        np.int32))
    assert got.sum(1).tolist() == [G * 50] * mtfv.shape[0]


def test_flat_hist_equals_chain_mtf2_of_jax():
    """Through the whole MTF half: the flat histogram that _chain_mtf2
    returns on the card's path against the JAX chain_mtf2's."""
    rng = np.random.default_rng(9)
    bwt = rng.choice(np.array([97, 98, 99, 32, 101, 200], np.uint8),
                     (3, 8192), p=[.4, .2, .1, .15, .1, .05])
    ns = np.array([8192, 5000, 1], np.int32)
    cmaps = np.zeros((3, 256), np.uint8)
    cmaps[:, [32, 97, 98, 99, 101, 200]] = 1
    mtfv, nm, hist, _, _ = chain._chain_mtf2(*(to_torch(a) for a in (
        bwt, ns, cmaps)))
    want = jchain.chain_mtf2(jnp.asarray(bwt), jnp.asarray(ns),
                             jnp.asarray(cmaps))
    ninuse = to_torch(cmaps.sum(1, dtype=np.int32))
    np.testing.assert_array_equal(
        to_numpy(rle2._flat_hist(mtfv, nm, ninuse)), np.asarray(want[2]))
    np.testing.assert_array_equal(to_numpy(hist), np.asarray(want[2]))
