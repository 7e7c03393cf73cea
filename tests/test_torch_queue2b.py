"""Three functions of the JAX package that the port gained with the
cyclic BWT: bwt2's ``pass4``, the chain's ``chain_mtf`` and
``em_estep_batch`` (lbzip2_tpu_torch/ops/bwt2.py, ops/chain.py), each
against JAX on the CPU, exactly, and against the numpy model of the
kernel it runs on a card where one exists.

- ``pass4``: ISA and counts on Lyndon rows of four kinds at k = 16 and
  k = 6000, where j k is clamped to N for j >= 2 and i + j k passes 2N
  for j = 3 (both regimes of the sentinel rule,
  lbzip2_tpu/ops/bwt2.py:144-148).
- ``chain_mtf``: mtfv, nm and the histogram of mtfv[:nm] (no padded
  groups' count) on BWT rows of 1, 30 and 256 used values with garbage
  past n.
- ``em_estep_batch``: selectors of every group, frequencies and ngroups
  on the symbols of real rows, 1 to 6 trees, lengths up to 30 (costs
  past the 1023 of a 10-bit lane), rows of nm below one group; also
  against the E-step kernel's model (tests/test_torch_em_kernel.py) at
  one iteration, which is what a card's ``lbz2t_em_chain`` with
  cluster_factor 1 runs.
"""

import jax
import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2, chain, rle2

import test_torch_bwt2_kernel as digit_model
import test_torch_em_kernel as em_model

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native lyndon_prep")
N, B = 8192, 8
_J_SEED16 = jax.jit(jbwt2._seed16)
_J_PASS4 = jax.jit(jbwt2._pass4)
_J_CHAIN_MTF = jax.jit(jchain._chain_mtf)
_J_ESTEP = jax.jit(jchain._em_estep_batch)


@pytest.mark.parametrize("k", [16, 6000])
@pytest.mark.parametrize("kind", ["random", "small_alpha", "runs", "deep"])
def test_pass4_matches_jax(kind, k):
    rot, ns = digit_model._batch(digit_model._blocks(kind, 7))
    isa0 = np.array(_J_SEED16(rot, ns)[0])
    w_isa, w_cnt = (np.asarray(a) for a in _J_PASS4(isa0, np.int32(k), ns))
    for fn in (bwt2.pass4, bwt2._pass4_plain,
               lambda i, kk, n: bwt2._passx(i, kk, n, 4)):
        isa, cnt = fn(to_torch(isa0), k, to_torch(ns))
        np.testing.assert_array_equal(to_numpy(isa), w_isa)
        np.testing.assert_array_equal(to_numpy(cnt), w_cnt)
    # _passx at 8 keys is _pass8, JAX's too
    w8 = [np.asarray(a) for a in jbwt2.pass8(isa0, np.int32(k), ns)]
    got8 = bwt2._passx(to_torch(isa0), k, to_torch(ns), 8)
    for g, w in zip(got8, w8):
        np.testing.assert_array_equal(to_numpy(g), w)


def _chain_rows(kind, seed=3):
    """(bwt (B, N) uint8 with garbage past n, ns, cmaps) of BWT rows."""
    rng = np.random.default_rng(seed)
    ns = np.array([N, 8000, 1, 2, 49, 50, 3001, 6000], np.int32)
    bwt = rng.integers(0, 256, (B, N)).astype(np.uint8)
    cmaps = np.zeros((B, 256), np.uint8)
    for b, n in enumerate(ns):
        if kind == "one_value":
            raw = np.full(n, 77, np.uint8)
        elif kind == "values_30":
            raw = rng.integers(100, 130, n).astype(np.uint8)
        else:
            raw = rng.integers(0, 256, n).astype(np.uint8)
            raw[:256] = np.arange(256)[:min(n, 256)]
        row, _ = native.bwt(raw)
        bwt[b, :n] = row
        cmaps[b, np.unique(raw)] = 1
    return bwt, ns, cmaps


@pytest.mark.parametrize("kind", ["one_value", "values_30", "values_256"])
def test_chain_mtf_matches_jax(kind):
    bwt, ns, cmaps = _chain_rows(kind)
    want = [np.asarray(a) for a in _J_CHAIN_MTF(bwt, ns, cmaps)]
    args = (to_torch(bwt), to_torch(ns), to_torch(cmaps))
    for fn in (chain.chain_mtf, chain._chain_mtf_plain):
        got = fn(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_numpy(g), w)
    # the kernel's route on the CPU: the byte entry's plain version, then
    # RLE2 with the flag that leaves the padded groups out
    ninuse = to_torch(cmaps.astype(np.int32).sum(1).astype(np.int32))
    ranks = chain.mtf_ranks_bytes_rows(*args[::2], args[1])
    got = rle2.rle2_hist_rows(ranks, args[1], ninuse, pads=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), w)
    padded = rle2.rle2_hist_rows(ranks, args[1], ninuse)[2]
    assert int((padded - got[2]).sum()) == int(
        (-(-(N + 1) // 50) * 50 - want[1]).sum())


def _estep_case(case):
    rng = np.random.default_rng(case)
    bwt, ns, cmaps = _chain_rows("values_30" if case % 2 else "values_256",
                                 case)
    mtfv, nm, _ = chain._chain_mtf_plain(to_torch(bwt), to_torch(ns),
                                         to_torch(cmaps))
    mtfv, nm = to_numpy(mtfv), to_numpy(nm)
    ninuse = cmaps.astype(np.int32).sum(1).astype(np.int32)
    nt = (np.arange(B) % 6 + 1).astype(np.int32) if case < 2 else \
        np.full(B, 6 if case == 2 else 1, np.int32)
    hi = 31 if case != 3 else 4
    lengths = rng.integers(1, hi, (B, 6, 259)).astype(np.int32)
    return mtfv, nm, ninuse, nt, lengths


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_em_estep_batch_matches_jax(case):
    args = _estep_case(case)
    want = [np.asarray(a) for a in _J_ESTEP(*args)]
    got = chain.em_estep_batch(*(to_torch(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), w)
    # one iteration of the EM kernels' model: the card's single E-step
    sel, freqs = em_model.model_em_loop(*args, 1)[:2]
    np.testing.assert_array_equal(sel, want[0])
    np.testing.assert_array_equal(freqs, want[1])


def test_jax_names_are_the_ports_functions():
    """The JAX modules' jitted names have their counterparts here."""
    assert (bwt2.seed16, bwt2.pass4, bwt2.pass8, bwt2.emit2,
            bwt2.emit_bytes) == (bwt2._seed16, bwt2._pass4, bwt2._pass8,
                                 bwt2._emit2, bwt2._emit_bytes)
    assert (chain.group_hist, chain.em_estep_hist, chain.chain_mtf2) == (
        chain._group_hist, chain._em_estep_hist, chain._chain_mtf2)
    with pytest.raises(ValueError, match="nkeys"):
        bwt2._passx(torch.zeros((1, 8), dtype=torch.int32), 1,
                    torch.ones(1, dtype=torch.int32), 6)
