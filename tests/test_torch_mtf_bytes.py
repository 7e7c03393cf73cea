"""The MTF kernel's byte entry (``ops/mtf_pallas.py::mtf_ranks_bytes_rows``,
``_compact_syms`` fused into the loads of csrc/mtf_ranks.cu), the flat
payload compaction (``ops/chain.py::_flatten_words``, csrc/flatten_words.cu)
and the port's copy of the host RLE2 (``codec/rle2.py``), against the JAX
package.

On a CPU tensor the wrappers run their plain versions, which must equal
JAX's ``_compact_syms`` then ``mtf_ranks`` (and ``chain_mtf2``) and
``_flatten_words``.  Numpy models follow the kernels: the symbol table a
warp builds from the row's used-byte map (lane l sums bytes 8 l .. 8 l + 7,
a warp scan gives the sums below) and the load through it; the binary
search of each flat slot's row in the rows' word sums.  Inputs are made
with numpy from seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.codec.rle2 import rle2_from_ranks as j_codec_rle2
from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu_torch.codec.rle2 import rle2_from_ranks as t_codec_rle2
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import chain, mtf_pallas
from lbzip2_tpu_torch.ops.rle2 import rle2_from_ranks as t_ops_rle2

N = 4096


def _rows(kind: str):
    """(bwt (4, N) uint8, ns, cmaps (4, 256) uint8) of one kind: rows of
    ``kind`` used values below n (1, 30 or 256), with garbage past n
    (values the map does not mark) in the last kind."""
    rng = np.random.default_rng({"used_1": 40, "used_30": 41, "used_256": 42,
                                 "garbage_past_n": 43}[kind])
    ns = np.array([N, 3000, 1, 0], np.int32)
    if kind == "used_1":
        vals = np.array([77], np.uint8)
    elif kind == "used_256":
        vals = np.arange(256, dtype=np.uint8)
    else:
        vals = rng.choice(np.arange(1, 255, dtype=np.uint8), 30,
                          replace=False)
    bwt = vals[rng.integers(0, vals.size, (4, N))]
    if kind == "garbage_past_n":
        ns = np.array([2500, 4000, 17, 0], np.int32)
        for b in range(4):
            bwt[b, ns[b]:] = rng.choice([0, 255], N - ns[b])
    cmaps = np.zeros((4, 256), np.uint8)
    for b in range(4):
        cmaps[b, np.unique(bwt[b, :ns[b]])] = 1
    if kind == "used_256":
        cmaps[:] = 1
    return bwt, ns, cmaps


@pytest.mark.parametrize("kind", ["used_1", "used_30", "used_256",
                                  "garbage_past_n"])
def test_fused_load_plain_against_jax(kind):
    bwt, ns, cmaps = _rows(kind)
    got = to_numpy(mtf_pallas.mtf_ranks_bytes_rows(
        to_torch(bwt), to_torch(cmaps), to_torch(ns)))
    syms = jchain._compact_syms(jnp.asarray(bwt), jnp.asarray(cmaps))
    want = np.asarray(jchain._mtf_ranks_rows(syms, jnp.asarray(ns)))
    np.testing.assert_array_equal(got, want)
    # the chain's first half, which now runs the byte entry
    got2 = chain._chain_mtf2(to_torch(bwt), to_torch(ns), to_torch(cmaps))
    want2 = jchain.chain_mtf2(jnp.asarray(bwt), jnp.asarray(ns),
                              jnp.asarray(cmaps))
    for g, w in zip(got2, want2):  # mtfv, nm, hist, hist_g, ngroups
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


def table_model(cmap: np.ndarray) -> np.ndarray:
    """The kernel's table: lane l of one warp sums bytes 8 l .. 8 l + 7 of
    the map, an inclusive warp scan of the sums less its own gives the
    used values below the lane's, then the lane walks its eight."""
    c = cmap.astype(np.int64).reshape(32, 8)
    sums = c.sum(1)
    below = np.cumsum(sums) - sums
    tab = np.empty(256, np.int64)
    for lane in range(32):
        run = below[lane]
        for k in range(8):
            tab[8 * lane + k] = run
            run += c[lane, k]
    return tab


@pytest.mark.parametrize("kind", ["random", "extremes"])
def test_table_model_and_load(kind):
    """The table model against ``_compact_syms``' table, and the load
    (tab[byte] & 255) against ``_compact_syms`` on the lanes < n."""
    rng = np.random.default_rng(44)
    if kind == "random":
        cmaps = (rng.random((6, 256)) < rng.random((6, 1))).astype(np.uint8)
    else:
        cmaps = np.zeros((4, 256), np.uint8)
        cmaps[1] = 1
        cmaps[2, 255] = 1
        cmaps[3, 0] = 1
    B = cmaps.shape[0]
    bwt = rng.integers(0, 256, (B, 512), dtype=np.uint8)
    ns = rng.integers(0, 513, B).astype(np.int32)
    got = to_numpy(mtf_pallas._compact_syms(to_torch(bwt), to_torch(cmaps)))
    for b in range(B):
        tab = table_model(cmaps[b])
        np.testing.assert_array_equal(
            tab, np.cumsum(cmaps[b], dtype=np.int64) - cmaps[b])
        n = ns[b]
        np.testing.assert_array_equal(tab[bwt[b, :n]] & 255, got[b, :n])


def flatten_model(words, ends, F, base):
    """The flatten kernel slot by slot: the first row whose sum exceeds
    the slot (a binary search), its word at the slot less the row's
    start, clamped to the width; 0 past the last row."""
    B, W = words.shape
    out = np.zeros(F, words.dtype)
    for j in range(F):
        f = base + j
        lo, hi = 0, B
        while lo < hi:
            mid = (lo + hi) // 2
            if ends[mid] <= f:
                lo = mid + 1
            else:
                hi = mid
        if lo < B:
            start = ends[lo - 1] if lo else 0
            out[j] = words[lo, min(max(f - start, 0), W - 1)]
    return out


FLATTEN = {
    "base_0": ([300, 0, 17, 250, 1], 1000, 0),
    "base_700": ([300, 0, 17, 250, 1], 512, 700),
    "past_the_end": ([300, 0, 17, 250, 1], 256, 500),
    "leading_empty_rows": ([0, 0, 300, 0, 120], 700, 0),
    "one_row": ([123], 300, 5),
}


@pytest.mark.parametrize("name", sorted(FLATTEN))
def test_flatten_model_plain_and_jax(name):
    wc, F, base = FLATTEN[name]
    rng = np.random.default_rng(45)
    words = rng.integers(0, 1 << 32, (len(wc), 300),
                         dtype=np.uint64).astype(np.uint32)
    ends = np.cumsum(np.array(wc, np.int32)).astype(np.int32)
    want = np.asarray(jchain._flatten_words(jnp.asarray(words),
                                            jnp.asarray(ends), F, base))
    np.testing.assert_array_equal(flatten_model(words, ends, F, base), want)
    # the card's layout: the u32 words as int32 bit patterns
    got = chain._flatten_words(torch.from_numpy(words.view(np.int32)),
                               to_torch(ends), F, base)
    np.testing.assert_array_equal(to_numpy(got).view(np.uint32), want)


@pytest.mark.parametrize("zero_p", [0.0, 0.6, 1.0])
def test_codec_rle2_copy(zero_p):
    """The port's host RLE2 against the JAX package's and against the
    device form's single-row ``rle2_from_ranks``."""
    rng = np.random.default_rng(46)
    n, ninuse = 5000, 200
    ranks = rng.integers(1, ninuse, n).astype(np.int32)
    ranks[rng.random(n) < zero_p] = 0
    got = t_codec_rle2(ranks, ninuse)
    np.testing.assert_array_equal(got, j_codec_rle2(ranks, ninuse))
    mtfv, nm = t_ops_rle2(torch.from_numpy(ranks), n, ninuse)
    assert got.dtype == np.uint16 and int(nm) == got.size
    np.testing.assert_array_equal(to_numpy(mtfv)[:got.size], got)


def test_cuda_wrappers_raise_without_nvcc(tmp_path, monkeypatch):
    """The byte entry and the flat compaction on CUDA tensors (fake ones:
    no card here) reach their kernels' build and raise; nothing falls
    back to the plain versions and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lbzip2_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    calls = []
    for mod, name in ((mtf_pallas, "mtf_ranks_bytes_plain"),
                      (mtf_pallas, "_compact_syms"),
                      (chain, "_flatten_words_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name: calls.append(_n))
    with FakeTensorMode():
        bwt = torch.zeros((2, 64), dtype=torch.uint8, device="cuda")
        cmaps = torch.ones((2, 256), dtype=torch.uint8, device="cuda")
        ns = torch.full((2,), 64, dtype=torch.int32, device="cuda")
        words = torch.zeros((2, 64), dtype=torch.int32, device="cuda")
    before = (mtf_pallas.launches, mtf_pallas.bytes_launches,
              chain.flatten_launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mtf_pallas.mtf_ranks_bytes_rows(bwt, cmaps, ns)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chain._flatten_words(words, ns, 128, 0)
    assert (mtf_pallas.launches, mtf_pallas.bytes_launches,
            chain.flatten_launches) == before
    assert not calls
    meta = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mtf_pallas.mtf_ranks_bytes_rows(meta, cmaps, ns)
    with pytest.raises(ValueError, match="unsupported device"):
        chain._flatten_words(meta.int(), ns, 128, 0)
