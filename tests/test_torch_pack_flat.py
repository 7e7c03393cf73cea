"""The flat mode of the group-packing kernel (lbzip2_tpu_torch/csrc/
pack_groups.cu, ``lbz2t_pack_flat`` behind ``ops/chain.py::_pack_flat``):
the payload words packed straight into the flat download's slots, held
against the JAX package's ``_flatten_words(pack_groups(...), ends, F)``
(lbzip2_tpu/ops/chain.py:362 over :222, as ``_flatten_download`` :380
composes them), bit for bit.

On CPU tensors ``_pack_flat`` is the plain composition; the numpy model
of the kernel's launch (``test_torch_pack_kernel.py::model`` with
``ends``) stores each row's words at [ends[r - 1], ends[r]) below F, a row
of no words (it does not fit) writing nothing.  Cases: the packing cases
with the word counts chain_payloads gives them, rows left out (the first,
the last, both, all), a row of ngroups 0, F of one and of three
FLAT_CHUNK chunks and F below the last row's end; the chain's payload
bytes through the flat branch against the JAX chain's; and a CUDA tensor
without nvcc raising.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import chain
from test_torch_pack_kernel import CASES, CONFIGS, ORDER, _case, _jax, model

CHUNK = chain.FLAT_CHUNK


def word_ends(args, keep=None):
    """The rows' inclusive word ends as chain_payloads makes them: a row
    that fits W has ceil(total bits / 32) words, one that does not (or
    that ``keep`` leaves out) none."""
    _, total = _jax(args)
    total = total.astype(np.int64)
    fits = total <= 32 * args["W"]
    if keep is not None:
        fits &= keep
    wcnt = np.where(fits, (total + 31) // 32, 0)
    return np.cumsum(wcnt).astype(np.int32)


def _want(args, ends, F):
    """JAX's compaction of JAX's words."""
    words, _ = _jax(args)
    return np.asarray(jchain._flatten_words(jnp.asarray(words),
                                            jnp.asarray(ends), F))


def _check(args, ends, F, chunks=CONFIGS):
    """_pack_flat on the CPU and the kernel's model at each chunk equal
    to JAX, bit for bit; the CPU flat."""
    want = _want(args, ends, F)
    got = chain._pack_flat(*(to_torch(args[k]) for k in ORDER), args["W"],
                           to_torch(ends), F)
    assert got.dtype == torch.int32 and got.shape == (F,)
    np.testing.assert_array_equal(to_numpy(got, like=np.uint32), want)
    for chunk in chunks:
        flat, _ = model(*(args[k] for k in ORDER), args["W"], chunk,
                        ends=ends, F=F)
        np.testing.assert_array_equal(flat, want, err_msg=f"{chunk}")
    return want


@pytest.mark.parametrize("name", CASES)
def test_pack_flat_against_jax(name):
    """Every packing case, the word counts chain_payloads gives it, one
    FLAT_CHUNK of slots."""
    args = _case(name)
    ends = word_ends(args)
    want = _check(args, ends, CHUNK)
    assert not want[ends[-1]:].any()
    if name == "rows_overflow_W":
        assert (np.diff(np.concatenate([[0], ends])) == 0).sum() == 2


@pytest.mark.parametrize("left_out", ["first", "last", "first_and_last",
                                      "all"])
def test_rows_that_do_not_fit(left_out):
    """Rows of wcnt 0 write nothing, the first and the last among them;
    their neighbours' words sit back to back."""
    rng = np.random.default_rng(sum(map(ord, left_out)))
    args = _case("start_bit_31")
    B = len(args["nm"])
    keep = np.ones(B, bool)
    keep[[0] if left_out == "first" else [B - 1] if left_out == "last"
         else [0, B - 1] if left_out == "first_and_last" else
         list(range(B))] = False
    ends = word_ends(args, keep)
    want = _check(args, ends, CHUNK, chunks=[CONFIGS[0], 2])
    assert not want[ends[-1]:].any()
    if left_out == "all":
        assert not want.any()
    # the same rows at other start bits
    args["start_bit"] = rng.integers(0, 32, B).astype(np.int32)
    _check(args, word_ends(args, keep), CHUNK, chunks=[6])


def test_row_of_ngroups_0():
    """A row of ngroups 0 packs no group: its words are the start bits'
    zeros, as many as chain_payloads counts."""
    args = _case("ngroups_0_and_below_G")
    args["start_bit"][:] = [5, 0, 31]
    ends = word_ends(args)
    assert ends[0] == 1
    _check(args, ends, CHUNK)


@pytest.mark.parametrize("F", [3 * CHUNK, 1000])
def test_three_chunks_and_slots_past_F(F):
    """F of three chunks (zeros past the rows' end) and F below the last
    row's end (the slots at and past F dropped)."""
    args = _case("every_code_20_bits")
    ends = word_ends(args)
    assert (F > ends[-1]) == (F == 3 * CHUNK)
    _check(args, ends, F, chunks=[CONFIGS[0], 6])


def test_chain_payloads_through_the_flat_pack():
    """chain_payloads packs through _pack_flat (not _pack_groups and
    _flatten_words) and its payload bytes equal the JAX chain's on the
    same rows."""
    from test_torch_chain import MIXED, _mk_blocks

    bwts, ns, cmaps, idxs, crcs = _mk_blocks(MIXED, seed=11)
    calls = {"_pack_flat": 0, "_pack_groups": 0, "_flatten_words": 0}
    real = {k: getattr(chain, k) for k in calls}

    def spy(name):
        def call(*a):
            calls[name] += 1
            return real[name](*a)
        return call

    try:
        for k in calls:
            setattr(chain, k, spy(k))
        got = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs)
    finally:
        for k, fn in real.items():
            setattr(chain, k, fn)
    assert calls == {"_pack_flat": 1, "_pack_groups": 0,
                     "_flatten_words": 0}
    want = jchain.chain_payloads(jnp.asarray(bwts), ns, cmaps, idxs, crcs)
    assert got == want and all(p for p in got)


def test_pack_flat_raises_for_a_cuda_tensor_without_nvcc(tmp_path,
                                                         monkeypatch):
    """On a CUDA tensor (a fake one: no card here) _pack_flat reaches the
    kernel's build and raises; nothing falls back to the plain versions
    and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lbzip2_tpu_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    calls = []
    for name in ("_pack_groups_plain", "_flatten_words_plain"):
        monkeypatch.setattr(chain, name, lambda *a, _n=name: calls.append(_n))
    B, N = 2, 64
    with FakeTensorMode():
        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device="cuda")

        args = (i32(B, N), i32(B), i32(B), i32(B), i32(B, -(-N // 50)),
                torch.zeros((B, 6, 259), dtype=torch.int64, device="cuda"),
                i32(B, 6, 259), i32(B), 40, i32(B), CHUNK)
    before = chain.pack_launches, chain.flat_launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chain._pack_flat(*args)
    assert (chain.pack_launches, chain.flat_launches) == before
    assert not calls
