"""The cyclic and 4-key modes of lbzip2_tpu_torch/csrc/bwt2_sort.cu, row
by row in numpy, against the port's plain versions and JAX on the CPU.

The numpy models of the bwt2 kernels (tests/test_torch_bwt2_seed_runs.py,
tests/test_torch_bwt2_segmented.py, tests/test_torch_bwt2_kernel.py)
take the modes as arguments: the seed's cyclic gather (words W0..W3 of
bytes (p + d) mod n, and the pads' key of sixteen FF bytes: a lone valid
lane of that key counts as unresolved when the row has pads, and no
rank moves); the pass's cyclic mapping N + ISA[(p + (j k mod n)) mod n],
the offset taken mod n in 64 bits (k passes n in the loop); the
tie-break mapping n - 1 - p past key 0; and the 4-key pass (keys 4 to 7
stored as 0 for the 7-key block sorts).  They are held against
``_seed_cyclic_plain`` (JAX's ``_seed_sparse``), ``_pass_cyclic_plain``,
``_pass4_plain`` and JAX's ``pass4``, and the model's whole loop on the
card (the seed, loop_passes(N) passes with a row skipped once resolved,
the tie-break) against the final ISA of JAX's sparse task.  Valid lanes
and counts, exactly.  Rows as in tests/test_torch_bwt_v1.py.
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops import bwt as jbwt
from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu_torch.ops import bwt, bwt2

import test_torch_bwt2_kernel as digit_model
import test_torch_bwt2_seed_runs as seed_model
import test_torch_bwt2_segmented as seg_model
from test_torch_bwt_v1 import B, N, batch, blocks_of

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "lbzip2_tpu_torch" / "csrc" / "bwt2_sort.cu"
_J_SEED = jax.jit(jbwt._seed_sparse)
_J_PASS4 = jax.jit(jbwt2._pass4)
_J_SEED16 = jax.jit(jbwt2._seed16)


def _rows(kind):
    rows, ns = batch(blocks_of(kind))
    return rows, ns, torch.from_numpy(rows), torch.from_numpy(ns)


def _valid(isa, ns):
    return [np.asarray(isa)[r, :ns[r]] for r in range(len(ns))]


def _assert_valid(got, want, ns, who):
    for r, (g, w) in enumerate(zip(_valid(got, ns), _valid(want, ns))):
        np.testing.assert_array_equal(g, w, f"{who}: row {r}")


@pytest.mark.parametrize("kind,bins", [
    ("edges", "real"), ("values_2", "real"), ("values_4", "tiny"),
    ("periodic", "real"), ("periodic", "tiny"), ("ff_runs", "real"),
    ("text", "tiny")])
def test_cyclic_seed_model(kind, bins):
    """The seed's model in its cyclic mode, at the kernel's bins and at
    tiny ones (every route, two run digits), against the plain seed and
    JAX's ``_seed_sparse``."""
    rows, ns, t_rows, t_ns = _rows(kind)
    bins = seed_model.BINS if bins == "real" else seed_model.TINY
    w_isa, _, _, w_cnt = (np.asarray(a) for a in _J_SEED(rows, ns))
    isa, cnt = bwt._seed_cyclic_plain(t_rows, t_ns)
    np.testing.assert_array_equal(cnt.numpy(), w_cnt)
    _assert_valid(isa.numpy(), w_isa, ns, "plain seed")
    rng = np.random.default_rng(5)
    for r in range(B):
        m_isa, m_cnt = seed_model.model_seed(rows[r], int(ns[r]), bins, rng,
                                             cyclic=True)
        n = int(ns[r])
        np.testing.assert_array_equal(m_isa[:n], w_isa[r, :n], f"row {r}")
        assert m_cnt == w_cnt[r], (r, m_cnt, w_cnt[r])


@pytest.mark.parametrize("kind", ["values_2", "periodic", "text"])
def test_cyclic_passes_models(kind):
    """Every pass of the loop (k = 16, 128, 1024: past n on the short
    rows) by the segmented model and by the digit passes' model, against
    ``_pass_cyclic_plain``; lanes shuffled inside each class."""
    rows, ns, t_rows, t_ns = _rows(kind)
    isa, _ = bwt._seed_cyclic_plain(t_rows, t_ns)
    rng = np.random.default_rng(6)
    k = 16
    for _ in range(bwt2.loop_passes(N)):
        want, w_cnt = bwt._pass_cyclic_plain(isa, k, t_ns)
        seg = isa.numpy().astype(np.int64)
        for r in range(B):
            n = int(ns[r])
            c = seg_model.model_pass(seg[r], k, n, rng=rng, mapping="cyclic")
            assert c == int(w_cnt[r]), (k, r)
            d_isa, d_cnt = digit_model.model_pass8(
                isa.numpy()[r].astype(np.int64), k, n, mapping="cyclic")
            assert d_cnt == int(w_cnt[r]), (k, r)
            np.testing.assert_array_equal(d_isa[:n], want.numpy()[r, :n])
        _assert_valid(seg, want.numpy(), ns, f"k = {k}")
        isa = want
        k *= 8


@pytest.mark.parametrize("kind", ["periodic", "values_2"])
def test_tie_break_models(kind):
    """The tie-break pass after the loop, by both models, against its
    plain version; the result is JAX's final ISA, a permutation of
    [0, n) on each row."""
    rows, ns, t_rows, t_ns = _rows(kind)
    isa, cnt = bwt._seed_cyclic_plain(t_rows, t_ns)
    k = 16
    for _ in range(bwt2.loop_passes(N)):
        isa, cnt = bwt._pass_cyclic_plain(isa, k, t_ns)
        k *= 8
    want, w_cnt = bwt._pass_cyclic_plain(isa, 1, t_ns, tie=True)
    assert int(w_cnt.max()) == 0
    seg = isa.numpy().astype(np.int64)
    for r in range(B):
        n = int(ns[r])
        assert seg_model.model_pass(seg[r], 1, n, nkeys=4,
                                    mapping="tie") == 0
        d_isa, d_cnt = digit_model.model_pass8(
            isa.numpy()[r].astype(np.int64), 1, n, nkeys=4, mapping="tie")
        assert d_cnt == 0
        np.testing.assert_array_equal(d_isa[:n], want.numpy()[r, :n])
        assert sorted(want.numpy()[r, :n].tolist()) == list(range(n))
    _assert_valid(seg, want.numpy(), ns, "tie-break")
    jt = jbwt.SparseBwtTask(rows, ns)
    jt.result()
    _assert_valid(want.numpy(), np.asarray(jt.ISA), ns, "JAX's final ISA")


@pytest.mark.parametrize("k", [16, 6000])
def test_four_key_pass_models(k):
    """The 4-key suffix pass (bwt2's ``_pass4``) by both models, against
    ``_pass4_plain`` and JAX's ``_pass4`` on the Lyndon rows of
    tests/test_torch_bwt2_kernel.py; k = 6000 takes both regimes of the
    offsets (j k clamped to N, and i + j k past 2N)."""
    rot, ns = digit_model._batch(digit_model._blocks("runs", 2))
    isa0 = np.array(_J_SEED16(rot, ns)[0])
    w_isa, w_cnt = (np.asarray(a) for a in _J_PASS4(isa0, np.int32(k), ns))
    isa, cnt = bwt2._pass4_plain(torch.from_numpy(isa0), k,
                                 torch.from_numpy(ns))
    np.testing.assert_array_equal(isa.numpy(), w_isa)
    np.testing.assert_array_equal(cnt.numpy(), w_cnt)
    seg = isa0.astype(np.int64)
    for r in range(B):
        n = int(ns[r])
        assert seg_model.model_pass(seg[r], k, n, nkeys=4) == w_cnt[r]
        d_isa, d_cnt = digit_model.model_pass8(isa0[r].astype(np.int64), k,
                                               n, nkeys=4)
        assert d_cnt == w_cnt[r]
        np.testing.assert_array_equal(d_isa[:n], w_isa[r, :n])
    _assert_valid(seg, w_isa, ns, "segmented model")


@pytest.mark.parametrize("kind", ["edges", "ff_runs"])
def test_model_loop_matches_jax(kind):
    """The loop as the card runs it, in the models: the cyclic seed,
    loop_passes(N) passes, a row skipped once the seed or a pass left it
    no tie, then the tie-break under the same rule; the final ISA is
    JAX's and the emit gives JAX's rows and primaries."""
    rows, ns, t_rows, t_ns = _rows(kind)
    isa = np.zeros((B, N), np.int64)
    prev = []
    for r in range(B):
        isa[r], c = seed_model.model_seed(rows[r], int(ns[r]), cyclic=True)
        prev.append(c)
    k = 16
    for _ in range(bwt2.loop_passes(N) + 1):
        tie = k > 16 * 8 ** (bwt2.loop_passes(N) - 1)
        for r in range(B):
            prev[r] = seg_model.model_pass(
                isa[r], 1 if tie else k, int(ns[r]), prev[r],
                nkeys=4 if tie else 8, mapping="tie" if tie else "cyclic")
        k *= 8
    assert not any(prev)
    jt = jbwt.SparseBwtTask(rows, ns)
    w_packed, w_prim = jt.result()
    _assert_valid(isa, np.asarray(jt.ISA), ns, "the model's loop")
    packed, prim = bwt._emit_sparse_plain(
        t_rows, torch.from_numpy(isa.astype(np.int32)), t_ns)
    np.testing.assert_array_equal(packed.numpy(), w_packed)
    np.testing.assert_array_equal(prim.numpy(), w_prim)


def test_the_kernel_source_has_the_modes():
    """The modes the models follow are the kernel's: the cyclic gather
    (one subtraction, then the division for n < 16), the pass's three
    mappings, the offsets j k mod n taken by seg_setup in 64 bits, the
    cyclic pads' rule, the instances the launcher dispatches to, and the
    wrappers' mapping numbers."""
    src = SRC.read_text()
    assert "if (q >= n) q -= n;\n  if (q >= n) q %= n;" in src
    assert "return q < n ? N + isa[base + q] : N - 1 - p;" in src
    assert "return N + isa[base + (q >= n ? q - n : q)];" in src
    assert "return off < 0 ? n - 1 - p : N + isa[base + p];" in src
    assert "n > 0 ? static_cast<int>(offs.jk[j] % n) : 0;" in src
    assert "m += (w[0] & w[1] & w[2]) == kFull;" in src
    assert "if (threadIdx.x == 0 && equal == 1) cnt[b] += 1;" in src
    for inst in ("pass<8, kSuffix>", "pass<4, kSuffix>", "pass<8, kCyclic>",
                 "pass<4, kTieBreak>", "seed<true>", "seed<false>"):
        assert inst in src
    consts = dict(re.findall(r"k(Suffix|Cyclic|TieBreak) = (\d)", src))
    assert (int(consts["Suffix"]), int(consts["Cyclic"]),
            int(consts["TieBreak"])) == (bwt2.SUFFIX, bwt2.CYCLIC,
                                         bwt2.TIE_BREAK)
    assert "else  // the block sorts compare 7 keys: 4 to 7 equal" in src
