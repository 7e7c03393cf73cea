"""The group-packing kernel's single pass
(lbzip2_tpu_torch/csrc/pack_groups.cu) with its CTAs interleaved as the
card may run them, held against the plain ``_pack_groups_plain`` and the
JAX package's ``pack_groups``, exactly.

The model is ``test_torch_pack_kernel.py::model`` (the kernel's launch)
driven by ``test_torch_rle2_lookback.py``'s seeded scheduler: CTAs draw
their tickets as they start (chunk-major across the rows), at most
``resident`` at a time, and each step advances a random resident CTA to
its next point of contact with the others: its chunk's bits published
(status X -> A), each look-back window read (a mix of A and P), its
inclusive sum published (A -> P), its placement.  It runs at the
kernel's chunk (read from the source) and at tiny chunks, so that groups
straddle chunk edges in bits, with the kernel's look-back window of 32
lanes and a window of 3; on rows with ngroups 0, rows past W, symbols
outside the row's alphabet (their entries read from device memory); in
the flat mode, each row's words stored at its flat slots (rows that do
not fit left out, the first and the last among them); and on one device
state over several calls.
"""

import numpy as np
import pytest

from test_torch_pack_kernel import (CONFIGS, ORDER, _case, _inputs, _jax,
                                    _plain, model, new_state)
from test_torch_pack_flat import CHUNK, _want as _want_flat, word_ends
from test_torch_rle2_lookback import random_order


def _want(args):
    want_w, want_t = _plain(args)
    jax_w, jax_t = _jax(args)
    np.testing.assert_array_equal(want_w, jax_w)
    np.testing.assert_array_equal(want_t, jax_t)
    return want_w, want_t


def _run(args, want, seed: int):
    """Every config at residencies 2 and 9, windows 32 and 3, each
    exact; the kinds the look-backs read, by config."""
    kinds = {}
    for c, chunk in enumerate(CONFIGS):
        for resident, window in ((2, 32), (9, 3)):
            rng = np.random.default_rng([seed, c, resident])
            seen: list = []
            words, total = model(*(args[k] for k in ORDER), args["W"], chunk,
                                 random_order(rng, resident), window,
                                 seen=seen)
            np.testing.assert_array_equal(words, want[0],
                                          err_msg=f"{chunk} {resident}")
            np.testing.assert_array_equal(total, want[1])
            kinds.setdefault(chunk, []).extend(seen)
    return kinds


CASES = ["start_bit_0", "start_bit_31", "every_code_20_bits",
         "zero_length_groups", "dummy_symbol_has_a_length",
         "ngroups_0_and_below_G", "rows_overflow_W", "one_row"]


@pytest.mark.parametrize("name", CASES)
def test_interleaved_against_plain_and_jax(name):
    args = _case(name)
    kinds = _run(args, _want(args), sum(map(ord, name)))
    assert {"A", "P"} <= set(kinds[2]), "tiny chunks met one kind only"


def test_ngroups_0_rows_and_rows_past_W():
    """Every row with ngroups 0 (chunk 0 writes start_bit as the total,
    no word is written), then rows past W beside one that fits."""
    rng = np.random.default_rng(30)
    args = _inputs(rng, 3, 3001, [3001, 40, 1], [255, 9, 2])
    args["ngroups"][:] = 0
    want = _want(args)
    assert not want[0].any() and (want[1] == args["start_bit"]).all()
    _run(args, want, 30)
    args = _inputs(rng, 4, 6001, [6001, 6001, 200, 5000], [255, 100, 3, 60])
    args["W"] = 333
    want = _want(args)
    assert (want[1] > 32 * 333).sum() == 3
    _run(args, want, 31)


def test_symbols_outside_the_alphabet():
    """Symbols past ninuse + 2 (and the dummy's lane past 258): their
    entries come from device memory, the same as the plain gather's."""
    rng = np.random.default_rng(32)
    args = _inputs(rng, 3, 2001, [2001, 1500, 999], [3, 40, 256])
    args["mtfv"][0, :1999] = rng.integers(0, 259, 1999)
    args["mtfv"][1, 100:700] = rng.integers(40, 259, 600)
    args["lens"][:] = rng.integers(1, 21, args["lens"].shape)
    args["codes"] = (rng.integers(0, 1 << 20, args["lens"].shape) &
                     ((1 << args["lens"]) - 1)).astype(np.uint32)
    want = _want(args)
    seen: list = []
    words, total = model(*(args[k] for k in ORDER), args["W"], 6,
                         random_order(np.random.default_rng(3), 5), 32,
                         seen=seen)
    np.testing.assert_array_equal(words, want[0])
    np.testing.assert_array_equal(total, want[1])
    assert seen.count("global") > 1000


def test_stale_descriptors_of_an_earlier_call():
    """Calls of several shapes on one device state: none reads an
    earlier call's descriptor, each leaves the ticket at 0."""
    st = new_state()
    for i, name in enumerate(["one_row", "rows_overflow_W", "start_bit_31",
                              "one_row"]):
        args = _case(name)
        want = _want(args)
        words, total = model(*(args[k] for k in ORDER), args["W"], 6,
                             random_order(np.random.default_rng(i), 7),
                             3, state=st)
        np.testing.assert_array_equal(words, want[0])
        np.testing.assert_array_equal(total, want[1])
    assert st["epoch"] == 4 and st["ticket"] == 0


@pytest.mark.parametrize("name", ["rows_overflow_W", "start_bit_31",
                                  "ngroups_0_and_below_G"])
def test_interleaved_flat_stores(name):
    """The flat mode interleaved: every row's words at [ends[r - 1],
    ends[r]) of the flat slots, exactly JAX's compaction of its words;
    the first and the last row left out of start_bit_31."""
    args = _case(name)
    keep = np.ones(len(args["nm"]), bool)
    if name == "start_bit_31":
        keep[[0, -1]] = False
    ends = word_ends(args, keep)
    want = _want_flat(args, ends, CHUNK)
    for c, chunk in enumerate(CONFIGS):
        for resident, window in ((2, 32), (9, 3)):
            rng = np.random.default_rng([sum(map(ord, name)), c, resident])
            seen: list = []
            flat, _ = model(*(args[k] for k in ORDER), args["W"], chunk,
                            random_order(rng, resident), window, seen=seen,
                            ends=ends, F=CHUNK)
            np.testing.assert_array_equal(flat, want,
                                          err_msg=f"{chunk} {resident}")
