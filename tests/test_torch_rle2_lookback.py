"""The RLE2 kernel's single pass (lbzip2_tpu_torch/csrc/rle2.cu) with its
CTAs interleaved as the card may run them, held against the plain
``rle2_hist_plain`` and the JAX package's ``rle2_batch`` with the
group-summed histogram of ``chain_mtf2``, exactly.

The model is ``test_torch_rle2_kernel.py::model`` (the kernel's launches)
driven by a seeded scheduler: CTAs draw their tickets as they start (the
ticket order is tile-major across the rows), at most ``resident`` at a
time, and each step advances a random resident CTA to its next point of
contact with the others: its aggregate published (status X -> A), each
look-back window read (a lane spins while its tile is X; the window meets
a mix of A and P), its inclusive Run published (A -> P), its emit.  It
runs at the kernel's tile (read from the source) and at tiny tiles, so
that runs cross many tile edges, with the kernel's look-back window of 32
lanes and a window of 3 that walks far back through aggregates; and twice
on one device state, the second call reading the first call's
descriptors as stale.
"""

import numpy as np
import pytest

from test_torch_rle2_kernel import (CONFIGS, _case, _jax, _plain, model,
                                    new_state, row_runs)


def random_order(rng, resident: int):
    """A schedule: CTAs start in ticket order while fewer than
    ``resident`` run; each step advances a random running CTA by one
    step.  A CTA waits only on lower tickets, all started, so the lowest
    running one always moves."""
    def run(factories):
        active, nxt, steps = [], 0, 0
        while nxt < len(factories) or active:
            while len(active) < resident and nxt < len(factories):
                active.append(factories[nxt]())
                nxt += 1
            i = int(rng.integers(len(active)))
            try:
                next(active[i])
            except StopIteration:
                active.pop(i)
            steps += 1
            assert steps < 10 ** 7, "no progress"
    return run


def _stress(name: str):
    """Look-back stress rows, (ranks, ns, ninuse): one zero run across
    every tile of the row (all-zero ranks, n = N), one run of the whole
    row after a nonzero, and rows of n = 0, 1 and 2."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one_run_across_every_tile":
        N = 2 * 4096 + 3  # three of the kernel's tiles
        r = np.zeros((3, N), np.int32)
        r[1, 0] = 9  # one nonzero, then one run of N - 1
        r[2, N - 1] = 4  # one run, then one nonzero at lane n - 1
        return r, np.array([N, N, N]), np.array([1, 10, 5])
    if name == "n_0_1_2":
        r = rng.integers(0, 3, (6, 300)).astype(np.int32)
        r[:, :2] = [[0, 0], [5, 0], [0, 7], [3, 3], [0, 0], [1, 0]]
        return r, np.array([0, 1, 1, 2, 2, 2]), np.array([3, 6, 8, 4, 1, 2])
    raise KeyError(name)


def _want(ranks, ns, ninuse):
    want = _plain(ranks, ns, ninuse)
    for w, j in zip(want, _jax(ranks, ns, ninuse)):
        np.testing.assert_array_equal(w, j)
    return want


def _run(ranks, ns, ninuse, want, seed: int, window: int):
    """Every config at residencies 2, 7 and 40, each exact; the kinds
    the look-backs read."""
    kinds = []
    for c, (threads, per) in enumerate(CONFIGS):
        for resident in (2, 7, 40):
            rng = np.random.default_rng([seed, c, resident, window])
            seen: list = []
            got, events = model(ranks, ns, ninuse, threads, per,
                                random_order(rng, resident), window,
                                seen=seen)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(
                    g, w, err_msg=f"{threads}x{per} resident {resident}")
            assert sorted((b, end, k) for b, _, end, k in events) == \
                sorted(row_runs(ranks, ns, ranks.shape[1]))
            kinds.append(((threads, per), resident, seen))
    return kinds


CASES = ["all_zero", "pow2_runs_across_tile_edges",
         "run_over_three_tiles_and_runs_ending_at_n", "n_0_1_and_N",
         "garbage_past_n", "mixed_n"]


@pytest.mark.parametrize("window", [32, 3])
@pytest.mark.parametrize("name", CASES)
def test_interleaved_against_plain_and_jax(name, window):
    ranks, ns, ninuse = _case(name)
    kinds = _run(ranks, ns, ninuse, _want(ranks, ns, ninuse),
                 sum(map(ord, name)), window)
    # tiny tiles give every row many tiles: the look-backs meet both
    # kinds once CTAs overlap
    for cfg, resident, seen in kinds:
        if cfg == (4, 4) and resident > 2:
            assert {"A", "P"} <= set(seen), (cfg, resident)


@pytest.mark.parametrize("name", ["one_run_across_every_tile", "n_0_1_2"])
def test_stress_rows(name):
    ranks, ns, ninuse = _stress(name)
    _run(ranks, ns, ninuse, _want(ranks, ns, ninuse), 7, 3)


def test_look_back_reaches_tile_0_through_aggregates():
    """With every CTA resident and the window of 3, some look-back reads
    30 aggregates or more before its first inclusive Run (tile 0's P, or
    the identity left of it, ends the longest)."""
    rng = np.random.default_rng(5)
    ranks = np.where(rng.random((3, 400)) < 0.7, 0,
                     rng.integers(1, 256, (3, 400))).astype(np.int32)
    ns, ninuse = np.array([400, 333, 2]), np.array([255, 30, 256])
    want = _want(ranks, ns, ninuse)
    deepest = 0
    for seed in range(4):
        seen: list = []
        got, _ = model(ranks, ns, ninuse, 2, 1,
                       random_order(np.random.default_rng(seed), 10 ** 6),
                       3, seen=seen)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        run = longest = 0
        for k in seen:
            run = run + 1 if k == "A" else 0
            longest = max(longest, run)
        deepest = max(deepest, longest)
    assert deepest >= 30, deepest


def test_stale_descriptors_of_an_earlier_call():
    """Three calls on one device state: each later one (another shape,
    so its tiles sit where the earlier calls' other tiles were) reads
    none of the earlier calls' descriptors, and each leaves the ticket,
    the row counts and the counters at 0."""
    st = new_state()
    for name, seed in (("pow2_runs_across_tile_edges", 1), ("mixed_n", 2),
                       ("all_zero", 3)):
        ranks, ns, ninuse = _case(name)
        want = _want(ranks, ns, ninuse)
        got, _ = model(ranks, ns, ninuse, 5, 3,
                       random_order(np.random.default_rng(seed), 9),
                       state=st)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert st["epoch"] == 3 and st["ticket"] == 0
    assert {d[0] for d in st["desc"]} <= {0, 1, 2, 3}
