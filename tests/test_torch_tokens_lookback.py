"""The token scan's single pass (``tok_scan`` then ``tok_tail`` of
lbzip2_tpu_torch/csrc/bwt2_emit.cu) with its CTAs interleaved as the card
may run them, held against the port's plain ``_tokens_plain`` and the JAX
package's ``emit2`` tokens and run counts, exactly.

The model is ``test_torch_emit_kernel.py::tokens_model`` driven by
``test_torch_rle2_lookback.py``'s seeded scheduler: CTAs draw their
tickets as they start (tile-major across the rows), at most ``resident``
at a time, and each step advances a random resident CTA to its next point
of contact with the others: its aggregate published (X -> A), each
look-back window read (a lane spins while its tile is X; the window meets
a mix of A and P), its inclusive span published (A -> P), its starts
placed, its tokens stored.  The combine of two spans (first and last
change, the starts from the first change on) is checked against spans
counted lane by lane and for associativity.  Every case runs at the
kernel's tile (read from the source) and at tiles of 16 and 2 lanes, so
that runs cross many tile edges, with the look-back window of 32 lanes
and one of 3 that walks far back through aggregates; and calls of other
shapes run on one device state, each reading the earlier calls'
descriptors as stale.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu.ops import bwt2 as jbwt2
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import bwt2
from test_torch_emit_kernel import (CONFIGS, EMPTY, MAXLEN, _assert_tokens,
                                    _smoke, new_token_state, seg_combine,
                                    tokens_model)
from test_torch_rle2_lookback import random_order

def span(row, n: int, x: int, y: int):
    """The span (fc, lc, cnt, hi) of lanes [x, y) of a row, counted lane
    by lane: its changes, and the starts from its first change on."""
    y = min(y, n)
    fc = lc = -1
    cnt = 0
    for p in range(x, y):
        if p == 0 or row[p] != row[p - 1]:
            fc = p if fc < 0 else fc
            lc = p
            cnt += 1
        elif lc >= 0 and (p - lc) % MAXLEN == 0:
            cnt += 1
    return fc, lc, cnt, y


def rows_for(name: str, T: int):
    """Token rows (B, N) uint8 and ns for tiles of T lanes, N a multiple
    of 8 with at least four tiles and room for runs past 255."""
    N = -(-max(4 * T + 8, 1032) // 8) * 8
    rng = np.random.default_rng(sum(map(ord, name)) + T)
    D = rng.integers(0, 256, (3, N), dtype=np.uint8)
    if name == "one_run_whole_row":
        D[0] = 7
        D[1, :] = 9
        D[1, N // 2:] = 10  # two runs, each past 255
        return D, np.array([N, N, N - 3], np.int32)
    if name == "runs_255k_at_a_tile_edge":
        # runs of exactly 255 k lanes ending at a tile edge, one lane
        # before it and one lane after it
        for r, shift in enumerate((0, -1, 1)):
            p = 0
            for k, edge in enumerate(range(T, N, T)):
                L = MAXLEN * (k % 3 + 1)
                lo = edge + shift - L
                if lo <= p or edge + shift + 1 >= N:
                    continue
                D[r, lo:lo + L] = D[r, lo - 1] ^ 1
                D[r, lo + L] = D[r, lo] ^ 2
                p = lo + L + 1
        return D, np.array([N, N, N], np.int32)
    if name == "long_run_over_tiles":
        D[0, 5:5 + 3 * T + 600] = 4  # a run over several tiles
        D[1, T - 3:] = 8  # a run from before an edge to n
        D[2, 1:N - 1] = 6
        return D, np.array([N, N - 5, N], np.int32)
    if name == "alternating_past_cap":
        D[0] = np.arange(N) % 2 + 30
        D[1] = rng.integers(0, 2, N) + 50
        return D, np.array([N, N, N // 2], np.int32)
    if name == "n_0_1_2":
        return D[:, :N], np.array([0, 1, 2], np.int32)
    raise KeyError(name)


def _want(D, ns):
    """The port's plain tokens, equal to JAX's emit2 of blocks whose BWT
    rows are D (chip_smoke.py's emit_inputs under random permutations)."""
    want = tuple(to_numpy(t) for t in bwt2._tokens_plain(to_torch(D),
                                                         to_torch(ns)))
    blocks, isa, ns2, ms = _smoke().emit_inputs(D, ns,
                                                np.random.default_rng(40))
    tok_j, _, cnt_j, _ = (np.asarray(a) for a in jbwt2.emit2(
        jnp.asarray(blocks), jnp.asarray(isa), jnp.asarray(ns2),
        jnp.asarray(ms)))
    _assert_tokens((tok_j, cnt_j), want, ns)
    return want


def _run(D, ns, want, seed: int, window: int, config):
    """The scan at residencies 2, 7 and 40, each exact: the kinds the
    look-backs read."""
    threads, per = config
    seen_all = []
    for resident in (2, 7, 40):
        rng = np.random.default_rng([seed, threads, resident, window])
        seen: list = []
        got = tokens_model(D, ns, threads, per, random_order(rng, resident),
                           window, seen=seen)
        _assert_tokens(got, want, ns)
        assert not got[0].view(np.uint16)[
            np.arange(got[0].shape[1] * 2)[None] >= got[1][:, None]].any()
        seen_all += seen
    return seen_all


def test_combine_against_spans_counted_lane_by_lane():
    """Spans cut at random points and combined in every grouping of
    three (a tile's threads, the tiles of a window, the prefix) equal the
    span counted lane by lane, on rows with runs past 255."""
    rng = np.random.default_rng(41)
    for trial in range(60):
        n = int(rng.integers(1, 1500))
        row = np.repeat(rng.integers(0, 3, 40), rng.integers(1, 400, 40))
        row = row[:n] if row.size >= n else np.resize(row, n)
        x, a, b, y = sorted(int(v) for v in rng.integers(0, n + 1, 4))
        a, b = (x, b) if trial % 4 == 1 else (a, y) if trial % 4 == 2 \
            else (a, b)
        s1, s2, s3 = span(row, n, x, a), span(row, n, a, b), \
            span(row, n, b, y)
        if x == a:
            s1 = EMPTY  # the empty span on the left
        if b == y:
            s3 = EMPTY  # and on the right
        left = seg_combine(seg_combine(s1, s2), s3)
        right = seg_combine(s1, seg_combine(s2, s3))
        whole = span(row, n, x, y)
        assert left == right, (trial, s1, s2, s3)
        if x < y:
            assert left == whole, (trial, left, whole)
        if x == 0:  # a span from lane 0 holds every start in it
            lc, starts = -1, 0
            for p in range(y):
                if p == 0 or row[p] != row[p - 1]:
                    lc, starts = p, starts + 1
                elif (p - lc) % MAXLEN == 0:
                    starts += 1
            assert left[2] == starts and left[1] == lc


CASES = ["one_run_whole_row", "runs_255k_at_a_tile_edge",
         "long_run_over_tiles", "alternating_past_cap", "n_0_1_2"]


@pytest.mark.parametrize("window", [32, 3])
@pytest.mark.parametrize("name", CASES)
def test_interleaved_against_plain_and_jax(name, window):
    """Every case at the kernel's tile and at tiles of 16 and 2 lanes."""
    for config in CONFIGS:
        D, ns = rows_for(name, config[0] * config[1])
        seen = _run(D, ns, _want(D, ns), sum(map(ord, name)), window, config)
        if config == (4, 4) and name != "n_0_1_2":
            assert {"A", "P"} <= set(seen), (config, window)
    if name == "alternating_past_cap":
        assert (_want(D, ns)[1][:2] > D.shape[1] // 4).all()


def test_look_back_reaches_tile_0_through_aggregates():
    """With every CTA resident and the window of 3, some look-back reads
    30 aggregates or more before its first inclusive span."""
    D, ns = rows_for("long_run_over_tiles", 2)
    want = _want(D, ns)
    deepest = 0
    for seed in range(3):
        seen: list = []
        got = tokens_model(D, ns, 2, 1,
                           random_order(np.random.default_rng(seed), 10 ** 6),
                           3, seen=seen)
        _assert_tokens(got, want, ns)
        run = longest = 0
        for k in seen:
            run = run + 1 if k == "A" else 0
            longest = max(longest, run)
        deepest = max(deepest, longest)
    assert deepest >= 30, deepest


def test_stale_descriptors_of_an_earlier_call():
    """Calls of other shapes on one device state: none reads an earlier
    call's descriptor, each leaves the ticket at 0."""
    st = new_token_state()
    for i, name in enumerate(["alternating_past_cap", "n_0_1_2",
                              "runs_255k_at_a_tile_edge",
                              "one_run_whole_row"]):
        D, ns = rows_for(name, 16 if i % 2 else 8)
        D, ns = D[:3 - i % 2], ns[:3 - i % 2]
        got = tokens_model(D, ns, 4, 4 if i % 2 else 2,
                           random_order(np.random.default_rng(i), 9), 3,
                           state=st)
        _assert_tokens(got, _want(D, ns), ns)
    assert st["epoch"] == 4 and st["ticket"] == 0
    assert {d[0] for d in st["desc"]} <= {0, 1, 2, 3, 4}
