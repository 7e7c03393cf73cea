"""The port's RLE1 collect on several threads
(``lbzip2_tpu_torch.native.rle1_collect`` with ``threads``) against one
serial walk of the same input, block for block."""

import sys
import threading

import numpy as np
import pytest

from lbzip2_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="no C compiler")

W = 20000  # the granule and block capacity of the threaded collects


def _small_alphabet(n, seed=11):
    return np.random.default_rng(seed).integers(0, 5, n, dtype=np.uint8)


def _runs_of_four(n):
    """Runs of exactly four equal bytes: RLE1 writes five bytes for each
    four, so every window fills a block and spills into a second."""
    return (np.arange(n) // 4 % 7 * 30).astype(np.uint8)


def _run_across_windows():
    d = _small_alphabet(10 * W)
    d[3 * W // 2:7 * W // 2] = 0  # from mid window 1 to mid window 3
    return d


# each case: collects made in a row on one thread, (data, granule,
# threads, the chunks they run as)
_THREADED = {
    "ragged_tail": [(_small_alphabet(9 * W + 1234), W, 2, 8)],
    "two_blocks_a_window": [(_runs_of_four(8 * W), W, 3, 8)],
    "run_across_windows": [(_run_across_windows(), W, 2, 8)],
    "threads_past_windows": [(_small_alphabet(10 * W), W, 16, 1)],
    "no_granule": [(_small_alphabet(3 * W + 5), None, 4, 1)],
    "more_threads_than_cores": [(_small_alphabet(70 * W - 3), W, 32, 70)],
    "larger_then_smaller": [(_small_alphabet(12 * W + 7, 12), W, 4, 13),
                            (_small_alphabet(5 * W, 13), W, 2, 5)],
}


@pytest.mark.parametrize("case", list(_THREADED))
def test_threaded_rle1_collect_equals_one_walk(case):
    """The port's collect on several threads, windows cut into runs
    each collected into its own region of the thread's arena, gives the
    blocks of one serial walk: spans, bytes, cmaps, order.  Its threads
    are gone when it returns, and a smaller collect after a larger one
    reuses the grown arena.  Threads switch every microsecond, so that a
    run of windows taken twice or never shows."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _collect_in_turn(_THREADED[case], case == "two_blocks_a_window")
    finally:
        sys.setswitchinterval(interval)


def _collect_in_turn(collects, two_blocks_a_window):
    out = None
    for data, granul, threads, chunks in collects:
        assert native.collect_chunks(data.size, granul, threads) == chunks
        got = native.rle1_collect(data, W, granul, reuse_arena=True,
                                   threads=threads)
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("lbz2-")]
        if out is not None:
            assert native._collect_arena.out_buf is out
        out = native._collect_arena.out_buf
        want = native.rle1_collect(data, W, granul)
        nwin = -(-data.size // granul) if granul else 1
        assert len(got) == len(want) >= nwin
        if two_blocks_a_window:
            assert len(want) == 2 * nwin
        for (s1, e1, b1, c1), (s2, e2, b2, c2) in zip(got, want):
            assert (s1, e1) == (s2, e2)
            np.testing.assert_array_equal(b1, b2)
            np.testing.assert_array_equal(c1, c2)
