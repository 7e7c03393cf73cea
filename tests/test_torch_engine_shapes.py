"""The port's engine ships the rows it has and waits without napping.

A batch holds the blocks the device claimed and kept, no pad row, in
chain and in token mode, and the stream stays byte-identical to the JAX
package's (which pads every batch to its static shape) and to the host
C pipeline's.  The fetch thread blocks on the batch's event; the
dispatch thread waits on a condition that the fetch worker, fail() and
the end of run() signal.  All on the CPU, with small buckets.
"""

import bz2
import threading
import time

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.codec import encoder as jenc
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch import device as tdevice
from lbzip2_tpu_torch.codec import encoder

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="needs C toolchain")

WIDE = 131072  # holds a level-1 block


def _set(monkeypatch, name, value):
    for mod in (encoder, jenc):
        monkeypatch.setattr(mod, name, value)


@pytest.fixture()
def small_buckets(monkeypatch):
    """Level-1 blocks on the device, host stealing off, claims of at
    most 4 blocks: 7 blocks are claimed as 3, 2, 1 and 1."""
    _set(monkeypatch, "_HOST_STEAL", False)
    _set(monkeypatch, "_STEALBACK", False)
    _set(monkeypatch, "_BUCKETS", (8192, WIDE))
    _set(monkeypatch, "_MID_CUTOFF", 8192)
    _set(monkeypatch, "_BATCH", 4)


def _no_runs(n, seed):
    """n letters (n even), none equal to its neighbour: RLE1 leaves them
    alone, so every 100,000 of them are one level-1 block."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 13, n) + np.tile([97, 110], n // 2)).astype(
        np.uint8).tobytes()


def _seven_blocks():
    return _no_runs(700_000, 6)


@needs_native
@pytest.mark.parametrize("chain", [True, False], ids=["chain", "tokens"])
def test_short_claims_ship_their_live_rows(small_buckets, monkeypatch,
                                           chain):
    _set(monkeypatch, "_DEVICE_CHAIN", chain)
    data = _seven_blocks()
    out = encoder.compress(data, 1, device="cpu")
    s = encoder.last_stats
    assert s["device_blocks"] == 7 and s["host_blocks"] == 0
    assert [t["shape"] for t in s["batch_trace"]] == \
        [[3, WIDE], [2, WIDE], [1, WIDE], [1, WIDE]]
    assert [t["rows"] for t in s["batch_trace"]] == [3, 2, 1, 1]
    assert out == jenc.compress(data, 1)
    assert jenc.last_stats["device_blocks"] == 7
    assert out == compress_parallel(data, 1)
    assert bz2.decompress(out) == data


@needs_native
@pytest.mark.parametrize("chain", [True, False], ids=["chain", "tokens"])
def test_small_bucket_ships_one_row(monkeypatch, chain):
    """The 8192 bucket follows the same rule: one block, one row."""
    _set(monkeypatch, "_DEVICE_CHAIN", chain)
    _set(monkeypatch, "_HOST_STEAL", False)
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(97, 100, 6000, dtype=np.uint8))
    out = encoder.compress(data, 9, device="cpu")
    assert [t["shape"] for t in encoder.last_stats["batch_trace"]] == \
        [[1, 8192]]
    assert out == jenc.compress(data, 9) == compress_parallel(data, 9)


@needs_native
def test_periodic_block_gives_its_row_back(small_buckets, monkeypatch):
    """A fully periodic block goes to the host and leaves no row behind:
    the batch is as tall as the blocks the device kept."""
    _set(monkeypatch, "_DEVICE_CHAIN", True)
    free = _no_runs(600_000, 3)
    data = free[:100_000] + b"ab" * 50_000 + free[100_000:]
    out = encoder.compress(data, 1, device="cpu")
    s = encoder.last_stats
    assert s["periodic_blocks"] == 0 and s["device_blocks"] == 6
    assert [t["shape"] for t in s["batch_trace"]] == \
        [[2, WIDE], [2, WIDE], [1, WIDE], [1, WIDE]]
    assert out == compress_parallel(data, 1)


class _FakeEvent:
    """Stands for a recorded CUDA event: done once synchronize returns."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.fixture()
def no_naps(monkeypatch):
    """time.sleep fails on the 50 ms nap the engine used to poll with
    (and on anything longer)."""
    real = time.sleep

    def sleep(s):
        assert s < 0.05, f"the engine napped {s} s"
        real(s)
    monkeypatch.setattr(time, "sleep", sleep)


def test_wait_event_blocks_on_the_event(no_naps):
    ev = _FakeEvent()
    tdevice.wait_event(ev)
    assert ev.waits == 1
    tdevice.wait_event(None)  # the CPU: every op has already run


@needs_native
@pytest.mark.parametrize("chain", [True, False], ids=["chain", "tokens"])
def test_every_batch_waits_once_on_its_event(small_buckets, monkeypatch,
                                             no_naps, chain):
    _set(monkeypatch, "_DEVICE_CHAIN", chain)
    events = []

    def record(dev):
        events.append(_FakeEvent())
        return events[-1]
    monkeypatch.setattr(encoder, "record_event", record)
    data = _no_runs(300_000, 8)
    assert encoder.compress(data, 1, device="cpu") == \
        compress_parallel(data, 1)
    assert len(events) == len(encoder.last_stats["batch_trace"]) >= 2
    assert [e.waits for e in events] == [1] * len(events)


def _idle_pool():
    """A pool with nothing to claim and one batch counted in flight."""
    pool = encoder._TorchPool(np.zeros(1, np.uint8), [], 8, 0, True,
                              torch.device("cpu"))
    pool.fetch_pending = 1
    return pool


def _waiting(pool):
    t = threading.Thread(target=pool._device_pipeline, daemon=True)
    t.start()
    t.join(timeout=0.3)  # into the drain wait
    assert t.is_alive()
    return t


def test_drain_wakes_on_the_fetch_workers_signal(monkeypatch, no_naps):
    """With the condition's timeout out of reach, only a signal ends the
    drain wait: the fetch worker's, when it has finished a batch."""
    monkeypatch.setattr(encoder, "_WAKE_S", 3600.0)
    pool = _idle_pool()
    t = _waiting(pool)
    pool._fetched()
    t.join(timeout=60)
    assert not t.is_alive() and pool.fetch_pending == 0


@pytest.mark.parametrize("how", ["error", "complete"])
def test_drain_still_stops_on_error_and_completion(monkeypatch, no_naps,
                                                   how):
    monkeypatch.setattr(encoder, "_WAKE_S", 3600.0)
    pool = _idle_pool()
    t = _waiting(pool)
    if how == "error":
        pool.fail(RuntimeError("fetch worker died"))
    else:
        pool.complete = True
        pool._wake_dispatch()
    t.join(timeout=60)
    assert not t.is_alive() and pool.fetch_pending == 1


def test_drain_sees_abandonment_by_its_timeout(monkeypatch, no_naps):
    """The watchdog sets ``abandoned`` without a signal: the wait's own
    timeout reads it."""
    monkeypatch.setattr(encoder, "_WAKE_S", 0.02)
    pool = _idle_pool()
    t = _waiting(pool)
    pool.abandoned = True
    t.join(timeout=60)
    assert not t.is_alive()
