"""The engine's drain guard, first claim and steal-back, fitted to the
card's latencies (lbzip2_tpu_torch/codec/encoder.py).

On an H100 a device claim comes back in 0.04 s (one row) to about 1 s
(32 rows while eight host workers hold the cores), and the whole
60 MB smoke stream takes about one second (PERF.md section 5).  The
guard inherited from the TPU engine held that latency at a 2 s floor,
fed its estimate the ready wait alone, claimed 32 rows first and let the
host steal claims back at once: the device delivered 0 to 12 of 68
blocks.  These tests set the pool's stats to the card's numbers on a
fake clock.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch.codec import encoder

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="needs C toolchain")

T0 = 1000.0


@pytest.fixture()
def clock(monkeypatch):
    """encoder's time.time() reads now[0]."""
    now = [T0]
    monkeypatch.setattr(encoder, "time",
                        types.SimpleNamespace(time=lambda: now[0]))
    return now


def _pool(n):
    return encoder._TorchPool(np.zeros(1, np.uint8), [None] * n, 8, 8,
                              True, torch.device("cpu"))


def test_take_head_grants_a_claim_the_tpu_floor_refused(clock):
    """Half a second into a 68-block stream: the host has encoded 10
    blocks (20 a second), the device delivered two batches and its
    claims come back in 0.3 s.  48 blocks remain, more than a claim of
    32 plus the 6 the host does in 0.3 s: the device claims (8, near the
    end).  Held at 2 s the guard expected the host to take 40 and
    refused."""
    pool = _pool(68)
    pool.head, pool.tail, pool.claims = 10, 58, 2
    pool.stats["host_blocks"] = 10
    pool.stats["device_batches"] = [(8, 0.25), (2, 0.4)]
    pool.lat_ema = 0.3
    clock[0] = T0 + 0.5
    assert pool.take_head(32) == list(range(10, 18))
    # the guard still refuses where the host would outrun the claim
    pool.lat_ema = 2.0
    assert pool.take_head(32) == []


def test_lat_ema_follows_claim_to_deliver_not_the_ready_wait(clock):
    """A batch claimed at 0.0 s and delivered at 0.9 s whose fetch
    waited 0.15 s for the device: the latency is 0.9 s."""
    pool = _pool(68)
    clock[0] = T0 + 0.9
    pool._batch_done({"claimed_t": 0.0, "ready_s": 0.15}, 8, 0)
    assert pool.lat_ema == pytest.approx(0.9)
    clock[0] = T0 + 1.2
    tele = {"claimed_t": 0.5, "ready_s": 0.2}
    pool._batch_done(tele, 16, 0)
    assert tele["claim_s"] == pytest.approx(0.7)
    assert pool.lat_ema == pytest.approx(0.8)
    assert pool.last_batch_t == T0 + 1.2


def test_first_claims_ramp_up_to_a_full_batch(clock):
    """The first claim is 8 rows (0.13 s to come back on the card, a
    32-row claim up to a second), then 16, then full batches."""
    pool = _pool(300)
    sizes = [len(pool.take_head(32)) for _ in range(5)]
    assert sizes == [8, 16, 32, 32, 32]
    assert pool.claims == 5 and pool.head == 120


def test_steal_back_waits_while_the_device_delivers(clock, monkeypatch):
    """The tail is empty and the device holds claims.  It delivered a
    batch 0.2 s ago and its claims take 0.3 s: within two latencies it
    keeps them; after 0.7 s of silence the host takes the youngest.
    LBZ2_STEALBACK_GRACE_S still sets a longer grace."""
    pool = _pool(68)
    pool.head = pool.tail = 40
    pool.claimed.update({30, 31, 32})
    pool.lat_ema = 0.3
    pool.last_batch_t = T0
    clock[0] = T0 + 0.2
    assert pool.stealback_grace() == pytest.approx(0.6)
    assert pool.take_claimed() is None
    clock[0] = T0 + 0.7
    monkeypatch.setattr(encoder, "_STEALBACK_GRACE_S", 5.0)
    assert pool.take_claimed() is None
    monkeypatch.setattr(encoder, "_STEALBACK_GRACE_S", 0.0)
    assert pool.take_claimed() == 32
    # no delivery ever: steal at once (cold start, wedged engine)
    cold = _pool(68)
    cold.claimed.add(5)
    assert cold.take_claimed() == 5


def test_a_refused_claim_waits_for_the_next_delivery(monkeypatch):
    """The guard refuses while the device's first batch is out (the host
    outpaces an unproven engine); when that batch lands the device
    claims again, where the TPU engine stopped claiming for good."""
    monkeypatch.setattr(encoder, "_warmed", True)  # batches in flight: 3
    pool = _pool(68)
    pool.fetch_pending = 1  # the first batch, in flight
    answers, asked = [[], [5]], []

    def take_head(k):
        asked.append(k)
        return answers.pop(0) if answers else []
    pool.take_head = take_head
    pool._build_batch = lambda ids: None  # nothing to dispatch
    t = threading.Thread(target=pool._device_pipeline, daemon=True)
    t.start()
    try:
        time.sleep(0.05)
        assert t.is_alive() and len(asked) == 1
    finally:
        pool._fetched()  # the batch lands
        t.join(timeout=60)
    assert not t.is_alive() and len(asked) == 3


@needs_native
@pytest.mark.parametrize("steal", [False, True], ids=["device", "default"])
def test_every_batch_records_its_claim_to_deliver(monkeypatch, steal):
    """On the real engine (CPU, small buckets): each batch carries
    claim_s, no shorter than its ready wait, and the guard's estimate
    is their EMA; the bytes stay the host pipeline's.  (With host
    stealing on, the CPU's host workers may leave the device no
    batch.)"""
    for name, value in (("_HOST_STEAL", steal), ("_STEALBACK", steal),
                        ("_BUCKETS", (8192, 131072)), ("_MID_CUTOFF", 8192),
                        ("_BATCH", 4)):
        monkeypatch.setattr(encoder, name, value)
    rng = np.random.default_rng(6)
    data = (rng.integers(0, 13, 700_000) +
            np.tile([97, 110], 350_000)).astype(np.uint8).tobytes()
    ema = []

    def done(self, tele, fresh, stale, _real=encoder._TorchPool._batch_done):
        _real(self, tele, fresh, stale)
        ema.append(self.lat_ema)
    monkeypatch.setattr(encoder._TorchPool, "_batch_done", done)
    assert encoder.compress(data, 1, device="cpu") == \
        compress_parallel(data, 1)
    trace = encoder.last_stats["batch_trace"]
    assert len(ema) == len(trace) and (trace or steal)
    want = 0.0
    for tele, got in zip(trace, ema):
        assert tele["claim_s"] >= tele["ready_s"]
        want = tele["claim_s"] if not want else \
            0.5 * want + 0.5 * tele["claim_s"]
        assert got == pytest.approx(want)
    if not steal:
        assert [t["rows"] for t in trace] == [3, 2, 1, 1]
