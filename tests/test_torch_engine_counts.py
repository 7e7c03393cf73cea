"""The engine's block counts when both engines produce one block
(lbzip2_tpu_torch/codec/encoder.py).

The device claims the stream's one block; the host steals the claim back
and encodes it too.  Events put the two deliveries in a fixed order: the
host's result first (the device's row arrives after its stale check and
must count as stale), or the device's first (the host's result must be
dropped and not counted).  In chain mode the device delivers the payload
itself; in token mode it hands the row to the host's entropy stage.
Either way the stream is the host pipeline's, and device_blocks +
host_blocks is the number of blocks.
"""

import bz2
import threading

import numpy as np
import pytest

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.parallel.encode import compress_parallel

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="needs C toolchain")
WAIT_S = 60.0


def _data():
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(2, 9, 150)]
    return b" ".join(words[i] for i in rng.integers(0, 150, 1500))[:7000]


def _race(monkeypatch, order: str):
    """Hooks that make the host steal the device's claim back and order
    the two deliveries; returns the events that prove the race ran."""
    P = encoder._TorchPool
    took, checked, host_put, fetched = (threading.Event() for _ in range(4))
    inside = threading.local()  # set on the fetch thread inside a fetch
    monkeypatch.setattr(P, "take_tail", lambda self: None)  # steal-backs only
    take_claimed, is_stale, put_result = (
        P.take_claimed, P.is_stale, P.put_result)

    def take_claimed_hook(self):
        i = take_claimed(self)
        if i is not None:
            took.set()
        return i

    def fetch_hook(fetch):
        def run(self, *a):
            assert took.wait(WAIT_S), "the host never stole the claim"
            inside.on = True
            try:
                return fetch(self, *a)
            finally:
                inside.on = False
                fetched.set()
        return run

    def is_stale_hook(self, i):
        stale = is_stale(self, i)
        if getattr(inside, "on", False) and not stale and \
                order == "host_first":
            # inside the window between the stale check and the delivery
            checked.set()
            assert host_put.wait(WAIT_S), "the host never delivered"
        return stale

    def put_result_hook(self, i, payload_crc):
        kept = put_result(self, i, payload_crc)
        if threading.current_thread().name.startswith("lbz2-host"):
            host_put.set()
        return kept

    host_block = encoder._host_block

    def host_block_hook(*a):
        out = host_block(*a)
        # the device's fetch found the row not stale yet, or has ended
        done = checked if order == "host_first" else fetched
        assert done.wait(WAIT_S), "the device never fetched"
        return out

    monkeypatch.setattr(P, "take_claimed", take_claimed_hook)
    monkeypatch.setattr(P, "_fetch_chain", fetch_hook(P._fetch_chain))
    monkeypatch.setattr(P, "_fetch_tokens", fetch_hook(P._fetch_tokens))
    monkeypatch.setattr(P, "is_stale", is_stale_hook)
    monkeypatch.setattr(P, "put_result", put_result_hook)
    monkeypatch.setattr(encoder, "_host_block", host_block_hook)
    return took, host_put, fetched


@needs_native
@pytest.mark.parametrize("chain", [True, False], ids=["chain", "tokens"])
@pytest.mark.parametrize("order", ["host_first", "device_first"])
def test_a_block_both_engines_made_counts_once(monkeypatch, chain, order):
    monkeypatch.setattr(encoder, "_DEVICE_CHAIN", chain)
    monkeypatch.setattr(encoder, "_HOST_STEAL", True)
    monkeypatch.setattr(encoder, "_STEALBACK", True)
    data = _data()
    took, host_put, fetched = _race(monkeypatch, order)
    out = encoder.compress(data, 9, entropy_workers=1, device="cpu")
    s = encoder.last_stats
    assert took.is_set() and host_put.is_set() and fetched.is_set()
    assert out == compress_parallel(data, 9)
    assert bz2.decompress(out) == data
    assert s["device_blocks"] + s["host_blocks"] == 1, s
    # the device fetched its one row: it delivered it or found it stale
    assert s["device_blocks"] + s["stale_rows"] == 1, s
    if order == "host_first" or not chain:
        # the host delivered first, or held the claim when the device's
        # row came to be handed over
        assert s["host_blocks"] == 1
    else:
        assert s["device_blocks"] == 1
