"""The engine's round-robin over devices (lbzip2_tpu_torch/codec/
encoder.py::_TorchPool), on logical CPU devices: batch i goes to device
i mod D (``batch_trace[*]["dev"]``), each batch's fetch runs with its
device current, one more batch in flight for each device past the
first, and the stream is the same bytes as on one device, as the JAX
engine's over conftest's eight CPU devices and as the host C
pipeline's."""

import bz2

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
CPU0 = torch.device("cpu", 0)  # a second name for the CPU: tells the
                               # two logical devices apart


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


def _seven_blocks():
    rng = np.random.default_rng(6)
    return (rng.integers(0, 13, 700_000) + np.tile([97, 110], 350_000)
            ).astype(np.uint8).tobytes()


@needs_native
@pytest.mark.parametrize("chain", [True, False], ids=["chain", "tokens"])
def test_two_devices_same_bytes(small_buckets, monkeypatch, chain):
    _set(monkeypatch, "_DEVICE_CHAIN", chain)
    data = _seven_blocks()
    two = encoder.compress(data, 1, device=["cpu", CPU0])
    s = encoder.last_stats
    assert s["device_blocks"] == 7 and s["host_blocks"] == 0
    assert [t["dev"] for t in s["batch_trace"]] == [0, 1, 0, 1]
    assert [t["rows"] for t in s["batch_trace"]] == [3, 2, 1, 1]
    one = encoder.compress(data, 1, device="cpu")
    assert [t["dev"] for t in encoder.last_stats["batch_trace"]] == \
        [0, 0, 0, 0]
    assert two == one == jenc.compress(data, 1) == compress_parallel(data, 1)
    assert bz2.decompress(two) == data


@needs_native
def test_three_devices_round_robin(small_buckets):
    data = _seven_blocks()
    out = encoder.compress(data, 1, device=["cpu"] * 3)
    assert [t["dev"] for t in encoder.last_stats["batch_trace"]] == \
        [0, 1, 2, 0]
    assert out == compress_parallel(data, 1)


@needs_native
def test_fetch_runs_on_the_batch_device(small_buckets, monkeypatch):
    """Dispatch and fetch of batch i both enter device i mod 2."""
    entered = []
    real = encoder.on

    def spy(dev, stream=None):
        import threading
        entered.append((threading.current_thread().name, dev))
        return real(dev, stream)

    monkeypatch.setattr(encoder, "on", spy)
    encoder.compress(_seven_blocks(), 1, device=["cpu", CPU0])
    want = [torch.device("cpu"), CPU0] * 2
    assert [d for t, d in entered if t == "lbz2-device"] == want
    assert [d for t, d in entered if t == "lbz2-fetch"] == want


def test_inflight_cap_grows_with_devices(monkeypatch):
    """1 until a batch lands (no warm_device), then _INFLIGHT plus one a
    device past the first (JAX codec/encoder.py:423)."""
    monkeypatch.setattr(encoder, "_warmed", False)
    cpu = torch.device("cpu")
    for devs, warm in (([cpu], encoder._INFLIGHT),
                       ([cpu, CPU0], encoder._INFLIGHT + 1),
                       ([cpu] * 4, encoder._INFLIGHT + 3)):
        pool = encoder._TorchPool(np.zeros(1, np.uint8), [], 8, 0, True,
                                  devs)
        assert pool.inflight_cap() == 1
        pool.stats["device_batches"].append((1, 0.0))
        assert pool.inflight_cap() == warm
    monkeypatch.setattr(encoder, "_warmed", True)
    pool = encoder._TorchPool(np.zeros(1, np.uint8), [], 8, 0, True,
                              [cpu, CPU0])
    assert pool.inflight_cap() == encoder._INFLIGHT + 1


def test_resolve_all():
    cpu = torch.device("cpu")
    assert tdevice.resolve_all("cpu") == [cpu]
    assert tdevice.resolve_all(["cpu", "cpu"]) == [cpu, cpu]
    assert tdevice.resolve_all(cpu) == [cpu]
    if not torch.cuda.is_available():
        for name in ("cuda", "cuda:1", ["cpu", "cuda:0"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tdevice.resolve_all(name)
