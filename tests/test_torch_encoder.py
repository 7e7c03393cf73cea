"""Port's engine (lbzip2_tpu_torch/codec/encoder.py) on the CPU, plus the
package's contracts: no jax import, explicit devices, interop dtypes.

Streams are byte-compared with the JAX package's chain-mode compress
(JAX on the CPU) and with the host C pipeline compress_parallel.
"""

import bz2
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.codec import encoder as jenc
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch import device as tdevice
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.interop import to_numpy, to_torch

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="needs C toolchain")


def _set(monkeypatch, name, value):
    """Set a scheduler switch of both engines: each package reads its
    own module's."""
    for mod in (encoder, jenc):
        monkeypatch.setattr(mod, name, value)


@pytest.fixture()
def device_only(monkeypatch):
    """Chain mode with host stealing off, so the device does every
    eligible block, in the port's engine and in the JAX package's."""
    _set(monkeypatch, "_DEVICE_CHAIN", True)
    _set(monkeypatch, "_HOST_STEAL", False)
    _set(monkeypatch, "_STEALBACK", False)
    return jenc


def _stream(kind):
    rng = np.random.default_rng(11)
    if kind == "text":
        words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
                 for k in rng.integers(2, 9, 200)]
        return b" ".join(words[i] for i in rng.integers(0, 200, 2000))[:7800]
    if kind == "digits":
        return bytes(rng.integers(48, 58, 6000, dtype=np.uint8))
    if kind == "abcd_runs":
        return bytes(np.repeat(np.frombuffer(b"abcd", np.uint8), 500))
    return bytes(rng.integers(0, 256, 8000, dtype=np.uint8))


@needs_native
@pytest.mark.parametrize("kind", ["text", "digits", "abcd_runs", "random"])
def test_compress_matches_jax_and_host(device_only, kind):
    data = _stream(kind)
    out = encoder.compress(data, 9, device="cpu")
    assert encoder.last_stats["device_blocks"] == 1
    assert out == compress_parallel(data, 9)
    assert out == device_only.compress(data, 9)
    assert device_only.last_stats["device_blocks"] == 1
    assert bz2.decompress(out) == data


@needs_native
def test_multi_batch_pipeline(device_only, monkeypatch):
    """Several batches in flight and the end-of-stream drain, through
    the pool's _build_batch with small buckets."""
    _set(monkeypatch, "_BUCKETS", (8192, 131072))
    _set(monkeypatch, "_MID_CUTOFF", 8192)
    _set(monkeypatch, "_BATCH", 2)
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(97, 123, size=200_000, dtype=np.uint8))
    out = encoder.compress(data, 1, device="cpu")
    assert out == compress_parallel(data, 1)
    nblocks = len(native.rle1_collect(np.frombuffer(data, np.uint8),
                                      100_000, 100_000))
    s = encoder.last_stats
    assert s["host_blocks"] == 0 and s["device_blocks"] == nblocks
    assert len(s["batch_trace"]) >= 2
    for t in s["batch_trace"]:
        assert {"prep_s", "dispatch_s", "ready_s", "done_t",
                "chain_stages"} <= set(t)


def test_package_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import lbzip2_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'lbzip2_tpu_torch.codec.encoder' in sys.modules\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve("cuda")
    with pytest.raises(RuntimeError):
        encoder.compress(b"abc", 9)  # the default device is "cuda"
    with pytest.raises(ValueError):
        tdevice.resolve("meta")
    assert tdevice.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("dtype,torch_dtype", [
    (np.uint8, torch.uint8), (np.int32, torch.int32),
    (np.uint32, torch.int64), (np.float32, torch.float32),
])
def test_interop_round_trip(dtype, torch_dtype):
    a = np.array([0, 1, 200, 255], dtype)
    if dtype == np.uint32:
        a = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], dtype)
    t = to_torch(a)
    assert t.dtype == torch_dtype
    back = to_numpy(t, like=a)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)


def test_inflight_gate_generation():
    """A timed-out wait abandons leftover batches to an old generation:
    a straggler finishing later must not eat a new batch's count (the
    JAX counter resets to 0 and clamps, losing that accounting)."""
    gate = encoder._InflightGate()
    old = gate.inc()
    gate.inc()
    gate.wait_idle(timeout_s=0.05, max_inflight=0)  # times out
    assert gate.inflight == 0
    new = gate.inc()
    gate.dec(old)  # straggler of the abandoned generation
    assert gate.inflight == 1
    gate.dec(new)
    assert gate.inflight == 0
    gate.wait_idle(timeout_s=0.05, max_inflight=0)  # idle: returns


def test_drain_loop_stops_on_error():
    """The dispatch thread's drain wait ends when a fetch worker has
    failed, even with a batch still counted in flight."""
    pool = encoder._TorchPool(np.zeros(1, np.uint8), [], 8, 0, True,
                              torch.device("cpu"))
    pool.fetch_pending = 1  # a batch nobody will ever finish
    pool.fail(RuntimeError("fetch worker died"))
    t = threading.Thread(target=pool._device_pipeline, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture()
def token_mode(monkeypatch):
    """Token mode (LBZ2_DEVICE_CHAIN=0) with host stealing off."""
    _set(monkeypatch, "_DEVICE_CHAIN", False)
    _set(monkeypatch, "_HOST_STEAL", False)
    _set(monkeypatch, "_STEALBACK", False)
    return jenc


@needs_native
@pytest.mark.parametrize("kind", ["text", "digits", "abcd_runs", "random"])
def test_token_mode_matches_jax_and_host(token_mode, kind):
    """random overflows the token capacity: its row goes as raw bytes."""
    data = _stream(kind)
    out = encoder.compress(data, 9, device="cpu")
    s = encoder.last_stats
    assert s["device_blocks"] == 1 and s["host_blocks"] == 0
    assert "expand_s" in s["batch_trace"][0]
    assert out == compress_parallel(data, 9)
    assert out == token_mode.compress(data, 9)
    assert token_mode.last_stats["device_blocks"] == 1
    assert bz2.decompress(out) == data


@needs_native
def test_token_mode_multi_batch_with_raw_rows(token_mode, monkeypatch):
    """Several token-mode batches in flight, rows within the token
    capacity and rows over it (random bytes) in one stream."""
    _set(monkeypatch, "_BUCKETS", (8192, 131072))
    _set(monkeypatch, "_MID_CUTOFF", 8192)
    _set(monkeypatch, "_BATCH", 2)
    rng = np.random.default_rng(2)
    parts = [bytes(rng.integers(97, 100, 100_000, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 100_000, dtype=np.uint8)),
             bytes(np.repeat(rng.integers(0, 256, 10_000, dtype=np.uint8),
                             20))]
    data = b"".join(parts)
    out = encoder.compress(data, 1, device="cpu")
    assert out == compress_parallel(data, 1)
    assert out == token_mode.compress(data, 1)
    nblocks = len(native.rle1_collect(np.frombuffer(data, np.uint8),
                                      100_000, 100_000))
    s = encoder.last_stats
    assert s["host_blocks"] == 0 and s["device_blocks"] == nblocks
    assert len(s["batch_trace"]) >= 2
    for t in s["batch_trace"]:
        assert {"prep_s", "dispatch_s", "ready_s", "expand_s",
                "done_t"} <= set(t)
    assert bz2.decompress(out) == data


@needs_native
@pytest.mark.parametrize("chain", [True, False])
def test_device_chain_switch_picks_the_engine(monkeypatch, chain):
    """The pool reads its module's _DEVICE_CHAIN when it is made:
    False dispatches bwt2_tokens and never bwt2_bytes, True the other
    way round; warm_device warms the same mode."""
    _set(monkeypatch, "_DEVICE_CHAIN", chain)
    _set(monkeypatch, "_HOST_STEAL", False)
    monkeypatch.setattr(encoder, "_warmed", False)
    calls = {"bwt2_tokens": 0, "bwt2_bytes": 0}
    for name in calls:
        def counted(*a, _fn=getattr(encoder, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(encoder, name, counted)
    used = "bwt2_bytes" if chain else "bwt2_tokens"
    encoder.warm_device(rows=(1,), bucket=8192, device="cpu")
    data = _stream("text")
    assert encoder.compress(data, 9, device="cpu") == \
        compress_parallel(data, 9)
    assert calls == {name: 2 * (name == used) for name in calls}


@needs_native
@pytest.mark.parametrize("env,mode", [("0", "tokens"), (None, "chain")])
def test_device_chain_env_selects_mode(env, mode):
    """LBZ2_DEVICE_CHAIN=0 in the environment runs token mode; unset,
    chain mode (the JAX package's documented switch)."""
    code = ("import numpy as np\n"
            "from lbzip2_tpu_torch.codec import encoder\n"
            "rng = np.random.default_rng(1)\n"
            "data = bytes(rng.integers(97, 100, 6000, dtype=np.uint8))\n"
            "encoder.compress(data, 9, device='cpu')\n"
            "t = encoder.last_stats['batch_trace'][0]\n"
            "print('tokens' if 'expand_s' in t else 'chain'"
            " if 'chain_stages' in t else 'none')\n")
    envs = {k: v for k, v in os.environ.items()
            if k != "LBZ2_DEVICE_CHAIN"}
    envs.update(LBZ2_HOST_STEAL="0", LBZ2_STEALBACK="0")
    if env is not None:
        envs["LBZ2_DEVICE_CHAIN"] = env
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=envs, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == mode


_FEW_BLOCKS = (
    "import numpy as np\n"
    "from lbzip2_tpu_torch.codec import encoder\n"
    "encoder._BUCKETS, encoder._MID_CUTOFF, encoder._BATCH = \\\n"
    "    (8192, 131072), 8192, 2\n"
    "rng = np.random.default_rng(1)\n"
    "data = bytes(rng.integers(97, 123, 300_000, dtype=np.uint8))\n"
    "encoder.compress(data, 1, device='cpu')\n")


@needs_native
def test_process_exits_cleanly_right_after_compress():
    """Chain mode with host stealing on: the host finishes the stream
    while a fetch thread still holds a device batch.  The process exits
    the moment compress returns and must not abort in teardown."""
    envs = {k: v for k, v in os.environ.items()
            if k not in ("LBZ2_HOST_STEAL", "LBZ2_STEALBACK",
                         "LBZ2_DEVICE_CHAIN")}
    for _ in range(3):
        r = subprocess.run([sys.executable, "-c", _FEW_BLOCKS],
                           capture_output=True, text=True, env=envs,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        assert "terminate called" not in r.stderr


@needs_native
@pytest.mark.parametrize("steal", [True, False])
def test_no_engine_thread_outlives_compress(monkeypatch, steal):
    _set(monkeypatch, "_DEVICE_CHAIN", True)
    _set(monkeypatch, "_HOST_STEAL", steal)
    _set(monkeypatch, "_STEALBACK", steal)
    _set(monkeypatch, "_BUCKETS", (8192, 131072))
    _set(monkeypatch, "_MID_CUTOFF", 8192)
    _set(monkeypatch, "_BATCH", 2)
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(97, 123, 300_000, dtype=np.uint8))
    assert encoder.compress(data, 1, device="cpu") == \
        compress_parallel(data, 1)
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("lbz2-")]
    assert not alive, alive
