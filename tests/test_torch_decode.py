"""Port's decompression (lbzip2_tpu_torch/parallel/decode.py) on the CPU
vs the JAX package's decompress_parallel and the data.

The device stages run their plain PyTorch versions on the CPU.  Output
bytes and StreamError codes must equal the JAX package's, with the
switches on and off; the IBWT batcher never takes more than max_batch
rows and hands a failing flush's error to every waiter.
"""

import bz2
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.core.constants import StreamError as JaxStreamError
from lbzip2_tpu.parallel import decode as jdec
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu.ref import bwt as ref_bwt
from lbzip2_tpu_torch.core.constants import StreamError
from lbzip2_tpu_torch.ops import huffdec
from lbzip2_tpu_torch.parallel import decode

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")

SWITCHES = {"off": (False, False), "huff": (True, False),
            "ibwt": (False, True), "both": (True, True)}


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(2, 9, 400)]
    return b" ".join(words[i] for i in rng.integers(0, 400, n // 4))[:n]


_DATA = {1: _text(250_000, 1),     # three level-1 blocks
         9: _text(1_000_000, 9)}   # two level-9 blocks, one full


def _blob(level, layout):
    data = _DATA[level]
    return data, (bz2.compress(data, level) if layout == "bz2"
                  else compress_parallel(data, level))


@pytest.fixture()
def switches(monkeypatch):
    """Set the port's switches (and the JAX module's, for parity runs);
    narrow IBWT rows keep level-1 batches cheap on the CPU."""
    def set_(name, level=1, jax_too=False):
        huff, ibwt_on = SWITCHES[name]
        monkeypatch.setattr(decode, "DEVICE_HUFF", huff)
        monkeypatch.setattr(decode, "DEVICE_IBWT", ibwt_on)
        width = 131072 if level == 1 else 901120
        monkeypatch.setattr(decode, "_IBWT_N", width)
        if jax_too:
            monkeypatch.setattr(jdec, "DEVICE_HUFF", huff)
            monkeypatch.setattr(jdec, "DEVICE_IBWT", ibwt_on)
            monkeypatch.setattr(jdec, "_IBWT_N", width)
        return ibwt_on
    return set_


@pytest.mark.parametrize("name", list(SWITCHES))
@pytest.mark.parametrize("layout", ["bz2", "lbzip2"])
@pytest.mark.parametrize("level", [1, 9])
def test_roundtrip_matches_jax(switches, level, layout, name):
    data, blob = _blob(level, layout)
    ibwt_on = switches(name, level)
    out = decode.decompress_parallel(blob, device="cpu")
    assert out == data
    assert out == jdec.decompress_parallel(blob)
    s = decode.last_stats
    assert s["blocks"] == len(decode.block_payloads(blob))
    assert s["ibwt_rows"] >= s["blocks"] if ibwt_on else \
        s["ibwt_rows"] == 0


@pytest.mark.parametrize("name", ["off", "both"])
def test_concatenated_streams(switches, name):
    switches(name)
    a, b = _text(120_000, 3), _text(50_000, 4)
    blob = compress_parallel(a, 1) + bz2.compress(b, 2) + \
        compress_parallel(b"", 9)
    out = decode.decompress_parallel(blob, device="cpu")
    assert out == a + b == jdec.decompress_parallel(blob)


@pytest.mark.parametrize("name", ["huff", "both"])
def test_device_stages_match_jax_device_stages(switches, name):
    data, blob = _blob(1, "lbzip2")
    ibwt_on = switches(name, jax_too=True)
    assert decode.decompress_parallel(blob, device="cpu") == \
        jdec.decompress_parallel(blob, device_ibwt=ibwt_on) == data


def _code(fn, blob, **kw):
    """Name of the stream error ``fn`` raises (each package has its own
    StreamError and Error enum, member for member), or None."""
    try:
        fn(blob, **kw)
    except (StreamError, JaxStreamError) as e:
        return e.code.name
    return None


def _flip(off):
    def damage(blob):
        blob = bytearray(blob)
        blob[off] ^= 0x10
        return bytes(blob)
    return damage


DAMAGE = {  # error codes seen: BLKCRC, BWTIDX, DELTA, STRMCRC, HEADER, EOF
    "block_crc": _flip(10), "bwt_index": _flip(14), "tree_delta": _flip(30),
    "payload": _flip(2000), "stream_crc": _flip(-3), "eos_magic": _flip(-8),
    "cut_half": lambda b: b[:len(b) // 2], "cut_tail": lambda b: b[:-3],
    "cut_header": lambda b: b[:20],
}


@pytest.mark.parametrize("name", ["off", "both"])
@pytest.mark.parametrize("damage", list(DAMAGE))
def test_corrupt_stream_error_matches_jax(switches, name, damage):
    ibwt_on = switches(name, jax_too=True)
    blob = DAMAGE[damage](_blob(1, "lbzip2")[1])
    want = _code(jdec.decompress_parallel, blob, device_ibwt=ibwt_on)
    assert want is not None
    assert _code(decode.decompress_parallel, blob, device="cpu") == want


def _rows(count, width=4096, seed=11):
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(count):
        raw = rng.integers(0, 1 + k % 7, int(rng.integers(1, width)),
                           dtype=np.uint8)
        bw, idx = ref_bwt.bwt(raw)
        rows.append((raw, bw, idx))
    return rows


def _hammer(batcher, rows):
    """Call run() for every row at once from its own thread; returns
    (results, errors) by row, and the threads still alive after 30 s."""
    results, errors = [None] * len(rows), [None] * len(rows)
    gate = threading.Barrier(len(rows))

    def work(k):
        gate.wait()
        try:
            results[k] = batcher.run(rows[k][1], rows[k][2])
        except Exception as e:  # noqa: BLE001 — collected for the test
            errors[k] = e
    threads = [threading.Thread(target=work, args=(k,), daemon=True)
               for k in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results, errors, [t for t in threads if t.is_alive()]


def test_batcher_caps_rows_per_flush(monkeypatch):
    monkeypatch.setattr(decode, "_IBWT_N", 4096)
    shapes = []
    plain = decode.ibwt_rows

    def spy(bwt, ns, idxs):
        shapes.append(tuple(bwt.shape))
        return plain(bwt, ns, idxs)
    monkeypatch.setattr(decode, "ibwt_rows", spy)
    rows = _rows(16)
    batcher = decode._DeviceIbwtBatcher(max_batch=2, linger_s=0.001,
                                        device="cpu")
    results, errors, alive = _hammer(batcher, rows)
    assert not alive and errors == [None] * 16
    for (raw, _, _), got in zip(rows, results):
        np.testing.assert_array_equal(got, raw)
    assert batcher.rows == 16 and batcher.most_rows <= 2
    assert batcher.flushes == len(shapes) >= 8
    assert set(shapes) == {(2, 4096)}  # padded to max_batch rows


def test_failing_flush_reaches_every_waiter(monkeypatch):
    monkeypatch.setattr(decode, "_IBWT_N", 4096)

    def broken(bwt, ns, idxs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(decode, "ibwt_rows", broken)
    batcher = decode._DeviceIbwtBatcher(max_batch=2, linger_s=0.001,
                                        device="cpu")
    _, errors, alive = _hammer(batcher, _rows(16))
    assert not alive
    assert all(isinstance(e, RuntimeError) for e in errors), errors


@pytest.mark.parametrize("stage", ["huff", "ibwt"])
def test_kernel_error_propagates_not_stream_error(switches, monkeypatch,
                                                  stage):
    switches("huff" if stage == "huff" else "ibwt")

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")
    if stage == "huff":
        monkeypatch.setattr(huffdec, "decode_groups", broken)
    else:
        monkeypatch.setattr(decode, "ibwt_rows", broken)
    _, blob = _blob(1, "bz2")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        decode.decompress_parallel(blob, device="cpu")


@pytest.mark.parametrize("name", ["huff", "ibwt", "both"])
def test_switch_on_without_cuda_raises(switches, monkeypatch, name):
    switches(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, blob = _blob(1, "bz2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.decompress_parallel(blob)  # the default device is "cuda"
    switches("off")  # host path: the device is never asked for
    assert decode.decompress_parallel(blob) == data


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import lbzip2_tpu_torch.ops.huffdec, lbzip2_tpu_torch.ops.ibwt\n"
            "import lbzip2_tpu_torch.parallel.decode, lbzip2_tpu_torch.cli\n"
            "import lbzip2_tpu_torch.__main__\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr
