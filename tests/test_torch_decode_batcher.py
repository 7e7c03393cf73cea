"""The port's IBWT batcher (lbzip2_tpu_torch/parallel/decode.py
``_DeviceIbwtBatcher``) on the CPU: it never takes more than max_batch
rows, ships each flush's live rows only and hands a failing flush's
error to every waiter; a device stage switched on without CUDA raises
(no CPU fallback); the decoder's modules import no JAX.  The streams
and switches are test_torch_decode.py's.
"""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_decode import _blob, switches  # noqa: F401 (fixture)

from lbzip2_tpu import native
from lbzip2_tpu.ref import bwt as ref_bwt
from lbzip2_tpu_torch.parallel import decode

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


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
    shapes = []
    plain = decode.ibwt_rows

    def spy(bwt, ns, idxs):
        shapes.append((tuple(bwt.shape), int(ns.max())))
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
    # each flush ships its live rows, as wide as its longest
    assert sum(rows for (rows, _), _ in shapes) == 16
    assert all(rows <= 2 and width == longest
               for (rows, width), longest in shapes)


def test_failing_flush_reaches_every_waiter(monkeypatch):

    def broken(bwt, ns, idxs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(decode, "ibwt_rows", broken)
    batcher = decode._DeviceIbwtBatcher(max_batch=2, linger_s=0.001,
                                        device="cpu")
    _, errors, alive = _hammer(batcher, _rows(16))
    assert not alive
    assert all(isinstance(e, RuntimeError) for e in errors), errors


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
