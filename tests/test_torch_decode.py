"""Port's decompression (lbzip2_tpu_torch/parallel/decode.py) on the CPU
vs the JAX package's decompress_parallel and the data.

The device stages run their plain PyTorch versions on the CPU.  Output
bytes must equal the JAX package's, with the switches on and off.
test_torch_decode_errors.py holds the stream errors and
test_torch_decode_batcher.py the IBWT batcher and the switches (each
file stays under test_cli.py's 21 cases, see the verify skill's
Gotchas); both take their streams and switches from here.
"""

import bz2

import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.parallel import decode as jdec
from lbzip2_tpu.parallel.encode import compress_parallel
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
    """Set the port's switches (and the JAX module's, for parity runs;
    narrow JAX IBWT rows keep level-1 batches cheap on the CPU, where
    the port's batches are as wide as their rows)."""
    def set_(name, level=1, jax_too=False):
        huff, ibwt_on = SWITCHES[name]
        monkeypatch.setattr(decode, "DEVICE_HUFF", huff)
        monkeypatch.setattr(decode, "DEVICE_IBWT", ibwt_on)
        width = 131072 if level == 1 else 901120
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
