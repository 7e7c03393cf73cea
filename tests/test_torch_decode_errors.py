"""Port's decompression (lbzip2_tpu_torch/parallel/decode.py) on the CPU
vs the JAX package's on damaged streams: the StreamError codes must
equal the JAX package's with the device stages off and on, and a kernel
failure must reach the caller as itself, not as a stream error.  The
streams and switches are test_torch_decode.py's.
"""

import pytest
from test_torch_decode import _blob, switches  # noqa: F401 (fixture)

from lbzip2_tpu import native
from lbzip2_tpu.core.constants import StreamError as JaxStreamError
from lbzip2_tpu.parallel import decode as jdec
from lbzip2_tpu_torch.core.constants import StreamError
from lbzip2_tpu_torch.ops import huffdec
from lbzip2_tpu_torch.parallel import decode

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


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
