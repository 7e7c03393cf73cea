"""decompress_stream scans the bytes that arrive once, not its whole
window before every block.

``_StreamBuf.scan_new`` keeps an absolute scanned mark and rescans only
the overlap a 48-bit magic needs across the seam between two chunks.
Held against one ``scan_magic_bits`` over the whole stream, with magics
at every bit phase straddling the seams, and through decompress_stream
against the JAX package's decoder.
"""

import bz2
import io

import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.parallel import decode as jdecode
from lbzip2_tpu_torch.parallel import decode

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")

MAGIC = decode.BLOCK_MAGIC


def _put_magic(bits: np.ndarray, at: int) -> None:
    bits[at:at + 48] = [(MAGIC >> (47 - k)) & 1 for k in range(48)]


def _stream_with_magics(n_bytes: int, chunk: int) -> bytes:
    """Random bytes with a block magic across every chunk seam that has
    room for one, the bit phase changing from seam to seam, plus magics
    at the very start and the very end."""
    rng = np.random.default_rng(chunk)
    bits = rng.integers(0, 2, n_bytes * 8).astype(np.uint8)
    step = max(chunk, 7)  # magics must not overlap: 48 bits apart
    for k, seam in enumerate(range(step, n_bytes - 7, step)):
        _put_magic(bits, seam * 8 - 1 - (k * 5) % 47)
    _put_magic(bits, 0)
    _put_magic(bits, n_bytes * 8 - 48)
    return np.packbits(bits).tobytes()


@pytest.fixture()
def counted_scan(monkeypatch):
    """scan_magic_bits with a count of the scans of every stream byte:
    a scan covers the last arr.size bytes that have arrived."""
    real = decode.scan_magic_bits
    state = {"arrived": 0, "scans": None, "calls": 0, "real": real}

    def scan(arr, *a):
        end = state["arrived"]
        state["scans"][end - arr.size:end] += 1
        state["calls"] += 1
        return real(arr, *a)
    monkeypatch.setattr(decode, "scan_magic_bits", scan)
    return state


@pytest.mark.parametrize("chunk", [1, 7, 4096])
def test_chunks_yield_the_candidates_of_one_whole_scan(counted_scan, chunk):
    n = 3000 if chunk < 4096 else 40_000
    blob = _stream_with_magics(n, chunk)
    want = counted_scan["real"](np.frombuffer(blob, np.uint8)).tolist()
    assert len(want) >= n // max(chunk, 7)  # the seams hold magics
    counted_scan["scans"] = np.zeros(n, np.int32)
    src = io.BytesIO(blob)
    sb = decode._StreamBuf(src.read, chunk)
    got = []
    while True:
        more = sb.extend()
        counted_scan["arrived"] = src.tell()
        got.extend(sb.scan_new())
        if not more:
            break
    assert got == want
    assert counted_scan["scans"].max() <= 2, "a byte was scanned thrice"
    assert counted_scan["scans"].min() >= 1
    assert sb.scan_new() == []  # nothing new: no scan at all
    if chunk == 1:  # short chunks are gathered, not scanned one by one
        assert counted_scan["calls"] <= n // 6 + 2


def test_scanned_mark_moves_with_the_window(counted_scan):
    """drop_before cuts the window; the mark is absolute, so the scan
    goes on where it stopped and positions stay absolute."""
    chunk = 64
    bits = np.unpackbits(np.frombuffer(_stream_with_magics(4096, chunk),
                                       np.uint8))
    for k in range(0, 60, 5):  # magics well inside a chunk
        _put_magic(bits, (chunk * k + 10) * 8 + 3)
    blob = np.packbits(bits).tobytes()
    want = counted_scan["real"](np.frombuffer(blob, np.uint8)).tolist()
    counted_scan["scans"] = np.zeros(len(blob), np.int32)
    src = io.BytesIO(blob)
    sb = decode._StreamBuf(src.read, chunk)
    got = []
    while True:
        more = sb.extend()
        counted_scan["arrived"] = src.tell()
        got.extend(sb.scan_new())
        # the parser has passed all but the window's last 3 bytes: less
        # than the overlap the next scan would like
        sb.drop_before((sb.base + len(sb.buf) - 3) * 8)
        if not more:
            break
    assert sb.base > 0
    # every magic that does not start in bytes the parser had passed
    # when its end arrived is found, at its absolute position
    assert set(got) <= set(want)
    inside = [p for p in want if (p // 8) % chunk <= chunk - 7]
    assert set(inside) <= set(got) and len(inside) > 12
    assert counted_scan["scans"].max() <= 2


@pytest.mark.parametrize("chunk", [1, 7, 4096])
def test_stream_decodes_as_before_with_one_scan_a_byte(counted_scan, chunk):
    """Same bytes out, same counts, same block total as the JAX
    package's decompress_stream; no input byte scanned more than twice,
    whatever the number of blocks."""
    rng = np.random.default_rng(4)
    data = bytes(rng.integers(97, 110, 130_000, dtype=np.uint8))
    if chunk == 1:
        data = data[:20_000]  # two streams: byte-wise reading is slow
    blob = b"".join(bz2.compress(data[i:i + 10_000], 1)
                    for i in range(0, len(data), 10_000))
    counted_scan["scans"] = np.zeros(len(blob), np.int32)
    src = io.BytesIO(blob)

    def read(n):
        got = src.read(n)
        counted_scan["arrived"] = src.tell()
        return got
    out = []
    n_in, n_out = decode.decompress_stream(read, out.append, n_workers=2,
                                           chunk_size=chunk, device="cpu")
    assert b"".join(out) == data and (n_in, n_out) == (len(blob), len(data))
    assert counted_scan["scans"].max() <= 2
    jout = []
    jsrc = io.BytesIO(blob)
    assert jdecode.decompress_stream(jsrc.read, jout.append, n_workers=2,
                                     chunk_size=chunk) == (n_in, n_out)
    assert b"".join(jout) == data
    assert decode.last_stats["blocks"] == len(data) // 10_000
