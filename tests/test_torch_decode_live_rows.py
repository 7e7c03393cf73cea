"""The decoder's device stages ship what is live, and its stages are
traced (lbzip2_tpu_torch/parallel/decode.py, ops/huffdec.py).

Each IBWT flush ships the rows it holds, as wide as its longest row,
where the JAX batcher pads every flush to (8, 901120); the Huffman
stage packs its six inputs into one upload; traced,
``last_stats["trace"]`` holds a span of each stage of each block.  The
output stays equal to the data and to the JAX package's device-stage
decode.  All on the CPU, where the device stages run their plain
versions.
"""

import bz2
import threading

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.parallel import decode as jdec
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch.ops import huffdec
from lbzip2_tpu_torch.parallel import decode
from lbzip2_tpu_torch.utils import trace

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(2, 9, 400)]
    return b" ".join(words[i] for i in rng.integers(0, 400, n // 4))[:n]


# four level-1 blocks of different sizes, the last a short tail
DATA = _text(340_000, 3)


@pytest.fixture()
def spied(monkeypatch):
    """Both device stages on; every ibwt_rows call's shape and row
    sizes recorded."""
    monkeypatch.setattr(decode, "DEVICE_HUFF", True)
    monkeypatch.setattr(decode, "DEVICE_IBWT", True)
    calls = []
    plain = decode.ibwt_rows

    def spy(bwt, ns, idxs):
        calls.append((tuple(bwt.shape), ns.tolist()))
        return plain(bwt, ns, idxs)
    monkeypatch.setattr(decode, "ibwt_rows", spy)
    return calls


def _blob(layout):
    return bz2.compress(DATA, 1) if layout == "bz2" else \
        compress_parallel(DATA, 1)


def _check_flushes(calls, blocks):
    assert calls and sum(len(ns) for _, ns in calls) >= blocks
    for (rows, width), ns in calls:
        assert rows == len(ns) <= 8
        assert width == max(ns)  # no pad row, no pad column
        assert min(ns) > 1       # every row a block's


@pytest.mark.parametrize("layout", ["bz2", "lbzip2"])
def test_parallel_flushes_ship_live_rows(spied, monkeypatch, layout):
    """Against the JAX device stages on lbzip2's layout (one shape to
    compile keeps this file's memory low: see test_cli's RSS bound)."""
    blob = _blob(layout)
    out = decode.decompress_parallel(blob, device="cpu")
    assert out == DATA
    if layout == "lbzip2":
        monkeypatch.setattr(jdec, "DEVICE_HUFF", True)
        monkeypatch.setattr(jdec, "_IBWT_N", 131072)  # JAX pads to this
        assert out == jdec.decompress_parallel(blob, device_ibwt=True)
    _check_flushes(spied, decode.last_stats["blocks"])


@pytest.mark.parametrize("layout", ["bz2", "lbzip2"])
def test_stream_flushes_ship_live_rows(spied, layout):
    blob = _blob(layout)
    parts, view = [], memoryview(blob)
    pos = [0]

    def read(n):
        chunk = bytes(view[pos[0]:pos[0] + n])
        pos[0] += len(chunk)
        return chunk
    assert decode.decompress_stream(read, parts.append, chunk_size=65536,
                                    device="cpu") == (len(blob), len(DATA))
    assert b"".join(parts) == DATA
    _check_flushes(spied, decode.last_stats["blocks"])


ON = {"off": (False, False), "huff": (True, False), "ibwt": (False, True),
      "both": (True, True)}


@pytest.mark.parametrize("name", list(ON))
@pytest.mark.parametrize("entry", ["parallel", "stream"])
def test_last_stats_carry_stage_times(monkeypatch, name, entry):
    """Traced, each stage that ran is a span on a decode worker (or, for
    a parser-confirmed block of the stream, the caller's thread), and
    no other stage is."""
    huff, ibwt_on = ON[name]
    monkeypatch.setattr(decode, "DEVICE_HUFF", huff)
    monkeypatch.setattr(decode, "DEVICE_IBWT", ibwt_on)
    monkeypatch.setenv(trace.ENV, "1")
    blob = _blob("lbzip2")
    if entry == "parallel":
        assert decode.decompress_parallel(blob, device="cpu") == DATA
    else:
        parts = []
        chunks = iter([blob, b""])
        decode.decompress_stream(lambda n: next(chunks), parts.append,
                                 device="cpu")
        assert b"".join(parts) == DATA
    tr = decode.last_stats["trace"]
    ran = {"walk": huff, "huffman": huff, "imtf_rle2": huff,
           "host_retrieve": not huff, "ibwt": ibwt_on, "rle1": ibwt_on,
           "crc": ibwt_on, "host_emit": not ibwt_on}
    assert {sp["name"] for sp in tr["spans"]} == \
        {f"decode.{stage}" for stage, on in ran.items() if on}
    for sp in tr["spans"]:
        assert sp["call"] == tr["call"] and 0 <= sp["t1"] - sp["t0"], sp
        assert sp["thread"].startswith("lbz2-decode") or \
            sp["thread"] == threading.current_thread().name, sp


def test_huffman_inputs_travel_as_one_buffer():
    """The six inputs packed end to end and cut back into views decode
    the same groups as the inputs themselves."""
    blob = _blob("bz2")
    arr = np.frombuffer(blob, np.uint8)
    pos = decode.block_payloads(blob)[0]
    _, _, _, inputs = huffdec.group_inputs(arr, arr.size * 8, pos)
    flat = np.full(sum(a.size for a in inputs) + 7, -1, np.int32)
    shapes = huffdec.pack_inputs(inputs, flat)
    views = huffdec.unpack_inputs(torch.from_numpy(flat), shapes)
    for v, a in zip(views, inputs):
        np.testing.assert_array_equal(v.numpy(), a)
    got = huffdec.decode_groups(*views)
    want = huffdec.decode_groups(*(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in inputs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
