"""The port's own host layers (lbzip2_tpu_torch/core, native, ref,
parallel, codec.decoder) against the JAX package's, whose jax-free host
code they copy: the same seeded inputs give the same bytes and the same
stream errors, exactly.
"""

import bz2
import io

import numpy as np
import pytest

import lbzip2_tpu.codec.decoder as jcodec_dec
import lbzip2_tpu.native as jnative
import lbzip2_tpu.parallel.decode as jdecode
import lbzip2_tpu.parallel.encode as jencode
import lbzip2_tpu.parallel.scheduler as jsched
import lbzip2_tpu.ref.decoder as jref_dec
import lbzip2_tpu.ref.encoder as jref_enc
from lbzip2_tpu.core import bits as jbits
from lbzip2_tpu.core import constants as jconst
from lbzip2_tpu.core import crc32 as jcrc
from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.codec import decoder as codec_dec
from lbzip2_tpu_torch.core import bits, constants, crc32
from lbzip2_tpu_torch.ops import huffdec
from lbzip2_tpu_torch.parallel import decode, encode, scheduler
from lbzip2_tpu_torch.ref import decoder as ref_dec
from lbzip2_tpu_torch.ref import encoder as ref_enc

pytestmark = pytest.mark.skipif(
    not (native.native_available() and jnative.native_available()),
    reason="needs C toolchain")


def _data(kind, n=60_000):
    rng = np.random.default_rng(21)
    if kind == "text":
        words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
                 for k in rng.integers(2, 9, 300)]
        return b" ".join(words[i] for i in rng.integers(0, 300, n // 4))[:n]
    if kind == "runs":
        return bytes(np.repeat(rng.integers(0, 256, n // 20, dtype=np.uint8),
                               rng.integers(1, 40, n // 20)))[:n]
    if kind == "random":
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    if kind == "periodic":
        return b"abcab" * (n // 5)
    assert kind == "empty"
    return b""


KINDS = ["text", "runs", "random", "periodic", "empty"]


def _same(a, b):
    """Equal results of one call in the two packages (arrays, ints,
    bytes, dicts and tuples of them)."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _block(kind="text"):
    """One level-1 block of the native pipeline: RLE1 output, cmap, BWT."""
    buf = np.frombuffer(_data(kind, 30_000), np.uint8)
    a, b, blk, cmap = native.rle1_collect(buf, 100_000, 100_000)[0]
    brow, bidx = native.bwt(blk)
    return buf, blk.copy(), np.asarray(cmap, np.uint8), brow.copy(), bidx


def _native_calls():
    buf, blk, cmap, brow, bidx = _block()
    blob = np.frombuffer(bz2.compress(_data("text", 30_000), 1), np.uint8)
    rng = np.random.default_rng(3)
    freqs = rng.integers(0, 500, (3, 6, 259)).astype(np.uint32)
    as_arr = np.array([30, 258, 2], np.int32)

    def em(n):
        lengths = np.ones((3, 6, 259), np.uint8)
        n.em_mstep(freqs, as_arr, np.array([6, 2, 3], np.int32), lengths)
        return lengths

    def boundaries(n):
        err, end, meta = n.retrieve_boundaries(blob, blob.size * 8, 32 + 80)
        return err, end, {k: v for k, v in meta.items()}

    def emit(n):
        cur = n.EmitCursor(brow, bidx, 0)
        out = []
        while not cur.done:
            out.append(cur.next_chunk(7000))
        return out, cur.crc

    return {
        "crc32_block": lambda n: n.crc32_block(buf),
        "rle1_collect": lambda n: [
            (a, b, x.copy(), np.asarray(c).copy())
            for a, b, x, c in n.rle1_collect(buf, 9000, 9000)],
        "bwt": lambda n: n.bwt(blk),
        "lyndon_prep": lambda n: n.lyndon_prep(blk),
        "lyndon_prep_periodic": lambda n: n.lyndon_prep(
            np.frombuffer(b"xyz" * 500, np.uint8))[1],
        "encode_payload": lambda n: n.encode_payload(brow, cmap, bidx,
                                                     0x1234, 8),
        "encode_block": lambda n: n.encode_block(blk, cmap, 0x1234, 8),
        "retrieve_block": lambda n: n.retrieve_block(blob, blob.size * 8,
                                                     32 + 80),
        "retrieve_boundaries": boundaries,
        "scan_magic": lambda n: n.scan_magic(blob, 0x314159265359),
        "ibwt_emit": lambda n: n.ibwt_emit(brow, bidx, 0),
        "emit_cursor": emit,
        "em_mstep": em,
    }


@pytest.mark.parametrize("name", sorted(_native_calls()))
def test_native_matches_jax_package(name):
    call = _native_calls()[name]
    _same(call(native), call(jnative))


def test_native_is_built_from_the_ports_sources():
    assert native._SO.parent.name == "lbzip2_tpu_torch"
    assert native._SO.parent.parent.name == "build"
    assert native._SRC.parent.parent.name == "lbzip2_tpu_torch"
    assert native._SO.resolve() != jnative._SO.resolve()
    assert native._SO.exists()


def test_core_matches_jax_package():
    data = _data("text", 5000)
    arr = np.frombuffer(data, np.uint8)
    assert crc32.crc_of(arr) == jcrc.crc_of(arr)
    assert crc32.combine_crc(0x12345678, 0x9ABCDEF0) == \
        jcrc.combine_crc(0x12345678, 0x9ABCDEF0)
    for pos, k in [(0, 8), (13, 48), (777, 32), (39_000, 24)]:
        assert bits.read_bits_at(arr, pos, k) == jbits.read_bits_at(arr, pos,
                                                                    k)
    w, jw = bits.BitWriter(), jbits.BitWriter()
    for value, nbits in [(5, 3), (0x314159265359, 48), (1, 1), (0xFFFF, 17)]:
        w.put(value, nbits)
        jw.put(value, nbits)
    assert w.getvalue() == jw.getvalue()
    assert [(e.name, e.value) for e in constants.Error] == \
        [(e.name, e.value) for e in jconst.Error]
    assert {k.name: v for k, v in constants.ERROR_MESSAGES.items()} == \
        {k.name: v for k, v in jconst.ERROR_MESSAGES.items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [1, 9])
def test_ref_codec_matches_jax_package(kind, level):
    data = _data(kind, 12_000)
    blob = ref_enc.compress(data, level)
    assert blob == jref_enc.compress(data, level)
    assert ref_dec.decompress(blob) == jref_dec.decompress(blob) == data


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [1, 9])
def test_compress_parallel_matches_jax_package(kind, level):
    data = _data(kind, 250_000)
    blob = encode.compress_parallel(data, level, n_workers=2)
    assert blob == jencode.compress_parallel(data, level, n_workers=2)
    assert bz2.decompress(blob) == data


@pytest.mark.parametrize("kind", KINDS)
def test_compress_scheduler_matches_jax_package(kind):
    data = _data(kind, 250_000)
    outs = []
    for mod in (scheduler, jsched):
        sink = io.BytesIO()
        n_in, n_out = mod.CompressScheduler(1, 2, sink).run(
            io.BytesIO(data).read)
        assert (n_in, n_out) == (len(data), len(sink.getvalue()))
        outs.append(sink.getvalue())
    assert outs[0] == outs[1] == jencode.compress_parallel(data, 1)


def _streamed(mod, blob, chunk_size=1 << 16, **kw):
    out = []
    n_in, n_out = mod.decompress_stream(io.BytesIO(blob).read, out.append,
                                        n_workers=2, chunk_size=chunk_size,
                                        **kw)
    data = b"".join(out)
    assert n_out == len(data)
    return n_in, data


@pytest.mark.parametrize("layout", ["bz2", "lbzip2"])
@pytest.mark.parametrize("kind", KINDS)
def test_decoders_match_jax_package(kind, layout):
    data = _data(kind, 250_000)
    blob = bz2.compress(data, 1) if layout == "bz2" else \
        jencode.compress_parallel(data, 1)
    blob += bz2.compress(b"second stream", 9)
    want = data + b"second stream"
    assert codec_dec.decompress(blob) == jcodec_dec.decompress(blob) == want
    assert decode.decompress_parallel(blob, n_workers=2) == want
    assert _streamed(decode, blob) == _streamed(jdecode, blob) == \
        (len(blob), want)


DAMAGE = {
    "block_crc": lambda b: b[:10] + bytes([b[10] ^ 0x10]) + b[11:],
    "payload": lambda b: b[:2000] + bytes([b[2000] ^ 0x10]) + b[2001:],
    "stream_crc": lambda b: b[:-3] + bytes([b[-3] ^ 0x10]) + b[-2:],
    "cut_half": lambda b: b[:len(b) // 2],
    "bad_magic": lambda b: b"BZx" + b[3:],
    "header_only": lambda b: b[:4],
}


def _error_name(fn):
    try:
        fn()
    except (constants.StreamError, jconst.StreamError) as e:
        return type(e).__module__.split(".")[0], e.code.name
    return None


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_stream_errors_match_jax_package(damage):
    blob = DAMAGE[damage](bz2.compress(_data("text", 250_000), 1))
    pairs = [
        (lambda: ref_dec.decompress(blob), lambda: jref_dec.decompress(blob)),
        (lambda: codec_dec.decompress(blob),
         lambda: jcodec_dec.decompress(blob)),
        (lambda: decode.decompress_parallel(blob, n_workers=2),
         lambda: jdecode.decompress_parallel(blob, n_workers=2)),
        (lambda: _streamed(decode, blob), lambda: _streamed(jdecode, blob)),
    ]
    for mine, theirs in pairs:
        got, want = _error_name(mine), _error_name(theirs)
        assert want is not None and want[0] == "lbzip2_tpu"
        # the port raises its own StreamError, with the same code
        assert got == ("lbzip2_tpu_torch", want[1])


@pytest.mark.parametrize("switches", ["huff", "ibwt", "both"])
@pytest.mark.parametrize("chunk_size", [1 << 12, 1 << 22])
def test_decompress_stream_takes_the_device_stages(monkeypatch, switches,
                                                   chunk_size):
    """With the switches on, every block of the streaming decoder,
    speculative or parser-confirmed, goes through the port's stages
    (their plain versions here, on the CPU); small chunks force the
    parser-confirmed path to extend its window."""
    huff, ibwt_on = switches != "ibwt", switches != "huff"
    monkeypatch.setattr(decode, "DEVICE_HUFF", huff)
    monkeypatch.setattr(decode, "DEVICE_IBWT", ibwt_on)
    calls = {"huff": 0}
    plain = huffdec.decode_groups

    def counted(*a):
        calls["huff"] += 1
        return plain(*a)
    monkeypatch.setattr(huffdec, "decode_groups", counted)
    monkeypatch.setattr(
        native, "retrieve_block",
        (lambda *a: pytest.fail("host retrieve with DEVICE_HUFF on"))
        if huff else native.retrieve_block)
    data = _data("text", 350_000)  # four level-1 blocks
    blob = bz2.compress(data, 1)
    n_in, out = _streamed(decode, blob, chunk_size, device="cpu")
    assert (n_in, out) == (len(blob), data)
    s = decode.last_stats
    assert s["blocks"] == 4 and s["device_huff"] == huff
    # one group decode and one IBWT row for each block: none twice
    assert calls["huff"] == (4 if huff else 0)
    assert s["ibwt_rows"] == (4 if ibwt_on else 0)


def test_decompress_stream_uses_its_speculative_results(monkeypatch):
    """The parser takes the next block's speculative result instead of
    decoding the block again.  The JAX loop discards every candidate at
    or before the new parser position, the next block's included, so
    there the parser's own retriever decodes every block a second time;
    the port keeps the candidate at the position."""
    data = _data("text", 1_200_000)  # twelve level-1 blocks
    blob = bz2.compress(data, 1)
    made = {"port": 0, "jax": 0}

    def counting(cls, key):
        class Counted(cls):
            def __init__(self):
                made[key] += 1
                super().__init__()
        return Counted
    monkeypatch.setattr(native, "ResumableRetriever",
                        counting(native.ResumableRetriever, "port"))
    monkeypatch.setattr(jnative, "ResumableRetriever",
                        counting(jnative.ResumableRetriever, "jax"))
    want = (len(blob), data)
    assert _streamed(decode, blob, 1 << 22, device="cpu") == want
    assert _streamed(jdecode, blob, 1 << 22) == want
    blocks = decode.last_stats["blocks"]
    assert blocks >= 12 and made["jax"] == blocks
    assert made["port"] <= blocks // 3
