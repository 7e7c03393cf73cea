"""Speculative parallel decompression with the port's device stages.

Counterpart of lbzip2_tpu/parallel/decode.py.  bzip2 streams carry no
block index, so decode parallelism must be discovered: a bit scanner
finds every offset where the 48-bit block magic appears, speculative
workers decode each candidate concurrently, and the sequential parser
walks the stream confirming candidates and stitching results in order.
A false-positive candidate merely wastes a worker; a missing one falls
back to synchronous decode, so the result always equals sequential
decoding.  ``decompress_parallel`` works on a whole stream in memory,
``decompress_stream`` on a sliding window with bounded memory.

Two opt-in device stages, in both entry points:

  LBZ2_DEVICE_HUFF=1    Huffman stage: host boundary walk, group decode
                        on the device (ops/huffdec.py, csrc/huffdec.cu),
                        host IMTF + RLE2
  LBZ2_DEVICE_DECODE=1  inverse BWT of every non-randomised block on the
                        device, up to 8 blocks a batch, each batch as
                        many rows as it holds and as wide as its longest
                        (_DeviceIbwtBatcher over ops/ibwt.py,
                        csrc/ibwt.cu), host RLE1 + CRC

Both are off by default, as in the JAX package.  A switched-off stage
takes the host C path.  With a switch on, ``device="cuda"`` without
CUDA raises; an error raised by a kernel or its launch propagates out
of the entry point and never becomes a stream-error verdict.

Traced (``utils/trace.py``), ``last_stats["trace"]`` holds a span for
each stage of each block decoded (speculative candidates included), on
the worker thread that ran it: with the device stages, the host boundary
walk (``decode.walk``), the Huffman stage from upload to download
(``decode.huffman``), IMTF + RLE2 (``decode.imtf_rle2``), the wait for
the batcher's inverse BWT (``decode.ibwt``), RLE1 (``decode.rle1``) and
the CRC (``decode.crc``); on the host C path, retrieve (walk, Huffman,
IMTF + RLE2: ``decode.host_retrieve``) and inverse BWT + RLE1 + CRC
(``decode.host_emit``).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.bits import read_bits_at as _read_bits
from lbzip2_tpu_torch.core.constants import Error, StreamError
from lbzip2_tpu_torch.device import resolve, to_host, upload
from lbzip2_tpu_torch.ops.huffdec import decode_block_device
from lbzip2_tpu_torch.ops.ibwt import ibwt_rows
from lbzip2_tpu_torch.ref.rle1 import rle1_decode
from lbzip2_tpu_torch.utils import trace

BLOCK_MAGIC = 0x314159265359
EOS_MAGIC = 0x177245385090

# the JAX package's switches and defaults (parallel/decode.py:224, :231)
DEVICE_IBWT = os.environ.get("LBZ2_DEVICE_DECODE", "0") == "1"
DEVICE_HUFF = os.environ.get("LBZ2_DEVICE_HUFF", "0") == "1"

last_stats: dict | None = None  # device use of the last decompress call

def scan_magic_bits(data: np.ndarray, magic: int = BLOCK_MAGIC
                    ) -> np.ndarray:
    """All bit offsets where the 48-bit magic occurs.

    Production path: the C shift-register scan (native lbz2_scan_magic,
    O(1) extra memory).  Fallback: a vectorized numpy scan
    over 8 shifted views — for each bit phase s, compare the 6-byte
    windows of (data << s) against the magic bytes.
    """
    n = data.size
    if n < 6:
        return np.zeros(0, np.int64)
    if native.native_available():
        return native.scan_magic(data, magic)
    hits = []
    d = data.astype(np.uint16)
    for s in range(8):
        if s == 0:
            shifted = data
            m = n
        else:
            # byte i of (bitstream << s): (d[i] << s | d[i+1] >> (8-s))
            shifted = (((d[:-1] << s) | (d[1:] >> (8 - s))) & 0xFF
                       ).astype(np.uint8)
            m = n - 1
        if m < 6:
            continue
        mb = [(magic >> (40 - 8 * k)) & 0xFF for k in range(6)]
        ok = shifted[:m - 5] == mb[0]
        for k in range(1, 6):
            ok &= shifted[k:m - 5 + k] == mb[k]
        pos = np.flatnonzero(ok).astype(np.int64) * 8 + s
        hits.append(pos)
    out = np.concatenate(hits)
    out.sort()
    return out


OUT_GRANUL = 900000
EMIT_THRESH = 2  # speculative emit keeps this many slots free


class SlotPool:
    """Bounded output-buffer accounting with next-in-order reservation.

    The reference's anti-deadlock memory policy (src/expand.c:31-52):
    speculative emitters may only take a slot while more than
    EMIT_THRESH remain, so the in-order (authoritative) consumer always
    finds a free slot and the pipeline cannot wedge no matter how many
    speculative blocks are suspended mid-emit."""

    def __init__(self, slots: int):
        self.free = slots
        self.total = slots
        self.peak = 0
        self._cv = threading.Condition()

    def try_acquire(self, in_order: bool = False) -> bool:
        with self._cv:
            ok = self.free > EMIT_THRESH or (in_order and self.free > 0)
            if ok:
                self.free -= 1
                self.peak = max(self.peak, self.total - self.free)
            return ok

    def acquire_in_order(self) -> None:
        with self._cv:
            while self.free <= 0:
                self._cv.wait()
            self.free -= 1
            self.peak = max(self.peak, self.total - self.free)

    def release(self, k: int = 1) -> None:
        with self._cv:
            self.free += k
            self._cv.notify_all()


class _Request:
    """One IBWT row waiting in the batcher."""

    def __init__(self, bwt: np.ndarray, idx: int):
        self.bwt, self.idx = bwt, idx
        self.out: np.ndarray | None = None
        self.error: BaseException | None = None
        self.done = threading.Event()


class _DeviceIbwtBatcher:
    """Groups concurrent IBWT requests into device batches of up to
    ``max_batch`` rows, on a CUDA stream of its own.  A batch ships the
    rows it holds at the width its longest row needs (the JAX batcher
    pads every batch to (8, 901120): 7.2 MB up and down for the 1.5 to
    4.5 live rows a flush of the card's decoder holds).

    Workers block in ``run``; a linger window lets concurrent decoders
    coalesce.  A flush takes at most ``max_batch`` requests, first come
    first served, and leaves the rest for the next flush; every waiter
    whose request is still queued after a linger window flushes again,
    so none is stranded.  (The JAX batcher decides to flush and takes
    the queue under two lock acquisitions, so a ninth request can slip
    in between and overflow the batch, and then every waiter of that
    flush waits forever.)  A flush that raises hands its error to every
    request it took."""

    def __init__(self, max_batch: int = 8, linger_s: float = 0.005,
                 device: str | torch.device = "cuda"):
        self.max_batch = max_batch
        self.linger_s = linger_s
        self.device = resolve(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._queue: list[_Request] = []
        self.rows = 0       # live rows dispatched
        self.flushes = 0    # batches dispatched
        self.most_rows = 0  # most live rows in one batch

    def run(self, bwt: np.ndarray, idx: int) -> np.ndarray:
        req = _Request(bwt, idx)
        with self._lock:
            self._queue.append(req)
            full = len(self._queue) >= self.max_batch
        if full:
            self._flush()
        while not req.done.wait(self.linger_s):
            self._flush()
        if req.error is not None:
            raise req.error
        return req.out

    def _flush(self) -> None:
        with self._lock:
            reqs = self._queue[:self.max_batch]
            del self._queue[:len(reqs)]
            if reqs:
                self.rows += len(reqs)
                self.flushes += 1
                self.most_rows = max(self.most_rows, len(reqs))
        if not reqs:
            return
        try:
            out = self._ibwt(reqs)
            for r, req in enumerate(reqs):
                req.out = out[r, :req.bwt.size]
        except BaseException as e:  # noqa: BLE001 — every waiter gets it
            for req in reqs:
                req.error = e
        finally:
            for req in reqs:
                req.done.set()

    def _ibwt(self, reqs: list[_Request]) -> np.ndarray:
        width = max(req.bwt.size for req in reqs)
        batch = np.zeros((len(reqs), width), np.uint8)
        ns = np.empty(len(reqs), np.int32)
        idxs = np.empty(len(reqs), np.int32)
        for r, req in enumerate(reqs):
            batch[r, :req.bwt.size] = req.bwt
            ns[r] = req.bwt.size
            idxs[r] = req.idx
        if self.stream is None:
            return ibwt_rows(torch.from_numpy(batch), torch.from_numpy(ns),
                             torch.from_numpy(idxs)).numpy()
        with torch.cuda.stream(self.stream):
            out = to_host(ibwt_rows(*(upload(a, self.device)
                                      for a in (batch, ns, idxs))))
            done = torch.cuda.Event(blocking=True)
            done.record(self.stream)
        done.synchronize()  # this batch only, not the whole device
        return out.numpy()


def _decode_candidate(arr: np.ndarray, nbits: int, payload_pos: int,
                      pool: SlotPool | None = None,
                      batcher: _DeviceIbwtBatcher | None = None,
                      device: torch.device | None = None,
                      tr: trace.Tracer | None = None):
    """Speculatively retrieve + IBWT the block whose payload starts at
    payload_pos (lbzip2_tpu/parallel/decode.py:111-129): the Huffman
    stage on ``device`` when DEVICE_HUFF is on, the host C retrieve
    otherwise; then ``_emit_result``, which takes the batcher's device
    IBWT for a non-randomised block and the host C path for the rest."""
    if DEVICE_HUFF:
        err, newpos, bwt, idx, rnd = decode_block_device(
            arr, nbits, payload_pos, device, tr and tr.add)
    else:
        err, newpos, bwt, idx, rnd = trace.timed(
            tr, "decode.host_retrieve", native.retrieve_block, arr, nbits,
            payload_pos)
    if err != 0:
        return {"err": err}
    return _emit_result(bwt, idx, rnd, newpos, pool, batcher, tr)


def block_payloads(data: bytes) -> list[int]:
    """Payload bit offsets (just past magic and CRC) of every block of
    the first stream in ``data``, found by the host boundary walk."""
    arr = np.frombuffer(bytes(data), np.uint8)
    nbits = arr.size * 8
    pos, out = 32, []
    while nbits - pos >= 48 and _read_bits(arr, pos, 48) == BLOCK_MAGIC:
        out.append(pos + 80)
        err, pos, _ = native.retrieve_boundaries(arr, nbits, pos + 80)
        if err != 0:
            raise StreamError(_ERR_BY_VALUE.get(err, Error.ERR_HEADER))
    return out


def _emit_result(bwt, idx, rnd, newpos,
                 pool: SlotPool | None = None,
                 batcher: "_DeviceIbwtBatcher | None" = None,
                 tr: trace.Tracer | None = None):
    """IBWT + RLE1-expand a retrieved block into result chunks
    (slot-pooled when a SlotPool bounds memory)."""
    if batcher is not None and not rnd:
        # device IBWT (batched sublist list ranking), host RLE1+CRC
        if not (0 <= idx < bwt.size):
            return {"err": Error.ERR_RUNLEN.value}
        rle_domain = trace.timed(tr, "decode.ibwt", batcher.run, bwt,
                                 int(idx))
        plain, ok = trace.timed(tr, "decode.rle1", rle1_decode,
                                rle_domain)
        if not ok:
            return {"err": Error.ERR_RUNLEN.value}
        crc = (trace.timed(tr, "decode.crc", native.crc32_block, plain)
               ^ 0xFFFFFFFF) & 0xFFFFFFFF
        return {"err": 0, "end": newpos, "chunks": [plain.tobytes()],
                "cursor": None, "crc": crc, "size": int(bwt.size),
                "pooled": False}
    return trace.timed(tr, "decode.host_emit", _emit_host, bwt, idx, rnd,
                       newpos, pool)


def _emit_host(bwt, idx, rnd, newpos, pool: SlotPool | None):
    """The host C inverse BWT, RLE1 and CRC of a retrieved block."""
    if pool is None:
        try:
            plain, crcreg = native.ibwt_emit(bwt, idx, rnd)
        except ValueError:
            return {"err": Error.ERR_RUNLEN.value}
        return {"err": 0, "end": newpos, "chunks": [plain.tobytes()],
                "cursor": None,
                "crc": (crcreg ^ 0xFFFFFFFF) & 0xFFFFFFFF,
                "size": int(bwt.size), "pooled": False}
    try:
        cur = native.EmitCursor(bwt, idx, rnd)
    except ValueError:
        return {"err": Error.ERR_RUNLEN.value}
    chunks: list[bytes] = []
    while not cur.done:
        if not pool.try_acquire():
            return {"err": 0, "end": newpos, "chunks": chunks,
                    "cursor": cur, "size": int(bwt.size),
                    "pooled": True}
        try:
            chunks.append(cur.next_chunk(OUT_GRANUL))
        except ValueError:
            pool.release(len(chunks) + 1)
            return {"err": Error.ERR_RUNLEN.value}
    return {"err": 0, "end": newpos, "chunks": chunks, "cursor": None,
            "crc": cur.crc, "size": int(bwt.size), "pooled": True}


def _finish_in_order(res: dict, pool: SlotPool | None, sink) -> None:
    """Drain a confirmed block's chunks (and cursor tail) into sink,
    releasing slots as they are consumed."""
    pooled = res.get("pooled", False)
    for c in res["chunks"]:
        sink(c)
        if pool is not None and pooled:
            pool.release()
    res["chunks"] = []
    cur = res.get("cursor")
    if cur is not None:
        try:
            while not cur.done:
                if pool is not None:
                    pool.acquire_in_order()
                c = cur.next_chunk(OUT_GRANUL)
                sink(c)
                if pool is not None:
                    pool.release()
        except ValueError:
            raise StreamError(Error.ERR_RUNLEN)
        res["crc"] = cur.crc
        res["cursor"] = None


def _cancel_candidate(res_or_fut, pool: SlotPool | None) -> None:
    """Release every slot a stale speculative result still holds."""
    if pool is None:
        return
    try:
        res = res_or_fut.result() if hasattr(res_or_fut, "result") \
            else res_or_fut
    except Exception:  # noqa: BLE001 — dead speculative job holds nothing
        return
    if res and res.get("err") == 0 and res.get("pooled", False):
        pool.release(len(res["chunks"]))
        res["chunks"] = []


_ERR_BY_VALUE = {e.value: e for e in Error}


def decompress_parallel(data: bytes, n_workers: int | None = None,
                        out_slots: int | None = None,
                        device_ibwt: bool | None = None,
                        device: str | torch.device = "cuda") -> bytes:
    """Parallel decode, semantics identical to the sequential decoder
    and to lbzip2_tpu.parallel.decode.decompress_parallel (:285-380);
    the device stages run on ``device``.

    Speculative emission is bounded by a SlotPool of out_slots
    OUT_GRANUL buffers (default 16 per worker) with the next-in-order
    reservation, so a zip-bomb block cannot blow up resident memory
    beyond the pool no matter how many candidates decode it early."""
    global last_stats
    if native.get_lib() is None:
        from lbzip2_tpu_torch.ref.decoder import decompress as ref_dec
        return ref_dec(data)
    buf = bytes(data)
    if len(buf) < 4 or buf[0:3] != b"BZh" or not (0x31 <= buf[3] <= 0x39):
        raise StreamError(Error.ERR_MAGIC)
    use_ibwt = DEVICE_IBWT if device_ibwt is None else device_ibwt
    dev = resolve(device) if (DEVICE_HUFF or use_ibwt) else None
    arr = np.frombuffer(buf, np.uint8)
    nbits = arr.size * 8
    if n_workers is None:
        n_workers = min(32, os.cpu_count() or 1)
    spool = SlotPool(out_slots or 16 * n_workers)
    batcher = _DeviceIbwtBatcher(device=dev) if use_ibwt else None
    tr = trace.begin()
    stats = {"blocks": 0, "device_huff": DEVICE_HUFF,
             "ibwt_rows": 0, "ibwt_flushes": 0, "trace": None}
    last_stats = stats

    def decode(p):
        return _decode_candidate(arr, nbits, p + 80, spool, batcher, dev,
                                 tr)

    candidates = [int(p) for p in scan_magic_bits(arr)]
    out_parts: list[bytes] = []
    with ThreadPoolExecutor(max_workers=n_workers,
                            thread_name_prefix="lbz2-decode") as pool:
        futs: dict[int, object] = {}
        next_cand = 0

        def refill(parser_pos):
            nonlocal next_cand
            # windowed speculation: bounded futures ahead of the parser
            while next_cand < len(candidates) and \
                    len(futs) < 4 * n_workers:
                p = candidates[next_cand]
                next_cand += 1
                if p >= parser_pos:
                    futs[p] = pool.submit(decode, p)

        # sequential parser walk, consuming speculative results
        pos = 24
        level = _read_bits(arr, pos, 8) - 0x30
        pos += 8
        combined = 0
        while True:
            try:
                magic = _read_bits(arr, pos, 48)
            except EOFError:
                raise StreamError(Error.ERR_EOF)
            if magic == BLOCK_MAGIC:
                try:
                    crc_stored = _read_bits(arr, pos + 48, 32)
                except EOFError:
                    raise StreamError(Error.ERR_EOF)
                refill(pos)
                fut = futs.pop(pos, None)
                res = fut.result() if fut is not None else decode(pos)
                # discard false-positive candidates the parser passed
                for stale in [p for p in futs if p <= pos]:
                    _cancel_candidate(futs.pop(stale), spool)
                if res["err"] != 0:
                    raise StreamError(_ERR_BY_VALUE.get(
                        res["err"], Error.ERR_HEADER))
                if res["size"] > level * 100000:
                    raise StreamError(Error.ERR_OVERFLOW)
                _finish_in_order(res, spool, out_parts.append)
                if res["crc"] != crc_stored:
                    raise StreamError(Error.ERR_BLKCRC)
                stats["blocks"] += 1
                combined = crc32.combine_crc(combined, crc_stored)
                pos = res["end"]
                continue
            if magic == EOS_MAGIC:
                try:
                    stored = _read_bits(arr, pos + 48, 32)
                except EOFError:
                    raise StreamError(Error.ERR_EOF)
                pos += 80
                if stored != combined:
                    raise StreamError(Error.ERR_STRMCRC)
                pos += (-pos) % 8
                if nbits - pos >= 32:
                    hdr = _read_bits(arr, pos, 32)
                    if (hdr >> 8) == 0x425A68 and \
                            0x31 <= (hdr & 0xFF) <= 0x39:
                        pos += 32
                        level = (hdr & 0xFF) - 0x30
                        combined = 0
                        continue
                break
            raise StreamError(Error.ERR_HEADER)

    if batcher is not None:
        stats["ibwt_rows"] = batcher.rows
        stats["ibwt_flushes"] = batcher.flushes
    if tr:
        stats["trace"] = tr.result()
    return b"".join(out_parts)


_MAGIC_BYTES = 6  # a magic that a scan up to byte E could not see whole
                  # starts after bit 8 * E - 48, so in byte E - 6 or later


class _StreamBuf:
    """Sliding input window with absolute bit addressing."""

    def __init__(self, read_chunk, chunk_size: int):
        self.read_chunk = read_chunk
        self.chunk_size = chunk_size
        self.base = 0  # absolute byte offset of buf[0]
        self.buf = b""
        self.eof = False
        self.scanned = 0  # absolute byte offset: scan_new has reported
                          # every block magic that ends at or before it
        self._lock = threading.Lock()

    def extend(self) -> bool:
        # Serialized: speculative workers and the parser both extend.
        with self._lock:
            if self.eof:
                return False
            chunk = self.read_chunk(self.chunk_size)
            if not chunk:
                self.eof = True
                return False
            self.buf += chunk
            return True

    def ensure_bits(self, abs_bit: int, nbits: int) -> bool:
        """True if [abs_bit, abs_bit+nbits) is in the buffer (extending
        as needed)."""
        while (self.base + len(self.buf)) * 8 < abs_bit + nbits:
            if not self.extend():
                return False
        return True

    def drop_before(self, abs_bit: int) -> None:
        with self._lock:
            keep_from = abs_bit // 8 - self.base
            if keep_from > self.chunk_size:
                self.buf = self.buf[keep_from:]
                self.base += keep_from

    def scan_new(self) -> list[int]:
        """Absolute bit offsets, ascending, of the block magics that end
        in the bytes that arrived since the last call: each byte of the
        stream is scanned once as new and at most once more as the
        overlap a magic needs across the seam.  A call that finds fewer
        than ``_MAGIC_BYTES`` new bytes waits for more (a second short
        call would scan the same overlap a third time), except at the
        end of the input.  The mark is an absolute offset, so it moves
        with the window when ``drop_before`` cuts it; the overlap is
        cut to what the window still holds (anything before it lies
        behind the parser)."""
        arr, base = self.snapshot()
        end = base + arr.size
        fresh = end - self.scanned
        if fresh <= 0 or (fresh < _MAGIC_BYTES and not self.eof):
            return []
        start = max(self.scanned - _MAGIC_BYTES, base)
        seen = self.scanned * 8 - 48  # the last start bit of an old magic
        self.scanned = end
        found = scan_magic_bits(arr[start - base:]) + start * 8
        return [int(p) for p in found if p > seen]

    def arr(self) -> np.ndarray:
        return np.frombuffer(self.buf, np.uint8)

    def snapshot(self) -> tuple[np.ndarray, int]:
        """Atomic (buffer view, base) pair for concurrent decoders."""
        with self._lock:
            return np.frombuffer(self.buf, np.uint8), self.base

    def read_bits(self, abs_bit: int, k: int) -> int:
        if not self.ensure_bits(abs_bit, k):
            raise EOFError
        return _read_bits(self.arr(), abs_bit - self.base * 8, k)


def decompress_stream(read_chunk, write, n_workers: int | None = None,
                      chunk_size: int = 4 << 20,
                      out_slots: int | None = None,
                      _pool_out: list | None = None,
                      verbose: bool = False, in_size: int | None = None,
                      progress_name: str = "",
                      device: str | torch.device = "cuda"
                      ) -> tuple[int, int]:
    """Streaming decode with bounded input AND output memory.

    read_chunk(n) -> bytes supplies input; write(bytes) consumes output.
    Returns (bytes_in, bytes_out).  Semantics identical to
    decompress_parallel; blocks whose payload crosses the current window
    are retried after extending it (the resumable-coroutine analogue).
    Output-side memory is bounded by a SlotPool (16 slots/worker, last
    one reserved for the in-order block) — a 26-byte zip bomb expanding
    to 47 MB streams through the fixed pool instead of materializing.
    With DEVICE_HUFF / DEVICE_IBWT on, every block (speculative or
    parser-confirmed) takes those stages on ``device``.
    """
    global last_stats
    if n_workers is None:
        n_workers = min(32, os.cpu_count() or 1)
    spool = SlotPool(out_slots or 16 * n_workers)
    dev = resolve(device) if (DEVICE_HUFF or DEVICE_IBWT) else None
    batcher = _DeviceIbwtBatcher(device=dev) if DEVICE_IBWT else None
    tr = trace.begin()
    stats = {"blocks": 0, "device_huff": DEVICE_HUFF,
             "ibwt_rows": 0, "ibwt_flushes": 0, "trace": None}
    last_stats = stats
    if _pool_out is not None:
        _pool_out.append(spool)  # test hook: expose peak accounting
    sb = _StreamBuf(read_chunk, chunk_size)
    if not sb.ensure_bits(0, 32):
        raise StreamError(Error.ERR_MAGIC)
    hdr = sb.read_bits(0, 32)
    if (hdr >> 8) != 0x425A68 or not (0x31 <= (hdr & 0xFF) <= 0x39):
        raise StreamError(Error.ERR_MAGIC)
    level = (hdr & 0xFF) - 0x30
    pos = 32
    combined = 0
    total_out = 0

    # %/ETA over consumed input, once per second on a tty — the
    # reference's sink-side progress covers both directions
    # (src/process.c:392-411); rate is input-byte based there too.
    import sys as _sys
    import time as _time
    _t0 = _time.time()
    _last_prog = [0.0]

    def _progress(done_bits: int):
        if not (verbose and in_size and _sys.stderr.isatty()):
            return
        now = _time.time()
        if now - _last_prog[0] < 1.0:
            return
        _last_prog[0] = now
        done = min(done_bits // 8, in_size)
        pct = 100.0 * done / in_size
        elapsed = now - _t0
        eta = elapsed * (in_size - done) / max(1, done)
        _sys.stderr.write(f"\r{progress_name}: {pct:5.1f}% done, "
                          f"ETA {eta:6.1f}s")
        _sys.stderr.flush()

    def decode_at(p: int, speculative: bool = False):
        """Decode the block whose magic is at absolute bit p.

        The parser-confirmed call drives the C resumable retriever
        (native lbz2_retr_step, the reference's suspend-anywhere
        retrieve contract, src/decode.c:387-407): it consumes exactly
        the bits available and returns MORE when the window runs dry,
        so arbitrarily small input chunks stream through with no
        worst-case pre-buffering.  Speculative candidates decode only
        within the current snapshot (a false positive must not drag
        the file in) and report ERR_EOF, which the parser retries
        non-speculatively."""
        if not speculative and native.native_available() and \
                not DEVICE_HUFF:
            r = native.ResumableRetriever()
            try:
                sp = tr and tr.open("decode.host_retrieve")
                while True:
                    arr, base = sb.snapshot()
                    err, end, size, idx, rnd = r.step(arr, base * 8,
                                                      p + 80)
                    if err == Error.MORE.value and sb.extend():
                        continue
                    break
                if sp:
                    tr.close(sp)
                if err == Error.MORE.value:  # exhausted at true EOF
                    return {"err": Error.ERR_EOF.value}
                if err != 0:
                    return {"err": err}
                return {**_emit_result(r.bwt[:size], idx, rnd, 0,
                                       spool, batcher, tr),
                        "end": end}
            finally:
                r.close()
        if not speculative:
            payload_bound = (level * 100000 * 20) // 8 + 65536
            sb.ensure_bits(p + 80, payload_bound * 8)  # stops at EOF
        while True:
            arr, base = sb.snapshot()
            res = _decode_candidate(arr, arr.size * 8,
                                    p + 80 - base * 8, spool, batcher,
                                    dev, tr)
            if res["err"] == Error.ERR_EOF.value and not speculative \
                    and sb.extend():
                continue
            if res.get("end") is not None:
                res["end"] += base * 8
            return res

    with ThreadPoolExecutor(max_workers=n_workers,
                            thread_name_prefix="lbz2-decode") as pool:
        pending: dict[int, object] = {}
        found: list[int] = []  # candidates ahead of the parser, ascending

        def refresh_speculation():
            # the window's new bytes are scanned once; the candidates
            # found stay until the parser has passed them or a worker
            # has taken them
            found.extend(sb.scan_new())
            keep = []
            for ap in found:
                if ap <= pos or ap in pending:
                    continue
                if len(pending) < 4 * n_workers:
                    pending[ap] = pool.submit(decode_at, ap, True)
                else:
                    keep.append(ap)
            found[:] = keep

        while True:
            try:
                magic = sb.read_bits(pos, 48)
            except EOFError:
                raise StreamError(Error.ERR_EOF)
            if magic == BLOCK_MAGIC:
                try:
                    crc_stored = sb.read_bits(pos + 48, 32)
                except EOFError:
                    raise StreamError(Error.ERR_EOF)
                refresh_speculation()
                fut = pending.pop(pos, None)
                res = fut.result() if fut is not None else None
                if res is None or res["err"] == Error.ERR_EOF.value:
                    # miss, or speculative decode ran out of window:
                    # authoritative decode with window extension
                    res = decode_at(pos)
                if res["err"] != 0:
                    raise StreamError(_ERR_BY_VALUE.get(
                        res["err"], Error.ERR_HEADER))
                if res["size"] > level * 100000:
                    raise StreamError(Error.ERR_OVERFLOW)
                nw = [0]

                def sink(c, nw=nw):
                    write(c)
                    nw[0] += len(c)
                _finish_in_order(res, spool, sink)
                if res["crc"] != crc_stored:
                    raise StreamError(Error.ERR_BLKCRC)
                total_out += nw[0]
                stats["blocks"] += 1
                combined = crc32.combine_crc(combined, crc_stored)
                pos = res["end"]
                _progress(pos)
                # discard superseded/false-positive candidates, then
                # drop consumed input behind the earliest live future.
                # The candidate AT pos is the next block's and stays
                # (the JAX loop drops it too, with `<=`, so there every
                # block is decoded a second time by the parser).
                for stale in [p for p in pending if p < pos]:
                    _cancel_candidate(pending.pop(stale), spool)
                horizon = min(pending, default=pos)
                sb.drop_before(min(pos, horizon))
                continue
            if magic == EOS_MAGIC:
                try:
                    stored = sb.read_bits(pos + 48, 32)
                except EOFError:
                    raise StreamError(Error.ERR_EOF)
                pos += 80
                if stored != combined:
                    raise StreamError(Error.ERR_STRMCRC)
                pos += (-pos) % 8
                if sb.ensure_bits(pos, 32):
                    hdr = sb.read_bits(pos, 32)
                    if (hdr >> 8) == 0x425A68 and \
                            0x31 <= (hdr & 0xFF) <= 0x39:
                        pos += 32
                        level = (hdr & 0xFF) - 0x30
                        combined = 0
                        continue
                break
            raise StreamError(Error.ERR_HEADER)

    if batcher is not None:
        stats["ibwt_rows"] = batcher.rows
        stats["ibwt_flushes"] = batcher.flushes
    if tr:
        stats["trace"] = tr.result()
    total_in = sb.base + len(sb.buf)
    return total_in, total_out
