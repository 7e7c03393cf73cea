"""Speculative parallel decompression with the port's device stages.

Counterpart of the device parts of lbzip2_tpu/parallel/decode.py.  The
parser walk, the candidate scan, the slot pool and the in-order drain
are the JAX module's jax-free host code, reused as they are; this
module routes the two opt-in device stages to the port:

  LBZ2_DEVICE_HUFF=1    Huffman stage: host boundary walk, group decode
                        on the device (ops/huffdec.py, csrc/huffdec.cu),
                        host IMTF + RLE2
  LBZ2_DEVICE_DECODE=1  inverse BWT of every non-randomised block on the
                        device, in padded (8, 901120) batches
                        (_DeviceIbwtBatcher over ops/ibwt.py,
                        csrc/ibwt.cu), host RLE1 + CRC

Both are off by default, as in the JAX package.  A switched-off stage
takes the host C path.  With a switch on, ``device="cuda"`` without
CUDA raises; an error raised by a kernel or its launch propagates out
of ``decompress_parallel`` and never becomes a stream-error verdict.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lbzip2_tpu import native
from lbzip2_tpu.core import crc32
from lbzip2_tpu.core.bits import read_bits_at as _read_bits
from lbzip2_tpu.core.constants import Error, StreamError
from lbzip2_tpu.parallel.decode import (BLOCK_MAGIC, EOS_MAGIC, SlotPool,
                                        _cancel_candidate, _emit_result,
                                        _ERR_BY_VALUE, _finish_in_order,
                                        scan_magic_bits)
from lbzip2_tpu_torch.device import resolve, to_host, upload
from lbzip2_tpu_torch.ops.huffdec import decode_block_device
from lbzip2_tpu_torch.ops.ibwt import ibwt_rows

# the JAX package's switches and defaults (parallel/decode.py:224, :231)
DEVICE_IBWT = os.environ.get("LBZ2_DEVICE_DECODE", "0") == "1"
DEVICE_HUFF = os.environ.get("LBZ2_DEVICE_HUFF", "0") == "1"
_IBWT_N = 901120  # padded device row (covers MAX_BLOCK_SIZE)

last_stats: dict | None = None  # device use of the last decompress call


class _Request:
    """One IBWT row waiting in the batcher."""

    def __init__(self, bwt: np.ndarray, idx: int):
        self.bwt, self.idx = bwt, idx
        self.out: np.ndarray | None = None
        self.error: BaseException | None = None
        self.done = threading.Event()


class _DeviceIbwtBatcher:
    """Groups concurrent IBWT requests into padded (max_batch, _IBWT_N)
    device batches, on a CUDA stream of its own.

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
        rows = self.max_batch  # fixed shape, padded as in JAX
        batch = np.zeros((rows, _IBWT_N), np.uint8)
        ns = np.ones(rows, np.int32)
        idxs = np.zeros(rows, np.int32)
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
                      device: torch.device | None = None):
    """Speculatively retrieve + IBWT the block whose payload starts at
    payload_pos (lbzip2_tpu/parallel/decode.py:111-129): the Huffman
    stage on ``device`` when DEVICE_HUFF is on, the host C retrieve
    otherwise; then ``_emit_result``, which takes the batcher's device
    IBWT for a non-randomised block and the host C path for the rest."""
    if DEVICE_HUFF:
        err, newpos, bwt, idx, rnd = decode_block_device(
            arr, nbits, payload_pos, device)
    else:
        err, newpos, bwt, idx, rnd = native.retrieve_block(
            arr, nbits, payload_pos)
    if err != 0:
        return {"err": err}
    return _emit_result(bwt, idx, rnd, newpos, pool, batcher)


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


def decompress_parallel(data: bytes, n_workers: int | None = None,
                        out_slots: int | None = None,
                        device_ibwt: bool | None = None,
                        device: str | torch.device = "cuda") -> bytes:
    """Parallel decode, semantics identical to the sequential decoder
    and to lbzip2_tpu.parallel.decode.decompress_parallel, whose parser
    walk (:285-380) this is; the device stages run on ``device``."""
    global last_stats
    if native.get_lib() is None:
        from lbzip2_tpu.ref.decoder import decompress as ref_dec
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
    stats = {"blocks": 0, "device_huff": DEVICE_HUFF,
             "ibwt_rows": 0, "ibwt_flushes": 0}
    last_stats = stats

    def decode(p):
        return _decode_candidate(arr, nbits, p + 80, spool, batcher, dev)

    candidates = [int(p) for p in scan_magic_bits(arr)]
    out_parts: list[bytes] = []
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
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
    return b"".join(out_parts)
