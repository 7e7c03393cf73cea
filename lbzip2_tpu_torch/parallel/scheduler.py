"""Streaming compression scheduler with bounded memory (L3 analogue).

Reproduces the reference scheduler's structure (src/process.c):
  source thread  -> bounded input slots (2W buffers of in_granul bytes)
  worker threads -> per-window RLE1 + block encode (native/oracle)
  muxer/writer   -> strict in-order reassembly, bounded output slots,
                    combined stream CRC fold, progress reporting
Back-pressure is provided by the slot semaphores, mirroring the
reference's memory policy (process.c:624-646: in 2W x in_granul,
out 2W+2 slots).  Input windows of in_granul bytes are independent by
the collector's window rule, so block boundaries equal the whole-file
result.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.constants import CLUSTER_FACTOR


def _encode_window(buf: np.ndarray, level: int,
                   cluster_factor: int) -> tuple[bytes, list[int]]:
    """Encode one in_granul window -> (payload bytes, block crcs)."""
    mbs = level * 100000
    if native.native_available():
        blocks = native.rle1_collect(buf, mbs, mbs)
    else:
        from lbzip2_tpu_torch.ref import rle1
        blocks = [(s.start, s.end, s.data, s.cmap)
                  for s in rle1.rle1_blocks(buf, mbs, -1)]
    payloads = []
    crcs = []
    for (a, b, blk, cmap) in blocks:
        if native.native_available():
            crc_stored = (native.crc32_block(buf[a:b]) ^ 0xFFFFFFFF) \
                & 0xFFFFFFFF
            payloads.append(native.encode_block(
                blk, np.asarray(cmap, np.uint8), crc_stored,
                cluster_factor))
        else:
            crc_stored = crc32.crc_of(buf[a:b])
            from lbzip2_tpu_torch.ref.encoder import encode_block
            payloads.append(encode_block(blk, np.asarray(cmap, bool),
                                         crc_stored, cluster_factor))
        crcs.append(crc_stored)
    return b"".join(payloads), crcs


class CompressScheduler:
    """Bounded-slot streaming compressor."""

    def __init__(self, level: int, n_workers: int, outfd,
                 cluster_factor: int = CLUSTER_FACTOR,
                 verbose: bool = False, in_size: int | None = None,
                 progress_name: str = ""):
        self.level = level
        self.n_workers = max(1, n_workers)
        self.outfd = outfd
        self.cluster_factor = cluster_factor
        self.in_granul = level * 100000
        self.in_slots = threading.Semaphore(2 * self.n_workers)
        self.work_q: queue.Queue = queue.Queue()
        self.done: dict[int, tuple[bytes, list[int]]] = {}
        self.done_lock = threading.Condition()
        self.error: BaseException | None = None
        self.total_in = 0
        self.total_out = 0
        self.verbose = verbose
        self.in_size = in_size
        self.progress_name = progress_name
        self._t0 = time.time()
        self._last_prog = 0.0

    def _worker(self):
        while True:
            item = self.work_q.get()
            if item is None:
                return
            seq, buf = item
            try:
                res = _encode_window(buf, self.level, self.cluster_factor)
            except BaseException as e:  # propagate to muxer
                res = e
            with self.done_lock:
                self.done[seq] = res
                self.done_lock.notify_all()

    def _progress(self):
        if not (self.verbose and self.in_size and
                sys.stderr.isatty()):
            return
        now = time.time()
        if now - self._last_prog < 1.0:
            return
        self._last_prog = now
        pct = 100.0 * self.total_in / self.in_size
        elapsed = now - self._t0
        eta = elapsed * (self.in_size - self.total_in) / max(1, self.total_in)
        sys.stderr.write(f"\r{self.progress_name}: {pct:5.1f}% done, "
                         f"ETA {eta:6.1f}s")
        sys.stderr.flush()

    def run(self, read_chunk) -> tuple[int, int]:
        """read_chunk(n) -> bytes; returns (bytes_in, bytes_out)."""
        workers = [threading.Thread(target=self._worker, daemon=True)
                   for _ in range(self.n_workers)]
        for w in workers:
            w.start()

        self.outfd.write(bytes([0x42, 0x5A, 0x68, 0x30 + self.level]))
        self.total_out = 4

        combined = 0
        next_write = 0
        seq = 0
        eof = False
        inflight = 0
        while not eof or next_write < seq:
            # feed while slots available
            while not eof and self.in_slots.acquire(blocking=False):
                chunk = read_chunk(self.in_granul)
                if not chunk:
                    eof = True
                    self.in_slots.release()
                    break
                self.total_in += len(chunk)
                self.work_q.put((seq, np.frombuffer(chunk, np.uint8)))
                seq += 1
                inflight += 1
            # drain in order (event-driven: workers notify on completion)
            with self.done_lock:
                while next_write not in self.done and inflight > 0:
                    self.done_lock.wait()
                if next_write in self.done:
                    res = self.done.pop(next_write)
                else:
                    continue
            if isinstance(res, BaseException):
                for _ in workers:
                    self.work_q.put(None)
                raise res
            payload, crcs = res
            self.outfd.write(payload)
            self.total_out += len(payload)
            for c in crcs:
                combined = crc32.combine_crc(combined, c)
            next_write += 1
            inflight -= 1
            self.in_slots.release()
            self._progress()

        trailer = bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) + \
            combined.to_bytes(4, "big")
        self.outfd.write(trailer)
        self.total_out += len(trailer)
        for _ in workers:
            self.work_q.put(None)
        for w in workers:
            w.join()
        if self.verbose and self.in_size and sys.stderr.isatty():
            sys.stderr.write("\r")
        return self.total_in, self.total_out
