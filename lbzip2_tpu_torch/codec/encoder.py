"""Production compressor: the hybrid device + host pool on a PyTorch device.

The scheduler is lbzip2_tpu.codec.encoder._WorkPool (block queue, host
tail-stealing and steal-back, in-order delivery, watchdog), inherited
as it is, with its batch shapes ``_BUCKETS`` / ``_BATCH`` /
``_INFLIGHT``, ``_build_batch`` and its mode switch ``_DEVICE_CHAIN``
(``LBZ2_DEVICE_CHAIN``, read when a pool is made).  This module
replaces its device engine, in both modes:

  chain mode (default):
    dispatch thread: Lyndon prep -> pinned upload -> ops/bwt2.bwt2_bytes
                     -> event recorded after dispatch
    fetch threads:   wait on the event -> ops/chain.chain_payloads
                     (MTF kernel, RLE2, EM, pack on the device; headers
                     and splice on the host)
  token mode (LBZ2_DEVICE_CHAIN=0):
    dispatch thread: Lyndon prep -> pinned upload -> ops/bwt2.bwt2_tokens
                     -> copies of tokens, run counts and primary into
                     pinned host memory -> event recorded after them
    fetch threads:   wait on the event -> run tokens (or, for a row over
                     the token capacity, its raw bytes) to the host
                     workers' C entropy coder

Both halves of every batch run on one CUDA stream owned by the pool, so
the caching allocator never hands out memory another stream still
reads.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time

import numpy as np
import torch

from lbzip2_tpu import native
from lbzip2_tpu.codec import encoder as _ref
from lbzip2_tpu.core import crc32
from lbzip2_tpu.core.constants import CLUSTER_FACTOR
from lbzip2_tpu.ref import rle1
from lbzip2_tpu_torch.device import (record_event, resolve, to_host,
                                     upload, wait_event)
from lbzip2_tpu_torch.ops.bwt2 import bwt2_bytes, bwt2_tokens
from lbzip2_tpu_torch.ops.chain import chain_payloads

last_stats: dict | None = None  # engine split of the last compress call
_warmed = False                 # warm_device() ran in this process


class _InflightGate:
    """Dispatched-but-unfetched batches of every pool in the process.

    A new pool waits (bounded) for the previous pool's leftover batches
    before its first dispatch.  A timed-out wait starts a new
    generation instead of zeroing a shared count: a straggler batch of
    the old generation that finishes later decrements nothing."""

    def __init__(self):
        self._cv = threading.Condition()
        self._n = 0
        self._gen = 0

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._n

    def inc(self) -> int:
        """Count one dispatched batch; returns its generation tag."""
        with self._cv:
            self._n += 1
            return self._gen

    def dec(self, gen: int) -> None:
        with self._cv:
            if gen == self._gen:
                self._n -= 1
                self._cv.notify_all()

    def wait_idle(self, timeout_s: float = 60.0, max_inflight: int = 1):
        """Wait until at most ``max_inflight`` batches remain; on
        timeout abandon them to a closed generation."""
        deadline = time.time() + timeout_s
        with self._cv:
            while self._n > max_inflight:
                left = deadline - time.time()
                if left <= 0:
                    self._gen += 1
                    self._n = 0
                    return
                self._cv.wait(timeout=min(1.0, left))


_GATE = _InflightGate()
_JOIN_S = 120.0  # bound on joining a finished pool's threads (one
                 # chain-mode batch's EM loop has taken 11 s on the H100)


class _TorchPool(_ref._WorkPool):
    """_WorkPool whose device engine runs the port on ``device``, in
    chain mode or token mode as ``_ref._DEVICE_CHAIN`` says."""

    _NFETCH = 2  # fetch threads per pool

    def __init__(self, buf, blocks, cluster_factor, host_workers,
                 use_device, device: torch.device):
        super().__init__(buf, blocks, cluster_factor, host_workers,
                         use_device)
        self.device = device
        self.chain = _ref._DEVICE_CHAIN
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._engines: list[threading.Thread] = []   # device + host threads
        self._fetchers: list[threading.Thread] = []  # the device's fetchers

    def run(self):
        """The inherited ``run``, then a bounded join of every thread the
        pool started (device, host and fetch threads), so that no
        ``lbz2-`` thread of this pool outlives the ``compress`` call: a
        process that exits at once must not tear down the interpreter
        under a thread inside torch.  The one exception is a pool the
        watchdog abandoned: its device engine is wedged by definition,
        and its daemon threads are left to finish or die with the
        process, as in the JAX engine."""
        try:
            yield from super().run()
        finally:
            if not self.abandoned:
                self._join_threads()

    def _join_threads(self):
        # The inherited run() starts the engine threads before its first
        # result, but each registers itself only once it runs; the device
        # thread registers its fetchers before starting them, so once it
        # is joined the fetcher list is whole.
        deadline = time.time() + _JOIN_S
        expected = int(self.use_device) + self.host_workers
        while len(self._engines) < expected and time.time() < deadline:
            time.sleep(0.001)
        for threads in (self._engines, self._fetchers):
            for t in list(threads):
                t.join(timeout=max(0.0, deadline - time.time()))

    def device_loop(self):
        self._engines.append(threading.current_thread())
        super().device_loop()

    def host_loop(self):
        self._engines.append(threading.current_thread())
        super().host_loop()

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _device_pipeline(self):
        """Claim, prep, upload and dispatch batches; fetch workers finish
        them.  Depth 1 until the first batch completes or warm_device()
        ran, then up to _INFLIGHT batches in flight."""
        _GATE.wait_idle()  # don't queue behind a previous pool's tail
        nfetchers = self._NFETCH
        for w in range(nfetchers):
            t = threading.Thread(target=self._fetch_worker,
                                 name=f"lbz2-fetch{w}", daemon=True)
            self._fetchers.append(t)
            t.start()
        try:
            while not (self.abandoned or self.complete):
                if self.error is not None:
                    break
                cap = _ref._INFLIGHT \
                    if (self.stats["device_batches"] or _warmed) else 1
                if self.fetch_pending >= cap:
                    time.sleep(0.005)
                    continue
                ids = self.take_head(_ref._BATCH)
                if not ids:
                    break  # the drain below keeps the sentinels last
                built = self._build_batch(ids)
                if built is None:
                    continue
                ids, spans, batch, ns, ms, tele = built
                t0 = time.time()
                with self._on_stream():
                    args = (upload(batch, self.device),
                            upload(ns, self.device), upload(ms, self.device))
                    if self.chain:
                        outs = bwt2_bytes(*args)
                    else:
                        tokens, raw, counts, primary = bwt2_tokens(*args)
                        # the copies overlap later batches' kernels; raw
                        # rows are fetched only past the token capacity
                        outs = (to_host(tokens), raw, to_host(counts),
                                to_host(primary))
                    outs += (record_event(self.device),)
                tele["dispatch_s"] = round(time.time() - t0, 3)
                gen = _GATE.inc()
                with self.q_lock:
                    self.fetch_pending += 1
                self.fetch_q.put((ids, spans, outs, tele, gen))
            # drain: fetch workers finish in the background; stop early
            # when the stream completes, the watchdog fires, or a fetch
            # worker failed (its error is the pool's result)
            while self.fetch_pending > 0 and self.error is None and \
                    not (self.abandoned or self.complete):
                time.sleep(0.05)
        finally:
            if self.abandoned or self.error is not None:
                self._drain_fetch_q()
            for _ in range(nfetchers):
                self.fetch_q.put(None)

    def _drain_fetch_q(self):
        """Release the in-flight accounting of batches nobody will
        fetch; stops at the first sentinel and re-queues it."""
        while True:
            try:
                item = self.fetch_q.get_nowait()
            except queue.Empty:
                return
            if item is None:
                self.fetch_q.put(None)
                return
            _GATE.dec(item[-1])
            with self.q_lock:
                self.fetch_pending -= 1

    def _fetch_worker(self):
        while True:
            item = self.fetch_q.get()
            if item is None:
                return
            try:
                if all(self.is_stale(i) for i in item[0]):
                    # the host delivered every row: skip the batch's
                    # entropy stage (this also ends the pool's run sooner)
                    self.stats["stale_rows"] += len(item[0])
                    continue
                with self._on_stream():
                    fetch = self._fetch_chain if self.chain \
                        else self._fetch_tokens
                    fetch(*item[:-1])
            except Exception as e:  # recorded; run() re-raises it
                if not (self.abandoned or self.complete):
                    self.fail(e)
                self._drain_fetch_q()
                return
            finally:
                _GATE.dec(item[-1])
                with self.q_lock:
                    self.fetch_pending -= 1

    @staticmethod
    def _wait_ready(ev):
        wait_event(ev)

    def _fetch_tokens(self, ids, spans, outs, tele):
        """Token-mode completion: wait for the batch and its copies,
        queue each row's run tokens for the host entropy coder; a row
        over the token capacity downloads its raw bytes alone."""
        tokens, raw, run_counts, primary, ev = outs
        t0 = time.time()
        self._wait_ready(ev)
        counts = run_counts.numpy()
        prim = primary.numpy()
        tele["ready_s"] = round(time.time() - t0, 3)
        t1 = time.time()
        cap = tokens.shape[1] * 2
        tok = tokens.numpy().view(np.uint16)
        fresh = stale = 0
        for row, (i, span) in enumerate(zip(ids, spans)):
            if self.is_stale(i):  # host steal-back beat us to it
                stale += 1
                continue
            if counts[row] <= cap:
                brow = ("tok", tok[row, :counts[row]])
            else:  # near-incompressible row: its raw bytes only
                brow = raw[row].cpu().numpy().view(np.uint8)[
                    :span.data.size]
            self.entropy_q.put((i, span, brow, int(prim[row])))
            fresh += 1
        tele["expand_s"] = round(time.time() - t1, 3)
        self._batch_done(tele, fresh, stale)

    def _fetch_chain(self, ids, spans, outs, tele):
        """Entropy-code one BWT batch on the device and deliver payloads;
        rows that overflow the pack width re-encode on the host."""
        bwt_dev, primary, ev = outs
        t0 = time.time()
        self._wait_ready(ev)
        ns = np.array([s.data.size for s in spans], np.int32)
        cmaps = np.stack([np.asarray(s.cmap, np.uint8) for s in spans])
        crcs = np.array(
            [(native.crc32_block(self.buf[s.start:s.end]) ^ 0xFFFFFFFF)
             & 0xFFFFFFFF for s in spans], np.uint32)
        B = bwt_dev.shape[0]
        if B > len(spans):  # pad rows replay row 0
            pad = B - len(spans)
            ns = np.concatenate([ns, np.repeat(ns[:1], pad)])
            cmaps = np.concatenate([cmaps, np.repeat(cmaps[:1], pad, 0)])
            crcs = np.concatenate([crcs, np.repeat(crcs[:1], pad)])
        stage_times: dict = {}
        payloads = chain_payloads(bwt_dev, ns, cmaps,
                                  primary.cpu().numpy().astype(np.int32),
                                  crcs, self.cf, times=stage_times)
        tele["chain_stages"] = stage_times
        fresh = stale = 0
        for row, (i, span) in enumerate(zip(ids, spans)):
            if self.is_stale(i):
                stale += 1
                continue
            if payloads[row] is None:  # pack overflow: host re-encode
                self.unclaim(i)
                self.entropy_q.put((i, span, None, -1))
            else:
                self.put_result(i, (payloads[row], int(crcs[row])))
            fresh += 1
        tele["ready_s"] = round(time.time() - t0, 3)
        self._batch_done(tele, fresh, stale)

    def _batch_done(self, tele, fresh, stale):
        """Account a fetched batch: its completion time, the latency
        estimate of the drain guard and the block counts."""
        tele["done_t"] = round(time.time() - self.stats["t0"], 2)
        self.last_batch_t = time.time()
        self.lat_ema = tele["ready_s"] if not self.lat_ema else \
            0.5 * self.lat_ema + 0.5 * tele["ready_s"]
        self.stats["device_blocks"] += fresh
        self.stats["stale_rows"] += stale
        self.stats["device_batches"].append((fresh, tele["done_t"]))
        self.stats["batch_trace"].append(tele)


def lyndon_rows(blocks: list[np.ndarray], width: int):
    """Lyndon-prep byte blocks into one (len(blocks), width) batch, as
    the pool's ``_build_batch`` does.  Returns (batch, ns, ms); ms is -1
    for a fully periodic block, which the pool sends to the host."""
    batch = np.zeros((len(blocks), width), np.uint8)
    ns = np.array([b.size for b in blocks], np.int32)
    ms = np.empty(len(blocks), np.int32)
    for r, blk in enumerate(blocks):
        _, ms[r] = native.lyndon_prep(blk, out=batch[r, :blk.size])
    return batch, ns, ms


def device_eligible(data: bytes | np.ndarray, level: int = 9,
                    sequential_split: bool = False) -> int:
    """Number of blocks of ``data`` that the pool's ``_build_batch``
    sends to the device: non-periodic blocks in a device bucket.  The
    rest (mid-size tails, periodic blocks) go to the host by design."""
    buf = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(data, np.uint8)
    mbs = level * 100000
    n = 0
    for _, _, blk, _ in native.rle1_collect(
            buf, mbs, None if sequential_split else mbs):
        if _ref._bucket_for(blk.size) is not None and \
                native.lyndon_prep(blk)[1] >= 0:
            n += 1
    return n


def warm_device(rows=(_ref._BATCH,), bucket: int = _ref._BUCKETS[-1],
                device: str | torch.device = "cuda") -> float:
    """Run the device engine of the mode in force (``_ref._DEVICE_CHAIN``)
    once per (rows, bucket) shape on tiny Lyndon rows: the whole chain
    (building the CUDA kernel), or the token BWT and its copies to
    pinned memory.  Warms the allocator and the math libraries outside a
    timed stream.  Returns seconds spent."""
    global _warmed
    dev = resolve(device)
    t0 = time.time()
    for r in sorted(set(rows)):
        batch = np.zeros((r, bucket), np.uint8)
        batch[:, 3] = 1  # R = 0001: a genuine Lyndon row of length 4
        ns = np.full(r, 4, np.int32)
        ms = np.zeros(r, np.int32)
        args = (upload(batch, dev), upload(ns, dev), upload(ms, dev))
        if not _ref._DEVICE_CHAIN:
            tokens, _, counts, primary = bwt2_tokens(*args)
            for t in (tokens, counts, primary):
                to_host(t)
            continue
        bwt, primary = bwt2_bytes(*args)
        cmaps = np.zeros((r, 256), np.uint8)
        cmaps[:, :2] = 1
        crcs = np.zeros(r, np.uint32)
        idxs = primary.cpu().numpy().astype(np.int32)
        chain_payloads(bwt, ns, cmaps, idxs, crcs)
        chain_payloads(bwt, ns, cmaps, idxs, crcs, _force_full_pack=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _warmed = True
    return time.time() - t0


def compress_blocks_hybrid(data: bytes | np.ndarray, level: int = 9,
                           cluster_factor: int = CLUSTER_FACTOR,
                           sequential_split: bool = False,
                           entropy_workers: int | None = None,
                           use_device: bool | None = None,
                           device: str | torch.device = "cuda"
                           ) -> tuple[list[bytes], list[int]]:
    """Encode all blocks with the hybrid pool on ``device``; returns
    (payloads, stored block CRCs) in block order.  The host C kernels
    (``lbzip2_tpu.native``) are required: the device engine runs
    ``lyndon_prep``, and ``chain_finish`` or the token entropy coder."""
    global last_stats
    if not 1 <= level <= 9:
        raise ValueError(f"level must be 1..9, got {level}")
    dev = resolve(device)
    if not native.native_available():
        raise RuntimeError("lbzip2_tpu.native is not available: the "
                           "device engine needs its host C kernels")
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(
            data, dtype=np.uint8)
    mbs = level * 100000
    blocks = [rle1.BlockSpan(a, b, blk, cmap) for a, b, blk, cmap in
              native.rle1_collect(buf, mbs,
                                  None if sequential_split else mbs,
                                  reuse_arena=True)]
    if entropy_workers is None:
        entropy_workers = max(2, os.cpu_count() or 2)
    if use_device is None:
        use_device = _ref._DEVICE
    pool = _TorchPool(buf, blocks, cluster_factor, entropy_workers,
                      use_device, dev)
    last_stats = pool.stats
    payloads, crcs = [], []
    for payload, crc_stored in pool.run():
        payloads.append(payload)
        crcs.append(crc_stored)
    return payloads, crcs


def compress(data: bytes | np.ndarray, level: int = 9,
             cluster_factor: int = CLUSTER_FACTOR,
             sequential_split: bool = False,
             entropy_workers: int | None = None,
             use_device: bool | None = None,
             device: str | torch.device = "cuda") -> bytes:
    """Compress into a .bz2 stream on the hybrid pool with the device
    engine on ``device``.  Bit-identical to the JAX package's compress
    and to the host C pipeline."""
    payloads, crcs = compress_blocks_hybrid(
        data, level, cluster_factor, sequential_split, entropy_workers,
        use_device, device)
    parts = [bytes([0x42, 0x5A, 0x68, 0x30 + level])]
    combined = 0
    for payload, crc_stored in zip(payloads, crcs):
        parts.append(payload)
        combined = crc32.combine_crc(combined, crc_stored)
    parts.append(bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) +
                 combined.to_bytes(4, "big"))
    return b"".join(parts)
