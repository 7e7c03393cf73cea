"""Production compressor: the hybrid device + host work pool on a PyTorch
device.  Counterpart of lbzip2_tpu/codec/encoder.py.

Scheduling is the lbzip2 work pool over heterogeneous engines: a device
engine groups blocks into (rows, N) batches of the rows it claimed, with
several batches in flight; host workers run the C entropy stage for
finished device BWTs and, whenever no entropy work is queued, steal
whole blocks from the tail of the queue for host-side encode.  The
device takes blocks from the head, the host from the tail; they meet in
the middle.
Device-claimed blocks stay stealable: when the host would otherwise
idle it steals claimed blocks back; whichever engine finishes a block
first wins and the loser's late duplicate is dropped, so the hybrid
never loses to host-only.  Fully periodic blocks (no Lyndon conjugate)
always take the host path: their tie order is a host-side convention.

The device engine, in both modes (``_DEVICE_CHAIN``, set from
``LBZ2_DEVICE_CHAIN`` and read when a pool is made):

  chain mode (default):
    dispatch thread: Lyndon prep -> pinned upload -> ops/bwt2.bwt2_bytes
                     (queued whole: the BWT reads nothing on the host)
                     -> event recorded after dispatch
    fetch thread:    block on the event -> the BWT's passes a row
                     (``batch_trace[*]["bwt2_passes"]``, their max) ->
                     ops/chain.chain_payloads
                     (MTF kernel, RLE2, the EM kernels, pack on the
                     device; headers and splice on the host)
  token mode (LBZ2_DEVICE_CHAIN=0):
    dispatch thread: Lyndon prep -> pinned upload -> ops/bwt2.bwt2_tokens
                     -> copies of tokens, run counts and primary into
                     pinned host memory -> event recorded after them
    fetch thread:    block on the event -> run tokens (or, for a row over
                     the token capacity, its raw bytes) to the host
                     workers' C entropy coder

The engine drives every device it is given (all visible cards for
``device="cuda"``, as the JAX engine drives every local device): batch
i goes to device i mod D, with one more batch in flight for each device
past the first.  Both halves of a batch run on its device's CUDA stream,
owned by the pool, with that device current, so the caching allocator
never hands out memory another stream still reads.  One fetch thread
finishes the batches in order: a second one measured no faster on an
H100 once the M-step was a kernel (PERF.md).
"""

from __future__ import annotations

import heapq
import os
import queue
import threading
import time

import numpy as np
import torch

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.constants import CLUSTER_FACTOR
from lbzip2_tpu_torch.device import (on, record_event, resolve_all,
                                     to_host, upload, wait_event)
from lbzip2_tpu_torch.ops.bwt2 import bwt2_bytes, bwt2_tokens, last_passes
from lbzip2_tpu_torch.ops.chain import chain_payloads
from lbzip2_tpu_torch.ref import rle1
from lbzip2_tpu_torch.utils import trace

# Device row widths: one production bucket (covers
# MAX_BLOCK_SIZE with ~0.1% padding) and one tiny bucket so CPU tests
# exercise the device path cheaply.  Mid-size blocks (level < 9, stream
# tails) go to the host engine, which handles them at full speed anyway.
_BUCKETS = (8192, 901120)
_MID_CUTOFF = 262144  # blocks in (8192, _MID_CUTOFF] -> host engine

# Most rows a device batch holds; a batch ships the rows it has.
_BATCH = int(os.environ.get("LBZ2_DEVICE_BATCH", "32"))

# Batches kept in flight on the device queue simultaneously.
_INFLIGHT = int(os.environ.get("LBZ2_DEVICE_INFLIGHT", "3"))

_DEVICE = os.environ.get("LBZ2_DEVICE", "1") != "0"

# Diagnostic: disable host tail-stealing (device-only block encode).
_HOST_STEAL = os.environ.get("LBZ2_HOST_STEAL", "1") != "0"

# Steal-back of device-claimed blocks when the host would otherwise
# idle.  Grace period: steal only when the device has not delivered a
# batch for max(LBZ2_STEALBACK_GRACE_S, 2 x the claim->deliver latency
# estimate), so claims the device is about to deliver are not encoded
# twice (no delivery ever = steal immediately).  The latency estimate
# sets the grace: on an H100 a claim comes back in 0.04 to 1 s
# (PERF.md section 5), so a fixed grace of seconds would never fire.
_STEALBACK = os.environ.get("LBZ2_STEALBACK", "1") != "0"
_STEALBACK_GRACE_S = float(os.environ.get("LBZ2_STEALBACK_GRACE_S",
                                          "0"))

# Drain guard (take_head): stop device claims when the host pool would
# finish the remaining queue faster than one device claim comes back.
# The latency is the claim->deliver time of the device's batches (an
# EMA), never below this floor: the fastest claim->deliver measured on
# an H100, one row in 0.035 s (PERF.md section 5).
_DRAIN_LAT_FLOOR_S = float(os.environ.get("LBZ2_DRAIN_LAT_FLOOR_S",
                                          "0.035"))

# Rows of the device's first claim of a stream, doubled each claim up to
# _BATCH: on an H100 an 8-row batch comes back in 0.13 s and a 32-row
# one in 0.3 to 1 s (PERF.md section 5), so the first delivery lands
# while the host still has tail work, and later claims take full
# batches.
_FIRST_CLAIM = 8

# Niceness a host worker adds to its own thread while the pool runs a
# device engine: the engine's dispatch and fetch threads launch kernels
# and wait on them from Python, and behind eight busy host workers on
# eight cores an 8-row claim took 0.2 to 0.7 s to dispatch against
# 0.03 s alone (PERF.md section 5).  The workers still take every idle
# cycle.
_HOST_NICE = 10

# Device entropy chain: run MTF+RLE2+EM+bit-pack on the device and
# download only compressed payloads (ops/chain.py).  LBZ2_DEVICE_CHAIN=0
# selects the token path (device BWT + host token entropy).
_DEVICE_CHAIN = os.environ.get("LBZ2_DEVICE_CHAIN", "1") == "1"

last_stats: dict | None = None  # engine split of the last compress call
_warmed = False                 # warm_device() ran in this process


# One stream for each (device, place among the pool's entries for that
# device), kept from pool to pool.  The caching allocator serves a stream
# only from blocks freed on it: on a fresh stream each pool's first batch
# called cudaMalloc for the dispatch thread's BWT workspace and buffers
# (8 to 9 calls a compress of the smoke's stream, none freed), and that
# batch's dispatch took 0.05 to 0.31 s where the others took 0.01 (ROADMAP
# F10, PERF.md section 5).  Pools that overlap share the streams and stay
# ordered on them.
_POOL_STREAMS: dict = {}
_POOL_STREAMS_LOCK = threading.Lock()


def _pool_streams(devices) -> list:
    """The kept stream of each entry of ``devices`` (None off CUDA)."""
    seen: dict = {}
    out = []
    with _POOL_STREAMS_LOCK:
        for d in devices:
            if d.type != "cuda":
                out.append(None)
                continue
            k = seen[d] = seen.get(d, -1) + 1
            if (d, k) not in _POOL_STREAMS:
                _POOL_STREAMS[(d, k)] = torch.cuda.Stream(d)
            out.append(_POOL_STREAMS[(d, k)])
    return out


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
_WAKE_S = 0.25   # longest a waiting dispatch thread goes without
                 # re-reading abandoned / complete / error (each of
                 # which also signals it)
_JOIN_S = 120.0  # bound on joining a finished pool's threads (one
                 # chain-mode batch's EM loop has taken 11 s on the H100)


def _bucket_for(n: int) -> int | None:
    """Device bucket for a block of n bytes; None -> host engine."""
    if n <= _BUCKETS[0]:
        return _BUCKETS[0]
    if n <= _MID_CUTOFF:
        return None
    if n <= _BUCKETS[-1]:
        return _BUCKETS[-1]
    raise ValueError(f"block too large: {n}")


def _entropy_payload(buf, span, bwt_row, bwt_idx, cluster_factor):
    """Host entropy stage for one block (C kernels; the pool is made
    only when they are available).

    bwt_row is either the BWT byte row, or ("tok", u16_run_tokens), the
    device download format, consumed directly by the token MTF (no 900k
    byte-row expansion on the host)."""
    n = span.data.size
    crc_stored = (native.crc32_block(buf[span.start:span.end])
                  ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if isinstance(bwt_row, tuple):
        payload = native.encode_payload_from_tokens(
            bwt_row[1], np.asarray(span.cmap, np.uint8),
            int(bwt_idx), crc_stored, cluster_factor, n_bytes=n)
    else:
        payload = native.encode_payload(
            bwt_row[:n], np.asarray(span.cmap, np.uint8),
            int(bwt_idx), crc_stored, cluster_factor)
    return payload, crc_stored


def _host_block(buf, span, cluster_factor):
    brow, bidx = native.bwt(span.data, scratch=True)
    return _entropy_payload(buf, span, brow, bidx, cluster_factor)


class _EdfQueue:
    """EDF priority queue for entropy work: items pop smallest block id
    first (the reference's earliest-deadline-first pqueues keyed on
    struct position, src/process.c:36-63), so the block the in-order
    consumer needs next is always finished first.  close() replaces a
    sticky sentinel: after close, get() returns None once drained."""

    def __init__(self):
        self._h: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._seq = 0  # tie-break: duplicate ids pop in arrival order

    def put(self, item):
        with self._cv:
            self._seq += 1
            heapq.heappush(self._h, (item[0], self._seq, item))
            self._cv.notify()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def get(self, block=True, timeout=None):
        """Smallest-id item, else None (empty+non-blocking, closed, or
        timed out — callers re-poll their higher-priority sources)."""
        with self._cv:
            if self._h:
                return heapq.heappop(self._h)[2]
            if not block or self._closed:
                return None
            self._cv.wait(timeout)
            if self._h:
                return heapq.heappop(self._h)[2]
            return None

    def empty(self):
        with self._cv:
            return not self._h


class _TorchPool:
    """Hybrid scheduler (device head-consumer + host tail-stealers)
    whose device engine runs on ``device`` (one, or a list it
    round-robins batches over), in chain mode or token mode as
    ``_DEVICE_CHAIN`` says when the pool is made."""

    def __init__(self, buf, blocks, cluster_factor, host_workers,
                 use_device, device: torch.device | list[torch.device],
                 tracer: trace.Tracer | None = None):
        self.buf = buf
        self.blocks = blocks
        self.cf = cluster_factor
        self.results: dict[int, tuple[bytes, int]] = {}
        self.res_lock = threading.Lock()
        self.res_cv = threading.Condition(self.res_lock)
        self.error: BaseException | None = None
        # shared deque of block ids: device pops head, host pops tail
        self.ids = list(range(len(blocks)))
        self.head = 0
        self.tail = len(blocks)
        self.q_lock = threading.Lock()
        self.entropy_q = _EdfQueue()
        self.device_done = not use_device
        self.host_workers = host_workers
        self.use_device = use_device
        self.claimed: set[int] = set()  # device-claimed, undelivered
        self.abandoned = False
        self.complete = False  # every block delivered; engines may bail
        self.next_deliver = 0  # results below this are stale duplicates
        self.last_batch_t = 0.0  # monotonic t of last device completion
        self.lat_ema = 0.0     # claim->deliver latency estimate (s)
        self.claims = 0        # device claims granted
        self.fetch_q: queue.Queue = queue.Queue()
        self.fetch_pending = 0  # dispatched batches not yet fetched
        # the fetch worker signals every finished batch here; fail() and
        # the end of run() signal too, so the dispatch thread never naps
        self.fetch_cv = threading.Condition(self.q_lock)
        self.stats = {"device_blocks": 0, "host_blocks": 0,
                      "periodic_blocks": 0, "stale_rows": 0,
                      "device_batches": [], "batch_trace": [],
                      "t0": time.time(), "trace": None}
        self.devices = list(device) if isinstance(device, (list, tuple)) \
            else [device]
        self.chain = _DEVICE_CHAIN
        # a stream of its own on each device (a card listed twice too),
        # the same for every pool
        self.streams = _pool_streams(self.devices)
        self._engines: list[threading.Thread] = []   # device + host threads
        self._fetcher: threading.Thread | None = None  # the device's
        self.trace = tracer
        self._fetch_batch = -1  # the batch the fetch thread finishes

    # --- queue primitives -------------------------------------------------
    def take_head(self, k: int) -> list[int]:
        """Device claim: _FIRST_CLAIM rows first, doubling each claim up
        to k while the queue is deep, batches of 8 near the end, at
        most half the remainder — so host tail-stealing always keeps its
        share of a short queue.

        Drain guard: once live rates are known, don't claim blocks the
        host pool would finish faster than one claim takes to come
        back: otherwise the end of every stream runs at device batch
        latency."""
        with self.q_lock:
            if self.abandoned:  # watchdog fired: stop claiming
                return []
            remaining = self.tail - self.head
            el = time.time() - self.stats["t0"]
            hb = self.stats["host_blocks"]
            db = self.stats["device_batches"]
            k = min(k, _FIRST_CLAIM << min(self.claims, 16))
            if hb and len(db) >= 2 and el > 0:
                host_bps = hb / el                       # blocks/s
                # latency = observed claim->deliver time (an EMA of
                # each batch's claim_s), NOT completion spacing: with
                # several batches pipelined the cadence reads far
                # shorter than the time a claim takes to come back, and
                # a guard fed the cadence claims extra batches at the
                # drain
                lat = max(_DRAIN_LAT_FLOOR_S, self.lat_ema)
                if remaining < k + host_bps * lat:
                    return []
            if not db and hb >= remaining:
                # the unproven engine is being outpaced: the host has
                # already encoded more blocks than remain — a short
                # stream will end before the first batch lands, and
                # every claim is steal-back work at the drain
                return []
            if remaining < 2 * k:
                k = 8 if remaining >= 16 else max(1, remaining // 2)
            got = self.ids[self.head:min(self.head + k, self.tail)]
            self.head += len(got)
            self.claimed.update(got)
            self.claims += 1
            return got

    def take_tail(self) -> int | None:
        with self.q_lock:
            if self.tail <= self.head:
                return None
            self.tail -= 1
            return self.ids[self.tail]

    def stealback_grace(self) -> float:
        """Seconds without a device delivery before the host steals
        back claimed blocks: two claim->deliver times, or
        _STEALBACK_GRACE_S if longer."""
        return max(_STEALBACK_GRACE_S, 2.0 * self.lat_ema)

    def take_claimed(self) -> int | None:
        """Steal back a device-claimed block (cold start, wedged
        engine, end-of-stream drain) once the device has delivered
        nothing for the grace period.  Takes the youngest claim: the
        device completes oldest batches first, so the youngest is the
        least likely to be close to delivery.  First result wins; the
        loser's late duplicate is dropped by put_result."""
        if self.last_batch_t and \
                time.time() - self.last_batch_t < self.stealback_grace():
            return None  # the device is delivering its claims
        with self.q_lock:
            if not self.claimed:
                return None
            i = max(self.claimed)
            self.claimed.discard(i)
            return i

    def unclaim(self, i):
        with self.q_lock:
            self.claimed.discard(i)

    def release_claim(self, i) -> bool:
        """Hand device-claimed block i to the host's entropy stage: True
        if the device still held the claim (no steal-back can take the
        block from now on), False if a steal-back already took it."""
        with self.q_lock:
            if i not in self.claimed:
                return False
            self.claimed.discard(i)
            return True

    def is_stale(self, i) -> bool:
        """True once some engine already produced block i."""
        with self.res_cv:
            return i < self.next_deliver or i in self.results

    def put_result(self, i, payload_crc) -> bool:
        """Deliver block i's result; True if it was kept, False if an
        engine's result for i was there first (first result wins: a
        slower engine's duplicate is dropped).  Each engine counts the
        blocks it delivered by this answer, so a block two engines
        produced is counted once."""
        with self.q_lock:  # claimed is mutated under q_lock only
            self.claimed.discard(i)
        with self.res_cv:
            kept = i >= self.next_deliver and i not in self.results
            if kept:
                self.results[i] = payload_crc
            self.res_cv.notify_all()
        return kept

    def fail(self, exc):
        with self.res_cv:
            if self.error is None:
                self.error = exc
            self.res_cv.notify_all()
        self._wake_dispatch()

    def _wake_dispatch(self):
        with self.fetch_cv:
            self.fetch_cv.notify_all()

    # --- device engine ----------------------------------------------------
    def device_loop(self):
        try:
            self._device_pipeline()
        except BaseException as e:  # noqa: BLE001
            # after watchdog abandonment (or completion via steal-back)
            # the stream is already whole; a late error from the wedged
            # engine must not fail it
            if not (self.abandoned or self.complete):
                self.fail(e)
        finally:
            self.device_done = True
            self.entropy_q.close()  # wake idle workers for shutdown

    def _on(self, slot: int):
        """Device ``slot`` current and its stream in force."""
        return on(self.devices[slot], self.streams[slot])

    def inflight_cap(self) -> int:
        """Batches the dispatch thread keeps in flight: 1 until the first
        batch lands or warm_device() ran, then _INFLIGHT and one more
        for each device past the first (JAX codec/encoder.py:423)."""
        if self.stats["device_batches"] or _warmed:
            return _INFLIGHT + len(self.devices) - 1
        return 1

    def _device_pipeline(self):
        """Claim, prep, upload and dispatch batches, batch i to device
        i mod D; the fetch worker finishes them in order, each on its
        batch's device.

        Traced, the thread's life, its waits (the gate, the in-flight
        cap, a refused claim, the drain), each batch's prep and dispatch
        are spans; in token mode on a card two timing events bracket
        the BWT, which the fetch worker reads once the batch is done."""
        tr = self.trace
        life = tr and tr.open("engine.dispatch_life")
        sp = tr and tr.open("engine.gate_wait")
        _GATE.wait_idle()  # don't queue behind a previous pool's tail
        if sp:
            tr.close(sp)
        self._fetcher = threading.Thread(target=self._fetch_worker,
                                         name="lbz2-fetch", daemon=True)
        self._fetcher.start()
        disp = 0  # batches dispatched
        claims = 0  # claims granted: a batch's id
        try:
            while not (self.abandoned or self.complete):
                if self.error is not None:
                    break
                cap = self.inflight_cap()
                with self.fetch_cv:
                    if self.fetch_pending >= cap:
                        sp = tr and tr.open("engine.cap_wait")
                        self.fetch_cv.wait(timeout=_WAKE_S)
                        if sp:
                            tr.close(sp)
                        continue
                ids = self.take_head(_BATCH)
                if not ids:
                    # a refusal stands until a batch lands: each delivery
                    # renews the guard's latency and proves the engine,
                    # and on the card one lands within a second.  With
                    # none in flight, or no queue left, stop claiming
                    # (the drain below keeps the sentinel last)
                    with self.fetch_cv:
                        if self.fetch_pending == 0 or self.tail <= self.head:
                            break
                        sp = tr and tr.open("engine.refused_wait")
                        self.fetch_cv.wait(timeout=_WAKE_S)
                        if sp:
                            tr.close(sp)
                    continue
                batch_id = claims
                claims += 1
                claimed_t = round(time.time() - self.stats["t0"], 3)
                sp = tr and tr.open("engine.prep", cpu=True, batch=batch_id)
                built = self._build_batch(ids)
                if sp:
                    tr.close(sp, rows=0 if built is None else len(built[0]))
                if built is None:
                    continue
                ids, spans, batch, ns, ms, tele = built
                tele["claimed_t"] = claimed_t
                slot = disp % len(self.devices)
                disp += 1
                tele["dev"] = slot
                dev = self.devices[slot]
                sp = tr and tr.open("engine.dispatch", batch=batch_id)
                bracket = None
                t0 = time.time()
                with self._on(slot):
                    args = (upload(batch, dev), upload(ns, dev),
                            upload(ms, dev))
                    if self.chain:
                        outs = bwt2_bytes(*args)
                    else:
                        if sp and dev.type == "cuda":
                            bracket = (torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True))
                            bracket[0].record()
                        tokens, raw, counts, primary = bwt2_tokens(*args)
                        if bracket:
                            bracket[1].record()
                        # the copies overlap later batches' kernels; raw
                        # rows are fetched only past the token capacity
                        outs = (to_host(tokens), raw, to_host(counts),
                                to_host(primary))
                    # the BWT's passes a row, read behind the batch's event
                    outs += (to_host(last_passes()), record_event(dev))
                tele["dispatch_s"] = round(time.time() - t0, 3)
                if sp:
                    tr.close(sp, rows=len(ids))
                gen = _GATE.inc()
                with self.q_lock:
                    self.fetch_pending += 1
                self.fetch_q.put((ids, spans, outs, tele,
                                  (batch_id, sp, bracket), slot, gen))
            # drain: the fetch worker finishes in the background; stop
            # early when the stream completes, the watchdog fires, or the
            # fetch worker failed (its error is the pool's result)
            with self.fetch_cv:
                sp = tr and tr.open("engine.drain_wait")
                while self.fetch_pending > 0 and self.error is None and \
                        not (self.abandoned or self.complete):
                    self.fetch_cv.wait(timeout=_WAKE_S)
                if sp:
                    tr.close(sp)
        finally:
            if self.abandoned or self.error is not None:
                self._drain_fetch_q()
            self.fetch_q.put(None)
            if life:
                tr.close(life)

    def _drain_fetch_q(self):
        """Release the in-flight accounting of batches nobody will
        fetch."""
        while True:
            try:
                item = self.fetch_q.get_nowait()
            except queue.Empty:
                return
            if item is None:  # the end of the queue
                return
            _GATE.dec(item[-1])
            self._fetched()

    def _fetched(self):
        """One dispatched batch is off the fetch queue: wake the
        dispatch thread (its in-flight cap, its drain wait)."""
        with self.fetch_cv:
            self.fetch_pending -= 1
            self.fetch_cv.notify_all()

    def _fetch_worker(self):
        tr = self.trace
        life = tr and tr.open("engine.fetch_life")
        try:
            self._fetch_batches(tr)
        finally:
            if life:
                tr.close(life)

    def _fetch_batches(self, tr):
        while True:
            item = self.fetch_q.get()
            if item is None:
                return
            ids, spans, outs, tele, (batch_id, disp_sp, bracket), slot, \
                gen = item
            try:
                if all(self.is_stale(i) for i in ids):
                    # the host delivered every row: skip the batch's
                    # entropy stage (this also ends the pool's run sooner)
                    self.stats["stale_rows"] += len(ids)
                    if tr:
                        tr.count("engine.skipped_batches")
                        tr.count("engine.skipped_rows", len(ids))
                    continue
                self._fetch_batch = batch_id
                with self._on(slot):  # the batch's device
                    if self.chain:
                        self._fetch_chain(ids, spans, outs, tele)
                    else:
                        sp = tr and tr.open("engine.fetch_tokens",
                                            batch=batch_id)
                        self._fetch_tokens(ids, spans, outs, tele)
                        if sp:
                            tr.close(sp)
                    if bracket:  # done: the fetch waited on a later event
                        disp_sp["bwt_device_us"] = round(
                            1e3 * bracket[0].elapsed_time(bracket[1]))
            except Exception as e:  # recorded; run() re-raises it
                if not (self.abandoned or self.complete):
                    self.fail(e)
                self._drain_fetch_q()
                return
            finally:
                _GATE.dec(gen)
                self._fetched()

    @staticmethod
    def _wait_ready(ev):
        wait_event(ev)

    def _ready(self, ev):
        """Wait for a batch's event; traced, as a span."""
        tr = self.trace
        sp = tr and tr.open("engine.ready_wait", batch=self._fetch_batch)
        self._wait_ready(ev)
        if sp:
            tr.close(sp)

    def _fetch_tokens(self, ids, spans, outs, tele):
        """Token-mode completion: wait for the batch and its copies,
        queue each row's run tokens for the host entropy coder; a row
        over the token capacity downloads its raw bytes alone."""
        tokens, raw, run_counts, primary, passes, ev = outs
        t0 = time.time()
        self._ready(ev)
        tele["bwt2_passes"] = int(passes.max())
        counts = run_counts.numpy()
        prim = primary.numpy()
        tele["ready_s"] = round(time.time() - t0, 3)
        t1 = time.time()
        cap = tokens.shape[1] * 2
        tok = tokens.numpy().view(np.uint16)
        fresh = stale = 0
        for row, (i, span) in enumerate(zip(ids, spans)):
            # the host's entropy stage finishes the row; a steal-back
            # that took the block first has it, and the row is stale
            if self.is_stale(i) or not self.release_claim(i):
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
        bwt_dev, primary, passes, ev = outs
        t0 = time.time()
        self._ready(ev)
        tele["bwt2_passes"] = int(passes.max())
        ns = np.array([s.data.size for s in spans], np.int32)
        cmaps = np.stack([np.asarray(s.cmap, np.uint8) for s in spans])
        crcs = np.array(
            [(native.crc32_block(self.buf[s.start:s.end]) ^ 0xFFFFFFFF)
             & 0xFFFFFFFF for s in spans], np.uint32)
        stage_times: dict = {}
        tr = self.trace
        sp = tr and tr.open("engine.chain", batch=self._fetch_batch)
        payloads = chain_payloads(bwt_dev, ns, cmaps,
                                  primary.cpu().numpy().astype(np.int32),
                                  crcs, self.cf, times=stage_times)
        if sp:
            tr.close(sp, rows=len(ids))
        tele["chain_stages"] = stage_times
        fresh = stale = 0
        for row, (i, span) in enumerate(zip(ids, spans)):
            if self.is_stale(i):
                stale += 1
                continue
            if payloads[row] is None:  # pack overflow: host re-encode
                kept = self.release_claim(i)
                if kept:
                    self.entropy_q.put((i, span, None, -1))
            else:
                kept = self.put_result(i, (payloads[row], int(crcs[row])))
            fresh += kept
            stale += not kept
        tele["ready_s"] = round(time.time() - t0, 3)
        self._batch_done(tele, fresh, stale)

    def _batch_done(self, tele, fresh, stale):
        """Account a fetched batch: its completion time, its
        claim->deliver time (``claim_s``: from take_head handing out
        its ids to now, prep, dispatch, queueing and fetch included),
        the latency estimate of the drain guard and the block counts."""
        now = time.time() - self.stats["t0"]
        tele["done_t"] = round(now, 2)
        tele["claim_s"] = round(now - tele["claimed_t"], 3)
        self.last_batch_t = time.time()
        self.lat_ema = tele["claim_s"] if not self.lat_ema else \
            0.5 * self.lat_ema + 0.5 * tele["claim_s"]
        self.stats["device_blocks"] += fresh
        self.stats["stale_rows"] += stale
        self.stats["device_batches"].append((fresh, tele["done_t"]))
        self.stats["batch_trace"].append(tele)


    def _build_batch(self, ids):
        """Lyndon-prep ids into one (rows, bucket) batch of the rows
        the device keeps, no pad row; periodic and mid-size blocks route
        to the host immediately.

        The least rotation is written straight into the batch row
        (lyndon_prep's out buffer): no second copy of each 0.9 MB
        block."""
        t0 = time.time()
        eligible = []
        bucket = _BUCKETS[0]
        for i in ids:
            span = self.blocks[i]
            bucket_i = _bucket_for(span.data.size)
            if bucket_i is None:
                self.unclaim(i)
                self.entropy_q.put((i, span, None, -1))  # host BWT
                continue
            eligible.append((i, span))
            bucket = max(bucket, bucket_i)
        if not eligible:
            return None
        batch = np.zeros((len(eligible), bucket), np.uint8)
        ns = np.empty(len(eligible), np.int32)
        ms = np.empty(len(eligible), np.int32)
        kept = []
        row = 0
        for i, span in eligible:
            n = span.data.size
            _, m = native.lyndon_prep(span.data, out=batch[row, :n])
            if m < 0:  # fully periodic: host convention, reuse the row
                batch[row, :n] = 0
                self.unclaim(i)
                self.entropy_q.put((i, span, None, -1))
                continue
            ns[row] = n
            ms[row] = m
            kept.append((i, span))
            row += 1
        if not kept:
            return None
        # rows a periodic block gave back stay behind: ship the live ones
        batch, ns, ms = batch[:row], ns[:row], ms[:row]
        tele = {"rows": row, "shape": [row, bucket],
                "prep_s": round(time.time() - t0, 3),
                "t": round(time.time() - self.stats["t0"], 2)}
        return ([i for i, _ in kept], [span for _, span in kept],
                batch, ns, ms, tele)

    # --- host workers -----------------------------------------------------
    def _next_task(self):
        """Ordered scheduling policy: highest-priority available task,
        or None when the pool is finished.

        Static priority between task types (the reference's ordered
        task table, src/process.c:422-435 over compress.c:353-359),
        EDF within a type:
          1. entropy    — finish a device-BWT'd block (smallest id
                          first: feeds the in-order consumer and drains
                          device inventory)
          2. steal      — whole block from the tail of the shared queue
          3. steal_back — device-claimed block, gated by take_claimed's
                          streaming grace (cold start, outage, a device
                          that stopped delivering)
        Blocks (with a 1 s re-poll, no longer than the steal-back grace
        while there are claims to steal, so the gates above are
        re-evaluated) when nothing is ready but work may still
        appear."""
        tr = self.trace
        while True:
            item = self.entropy_q.get(block=False)
            if item is not None:
                return ("entropy", item)
            if _HOST_STEAL:
                i = self.take_tail()
                if i is not None:
                    return ("steal", i)
                if _STEALBACK and not self.device_done:
                    i = self.take_claimed()
                    if i is not None:
                        return ("steal_back", i)
            if self.device_done and self.entropy_q.empty():
                return None
            wait = 1.0
            if _HOST_STEAL and _STEALBACK and self.claimed:
                wait = min(wait, max(0.02, self.stealback_grace()))
            sp = tr and tr.open("host.wait")
            item = self.entropy_q.get(block=True, timeout=wait)
            if sp:
                tr.close(sp)
            if item is not None:
                return ("entropy", item)

    def host_loop(self):
        tr = self.trace
        life = tr and tr.open("host.life")
        try:
            if self.use_device:
                _yield_to_device()
            while True:
                task = self._next_task()
                if task is None:
                    return
                kind, item = task
                if kind == "entropy":
                    self._do_entropy(item)
                    continue
                # steal / steal_back: whole-block host encode
                sp = tr and tr.open("host.block", block=item)
                out = _host_block(self.buf, self.blocks[item], self.cf)
                if sp:
                    tr.close(sp)
                    tr.count(f"host.{kind}s")
                if self.put_result(item, out):
                    self.stats["host_blocks"] += 1
        except BaseException as e:  # noqa: BLE001
            self.fail(e)
        finally:
            if life:
                tr.close(life)

    def _do_entropy(self, item):
        i, span, bwt_row, bidx = item
        if self.is_stale(i):  # another engine already produced it
            return
        tr = self.trace
        # a periodic block, or a row the device gave back: full host
        # encode; else the entropy stage of the device's BWT
        sp = tr and tr.open("host.block" if bwt_row is None
                            else "host.entropy", block=i)
        if bwt_row is None:
            out = _host_block(self.buf, span, self.cf)
        else:
            out = _entropy_payload(self.buf, span, bwt_row, bidx, self.cf)
        if sp:
            tr.close(sp)
        self.put_result(i, out)

    # --- delivery loop ----------------------------------------------------
    def run(self):
        """Start the engines and yield (payload, stored CRC) in block
        order; then a bounded join of every thread the pool started
        (device, host and fetch threads), so that no ``lbz2-`` thread of
        this pool outlives the ``compress`` call: a process that exits
        at once must not tear down the interpreter under a thread
        inside torch.  The one exception is a pool the watchdog
        abandoned: its device engine is wedged by definition, and its
        daemon threads are left to finish or die with the process."""
        if self.use_device:
            self._engines.append(threading.Thread(
                target=self.device_loop, name="lbz2-device", daemon=True))
        for w in range(self.host_workers):
            self._engines.append(threading.Thread(
                target=self.host_loop, name=f"lbz2-host{w}", daemon=True))
        for t in self._engines:
            t.start()
        # Watchdog: if the device engine stops delivering while blocks
        # it claimed are outstanding, requeue them as host work so the
        # stream always completes (the stuck engine's late duplicates,
        # if any, are discarded at pop time).
        stall_s = float(os.environ.get("LBZ2_DEVICE_STALL_S", "300"))
        delivered = 0
        waited = 0.0
        seen = 0  # results observed at last stall check
        try:
            for i in range(len(self.blocks)):
                with self.res_cv:
                    while i not in self.results and self.error is None:
                        self.res_cv.wait(timeout=5.0)
                        if i in self.results or self.error is not None:
                            break
                        progress = delivered + len(self.results)
                        if progress != seen:  # stream alive: reset clock
                            seen = progress
                            waited = 0.0
                            continue
                        waited += 5.0
                        if waited >= stall_s and not self.abandoned and \
                                self.claimed:
                            # order matters for liveness: stop new claims
                            # (abandoned), requeue the stuck work, and
                            # only then set device_done: a worker
                            # observing (device_done and empty queue)
                            # between these steps would exit with work
                            # still pending
                            self.abandoned = True
                            with self.q_lock:  # take_head mutates claimed
                                stuck = sorted(self.claimed)
                            for j in stuck:
                                self.entropy_q.put(
                                    (j, self.blocks[j], None, -1))
                            self.device_done = True
                    if self.error is not None:
                        raise self.error
                delivered += 1
                with self.res_cv:
                    self.next_deliver = i + 1
                    payload = self.results.pop(i)
                yield payload
            self.complete = True
        finally:
            self._wake_dispatch()
            if not self.abandoned:
                self._join_threads()
        if self.error is not None:
            raise self.error

    def _join_threads(self):
        # the device thread sets its fetcher before starting it, so once
        # the engines are joined the fetcher is known
        deadline = time.time() + _JOIN_S
        for t in self._engines:
            t.join(timeout=max(0.0, deadline - time.time()))
        if self._fetcher is not None:
            self._fetcher.join(timeout=max(0.0, deadline - time.time()))


def _yield_to_device() -> None:
    """Lower the calling host worker thread's priority by _HOST_NICE
    (Linux sets it for a thread; elsewhere nothing changes)."""
    try:
        tid = threading.get_native_id()
        os.setpriority(os.PRIO_PROCESS, tid,
                       os.getpriority(os.PRIO_PROCESS, tid) + _HOST_NICE)
    except (AttributeError, OSError):
        pass  # no per-thread priority on this platform


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
        if _bucket_for(blk.size) is not None and \
                native.lyndon_prep(blk)[1] >= 0:
            n += 1
    return n


def warm_device(rows=(_BATCH,), bucket: int = _BUCKETS[-1],
                device: str | torch.device | list = "cuda") -> float:
    """Run the device engine of the mode in force (``_DEVICE_CHAIN``)
    once per (rows, bucket) shape on tiny Lyndon rows: the whole chain
    (building the CUDA kernels), or the token BWT and its copies to
    pinned memory.  Warms the allocator and the math libraries outside a
    timed stream; a stream ships batches of 1 to ``_BATCH`` rows, and no
    shape needs compiling, so the widest batch warms the most memory.
    Every device the engine would drive for ``device`` is warmed.
    Returns seconds spent."""
    global _warmed
    t0 = time.time()
    for dev in resolve_all(device):
        with on(dev):
            _warm_one(rows, bucket, dev)
    _warmed = True
    return time.time() - t0


def _warm_one(rows, bucket: int, dev: torch.device) -> None:
    for r in sorted(set(rows)):
        batch = np.zeros((r, bucket), np.uint8)
        batch[:, 3] = 1  # R = 0001: a genuine Lyndon row of length 4
        ns = np.full(r, 4, np.int32)
        ms = np.zeros(r, np.int32)
        args = (upload(batch, dev), upload(ns, dev), upload(ms, dev))
        if not _DEVICE_CHAIN:
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


def compress_blocks_hybrid(data: bytes | np.ndarray, level: int = 9,
                           cluster_factor: int = CLUSTER_FACTOR,
                           sequential_split: bool = False,
                           entropy_workers: int | None = None,
                           use_device: bool | None = None,
                           device: str | torch.device | list = "cuda"
                           ) -> tuple[list[bytes], list[int]]:
    """Encode all blocks with the hybrid pool, its device engine on the
    devices ``device`` names (``device.resolve_all``: ``"cuda"`` is every
    visible card); returns (payloads, stored block CRCs) in block
    order.  The host C kernels (``lbzip2_tpu_torch.native``) are
    required: the device engine runs ``lyndon_prep``, and
    ``chain_finish`` or the token entropy coder."""
    tr = trace.begin()
    out = _hybrid_blocks(data, level, cluster_factor, sequential_split,
                         entropy_workers, use_device, device, tr)
    if tr:
        last_stats["trace"] = tr.result()
    return out


def _hybrid_blocks(data, level, cluster_factor, sequential_split,
                   entropy_workers, use_device, device,
                   tr: trace.Tracer | None):
    """``compress_blocks_hybrid``'s work; traced, the collection of the
    blocks and the pool's run are spans of ``tr``."""
    global last_stats
    if not 1 <= level <= 9:
        raise ValueError(f"level must be 1..9, got {level}")
    devs = resolve_all(device)
    if not native.native_available():
        raise RuntimeError("lbzip2_tpu_torch.native is not available: the "
                           "device engine needs its host C kernels")
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(
            data, dtype=np.uint8)
    mbs = level * 100000
    granul = None if sequential_split else mbs
    if entropy_workers is None:
        entropy_workers = max(2, os.cpu_count() or 2)
    # before the pool starts, as many threads as it has workers collect
    # the granule windows
    sp = tr and tr.open("compress.collect")
    blocks = [rle1.BlockSpan(a, b, blk, cmap) for a, b, blk, cmap in
              native.rle1_collect(buf, mbs, granul, reuse_arena=True,
                                  threads=entropy_workers)]
    if sp:
        chunks = native.collect_chunks(buf.size, granul, entropy_workers)
        tr.close(sp, blocks=len(blocks), chunks=chunks,
                 threads=min(chunks, entropy_workers))
    if use_device is None:
        use_device = _DEVICE
    pool = _TorchPool(buf, blocks, cluster_factor, entropy_workers,
                      use_device, devs, tr)
    last_stats = pool.stats
    payloads, crcs = [], []
    sp = tr and tr.open("compress.run")
    for payload, crc_stored in pool.run():
        payloads.append(payload)
        crcs.append(crc_stored)
    if sp:
        tr.close(sp)
    return payloads, crcs


def compress(data: bytes | np.ndarray, level: int = 9,
             cluster_factor: int = CLUSTER_FACTOR,
             sequential_split: bool = False,
             entropy_workers: int | None = None,
             use_device: bool | None = None,
             device: str | torch.device | list = "cuda") -> bytes:
    """Compress into a .bz2 stream on the hybrid pool with the device
    engine on the devices ``device`` names (every visible card for
    ``"cuda"``).  Bit-identical to the JAX package's compress
    and to the host C pipeline.  Traced (``utils/trace.py``), the call,
    its blocks' collection, the pool's run and the stream's assembly
    are spans in ``last_stats["trace"]``."""
    tr = trace.begin()
    call = tr and tr.open("compress.call")
    payloads, crcs = _hybrid_blocks(
        data, level, cluster_factor, sequential_split, entropy_workers,
        use_device, device, tr)
    sp = tr and tr.open("compress.assemble")
    parts = [bytes([0x42, 0x5A, 0x68, 0x30 + level])]
    combined = 0
    for payload, crc_stored in zip(payloads, crcs):
        parts.append(payload)
        combined = crc32.combine_crc(combined, crc_stored)
    parts.append(bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) +
                 combined.to_bytes(4, "big"))
    out = b"".join(parts)
    if tr:
        tr.close(sp)
        tr.close(call)
        last_stats["trace"] = tr.result()
    return out
