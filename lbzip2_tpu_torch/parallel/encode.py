"""Multi-worker host compression (the pthread pipeline analogue).

Block data parallelism over a process pool: the native RLE1 collector
splits the input, workers run the per-block encode stack (BWT, MTF,
EM Huffman, bit packing), and the parent reassembles payloads in block
order folding the combined stream CRC — the collect/encode/transmit/
reorder task graph of src/compress.c with processes standing in for the
worker threads (the device engine, codec/encoder.py, replaces the
per-block BWT/MTF with batched device kernels instead).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.constants import CLUSTER_FACTOR


def _encode_worker(args) -> bytes:
    block_bytes, cmap_bytes, crc_stored, cluster = args
    blk = np.frombuffer(block_bytes, np.uint8)
    if native.native_available():
        # C SA-IS BWT + C entropy stage; releases the GIL, so thread
        # pools scale across cores without pickling.
        cmap_u8 = np.frombuffer(cmap_bytes, np.uint8)
        return native.encode_block(blk, cmap_u8, crc_stored, cluster)
    from lbzip2_tpu_torch.ref.encoder import encode_block
    cmap = np.frombuffer(cmap_bytes, np.uint8).astype(bool)
    return encode_block(blk, cmap, crc_stored, cluster)


def _collect_blocks(buf: np.ndarray, mbs: int, granul: int | None):
    if native.native_available():
        return native.rle1_collect(buf, mbs, granul)
    from lbzip2_tpu_torch.ref import rle1
    spans = rle1.rle1_blocks(buf, mbs, granul if granul else None)
    return [(s.start, s.end, s.data, s.cmap) for s in spans]


def _window_worker(args) -> list[tuple[bytes, int]]:
    """Collect + CRC + encode every block of one RLE1 window.

    In parallel (non -u) mode windows are RLE1-independent (the
    reference collects each in_granul buffer with a fresh collector,
    src/compress.c:66-117), so the whole per-window pipeline runs
    inside the worker and the main thread never serializes a collect
    pass over the full input before encoding can start.  The entire
    window goes through ONE fused C call (lbz2_encode_window) with a
    reusable per-thread arena, sparing the per-block Python wrapper
    and allocation overhead."""
    window, mbs, cluster = args
    pays, _, _, crcs = native.encode_window(window, mbs, cluster)
    return list(zip(pays, crcs))


def compress_blocks(data: bytes | np.ndarray, level: int = 9,
                    n_workers: int | None = None,
                    sequential_split: bool = False,
                    cluster_factor: int = CLUSTER_FACTOR
                    ) -> tuple[list[bytes], list[int]]:
    """Encode all blocks; returns (payloads, stored block CRCs)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(
            data, dtype=np.uint8)
    mbs = level * 100000
    if n_workers is None:
        n_workers = os.cpu_count() or 1

    if native.native_available() and not sequential_split and \
            buf.size > mbs:
        wins = [(buf[i:i + mbs], mbs, cluster_factor)
                for i in range(0, buf.size, mbs)]
        with ThreadPoolExecutor(max_workers=min(n_workers,
                                                len(wins))) as pool:
            per_win = list(pool.map(_window_worker, wins))
        payloads = [p for w in per_win for (p, _) in w]
        crcs = [c for w in per_win for (_, c) in w]
        return payloads, crcs

    blocks = _collect_blocks(buf, mbs, None if sequential_split else mbs)

    crcs = []
    jobs = []
    for (a, b, blk, cmap) in blocks:
        if native.native_available():
            crc_stored = (native.crc32_block(buf[a:b]) ^ 0xFFFFFFFF) \
                & 0xFFFFFFFF
        else:
            crc_stored = crc32.crc_of(buf[a:b])
        crcs.append(crc_stored)
        jobs.append((blk.tobytes(), cmap.astype(np.uint8).tobytes(),
                     crc_stored, cluster_factor))

    if len(jobs) <= 1 or n_workers <= 1:
        payloads = [_encode_worker(j) for j in jobs]
    elif native.native_available():
        with ThreadPoolExecutor(max_workers=min(n_workers,
                                                len(jobs))) as pool:
            payloads = list(pool.map(_encode_worker, jobs))
    else:
        with ProcessPoolExecutor(max_workers=min(n_workers,
                                                 len(jobs))) as pool:
            payloads = list(pool.map(_encode_worker, jobs, chunksize=1))
    return payloads, crcs


def compress_parallel(data: bytes | np.ndarray, level: int = 9,
                      n_workers: int | None = None,
                      sequential_split: bool = False,
                      cluster_factor: int = CLUSTER_FACTOR) -> bytes:
    payloads, crcs = compress_blocks(data, level, n_workers,
                                     sequential_split, cluster_factor)
    parts = [bytes([0x42, 0x5A, 0x68, 0x30 + level])]
    combined = 0
    for payload, crc_stored in zip(payloads, crcs):
        parts.append(payload)
        combined = crc32.combine_crc(combined, crc_stored)
    parts.append(bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) +
                 combined.to_bytes(4, "big"))
    return b"".join(parts)
