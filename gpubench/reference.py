"""The comparison that decides ``correct``.

It judges every answer of the window once the window has closed, and
imports nothing of the port and takes nothing the port made but the
answers it judges.

- Compress: every stream the window returned is decoded by libbzip2, the
  bzip2 format's reference decoder (Python's ``bz2`` module), and its
  bytes are compared with the file that went in: libbzip2 checks every
  block's CRC and the stream's, and the bytes must match exactly.  Two
  answers of one file with the same bytes are one answer, judged once.
  Each stream's header must read ``BZh`` and the configuration's level,
  and its blocks are counted (the 48-bit block magic at any bit offset,
  plain numpy) against the blocks that level's windows give the file:
  a stream cut into smaller blocks than the level states is a different
  result, not a faster one.  Each stream's length is held against
  libbzip2's at the same level for the same file (``size_excess``, the
  most any answer is longer, as a share): an encoder that spends less
  effort on its entropy coding (fewer EM refinements of its Huffman
  tables, fewer tables) writes valid streams that are longer, a lesser
  result.  libbzip2 compresses the file in pieces of ``REF_PIECE``
  bytes, in threads, after the window; the lengths are summed.
- Decompress: every output of the window is compared byte for byte with
  the file the set-up compressed.

Each number is held to its limit in ``LIMITS``; PERF.md gives the
readings each limit was set from.
"""

from __future__ import annotations

import bz2
import hashlib
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK_MAGIC = bytes.fromhex("314159265359")

# libbzip2's reference length of a file is the sum of its streams of
# pieces of this many bytes: 32 blocks of 900,000 (the pieces compress
# in threads; a piece's edge costs a partial block, about 0.05 % here)
REF_PIECE = 28_800_000

# Each number compared and its limit: a run is correct when every number
# is at most its limit (a number that could not be read, None, is not).
LIMITS = {
    "files_wrong": 0,          # answers that are not the file, or none
    "headers_wrong": 0,        # streams whose header is not BZh<level>
    "extra_block_share": 0.04,  # most blocks over the level's, a share
    "size_excess": 0.015,      # most bytes over libbzip2's, a share
}


def count_blocks(stream: bytes) -> int:
    """Block magics in ``stream`` at every bit offset."""
    a = np.frombuffer(stream, np.uint8)
    n = stream.count(BLOCK_MAGIC)
    if a.size < 7:
        return n
    hi = a[:-1].astype(np.uint16)
    lo = a[1:]
    for s in range(1, 8):
        shifted = ((hi << s) | (lo >> (8 - s))).astype(np.uint8)
        n += shifted.tobytes().count(BLOCK_MAGIC)
    return n


def level_blocks(nbytes: int, level: int) -> int:
    """The blocks a file of ``nbytes`` takes at ``level``: one a window
    of level x 100,000 input bytes."""
    return max(1, math.ceil(nbytes / (level * 100_000)))


def _judge_stream(stream: bytes, data_sha: str, nbytes: int,
                  level: int) -> dict:
    """One distinct compressed answer against its file."""
    try:
        plain = bz2.decompress(stream)
        same = len(plain) == nbytes and \
            hashlib.sha256(plain).hexdigest() == data_sha
        del plain
    except (OSError, ValueError, EOFError):
        same = False
    return {"same": same,
            "header": stream[:4] == b"BZh" + str(level).encode(),
            "extra": count_blocks(stream) / level_blocks(nbytes, level) - 1}


def reference_lengths(files: list, level: int, ex) -> list:
    """Futures of libbzip2's length at ``level`` for each file: its
    pieces of REF_PIECE bytes compressed on ``ex``, summed."""
    def piece(f, a):
        return len(bz2.compress(f.data[a:a + REF_PIECE], level))

    return [[ex.submit(piece, f, a) for a in range(0, len(f.data),
                                                   REF_PIECE)]
            for f in files]


def judge_compress(answers: list, files: list, level: int,
                   workers: int | None = None) -> dict:
    """The numbers of a compress window: ``answers`` holds (file index,
    stream or None) for every call made, ``files`` the cell's files.
    Answers that are one object, or hold the same bytes, are judged
    once."""
    groups: dict = {}
    wrong = 0
    for k, stream in answers:
        if stream is None:
            wrong += 1
            continue
        key = (k, id(stream))
        if key not in groups:
            key = next((g for g, (s, _) in groups.items()
                        if g[0] == k and s == stream), key)
        groups.setdefault(key, [stream, 0])[1] += 1
    used = sorted({k for k, _ in groups})
    with ThreadPoolExecutor(max_workers=workers or os.cpu_count() or 4) \
            as ex:
        futs = {key: ex.submit(_judge_stream, s, files[key[0]].sha256,
                               len(files[key[0]].data), level)
                for key, (s, _) in groups.items()}
        ref = dict(zip(used, reference_lengths([files[k] for k in used],
                                               level, ex)))
        results = {key: f.result() for key, f in futs.items()}
        ref_len = {k: sum(f.result() for f in fs) for k, fs in ref.items()}
    headers = 0
    extra_share = 0.0
    size_excess = None
    for key, (stream, count) in groups.items():
        r = results[key]
        wrong += count * (not r["same"])
        headers += count * (not r["header"])
        extra_share = max(extra_share, r["extra"])
        excess = len(stream) / ref_len[key[0]] - 1
        size_excess = excess if size_excess is None else \
            max(size_excess, excess)
    return {"files_wrong": wrong, "headers_wrong": headers,
            "extra_block_share": round(extra_share, 6),
            "size_excess": None if size_excess is None else
            round(size_excess, 6)}


def judge_decompress(answers: list, files: list) -> dict:
    """The numbers of a decompress window: ``answers`` holds (file index,
    output or None) for every call made."""
    wrong = sum(out is None or out != files[k].data for k, out in answers)
    return {"files_wrong": wrong}


def verdict(numbers: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and each number beside
    its limit."""
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return all(v is not None and v <= LIMITS[k]
               for k, v in numbers.items()), checks
