"""Sequential spec-exact bzip2 encoder — the correctness oracle.

Mirrors the reference encode path end-to-end (src/encode.c encode() +
transmit(), src/compress.c stream framing) including lbzip2's
byte-alignment padding quirk (tree_pad dummy delta codes + optional
dummy selector, src/encode.c:514-525), so output bytes are bit-exact
with the reference binary.
"""

from __future__ import annotations

import numpy as np

from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.bits import BitWriter
from lbzip2_tpu_torch.core.constants import (BLOCK_MAGIC, CLUSTER_FACTOR,
                                       GROUP_SIZE, MAX_TREES)
from lbzip2_tpu_torch.ref import rle1
from lbzip2_tpu_torch.ref.bwt import bwt
from lbzip2_tpu_torch.ref.huffman import PrefixModel, generate_prefix_code
from lbzip2_tpu_torch.ref.mtf import make_cmap, mtf_rle2

_HEADER_COST = 48 + 32 + 1 + 24 + 3 + 15  # fixed per-block metadata bits


def selector_mtf(selectors_new: np.ndarray) -> list[int]:
    """MTF-code the (new-id) selector sequence, initial list [0..5]."""
    order = list(range(MAX_TREES))
    out = []
    for c in selectors_new.tolist():
        j = order.index(c)
        del order[j]
        order.insert(0, c)
        out.append(j)
    return out


def encode_block(block_bytes: np.ndarray, cmap_bool: np.ndarray,
                 crc_stored: int,
                 cluster_factor: int = CLUSTER_FACTOR) -> bytes:
    """Encode one RLE1-transformed block into its byte-aligned bitstream."""
    ninuse = int(cmap_bool.sum())
    assert ninuse >= 1

    bwt_out, bwt_idx = bwt(block_bytes)
    mtfv = mtf_rle2(bwt_out, make_cmap(cmap_bool), ninuse)
    return encode_block_payload(mtfv, cmap_bool, bwt_idx, crc_stored,
                                cluster_factor)


def encode_block_payload(mtfv: np.ndarray, cmap_bool: np.ndarray,
                         bwt_idx: int, crc_stored: int,
                         cluster_factor: int = CLUSTER_FACTOR) -> bytes:
    """Entropy-code one block given its MTF values (post BWT+MTF stages).

    Shared by the sequential oracle and the device pipeline (which
    computes BWT/MTF on the device and hands the mtfv stream here)."""
    model: PrefixModel = generate_prefix_code(mtfv, cluster_factor)

    sels_new = model.tmap_old2new[model.selectors]
    smtf = selector_mtf(sels_new)
    assert smtf[0] == 0

    cost = _HEADER_COST + model.cost + sum(j + 1 for j in smtf)
    pad = (8 - (cost & 7)) & 7
    tree_pad = pad >> 1
    if pad & 1:
        smtf.append(0)
    num_selectors = model.num_selectors + (pad & 1)
    cost += pad
    assert cost % 8 == 0

    w = BitWriter()
    w.put(BLOCK_MAGIC, 48)
    w.put(crc_stored, 32)
    w.put(0, 1)  # not randomized
    w.put(bwt_idx, 24)

    # Character map: 16-bit big bucket + 16-bit small buckets.
    buckets = cmap_bool.reshape(16, 16)
    big = 0
    for i in range(16):
        big = (big << 1) | int(buckets[i].any())
    w.put(big, 16)
    for i in range(16):
        if buckets[i].any():
            pk = 0
            for j in range(16):
                pk = (pk << 1) | int(buckets[i, j])
            w.put(pk, 16)

    w.put(model.num_trees, 3)
    w.put(num_selectors, 15)
    for j in smtf:
        w.put((1 << (j + 1)) - 2, j + 1)  # j ones then a zero

    # Prefix trees, in new-id order; first tree absorbs tree_pad dummy
    # delta codes via a shifted initial 5-bit value.
    as_ = int(mtfv[-1]) + 1
    for tnew in range(model.num_trees):
        told = int(model.tmap_new2old[tnew])
        lens = model.lengths[told]
        a = int(lens[0])
        if tnew == 0:
            a = a + tree_pad if a < 4 else a - tree_pad
        w.put(a, 5)
        for v in range(as_):
            c = int(lens[v])
            while a < c:
                w.put(0b10, 2)
                a += 1
            while a > c:
                w.put(0b11, 2)
                a -= 1
            w.put(0, 1)

    # Prefix codes, vectorized: per-symbol (length, code) lookups.
    ns_real = model.num_selectors
    padded = np.full(ns_real * GROUP_SIZE, as_, dtype=np.int64)
    padded[:mtfv.size] = mtfv
    sel_per_sym = np.repeat(model.selectors, GROUP_SIZE)
    lens_arr = model.lengths[sel_per_sym, padded].astype(np.int64)
    codes_arr = model.codes[sel_per_sym, padded].astype(np.uint64)
    w.put_arrays(codes_arr, lens_arr)

    # Reference computes padding before adding the cmap cost (legal since
    # cmap bits are a multiple of 16); total block bits = cost + cmap.
    total_bits = cost + _cmap_cost(cmap_bool)
    assert w.nbits == total_bits, (w.nbits, total_bits)
    out = w.getvalue()
    assert len(out) == total_bits // 8
    return out


def _cmap_cost(cmap_bool: np.ndarray) -> int:
    return 16 + 16 * int(cmap_bool.reshape(16, 16).any(axis=1).sum())


def compress(data: bytes | np.ndarray, level: int = 9,
             cluster_factor: int = CLUSTER_FACTOR,
             sequential_split: bool = False) -> bytes:
    """Compress `data` into a complete .bz2 stream (single-threaded oracle).

    Stream framing per src/compress.c:291-350: BZh<level> header, blocks,
    EOS magic, combined CRC.  `sequential_split=True` reproduces the
    reference's -u mode (block boundaries independent of input buffer
    granularity, matching single-threaded bzip2).
    """
    assert 1 <= level <= 9
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    mbs = level * 100000

    parts = [bytes([0x42, 0x5A, 0x68, 0x30 + level])]
    combined = 0
    for span in rle1.rle1_blocks(buf, mbs,
                                 None if sequential_split else -1):
        crc_stored = crc32.crc_of(buf[span.start:span.end])
        parts.append(encode_block(span.data, span.cmap, crc_stored,
                                  cluster_factor))
        combined = crc32.combine_crc(combined, crc_stored)

    trailer = bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) + \
        combined.to_bytes(4, "big")
    parts.append(trailer)
    return b"".join(parts)
