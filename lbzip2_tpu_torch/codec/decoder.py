"""Production decompressor: header walk (host) + native retrieve/IBWT.

Semantics identical to ref.decoder.decompress (the oracle); this path
uses the C kernels for the per-block hot stages and constant-time bit
addressing for the stream walk.  Falls back to the oracle if the native
library is unavailable.
"""

from __future__ import annotations

import numpy as np

from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.bits import read_bits_at as _read_bits
from lbzip2_tpu_torch.core.constants import Error, StreamError
from lbzip2_tpu_torch import native

_ERR_BY_VALUE = {e.value: e for e in Error}




def decompress(data: bytes | np.ndarray) -> bytes:
    buf = bytes(data) if not isinstance(data, bytes) else data
    if native.get_lib() is None:
        from lbzip2_tpu_torch.ref.decoder import decompress as ref_dec
        return ref_dec(buf)

    if len(buf) < 4 or buf[0:3] != b"BZh" or not (0x31 <= buf[3] <= 0x39):
        raise StreamError(Error.ERR_MAGIC)

    arr = np.frombuffer(buf, dtype=np.uint8)
    nbits = arr.size * 8
    pos = 24
    level = _read_bits(arr, pos, 8) - 0x30
    pos += 8
    combined = 0
    out_parts: list[bytes] = []

    while True:
        try:
            magic = _read_bits(arr, pos, 48)
        except EOFError:
            raise StreamError(Error.ERR_EOF)
        pos += 48
        if magic == 0x314159265359:
            try:
                crc_stored = _read_bits(arr, pos, 32)
            except EOFError:
                raise StreamError(Error.ERR_EOF)
            pos += 32
            err, pos2, bwt, idx, rnd = native.retrieve_block(arr, nbits, pos)
            if err != 0:
                raise StreamError(_ERR_BY_VALUE.get(err, Error.ERR_HEADER))
            if bwt.size > level * 100000:
                raise StreamError(Error.ERR_OVERFLOW)
            try:
                plain, crcreg = native.ibwt_emit(bwt, idx, rnd)
            except ValueError:
                raise StreamError(Error.ERR_RUNLEN)
            if (crcreg ^ 0xFFFFFFFF) & 0xFFFFFFFF != crc_stored:
                raise StreamError(Error.ERR_BLKCRC)
            out_parts.append(plain.tobytes())
            combined = crc32.combine_crc(combined, crc_stored)
            pos = pos2
            continue
        if magic == 0x177245385090:
            try:
                stored = _read_bits(arr, pos, 32)
            except EOFError:
                raise StreamError(Error.ERR_EOF)
            pos += 32
            if stored != combined:
                raise StreamError(Error.ERR_STRMCRC)
            pos += (-pos) % 8
            if nbits - pos >= 32:
                hdr = _read_bits(arr, pos, 32)
                if (hdr >> 8) == 0x425A68 and 0x31 <= (hdr & 0xFF) <= 0x39:
                    pos += 32
                    level = (hdr & 0xFF) - 0x30
                    combined = 0
                    continue
            break
        raise StreamError(Error.ERR_HEADER)

    return b"".join(out_parts)
