"""Big-endian bitstream writer/reader.

bzip2 streams are MSB-first bit sequences. The reference packs via a
64-bit shift register (src/encode.c:1140-1150 PUTBIT/DUMP/SEND and
src/decode.c bitstream macros); here the writer instead collects
(value, nbits) pairs and materializes the byte stream with a single
vectorized pass (repeat + cumsum + packbits) — the same formulation used
by the device bitpacker in lbzip2_tpu.ops.bitpack.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Accumulates big-endian bit fields; vectorized serialization."""

    def __init__(self):
        self._vals: list[np.ndarray] = []
        self._lens: list[np.ndarray] = []
        self._nbits = 0

    @property
    def nbits(self) -> int:
        return self._nbits

    def put(self, value: int, nbits: int) -> None:
        """Append `nbits` bits of `value` (MSB of the field first)."""
        assert 0 <= nbits <= 64
        assert value >= 0 and (nbits == 64 or value < (1 << nbits))
        if nbits == 0:
            return
        self._vals.append(np.asarray([value], dtype=np.uint64))
        self._lens.append(np.asarray([nbits], dtype=np.int64))
        self._nbits += nbits

    def put_arrays(self, values: np.ndarray, lengths: np.ndarray) -> None:
        """Append many variable-length fields at once."""
        values = np.ascontiguousarray(values, dtype=np.uint64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int64)
        assert values.shape == lengths.shape
        if values.size == 0:
            return
        self._vals.append(values.ravel())
        self._lens.append(lengths.ravel())
        self._nbits += int(lengths.sum())

    def pad_to_byte(self) -> int:
        """Pad with zero bits to a byte boundary; returns pad amount."""
        pad = (-self._nbits) % 8
        if pad:
            self.put(0, pad)
        return pad

    def getvalue(self) -> bytes:
        """Serialize to bytes; trailing partial byte is zero-padded."""
        if not self._vals:
            return b""
        vals = np.concatenate(self._vals)
        lens = np.concatenate(self._lens)
        return pack_bits_be(vals, lens)


def pack_bits_be(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Pack variable-length big-endian fields into a byte string.

    values[i] contributes its low lengths[i] bits, MSB-first.
    """
    values = values.astype(np.uint64, copy=False)
    lengths = lengths.astype(np.int64, copy=False)
    total = int(lengths.sum())
    if total == 0:
        return b""
    # Per-bit symbol id and position within the field.
    per_bit_val = np.repeat(values, lengths)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    idx_in_field = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    shift = (np.repeat(lengths, lengths) - 1 - idx_in_field).astype(np.uint64)
    bits = ((per_bit_val >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


def read_bits_at(data: np.ndarray, pos: int, k: int) -> int:
    """k (<=56) bits MSB-first at bit offset `pos` of a uint8 array.

    Constant-time (no unpacking); raises EOFError past the end.  Shared
    by the stream walkers (codec.decoder, parallel.decode)."""
    nbits = data.size * 8
    if pos + k > nbits:
        raise EOFError
    byte = pos >> 3
    off = pos & 7
    span = data[byte:byte + ((off + k + 7) >> 3) + 1]
    v = int.from_bytes(span.tobytes(), "big")
    return (v >> (span.size * 8 - off - k)) & ((1 << k) - 1)


class BitReader:
    """MSB-first bit reader over a byte buffer.

    Maintains both a scalar cursor (for sequential header parsing) and
    exposes the unpacked bit array for vectorized decode stages.
    """

    def __init__(self, data: bytes | np.ndarray, start_bit: int = 0):
        buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
            data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
        self.bits = np.unpackbits(buf)
        self.pos = start_bit

    @property
    def nbits(self) -> int:
        return int(self.bits.size)

    def remaining(self) -> int:
        return self.nbits - self.pos

    def peek(self, n: int) -> int:
        """Peek next n bits as an integer (MSB-first); short reads pad 0."""
        end = min(self.pos + n, self.nbits)
        chunk = self.bits[self.pos:end]
        v = 0
        for b in chunk.tolist():
            v = (v << 1) | b
        v <<= n - (end - self.pos)
        return v

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise EOFError("bitstream exhausted")
        v = self.peek(n)
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def align_byte(self) -> None:
        self.pos += (-self.pos) % 8

    def read_unary(self, max_run: int = 64) -> int:
        """Count of consecutive 1 bits before the terminating 0 (consumed)."""
        n = 0
        while True:
            if self.pos >= self.nbits:
                raise EOFError("bitstream exhausted in unary code")
            b = int(self.bits[self.pos])
            self.pos += 1
            if b == 0:
                return n
            n += 1
            if n > max_run:
                raise ValueError("unary run too long")
