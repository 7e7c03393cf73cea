"""bzip2 CRC-32 (MSB-first, polynomial 0x04C11DB7 — NOT zlib's reflected CRC).

Spec source: reference src/crctab.c + build-aux/make-crctab.pl (table
definition) and src/encode.c:103 (update rule
``crc = (crc << 8) ^ table[(crc >> 24) ^ byte]`` with init 0xFFFFFFFF and
final xor 0xFFFFFFFF).

Two implementations:

- :func:`crc_update_bytes` — the literal per-byte recurrence (slow,
  obviously-correct truth for tests and tiny inputs);
- :func:`crc_block` — an O(n) fully-vectorized evaluation that exploits
  GF(2)-linearity of the CRC register map: positional byte tables give
  zero-init CRCs of fixed-size chunks with gathers, then a logarithmic
  tree of linear "advance by L zero bytes" operators folds the chunk CRCs.
  This same formulation is used by the on-device JAX CRC kernel
  (lbzip2_tpu.ops.crc) so host and device agree bit-for-bit.

bzip2 convention used throughout: functions taking/returning a *register*
use init 0xFFFFFFFF and no final xor; the value stored in the file is
``register ^ 0xFFFFFFFF``.
"""

from __future__ import annotations

import numpy as np

POLY = 0x04C11DB7
INIT = 0xFFFFFFFF
_CHUNK = 32  # bytes per leaf chunk of the vectorized evaluator


def _make_table() -> np.ndarray:
    v = np.arange(256, dtype=np.uint64) << np.uint64(24)
    for _ in range(8):
        hi = (v >> np.uint64(31)) & np.uint64(1)
        v = ((v << np.uint64(1)) ^ (hi * np.uint64(POLY))) & np.uint64(0xFFFFFFFF)
    return v.astype(np.uint32)


CRC_TABLE = _make_table()


def crc_update_bytes(crc: int, data: bytes | np.ndarray) -> int:
    """Per-byte CRC register update (reference semantics, slow path)."""
    data = np.asarray(bytearray(data) if isinstance(data, (bytes, bytearray)) else data,
                      dtype=np.uint8)
    c = crc & 0xFFFFFFFF
    tab = CRC_TABLE
    for b in data.tolist():
        c = ((c << 8) & 0xFFFFFFFF) ^ int(tab[((c >> 24) ^ b) & 0xFF])
    return c


# ---------------------------------------------------------------------------
# Vectorized evaluator.
#
# The register map for one input byte b is affine-linear over GF(2):
#   step_b(c) = (c << 8) ^ table[(c >> 24) ^ b]
#             = S(c) ^ table[b]          where S(c) = (c << 8) ^ table[c >> 24]
# (true because table[x ^ y] = table[x] ^ table[y] ^ table[0] and
#  table[0] == 0 for this polynomial; S is the "advance one zero byte" map).
#
# Hence for a message m of length n with zero initial register:
#   crc0(m) = XOR_j  S^(n-1-j)( table[m[j]] )
# and with init register I:  crc(m) = S^n(I) ^ crc0(m).
# Leading zero bytes leave a zero register unchanged, so zero-padding a
# message at the FRONT never changes crc0 — which makes both the chunk
# remainder and the power-of-two tree padding free.
# ---------------------------------------------------------------------------


def _op_identity() -> np.ndarray:
    return (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


def _op_shift1byte() -> np.ndarray:
    """S as a 32-vector: column k is S(1<<k)."""
    basis = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    out = ((basis << np.uint64(8)) & np.uint64(0xFFFFFFFF)) ^ \
        CRC_TABLE[(basis >> np.uint64(24)).astype(np.intp)].astype(np.uint64)
    return out.astype(np.uint32)


def _op_apply_scalar(op: np.ndarray, x: int) -> int:
    r = np.uint32(0)
    for k in range(32):
        if (x >> k) & 1:
            r ^= op[k]
    return int(r)


def _op_compose(op2: np.ndarray, op1: np.ndarray) -> np.ndarray:
    """Return op2 ∘ op1 (apply op1 first)."""
    out = np.zeros(32, dtype=np.uint32)
    for k in range(32):
        out[k] = _op_apply_scalar(op2, int(op1[k]))
    return out


def _op_byte_tables(op: np.ndarray) -> np.ndarray:
    """Expand a linear op into 4 x 256 byte-indexed lookup tables."""
    tabs = np.zeros((4, 256), dtype=np.uint32)
    vals = np.arange(256)
    for b in range(4):
        t = np.zeros(256, dtype=np.uint32)
        for k in range(8):
            bit = ((vals >> k) & 1).astype(bool)
            t[bit] ^= op[8 * b + k]
        tabs[b] = t
    return tabs


class _OpCache:
    """Caches S^(2^i) ops (32-vectors) and their byte tables."""

    def __init__(self):
        self.pow2: list[np.ndarray] = [_op_shift1byte()]  # S^(2^0 bytes)
        self.pow2_tabs: list[np.ndarray] = [_op_byte_tables(self.pow2[0])]

    def ensure(self, i: int) -> None:
        while len(self.pow2) <= i:
            nxt = _op_compose(self.pow2[-1], self.pow2[-1])
            self.pow2.append(nxt)
            self.pow2_tabs.append(_op_byte_tables(nxt))

    def advance_scalar(self, x: int, nbytes: int) -> int:
        """Apply S^nbytes to scalar register x."""
        i = 0
        while nbytes:
            if nbytes & 1:
                self.ensure(i)
                x = _op_apply_scalar(self.pow2[i], x)
            nbytes >>= 1
            i += 1
        return x

    def advance_vec(self, x: np.ndarray, log2_nbytes: int) -> np.ndarray:
        """Apply S^(2^log2_nbytes) to a uint32 vector, via byte tables."""
        self.ensure(log2_nbytes)
        t = self.pow2_tabs[log2_nbytes]
        return (t[0][(x & 0xFF).astype(np.intp)]
                ^ t[1][((x >> np.uint32(8)) & np.uint32(0xFF)).astype(np.intp)]
                ^ t[2][((x >> np.uint32(16)) & np.uint32(0xFF)).astype(np.intp)]
                ^ t[3][(x >> np.uint32(24)).astype(np.intp)])


_OPS = _OpCache()


def _make_positional_tables(chunk: int) -> np.ndarray:
    """P[j][v] = S^(chunk-1-j)(table[v]) — contribution of byte v at pos j."""
    tabs = np.zeros((chunk, 256), dtype=np.uint32)
    cur = CRC_TABLE.copy()  # S^0(table[v])
    for j in range(chunk - 1, -1, -1):
        tabs[j] = cur
        # advance by one zero byte for the next (earlier) position
        cur = ((cur.astype(np.uint64) << np.uint64(8)) & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            ^ CRC_TABLE[(cur >> np.uint32(24)).astype(np.intp)]
    return tabs


_POS_TABLES = _make_positional_tables(_CHUNK)


def crc_block(data: bytes | bytearray | np.ndarray, crc: int = INIT) -> int:
    """CRC register after processing `data` starting from register `crc`.

    Bit-identical to :func:`crc_update_bytes`, but vectorized.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    n = buf.size
    if n == 0:
        return crc & 0xFFFFFFFF
    if n <= 2 * _CHUNK:
        return crc_update_bytes(crc, buf)

    pad = (-n) % _CHUNK
    if pad:
        buf = np.concatenate([np.zeros(pad, dtype=np.uint8), buf])
    chunks = buf.reshape(-1, _CHUNK)

    # Leaf: zero-init CRC of each chunk via positional tables.
    acc = _POS_TABLES[0][chunks[:, 0].astype(np.intp)]
    for j in range(1, _CHUNK):
        acc ^= _POS_TABLES[j][chunks[:, j].astype(np.intp)]

    # Tree fold: combine(c_left, c_right) = S^L(c_left) ^ c_right.
    level = 0
    log2_chunk = int(np.log2(_CHUNK))
    while acc.size > 1:
        if acc.size & 1:
            acc = np.concatenate([np.zeros(1, dtype=np.uint32), acc])
        left, right = acc[0::2], acc[1::2]
        acc = _OPS.advance_vec(left, log2_chunk + level) ^ right
        level += 1

    # Contribution of the initial register across the true length n.
    init_part = _OPS.advance_scalar(crc & 0xFFFFFFFF, n)
    return int(acc[0]) ^ init_part


def crc_finalize(register: int) -> int:
    """Stored CRC value = register ^ 0xFFFFFFFF (src/encode.c:1188)."""
    return (register ^ 0xFFFFFFFF) & 0xFFFFFFFF


def crc_of(data: bytes | np.ndarray) -> int:
    """The CRC value bzip2 stores for `data` (init + final xor applied)."""
    return crc_finalize(crc_block(data, INIT))


def combine_crc(combined: int, block_crc_stored: int) -> int:
    """Fold one block's stored CRC into the stream CRC.

    Reference: ``(cc << 1) ^ (cc >> 31) ^ crc ^ -1`` with the *raw
    register* (src/encode.h:38); equivalently rotate-left-1 then xor the
    *stored* (finalized) block CRC, which is the form used here.
    """
    cc = combined & 0xFFFFFFFF
    return (((cc << 1) | (cc >> 31)) ^ block_crc_stored) & 0xFFFFFFFF
