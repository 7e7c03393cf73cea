"""Sequential spec-exact bzip2 decoder — oracle for all parallel paths.

Mirrors the reference decode stack: stream parsing (src/parse.c:147-271
FSA semantics incl. multi-stream restart and trailing-garbage
tolerance), block retrieval (src/decode.c:519-798: two-level canonical
Huffman decode, deferred bad-tree errors, selector clamping at 18001,
run-length guard), IBWT with legacy derandomization
(src/decode.c:801-930), RLE1 expansion and the CRC/overflow verdicts
(src/expand.c:694-740).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.core.bits import BitReader
from lbzip2_tpu_torch.core.constants import (MAX_BLOCK_SIZE, MAX_CODE_LENGTH,
                                       MAX_TREES, MIN_TREES, Error,
                                       StreamError)

GROUP_SIZE = 50
_SELECTOR_CLAMP = 18001  # reference bounds usable selectors (decode.c:630)

# bzip2 0.9 randomization offsets (format constant; reference
# decode.c:812-848 / bzip2 randtable.c).
RAND_TABLE = np.array([
    619, 720, 127, 481, 931, 816, 813, 233, 566, 247, 985, 724, 205, 454, 863,
    491, 741, 242, 949, 214, 733, 859, 335, 708, 621, 574, 73, 654, 730, 472,
    419, 436, 278, 496, 867, 210, 399, 680, 480, 51, 878, 465, 811, 169, 869,
    675, 611, 697, 867, 561, 862, 687, 507, 283, 482, 129, 807, 591, 733, 623,
    150, 238, 59, 379, 684, 877, 625, 169, 643, 105, 170, 607, 520, 932, 727,
    476, 693, 425, 174, 647, 73, 122, 335, 530, 442, 853, 695, 249, 445, 515,
    909, 545, 703, 919, 874, 474, 882, 500, 594, 612, 641, 801, 220, 162, 819,
    984, 589, 513, 495, 799, 161, 604, 958, 533, 221, 400, 386, 867, 600, 782,
    382, 596, 414, 171, 516, 375, 682, 485, 911, 276, 98, 553, 163, 354, 666,
    933, 424, 341, 533, 870, 227, 730, 475, 186, 263, 647, 537, 686, 600, 224,
    469, 68, 770, 919, 190, 373, 294, 822, 808, 206, 184, 943, 795, 384, 383,
    461, 404, 758, 839, 887, 715, 67, 618, 276, 204, 918, 873, 777, 604, 560,
    951, 160, 578, 722, 79, 804, 96, 409, 713, 940, 652, 934, 970, 447, 318,
    353, 859, 672, 112, 785, 645, 863, 803, 350, 139, 93, 354, 99, 820, 908,
    609, 772, 154, 274, 580, 184, 79, 626, 630, 742, 653, 282, 762, 623, 680,
    81, 927, 626, 789, 125, 411, 521, 938, 300, 821, 78, 343, 175, 128, 250,
    170, 774, 972, 275, 999, 639, 495, 78, 352, 126, 857, 956, 358, 619, 580,
    124, 737, 594, 701, 612, 669, 112, 134, 694, 363, 992, 809, 743, 168, 974,
    944, 375, 748, 52, 600, 747, 642, 182, 862, 81, 344, 805, 988, 739, 511,
    655, 814, 334, 249, 515, 897, 955, 664, 981, 649, 113, 974, 459, 893, 228,
    433, 837, 553, 268, 926, 240, 102, 654, 459, 51, 686, 754, 806, 760, 493,
    403, 415, 394, 687, 700, 946, 670, 656, 610, 738, 392, 760, 799, 887, 653,
    978, 321, 576, 617, 626, 502, 894, 679, 243, 440, 680, 879, 194, 572, 640,
    724, 926, 56, 204, 700, 707, 151, 457, 449, 797, 195, 791, 558, 945, 679,
    297, 59, 87, 824, 713, 663, 412, 693, 342, 606, 134, 108, 571, 364, 631,
    212, 174, 643, 304, 329, 343, 97, 430, 751, 497, 314, 983, 374, 822, 928,
    140, 206, 73, 263, 980, 736, 876, 478, 430, 305, 170, 514, 364, 692, 829,
    82, 855, 953, 676, 246, 369, 970, 294, 750, 807, 827, 150, 790, 288, 923,
    804, 378, 215, 828, 592, 281, 565, 555, 710, 82, 896, 831, 547, 261, 524,
    462, 293, 465, 502, 56, 661, 821, 976, 991, 658, 869, 905, 758, 745, 193,
    768, 550, 608, 933, 378, 286, 215, 979, 792, 961, 61, 688, 793, 644, 986,
    403, 106, 366, 905, 644, 372, 567, 466, 434, 645, 210, 389, 550, 919, 135,
    780, 773, 635, 389, 707, 100, 626, 958, 165, 504, 920, 176, 193, 713, 857,
    265, 203, 50, 668, 108, 645, 990, 626, 197, 510, 357, 358, 850, 858, 364,
    936, 638], dtype=np.int64)
assert RAND_TABLE.size == 512
RAND_THRESH = 617


@dataclass
class DecodedBlock:
    data: np.ndarray  # decoded plain bytes
    crc_stored: int
    crc_computed: int
    end_bit: int  # bit position just past this block's payload


@dataclass
class HuffTree:
    """Canonical decode tables (reference make_tree, decode.c:191-311)."""

    status: Error = Error.OK
    limit: np.ndarray = field(default=None)  # left-justified upper bounds
    base: np.ndarray = field(default=None)
    count: np.ndarray = field(default=None)  # cumulative counts per length
    perm: np.ndarray = field(default=None)


def _make_tree(code_len: np.ndarray, alpha_size: int) -> HuffTree:
    t = HuffTree()
    n = alpha_size
    lens = code_len[:n].astype(np.int64)
    C = np.bincount(lens, minlength=MAX_CODE_LENGTH + 2)
    # Kraft equality check.
    kraft = int(np.sum(C[1:MAX_CODE_LENGTH + 1]
                       << (MAX_CODE_LENGTH - np.arange(1, MAX_CODE_LENGTH + 1))))
    if kraft != (1 << MAX_CODE_LENGTH):
        t.status = (Error.ERR_INCOMPLT if kraft < (1 << MAX_CODE_LENGTH)
                    else Error.ERR_PREFIX)
        return t

    # Left-justified (MAX_CODE_LENGTH-bit) bases per length.
    base = np.zeros(MAX_CODE_LENGTH + 2, dtype=np.int64)
    sofar = 0
    for k in range(1, MAX_CODE_LENGTH + 1):
        base[k] = sofar
        sofar += int(C[k]) << (MAX_CODE_LENGTH - k)
    base[MAX_CODE_LENGTH + 1] = 1 << MAX_CODE_LENGTH  # sentinel

    cum = np.concatenate([[0], np.cumsum(C[1:MAX_CODE_LENGTH + 1])])[:-1]
    count = np.zeros(MAX_CODE_LENGTH + 2, dtype=np.int64)
    count[1:MAX_CODE_LENGTH + 1] = cum

    # Symbol permutation: counting sort by code length, symbol order
    # RUN_A, RUN_B, MTFV 1.., EOB — internal values: we use
    # 256+1=RUNA, 256+2=RUNB, 1..255 MTFV, 0=EOB like the reference.
    syms = np.empty(n, dtype=np.int64)
    syms[0] = 257
    syms[1] = 258
    if n > 2:
        syms[2:n - 1] = np.arange(2, n - 1) - 1
        syms[n - 1] = 0
    order = np.argsort(lens, kind="stable")
    perm = syms[order]

    t.limit = base  # upper bound of codes of length k is base[k+1]
    t.base = base
    t.count = count
    t.perm = perm
    return t


class _BlockDecoder:
    """Decodes one block payload (after the 48-bit magic + 32-bit CRC)."""

    def __init__(self, r: BitReader, bs100k: int):
        self.r = r
        self.bs100k = bs100k

    def decode(self, crc_stored: int) -> DecodedBlock:
        r = self.r
        randomized = r.read(1)
        bwt_idx = r.read(24)

        # Character map.
        big = r.read(16)
        used = []
        for i in range(16):
            if (big >> (15 - i)) & 1:
                small = r.read(16)
                for j in range(16):
                    if (small >> (15 - j)) & 1:
                        used.append(16 * i + j)
        if not used:
            raise StreamError(Error.ERR_BITMAP)
        alpha_size = len(used) + 2

        num_trees = r.read(3)
        if not (MIN_TREES <= num_trees <= MAX_TREES):
            raise StreamError(Error.ERR_TREES)
        num_selectors = r.read(15)
        if num_selectors == 0:
            raise StreamError(Error.ERR_GROUPS)

        selectors = np.empty(num_selectors, dtype=np.int64)
        for g in range(num_selectors):
            try:
                k = r.read_unary(max_run=6)
            except ValueError:
                # 7+ one-bits: no selector can be that large
                raise StreamError(Error.ERR_SELECTOR)
            if k + 1 > num_trees:
                raise StreamError(Error.ERR_SELECTOR)
            selectors[g] = k

        trees = [self._read_tree(alpha_size) for _ in range(num_trees)]

        data, size, crc_ok_bits = self._decode_mtf_stream(
            trees, selectors, alpha_size, used, bwt_idx, randomized)
        return data

    def _read_tree(self, alpha_size: int) -> HuffTree:
        """Delta-coded code lengths with the reference's batched bounds
        check (up to 3 +-1 ops are applied before the [1,20] check —
        transient off-by-one excursions inside a batch are legal)."""
        r = self.r
        length = r.read(5)
        code_len = np.zeros(alpha_size, dtype=np.int64)
        j = 0
        while j < alpha_size:
            ops = 0
            terminated = False
            while ops < 3:
                b = r.read(1)
                if b == 0:
                    terminated = True
                    break
                b2 = r.read(1)
                length += 1 if b2 == 0 else -1
                ops += 1
            if not (1 <= length <= MAX_CODE_LENGTH):
                raise StreamError(Error.ERR_DELTA)
            if terminated:
                code_len[j] = length
                j += 1
        return _make_tree(code_len, alpha_size)


    def _decode_symbol(self, tree: HuffTree) -> int:
        r = self.r
        v = r.peek(MAX_CODE_LENGTH)
        k = 1
        base = tree.base
        while v >= int(base[k + 1]):
            k += 1
        # k is the code length: base[k] <= v < base[k+1] (Kraft equality
        # guarantees coverage of all 20-bit values).
        idx = int(tree.count[k]) + ((v - int(base[k]))
                                    >> (MAX_CODE_LENGTH - k))
        if r.pos + k > r.nbits:
            raise EOFError("bitstream exhausted in prefix code")
        r.skip(k)
        return int(tree.perm[idx])

    def _decode_mtf_stream(self, trees, selectors, alpha_size, used,
                           bwt_idx, randomized):
        r = self.r
        n_used = len(used)
        imtf = list(used)  # inverse-MTF list over actual byte values
        run_char = imtf[0]
        run = 0
        shift = 0
        out = np.empty(MAX_BLOCK_SIZE, dtype=np.uint8)
        size = 0

        # Selector MTF with deferred bad-tree errors (decode.c:311,637).
        tree_mtf = list(range(MAX_TREES))
        ns = min(len(selectors), _SELECTOR_CLAMP)

        eob_seen = False
        for g in range(ns):
            i = int(selectors[g])
            t = tree_mtf[i]
            del tree_mtf[i]
            tree_mtf.insert(0, t)
            tree = trees[t]
            if tree.status is not Error.OK:
                raise StreamError(tree.status)

            for _ in range(GROUP_SIZE):
                s = self._decode_symbol(tree)
                if s == 0:  # EOB
                    if run > MAX_BLOCK_SIZE - size:
                        raise StreamError(Error.ERR_OVERFLOW)
                    out[size:size + run] = run_char
                    size += run
                    eob_seen = True
                    break
                if s >= 256 and run <= MAX_BLOCK_SIZE:  # RUN_A/RUN_B
                    run += (s - 256) << shift
                    shift += 1
                    continue
                if run > MAX_BLOCK_SIZE - size:
                    raise StreamError(Error.ERR_OVERFLOW)
                out[size:size + run] = run_char
                size += run
                # inverse MTF of value s (1..n_used-1; the alphabet size
                # ties the tree's symbol range to the used-byte count)
                run_char = imtf.pop(s)
                imtf.insert(0, run_char)
                run = 1
                shift = 0
            if eob_seen:
                break
        if not eob_seen:
            raise StreamError(Error.ERR_UNTERM)

        if size == 0:
            raise StreamError(Error.ERR_EMPTY)
        if bwt_idx >= size:
            raise StreamError(Error.ERR_BWTIDX)

        block = out[:size]
        plain = ibwt(block, bwt_idx)
        if randomized:
            plain = derandomize(plain)
        if size > self.bs100k * 100000:
            # Block overruns the size declared in the stream header
            # (expand.c:725, overrun.bz2 corpus case).
            raise StreamError(Error.ERR_OVERFLOW)
        expanded, ok = rle1_expand(plain)
        if not ok:
            raise StreamError(Error.ERR_RUNLEN)
        return expanded, size, None

def ibwt(bwt_bytes: np.ndarray, idx: int) -> np.ndarray:
    """Inverse BWT (reference decode(), src/decode.c:852-930).

    ptr[slot] = BWT position whose char is slot-th in the stable
    (char, position) order; chasing from ptr[idx] yields the original
    string.  The chase is sequential by nature; the production path
    (ops.ibwt) parallelizes it by pointer-doubling list ranking."""
    n = bwt_bytes.size
    ptr = np.argsort(bwt_bytes, kind="stable").astype(np.int64)
    out = np.empty(n, dtype=np.uint8)
    cur = int(ptr[idx])
    bw = bwt_bytes
    for k in range(n):
        out[k] = bw[cur]
        cur = int(ptr[cur])
    return out


def derandomize(plain: np.ndarray) -> np.ndarray:
    """XOR-toggle bytes at the legacy randomization offsets."""
    out = plain.copy()
    i = 0
    j = RAND_THRESH
    n = out.size
    while j < n:
        out[j] ^= 1
        i = (i + 1) & 0x1FF
        j += int(RAND_TABLE[i])
    return out


def rle1_expand(data: np.ndarray) -> tuple[np.ndarray, bool]:
    """Undo RLE1; returns (bytes, ok) where ok=False on a missing run
    length (reference emit() ERR_RUNLEN)."""
    from lbzip2_tpu_torch.ref.rle1 import rle1_decode
    return rle1_decode(data)


def decompress(data: bytes | np.ndarray, with_meta: bool = False):
    """Decode a complete (possibly multi-stream) .bz2 byte string.

    Returns the decoded bytes; raises StreamError on malformed input.
    Trailing garbage after a complete stream is ignored, matching the
    reference parser (src/parse.c:160-180).
    """
    buf = bytes(data) if not isinstance(data, bytes) else data
    if len(buf) < 4 or buf[0:3] != b"BZh" or not (0x31 <= buf[3] <= 0x39):
        raise StreamError(Error.ERR_MAGIC)

    out_parts = []
    r = BitReader(buf)
    r.skip(24)
    level = r.read(8) - 0x30
    combined = 0
    blocks = 0

    while True:
        try:
            magic = r.read(48)
        except EOFError:
            raise StreamError(Error.ERR_EOF)
        if magic == 0x314159265359:
            try:
                crc_stored = r.read(32)
                dec = _BlockDecoder(r, level)
                plain = dec.decode(crc_stored)
            except EOFError:
                raise StreamError(Error.ERR_EOF)
            if crc32.crc_of(plain) != crc_stored:
                raise StreamError(Error.ERR_BLKCRC)
            out_parts.append(plain)
            combined = crc32.combine_crc(combined, crc_stored)
            blocks += 1
            continue
        if magic == 0x177245385090:
            try:
                stored = r.read(32)
            except EOFError:
                raise StreamError(Error.ERR_EOF)
            if stored != combined:
                raise StreamError(Error.ERR_STRMCRC)
            # Possible next stream (byte-aligned), else ignore garbage.
            r.align_byte()
            if r.remaining() >= 32:
                hdr = r.peek(32)
                if (hdr >> 8) == 0x425A68 and 0x31 <= (hdr & 0xFF) <= 0x39:
                    r.skip(32)
                    level = (hdr & 0xFF) - 0x30
                    combined = 0
                    continue
            break
        raise StreamError(Error.ERR_HEADER)

    result = (b"".join(p.tobytes() for p in out_parts)
              if out_parts else b"")
    return result
