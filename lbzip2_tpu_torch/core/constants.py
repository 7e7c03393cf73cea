"""bzip2 format constants and error taxonomy.

Spec source: reference src/common.h:42-78 (constant values are format
facts, not code).  All values are fixed by the bzip2 file format.
"""

from __future__ import annotations

import enum

# Alphabet: 2 run symbols (RUNA/RUNB), up to 255 MTF values, 1 EOB symbol.
MIN_ALPHA_SIZE = 2 + 0 + 1
MAX_ALPHA_SIZE = 2 + 255 + 1

MIN_TREES = 2
MAX_TREES = 6
GROUP_SIZE = 50
MIN_CODE_LENGTH = 1
MAX_CODE_LENGTH = 20
MAX_BLOCK_SIZE = 900_000
MAX_GROUPS = (MAX_BLOCK_SIZE + GROUP_SIZE - 1) // GROUP_SIZE
MAX_SELECTORS = 32767

# Decoders must tolerate (and clamp) selector counts above the number that
# can actually be used; 18002 = ceil(900000/50) + 1 padding selector.
MAX_USEFUL_SELECTORS = MAX_GROUPS + 1

# RLE1: runs of length 4..259 are coded as 4 literals + a length byte.
MAX_RUN_LENGTH = 4 + 255

# Stream framing.
STREAM_MAGIC_1 = 0x42  # 'B'
STREAM_MAGIC_2 = 0x5A  # 'Z'
STREAM_MAGIC_3 = 0x68  # 'h'
BLOCK_MAGIC = 0x314159265359  # 48-bit block header magic (pi)
EOS_MAGIC = 0x177245385090  # 48-bit end-of-stream magic (sqrt(pi))
HEADER_SIZE = 4
TRAILER_SIZE = 10

# Encoder tuning (reference src/encode.h:22).
CLUSTER_FACTOR = 8

# Threshold above which a block may use the "randomized" legacy mode
# (never produced by encoders since bzip2 0.9.5, but must be decoded).
RAND_THRESH = 617


class Error(enum.Enum):
    """Codec status/error taxonomy (reference src/common.h:55-76)."""

    OK = 0  # no error
    MORE = 1  # more input/output space needed (continuation)
    FINISH = 2  # stream finished

    ERR_MAGIC = 3  # bad stream header magic
    ERR_HEADER = 4  # bad block header magic
    ERR_BITMAP = 5  # empty source alphabet
    ERR_TREES = 6  # bad number of trees
    ERR_GROUPS = 7  # no coding groups
    ERR_SELECTOR = 8  # invalid selector
    ERR_DELTA = 9  # invalid delta code
    ERR_PREFIX = 10  # invalid prefix code
    ERR_INCOMPLT = 11  # incomplete prefix code
    ERR_EMPTY = 12  # empty block
    ERR_UNTERM = 13  # unterminated block
    ERR_RUNLEN = 14  # missing run length
    ERR_BLKCRC = 15  # block CRC mismatch
    ERR_STRMCRC = 16  # stream CRC mismatch
    ERR_OVERFLOW = 17  # block overflow
    ERR_BWTIDX = 18  # primary index too large
    ERR_EOF = 19  # unexpected end of file


class StreamError(Exception):
    """Raised by codec layers on malformed streams."""

    def __init__(self, code: Error, message: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {message}" if message else code.name)


#: Human-readable messages matching the reference CLI wording exactly
#: (src/expand.c:69-93 err2str).
ERROR_MESSAGES = {
    Error.ERR_MAGIC: "bad stream header magic",
    Error.ERR_HEADER: "bad block header magic",
    Error.ERR_BITMAP: "empty source alphabet",
    Error.ERR_TREES: "bad number of trees",
    Error.ERR_GROUPS: "no coding groups",
    Error.ERR_SELECTOR: "invalid selector",
    Error.ERR_DELTA: "invalid delta code",
    Error.ERR_PREFIX: "invalid prefix code",
    Error.ERR_INCOMPLT: "incomplete prefix code",
    Error.ERR_EMPTY: "empty block",
    Error.ERR_UNTERM: "unterminated block",
    Error.ERR_RUNLEN: "missing run length",
    Error.ERR_BLKCRC: "block CRC mismatch",
    Error.ERR_STRMCRC: "stream CRC mismatch",
    Error.ERR_OVERFLOW: "block overflow",
    Error.ERR_BWTIDX: "primary index too large",
    Error.ERR_EOF: "unexpected end of file",
}
