"""Live rows a flush of the decoder's IBWT batcher carries
(``last_stats``: ``ibwt_rows`` over ``ibwt_flushes``, summed over every
decompress call of the window)."""

from __future__ import annotations

LAYER = "decode batcher"
UNIT = "rows"
SOURCE = "program_counter"
MOVES = "decompress_MBps"
BETTER = "higher"


def read(ctx: dict) -> float | None:
    rows = sum(s.get("ibwt_rows", 0) for s in ctx["calls"] if s)
    flushes = sum(s.get("ibwt_flushes", 0) for s in ctx["calls"] if s)
    return rows / flushes if flushes else None
