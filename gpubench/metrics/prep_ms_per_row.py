"""Host milliseconds of a device row's preparation (RLE1'd block through
``native.lyndon_prep`` into the batch): the engine's ``prep_s`` summed
over the window's batches, over their rows."""

from __future__ import annotations

LAYER = "host C"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "compress_MBps"
BETTER = "lower"


def read(ctx: dict) -> float | None:
    batches = [b for s in ctx["calls"] if s for b in s["batch_trace"]]
    rows = sum(b["rows"] for b in batches)
    return 1e3 * sum(b["prep_s"] for b in batches) / rows if rows else None
