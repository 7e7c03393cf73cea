"""Device milliseconds of the token BWT a row, from the port's spans
(``last_stats["trace"]``): Σ ``bwt_device_us`` (two timing events on
the batch's stream around ``bwt2_tokens``, read by the fetch thread once
the batch is done: the stream's wall from the BWT's first kernel to its
last, launch gaps included) / 1000 / Σ ``rows`` of the
``engine.dispatch`` spans that carry it.  Token mode on a card only: in
chain mode the fetch thread queues the previous batch's chain on the
same stream, so no such bracket times the BWT alone."""

from __future__ import annotations

LAYER = "kernels"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "compress_MBps"
BETTER = "lower"


def _spans(ctx: dict):
    """Every span of the window's traced calls."""
    for s in ctx["calls"]:
        tr = s.get("trace") if s else None
        if tr:
            yield from tr["spans"]


def read(ctx: dict) -> float | None:
    us = rows = 0
    for sp in _spans(ctx):
        if sp["name"] == "engine.dispatch" and "bwt_device_us" in sp:
            us += sp["bwt_device_us"]
            rows += sp["rows"]
    return us / 1e3 / rows if rows else None
