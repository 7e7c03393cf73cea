"""The median claim-to-delivery seconds of the engine's device batches
over the window (``last_stats["batch_trace"][*]["claim_s"]``: from the
claim, through prep, dispatch and queueing, to the fetch's delivery)."""

from __future__ import annotations

import statistics

LAYER = "engine"
UNIT = "s"
SOURCE = "program_span"
MOVES = "compress_MBps"
BETTER = "lower"


def read(ctx: dict) -> float | None:
    claims = [b["claim_s"] for s in ctx["calls"] if s
              for b in s["batch_trace"] if "claim_s" in b]
    return statistics.median(claims) if claims else None
