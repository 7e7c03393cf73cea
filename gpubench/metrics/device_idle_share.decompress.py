"""The card's idle share over the decompress window: 1 - busy / wall,
the busy seconds the union of its intervals in the profiler's trace."""

from __future__ import annotations

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "decompress_MBps"
BETTER = "lower"


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if not tr or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
