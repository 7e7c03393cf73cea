"""The share of the rows the card was given whose work was thrown away:
the engine's ``last_stats["stale_rows"]`` (rows a host worker had
already delivered, in delivered batches and in batches the fetch thread
skipped whole) over the rows of every ``engine.prep`` span (every row
dispatched), summed over the window's traced calls."""

from __future__ import annotations

LAYER = "engine"
UNIT = "share"
SOURCE = "program_counter"
MOVES = "compress_MBps"
BETTER = "lower"


def read(ctx: dict) -> float | None:
    stale = rows = 0
    for s in ctx["calls"]:
        tr = s.get("trace") if s else None
        if not tr:
            continue
        stale += s["stale_rows"]
        rows += sum(sp["rows"] for sp in tr["spans"]
                    if sp["name"] == "engine.prep")
    return stale / rows if rows else None
