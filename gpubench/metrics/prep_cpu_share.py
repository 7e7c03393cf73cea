"""How much of the batch preparation is the dispatch thread's own
computing, from the port's spans (``last_stats["trace"]``): Σ the
thread's CPU time inside ``engine.prep`` (``cpu_ns``) / Σ its wall,
over the window's traced calls.  Below 1, the thread waited for a core
(descheduled among the pool's threads) or on a lock."""

from __future__ import annotations

LAYER = "host C"
UNIT = "share"
SOURCE = "program_span"
MOVES = "compress_MBps"
BETTER = "higher"


def _spans(ctx: dict):
    """Every span of the window's traced calls."""
    for s in ctx["calls"]:
        tr = s.get("trace") if s else None
        if tr:
            yield from tr["spans"]


def read(ctx: dict) -> float | None:
    cpu = wall = 0
    for sp in _spans(ctx):
        if sp["name"] == "engine.prep":
            cpu += sp["cpu_ns"]
            wall += sp["t1"] - sp["t0"]
    return cpu / wall if wall else None
