"""The share of the engine's dispatch thread spent preparing batches,
from the port's spans (``last_stats["trace"]``): Σ ``engine.prep``
(``_build_batch``: the claimed blocks through ``native.lyndon_prep``
into the batch) / Σ ``engine.dispatch_life`` (the thread from entry to
exit) over the window's traced calls; the rest is its waits and its
dispatches."""

from __future__ import annotations

LAYER = "engine"
UNIT = "share"
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
    wall = {"engine.prep": 0, "engine.dispatch_life": 0}
    for sp in _spans(ctx):
        if sp["name"] in wall:
            wall[sp["name"]] += sp["t1"] - sp["t0"]
    life = wall["engine.dispatch_life"]
    return wall["engine.prep"] / life if life else None
