"""The share of the host workers' lives spent waiting for work, from the
port's spans (``last_stats["trace"]``): Σ ``host.wait`` (the blocking
get on the entropy queue, when nothing else is ready) / Σ ``host.life``
(each worker from entry to exit) over the window's traced calls."""

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
    wall = {"host.wait": 0, "host.life": 0}
    for sp in _spans(ctx):
        if sp["name"] in wall:
            wall[sp["name"]] += sp["t1"] - sp["t0"]
    life = wall["host.life"]
    return wall["host.wait"] / life if life else None
