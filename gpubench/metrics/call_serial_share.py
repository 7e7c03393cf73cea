"""The share of the compress calls that the engine's pool does not
cover, from the port's spans (``last_stats["trace"]``): Σ
(``compress.call`` − ``compress.run``) / Σ ``compress.call`` over the
window's traced calls.  The rest is the call's serial head (the input's
copy, RLE1 and the blocks' list: ``compress.collect``) and tail (the
stream's assembly: ``compress.assemble``), while no engine thread
runs."""

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
    wall = {"compress.call": 0, "compress.run": 0}
    for sp in _spans(ctx):
        if sp["name"] in wall:
            wall[sp["name"]] += sp["t1"] - sp["t0"]
    call = wall["compress.call"]
    return (call - wall["compress.run"]) / call if call else None
