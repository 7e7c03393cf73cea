"""The card's share of the blocks of the window's files: the engine's
``last_stats`` counts, device blocks over device and host blocks, summed
over every compress call of the window."""

from __future__ import annotations

LAYER = "engine"
UNIT = "share"
SOURCE = "program_counter"
MOVES = "compress_MBps"
BETTER = "higher"


def read(ctx: dict) -> float | None:
    dev = sum(s["device_blocks"] for s in ctx["calls"] if s)
    host = sum(s["host_blocks"] for s in ctx["calls"] if s)
    return dev / (dev + host) if dev + host else None
