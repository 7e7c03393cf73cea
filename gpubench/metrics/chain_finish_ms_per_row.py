"""Host milliseconds of ``native.chain_finish`` (code assignment and
headers of the device's entropy chain) a row: the chain stages'
``finish_c`` summed over the window's chain batches, over their rows."""

from __future__ import annotations

LAYER = "host C"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "compress_MBps"
BETTER = "lower"


def read(ctx: dict) -> float | None:
    batches = [b for s in ctx["calls"] if s for b in s["batch_trace"]
               if "finish_c" in b.get("chain_stages", {})]
    rows = sum(b["rows"] for b in batches)
    if not rows:
        return None
    return 1e3 * sum(b["chain_stages"]["finish_c"] for b in batches) / rows
