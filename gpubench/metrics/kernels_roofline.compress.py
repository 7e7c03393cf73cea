"""The compress kernels' share of their roofline: the bytes the device
stages of every row the card took must read and write once
(``instrument.compress_spans``) over the card's bandwidth, over the
device time of every kernel the profiler recorded in the window."""

from __future__ import annotations

from gpubench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "compress_MBps"
BETTER = "higher"


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if not tr:
        return None
    return roofline.share_pct(ctx["device_bytes"], tr["kernel_s"],
                              ctx["card"]["kind"])
