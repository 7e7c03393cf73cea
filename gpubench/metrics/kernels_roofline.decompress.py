"""The decompress kernels' share of their roofline: each stream's Huffman
payload and its blocks' n bytes, for every call of the window, over the
card's bandwidth, over the device time of every kernel the profiler
recorded in the window."""

from __future__ import annotations

from gpubench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decompress_MBps"
BETTER = "higher"


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if not tr:
        return None
    return roofline.share_pct(ctx["device_bytes"], tr["kernel_s"],
                              ctx["card"]["kind"])
