"""The chip's peaks and the bytes bound of the device stages.

The bound reads the same work whatever kernels implement it: for each
block the card handled, the bytes its device stages must read and write
once (compress: the block's n input bytes and its device output, the
packed payload in chain mode or the run tokens in token mode;
decompress: the block's Huffman payload and its n output bytes), over the
card's memory bandwidth.  Divided by the device time of every kernel the
profiler recorded, it is the kernels' share of their roofline; it counts
no operations, since these stages are bound by bytes.
"""

from __future__ import annotations

# Published peaks, NVIDIA's data sheet, SXM part, at the full power limit
# of 700 W, keyed by torch.cuda.get_device_name().
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def bound_s(nbytes: int, kind: str) -> float | None:
    """Least seconds the card ``kind`` takes to move ``nbytes`` once;
    None for a card the table lacks."""
    peak = PEAKS.get(kind)
    return nbytes / peak["hbm_bytes_per_s"] if peak else None


def share_pct(nbytes: int, kernel_s: float, kind: str) -> float | None:
    """The bound over the kernels' device time, in %; None where there is
    nothing to read (no bytes, no kernel time, an unknown card)."""
    b = bound_s(nbytes, kind)
    if b is None or nbytes <= 0 or kernel_s <= 0:
        return None
    return 100.0 * b / kernel_s
