"""Device state of the single-pass scans with decoupled look-back
(``csrc/rle2.cu``, ``csrc/pack_groups.cu`` in both modes, the token scan
of ``csrc/bwt2_emit.cu``, ``csrc/bitpack.cu``) and of the CRC's last-CTA
fold (``csrc/crc32.cu``: its CTAs' slots and ticket), held per calling
thread and device.

Each kernel publishes a descriptor a tile whose status word carries the
call's epoch, so a call never takes an earlier call's descriptor for its
own and the descriptors need no reset; its counters (the ticket, the RLE2's
row histograms) are left 0 by every call, so they are zeroed once, when
made.  Both buffers are kept from call to call and only ever grown: a call
allocates nothing and reads nothing on the host.
"""

from __future__ import annotations

import threading

import torch

# a status word holds epoch << 2 | kind in 31 bits
MAX_EPOCH = 2 ** 29 - 1

_held = threading.local()


def scratch(name: str, dev: torch.device, desc_words: int,
            state_ints: int, desc_dtype=torch.int32):
    """(desc, state, epoch) of kernel ``name`` on ``dev`` for the calling
    thread: at least ``desc_words`` descriptor words of ``desc_dtype`` and
    ``state_ints`` int32 counters (0 between calls), and this call's
    epoch (1 .. MAX_EPOCH, one more than the last call's).  No call waits
    for its kernels: work queued on one stream is ordered before the next
    call's on the same stream, and a call on another stream first makes
    that stream wait for the last one's work."""
    mine = _held.__dict__.setdefault("buffers", {})  # (name, dev) -> dict
    stream = torch.cuda.current_stream(dev)
    held = mine.get((name, dev))
    if held is not None and held["stream"] != stream:
        stream.wait_stream(held["stream"])
        for buf in (held["desc"], held["state"]):
            buf.record_stream(stream)
        held["stream"] = stream
    if held is None:
        held = mine[(name, dev)] = {"stream": stream, "epoch": 0,
                                    "desc": None, "state": None}
    if held["desc"] is None or held["desc"].numel() < desc_words:
        held["desc"] = torch.zeros(max(desc_words, 1), dtype=desc_dtype,
                                   device=dev)
    if held["state"] is None or held["state"].numel() < state_ints:
        held["state"] = torch.zeros(max(state_ints, 1), dtype=torch.int32,
                                    device=dev)
    held["epoch"] += 1
    if held["epoch"] > MAX_EPOCH:  # a status word could repeat: start over
        held["desc"].zero_()
        held["epoch"] = 1
    return held["desc"], held["state"], held["epoch"]
