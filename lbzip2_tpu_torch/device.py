"""Explicit device resolution and event waits.

There is no automatic choice: ``"cuda"`` without a usable CUDA device
raises, so a run can never silently land on the CPU.  Only the tests
pass ``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device) -> torch.device:
    """torch.device for ``device``; raises if it names CUDA and there
    is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``dev``.  To CUDA through a pinned buffer,
    without blocking the host (the copy is ordered on the current
    stream)."""
    t = torch.from_numpy(np.require(x, requirements="CW"))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a device-to-host copy of ``t`` into pinned memory on the
    current stream, without blocking (``t`` itself on the CPU).  Read
    the result only after an event recorded behind the copy is done."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def record_event(dev: torch.device) -> torch.cuda.Event | None:
    """Blocking event recorded on the current stream of a CUDA device
    (None on the CPU, where every op has already run)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(blocking=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def wait_event(ev: torch.cuda.Event | None) -> None:
    """Block the calling thread until ``ev`` is done.  ``record_event``
    makes blocking events, so the wait sleeps in the CUDA runtime and
    spins no core, and it returns when the work does: there is no
    polling interval to tune.  The thread holds the GIL no longer than
    the call into the runtime takes; the caller holds no lock."""
    if ev is not None:
        ev.synchronize()
