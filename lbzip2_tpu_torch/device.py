"""Explicit device resolution and event waits.

There is no automatic choice: ``"cuda"`` without a usable CUDA device
raises, so a run can never silently land on the CPU.  Only the tests
pass ``"cpu"``.
"""

from __future__ import annotations

import contextlib

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


def resolve_all(device) -> list[torch.device]:
    """The devices an engine drives: every visible card for ``"cuda"``
    without an index (as the JAX engine drives ``jax.local_devices()``),
    the one named by ``"cuda:k"`` or ``"cpu"``, or each of a list (a
    test passes several logical CPU devices, or a card twice)."""
    if isinstance(device, (list, tuple)):
        return [resolve(d) for d in device]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve(dev)  # raises without CUDA
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve(dev)]


@contextlib.contextmanager
def on(dev: torch.device, stream: torch.cuda.Stream | None = None):
    """``dev`` the current device and ``stream`` the current stream, on a
    card (nothing on the CPU): the port's kernels launch on the
    runtime's current device, and their wrappers on its current
    stream."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), (torch.cuda.stream(stream) if stream
                                  is not None else contextlib.nullcontext()):
        yield


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
