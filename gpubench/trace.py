"""What a traced run reads from ``torch.profiler``: the device's busy
seconds (the union of its intervals, copied from ``chip_smoke.py``'s
``device_busy``), the kernels' summed device time, the device operations
that took most time, and the device's idle gaps by what the host was
doing (the spans ``instrument`` records by the host's clock, placed on
the profiler's timeline by the window's start, which both clocks mark).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

# a gap shorter than this is a launch gap, counted but not labelled
SHORT_GAP_US = 50.0
WINDOW_SPAN = "gpubench:window"
TOP = 10


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@contextlib.contextmanager
def profiled(enabled: bool, rec):
    """A ``torch.profiler`` of the host and the card over the block, or
    nothing; yields the profiler or None.  ``rec.window`` gets the
    block's start and end by ``time.perf_counter()``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            rec.window = (t0, time.perf_counter())


def _merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(g0: float, g1: float, spans: dict) -> str:
    """The span that covers most of the gap [g0, g1): an engine or
    decoder span first, then a host worker's, then the harness's own
    call."""
    for prefix in (("engine.", "decode."), ("host.",), ("call",)):
        best, best_ov = None, 0.0
        for name, (s, e) in spans.items():
            if not name.startswith(prefix):
                continue
            ov = np.clip(np.minimum(e, g1) - np.maximum(s, g0), 0, None)
            tot = float(ov.max()) if ov.size else 0.0
            if tot > best_ov:
                best, best_ov = name, tot
        if best is not None:
            return best
    return "no span open"


def summarize(prof, rec) -> dict:
    """busy_s, kernel_s, the traced window's seconds (window_s) and the
    breakdown of a profile taken by ``profiled``, with the host spans of
    ``rec`` (an ``instrument.Recorder``)."""
    from torch.autograd import DeviceType

    dev: list[tuple[float, float]] = []
    ops: dict[str, float] = {}
    window = None
    kernel_us = 0.0
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b))
            ops[e.name] = ops.get(e.name, 0.0) + (b - a) / 1e6
            if _is_kernel(e.name):
                kernel_us += b - a
        elif e.name == WINDOW_SPAN:
            window = (a, b)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN} span")
    merged = [(max(a, window[0]), min(b, window[1])) for a, b in _merge(dev)
              if b > window[0] and a < window[1]]
    busy_us = sum(b - a for a, b in merged)
    spans: dict[str, list] = {}
    h0 = rec.window[0]
    for name, a, b in rec.spans:  # host seconds -> profiler microseconds
        spans.setdefault(name, []).append(
            (window[0] + (a - h0) * 1e6, window[0] + (b - h0) * 1e6))
    arrays = {k: (np.array([s for s, _ in v]), np.array([e for _, e in v]))
              for k, v in spans.items()}
    edges = [window[0]] + [x for ab in merged for x in ab] + [window[1]]
    gaps: dict[str, float] = {}
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        name = "launch gaps" if g1 - g0 < SHORT_GAP_US else \
            _label(g0, g1, arrays)
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "kernel_s": kernel_us / 1e6,
            "window_s": (window[1] - window[0]) / 1e6,
            "device_intervals": len(dev),
            "breakdown": {"device_ops": [[k[:96], v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}
