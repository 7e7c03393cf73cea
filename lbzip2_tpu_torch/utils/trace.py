"""The port's tracer: the spans and counters of one library call, kept in
memory.

A call of ``codec.encoder.compress`` (or ``compress_blocks_hybrid``),
``parallel.decode.decompress_parallel`` or ``decompress_stream`` asks
``begin()`` once, at its start, for a tracer.  It gets one while the
environment sets ``LBZIP2_TPU_TRACE`` (to anything but "" or "0") or a
``torch.profiler`` is recording, and None otherwise; every site then
checks only that None, so a call traced off reads no clock and makes no
span.  A traced call leaves ``Tracer.result()`` in its module's
``last_stats["trace"]`` (None when off):

    {"clock": "perf_counter_ns", "call": <id>, "spans": [...],
     "counters": {name: int}}

Each span is a dict: ``name``, ``thread`` (its thread's name), ``t0`` and
``t1`` by ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux, the clock
``time.perf_counter()`` reads), ``call`` (the id every span of the call
shares), and where it has them ``batch`` or ``block`` (the id it works
on), ``cpu_ns`` (the thread's CPU time inside the span) and integer
attributes such as ``rows``.  A span is appended when it closes.

The tracer opens no ``record_function`` and no NVTX range: a range
opened around kernel launches adds device-side annotation events to a
profile, which a reader of the card's busy time would count as work.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

import torch

ENV = "LBZIP2_TPU_TRACE"
CLOCK = "perf_counter_ns"
_CALLS = itertools.count(1)


def begin() -> Tracer | None:
    """A tracer for one call while ``LBZIP2_TPU_TRACE`` is set or a
    profiler records, else None."""
    on = os.environ.get(ENV, "") not in ("", "0") or \
        torch._C._autograd._profiler_enabled()
    return Tracer() if on else None


class Tracer:
    """Spans and counters of one call.  Every thread of the call appends
    to one list (``list.append`` is atomic); counters take a lock."""

    def __init__(self):
        self.call = next(_CALLS)
        self.spans: list[dict] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def open(self, name: str, cpu: bool = False, **attrs) -> dict:
        """A span ``name`` starting now on the calling thread; ``cpu``
        also reads the thread's CPU clock.  ``attrs``: the batch or block
        id and integer attributes."""
        sp = {"name": name, "thread": threading.current_thread().name,
              "call": self.call, **attrs, "t0": time.perf_counter_ns()}
        if cpu:  # read inside the wall's reads: CPU <= wall
            sp["cpu_ns"] = time.thread_time_ns()
        return sp

    def close(self, sp: dict, **attrs) -> None:
        """End ``sp`` now, add ``attrs`` and keep it."""
        if "cpu_ns" in sp:
            sp["cpu_ns"] = time.thread_time_ns() - sp["cpu_ns"]
        sp["t1"] = time.perf_counter_ns()
        sp.update(attrs)
        self.spans.append(sp)

    def add(self, name: str, t0: int, t1: int) -> None:
        """Keep a span the caller timed by ``time.perf_counter_ns()``."""
        self.spans.append({"name": name,
                           "thread": threading.current_thread().name,
                           "call": self.call, "t0": t0, "t1": t1})

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def result(self) -> dict:
        return {"clock": CLOCK, "call": self.call, "spans": self.spans,
                "counters": self.counters}


def timed(tr: Tracer | None, name: str, fn, *args):
    """``fn(*args)``, inside a span ``name`` when ``tr`` is a tracer."""
    if tr is None:
        return fn(*args)
    sp = tr.open(name)
    try:
        return fn(*args)
    finally:
        tr.close(sp)
