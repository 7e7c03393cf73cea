"""Tracing (reference Trace() analogue, src/common.h:30-35).

Enabled by LBZIP2_TPU_TRACE=1; every scheduler/task transition logs a
timestamped line to stderr, like the reference's ENABLE_TRACING build.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_ENABLED = os.environ.get("LBZIP2_TPU_TRACE", "") not in ("", "0")
_t0 = time.time()
_lock = threading.Lock()


def trace_enabled() -> bool:
    return _ENABLED


def trace(fmt: str, *args) -> None:
    if not _ENABLED:
        return
    msg = fmt % args if args else fmt
    with _lock:
        sys.stderr.write(
            f"[trace {time.time() - _t0:9.4f} "
            f"{threading.current_thread().name}] {msg}\n")
