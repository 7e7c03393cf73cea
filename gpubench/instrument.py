"""Spans and byte counts a traced run records around the calls into the
port's layers, from the benchmark's own code: each wrapper records a
span ``<layer>.<step>`` by the host's clock, on whatever thread of the
port calls it, and, where the roofline needs it, counts the bytes the
device stages of a batch read and wrote.  The wrappers are installed for
the traced window only; an untraced run runs the port as it is.

The calls wrapped are the port's entry points into each layer
(``codec/encoder.py``: the batch build, the BWT dispatch, the entropy
chain, the token fetch, the host workers' block and entropy encode;
``parallel/decode.py``: the Huffman stage, the IBWT flush, RLE1).  A
byte count checks the layout of what it reads, by the wrapped function's
parameter names and the sizes it must agree with; a check that fails is
a fault in the recorder, and the traced run then prints no result
(``run.py``).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time


class Recorder:
    """The spans and the device stages' bytes of a traced window, and the
    layout checks that failed (``faults``)."""

    def __init__(self):
        self.in_bytes = 0    # bytes of the rows dispatched to the card
        self.out_bytes = 0   # the device stages' output of those rows
        # (name, start, end) by time.perf_counter(); list.append is
        # atomic, so every thread appends without a lock
        self.spans: list[tuple[str, float, float]] = []
        self.window = (0.0, 0.0)  # the traced window, set by trace.py
        self.faults: list[str] = []

    @property
    def device_bytes(self) -> int:
        return self.in_bytes + self.out_bytes


class LayoutError(Exception):
    """A wrapped call's arguments or result no longer have the layout
    the byte count reads."""


def span(rec: Recorder, name: str, fn, after=None):
    """``fn`` inside a span ``name``; ``after(arguments, result)`` runs
    on its result, with the call's arguments bound to ``fn``'s parameter
    names.  An ``after`` that fails records a fault in ``rec`` and never
    reaches the port."""
    sig = inspect.signature(fn) if after is not None else None

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        finally:
            rec.spans.append((name, t0, time.perf_counter()))
        if after is not None:
            try:
                after(sig.bind(*args, **kwargs).arguments, out)
            except Exception as e:  # noqa: BLE001 — the run fails, not the port
                rec.faults.append(f"{name}: {type(e).__name__}: {e}")
        return out
    return wrapped


@contextlib.contextmanager
def _patched(rec: Recorder, targets: list):
    """Wrap each (owner, attribute, span name, after) in a span for the
    block, then restore it."""
    saved = [(o, a, getattr(o, a)) for o, a, _, _ in targets]
    try:
        for o, a, name, after in targets:
            setattr(o, a, span(rec, name, getattr(o, a), after))
        yield
    finally:
        for o, a, v in saved:
            setattr(o, a, v)


def _rows_built(out) -> list[int]:
    """The row lengths of a batch ``_build_batch`` returned, checked: it
    is (ids, spans, batch, ns, ...), one span, one batch row and one n a
    row, each n its span's length."""
    ids, spans, batch, ns = out[0], out[1], out[2], out[3]
    sizes = [int(s.data.size) for s in spans]
    if not (len(ids) == len(sizes) == batch.shape[0] == len(ns)) or \
            [int(n) for n in ns] != sizes:
        raise LayoutError("_build_batch no longer returns (ids, spans, "
                          "batch, ns, ...) with ns the spans' lengths")
    return sizes


def _token_bytes(spans, outs) -> int:
    """The bytes a token batch wrote, checked: ``outs`` starts (tokens
    (rows, W) int32 of two u16 tokens each, raw, run counts (rows,)); a
    row over the capacity of 2 W tokens downloads its n raw bytes."""
    tok, counts = outs[0], outs[2]
    if tok.ndim != 2 or tok.shape[0] != len(spans) or \
            tuple(counts.shape) != (len(spans),):
        raise LayoutError("_fetch_tokens' outs no longer start (tokens, "
                          "raw, run counts) a row each")
    cap = tok.shape[1] * 2
    return sum(2 * c if c <= cap else int(s.data.size)
               for c, s in zip(counts.numpy().tolist(), spans))


def _payload_bytes(ns, out) -> int:
    """The bytes of the payloads ``chain_payloads`` returned, checked:
    one bytes or None (a pack overflow) a row of ``ns``."""
    if len(out) != len(ns) or \
            not all(p is None or isinstance(p, bytes) for p in out):
        raise LayoutError("chain_payloads no longer returns a payload or "
                          "None a row")
    return sum(len(p) for p in out if p is not None)


def compress_spans(encoder, rec: Recorder):
    """The compress engine's spans, and the roofline's bytes: each
    dispatched batch's rows in; each chain's payloads, or each token
    batch's tokens (a row past the token capacity: its raw bytes), out."""
    pool = encoder._TorchPool

    def built(a, out):
        if out is not None:
            rec.in_bytes += sum(_rows_built(out))

    def payloads(a, out):
        rec.out_bytes += _payload_bytes(a["ns"], out)

    def tokens(a, out):
        rec.out_bytes += _token_bytes(a["spans"], a["outs"])

    return _patched(rec, [
        (pool, "_build_batch", "engine.prep", built),
        (pool, "_fetch_tokens", "engine.fetch_tokens", tokens),
        (encoder, "bwt2_bytes", "engine.dispatch", None),
        (encoder, "bwt2_tokens", "engine.dispatch", None),
        (encoder, "chain_payloads", "engine.chain", payloads),
        (encoder, "_host_block", "host.block", None),
        (encoder, "_entropy_payload", "host.entropy", None),
    ])


def decompress_spans(decode, rec: Recorder):
    """The decoder's spans; its roofline bytes come from the streams and
    the files, not from here."""
    return _patched(rec, [
        (decode, "decode_block_device", "decode.huffman", None),
        (decode._DeviceIbwtBatcher, "_ibwt", "decode.ibwt", None),
        (decode, "rle1_decode", "decode.rle1", None),
    ])
