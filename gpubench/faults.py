"""Faults planted under a run's timed path, for the tests: each stands a
broken call in for the loop's (``run.main(..., call_wrapper=...)``), and
the run must come out with ``correct`` false.

- ``unchanged``: the call returns its input as it stands (the file for a
  compress, the stream for a decompress): a step that returns its state
  unchanged;
- ``half``: the call leaves out half of its work (a compress of the
  file's first half; a decompress's first half of the output);
- ``altered``: one bit of the answer flipped where it is produced.

The cells run on one card, so no fault leaves out an exchange between
cards.
"""

from __future__ import annotations


def _flip(b: bytes) -> bytes:
    out = bytearray(b)
    out[len(out) // 2] ^= 0x10
    return bytes(out)


def unchanged(loop, call):
    if hasattr(loop, "streams"):
        return lambda k: loop.streams[k]
    return lambda k: loop.files[k].data


def half(loop, call):
    if hasattr(loop, "streams"):
        return lambda k: (lambda out: out[:len(out) // 2])(call(k))
    return lambda k: loop.encoder.compress(
        loop.files[k].data[:len(loop.files[k].data) // 2], loop.level,
        device=loop.device)


def altered(loop, call):
    return lambda k: _flip(call(k))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
