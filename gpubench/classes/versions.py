"""Successive versions of a base text, after the pseudo-real construction
of the Pizza&Chili repetitive corpus (``sources.0001.2``).  The base is
the text class the corpus hands in, so a version is as long as that
text; the traffic file says where that length departs from the source's.

Version 1 is the base with its bytes changed, and version k + 1 is
version k with its bytes changed: each byte is replaced, with
probability ``mutation_rate``, by another byte drawn uniformly from the
base's distinct bytes.  The versions follow one another until the
class's share of the file is full.  Each version draws a binomial count
of changes, their positions (distinct) and their bytes, so the work is
a copy of the base a version.

The traffic file's ``versions`` group gives ``mutation_rate``.
"""

from __future__ import annotations

import numpy as np


def make(traffic: dict, rng: np.random.Generator, text: bytes,
         nbytes: int) -> bytes:
    """``nbytes`` bytes of successive versions of ``text``, drawn from
    ``rng``."""
    rate = float(traffic["versions"]["mutation_rate"])
    base = np.frombuffer(text, np.uint8)
    alphabet = np.unique(base)
    n = base.size
    count = -(-nbytes // n)
    out = np.empty((count, n), np.uint8)
    prev = base
    for k in range(count):
        out[k] = prev
        pos = rng.choice(n, rng.binomial(n, rate), replace=False)
        # another byte of the alphabet: draw among the others, skipping
        # the one there now
        now = np.searchsorted(alphabet, out[k, pos])
        pick = rng.integers(0, alphabet.size - 1, pos.size)
        out[k, pos] = alphabet[pick + (pick >= now)]
        prev = out[k]
    return out.reshape(-1)[:nbytes].tobytes()
