"""MTF + RLE2 (zero-run-length) coding of the BWT output.

Spec source: reference src/encode.c:340-425 (make_map_e, do_mtf).

Symbol space after this stage ("MTF values"):
  0 = RUNA, 1 = RUNB           (bijective base-2 digits of zero-run lengths)
  2..ninuse = MTF rank r coded as r+1
  ninuse+1 = EOB
"""

from __future__ import annotations

import numpy as np


def make_cmap(inuse: np.ndarray) -> np.ndarray:
    """Map byte value -> compact symbol index (src/encode.c:340-355)."""
    return np.cumsum(inuse) - inuse.astype(np.int64)


def zero_run_digits(k: int) -> list[int]:
    """Bijective base-2 digits (LSB first) of a zero-run of length k:
    the reference's ``mtfv = --k & 1; k >>= 1`` loop."""
    out = []
    while k:
        k -= 1
        out.append(k & 1)
        k >>= 1
    return out


def mtf_rle2(bwt: np.ndarray, cmap: np.ndarray, ninuse: int) -> np.ndarray:
    """MTF + zero-run encode the BWT byte sequence.

    Returns the MTF value array (uint16), ending with EOB.
    Oracle implementation: direct sequential list MTF (the production
    path lives in lbzip2_tpu.ops.mtf and is tested against this).
    """
    eob = ninuse + 1
    syms = cmap[bwt].astype(np.int64)
    order = list(range(ninuse))
    out: list[int] = []
    k = 0  # pending zero-run length
    u = 0  # symbol currently at rank 0
    for c in syms.tolist():
        if c == u:
            k += 1
            continue
        out.extend(zero_run_digits(k))
        k = 0
        r = order.index(c)
        assert r > 0
        # move to front
        del order[r]
        order.insert(0, c)
        u = c
        out.append(r + 1)
    out.extend(zero_run_digits(k))
    out.append(eob)
    return np.asarray(out, dtype=np.uint16)
