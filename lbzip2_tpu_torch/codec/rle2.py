"""Vectorized RLE2: MTF ranks -> bzip2 MTF-value stream (host, numpy).

Zero-run lengths are coded in bijective base 2 (RUNA=0/RUNB=1 digits,
LSB first): the digits of k are the binary digits of (k+1) minus its
leading 1 (reference src/encode.c:381-386).  Nonzero rank r is emitted
as symbol r+1; the stream ends with EOB = ninuse+1.

The port's copy of lbzip2_tpu/codec/rle2.py (numpy only); the device
form is lbzip2_tpu_torch/ops/rle2.py::rle2_from_ranks.
"""

from __future__ import annotations

import numpy as np


def rle2_from_ranks(ranks: np.ndarray, ninuse: int) -> np.ndarray:
    """Build the MTF value array (uint16, EOB-terminated) from MTF ranks."""
    ranks = np.asarray(ranks)
    n = ranks.size
    eob = ninuse + 1
    nz = np.flatnonzero(ranks)
    nnz = nz.size

    # zero-run length before each nonzero, plus the final run before EOB.
    bounds = np.concatenate([[-1], nz, [n]])
    ks = np.diff(bounds) - 1  # (nnz+1,)
    assert (ks >= 0).all()

    # digits per run: bitlength(k+1) - 1 (exact via frexp on float64).
    m = (np.frexp((ks + 1).astype(np.float64))[1] - 1).astype(np.int64)

    piece_lens = m + 1  # digits + (value | EOB)
    ends = np.cumsum(piece_lens)
    total = int(ends[-1])
    out = np.empty(total, dtype=np.uint16)

    vals = np.empty(nnz + 1, dtype=np.uint16)
    vals[:nnz] = ranks[nz] + 1
    vals[nnz] = eob
    out[ends - 1] = vals

    total_digits = int(m.sum())
    if total_digits:
        which = np.repeat(np.arange(nnz + 1), m)
        j = (np.arange(total_digits, dtype=np.int64)
             - np.repeat(np.cumsum(m) - m, m))
        pos = np.repeat(ends - 1 - m, m) + j
        out[pos] = ((np.repeat(ks + 1, m) >> j) & 1).astype(np.uint16)
    return out
