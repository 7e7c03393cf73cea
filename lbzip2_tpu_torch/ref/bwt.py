"""Burrows-Wheeler transform of block *rotations* (bzip2 semantics).

The reference uses an adapted divsufsort (src/divbwt.c) — an induced
suffix sort.  Any correct rotation sort yields the same BWT string; for
periodic inputs equal rotations are interchangeable, so only the primary
index can differ between algorithms (see reference tests/incomp).  This
oracle implementation uses prefix doubling over cyclic shifts
(np.lexsort), which the on-device kernel (lbzip2_tpu.ops.bwt) mirrors
with jax.lax sorts.
"""

from __future__ import annotations

import numpy as np


def bwt(block: np.ndarray) -> tuple[np.ndarray, int]:
    """Return (bwt_bytes, primary_index) for the rotation sort of block."""
    n = int(block.size)
    assert n > 0
    if n == 1:
        return block.copy(), 0
    rank = block.astype(np.int64)
    k = 1
    while k < n:
        key2 = np.roll(rank, -k)  # rank of rotation (i + k) mod n
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        bump = np.empty(n, dtype=np.int64)
        bump[0] = 0
        np.cumsum((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1]), out=bump[1:])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = bump
        if bump[-1] == n - 1:
            break
        k <<= 1
    # Equal rotations (fully periodic blocks) tie-break by DESCENDING
    # position: this matches both the doubled-string SA-IS formulation
    # (native/sais.c) and the reference divbwt on small periodic inputs
    # (e.g. "abababab" -> idx 3); the BWT string itself is unaffected.
    order = np.lexsort((-np.arange(n), rank))
    out = block[(order - 1) % n]
    idx = int(np.flatnonzero(order == 0)[0])
    return out, idx
