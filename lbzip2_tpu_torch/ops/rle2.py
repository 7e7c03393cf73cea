"""RLE2: MTF ranks -> padded MTF-value stream (zero-run coding).

Counterpart of lbzip2_tpu/ops/rle2.py::_rle2_batch.  A zero run of
length k becomes the bijective base-2 RUNA/RUNB digits of k + 1, rank r
becomes r + 1, EOB (ninuse + 1) terminates.  ``clz`` becomes an integer
bit length, and the stable-sort compaction a cumsum plus scatter; the
output is identical.
"""

from __future__ import annotations

import torch

_INF = 2 ** 31 - 1


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 1, by integer bisection (a float
    log2 is inexact above 2^24)."""
    m = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        hit = t > 0
        m = m + torch.where(hit, s, 0)
        x = torch.where(hit, t, x)
    return m


def _rle2_batch(ranks: torch.Tensor, ns: torch.Tensor,
                ninuse: torch.Tensor):
    """ranks (B, N) int32 (entries >= n ignored); ns, ninuse (B,).

    Returns (mtfv (B, N+1) int32 compacted to the front, 0 beyond nm;
    nm (B,) int32 MTF-value counts including EOB)."""
    B, N = ranks.shape
    dev = ranks.device
    pos = torch.arange(N, dtype=torch.int32, device=dev)[None].expand(B, N)
    nB = ns[:, None]
    valid = pos < nB
    r = torch.where(valid, ranks, 0)
    nz = valid & (r > 0)

    # run start: 1 + last nonzero position strictly before i
    last_nz_incl = torch.cummax(torch.where(nz, pos, -1), dim=1).values
    runstart = torch.cat([torch.zeros_like(last_nz_incl[:, :1]),
                          last_nz_incl[:, :-1] + 1], dim=1)
    # next nonzero position at or after i (n if none)
    nxt = torch.cummax(torch.where(nz, -pos, -_INF).flip(1), dim=1)
    next_nz = torch.minimum(-nxt.values.flip(1), nB)

    k = next_nz - runstart
    runpos = pos - runstart
    m = _floor_log2(torch.clamp(k, min=0) + 1)
    digit = ((k + 1) >> torch.clamp(runpos, 0, 30)) & 1
    keep = nz | (valid & ~nz & (runpos < m))
    value = torch.where(nz, r + 1, digit)

    # compaction: kept cells in position order, EOB right after them,
    # every other cell routed to a dump lane that is sliced off
    dest = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    nm = keep.sum(1, dtype=torch.int32) + 1
    out = torch.zeros((B, N + 2), dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(keep, dest, N + 1).long(), value)
    out.scatter_(1, (nm - 1).long()[:, None], (ninuse + 1)[:, None].int())
    mtfv = out[:, :N + 1]
    lanes = torch.arange(N + 1, dtype=torch.int32, device=dev)[None]
    return torch.where(lanes < nm[:, None], mtfv, 0), nm


def rle2_from_ranks(ranks: torch.Tensor, n, ninuse):
    """Single-row form of ``_rle2_batch`` (lbzip2_tpu/ops/rle2.py:74):
    ranks (N,) int32 -> (mtfv (N+1,) int32, nm 0-d int32)."""
    dev = ranks.device
    mtfv, nm = _rle2_batch(
        ranks.int()[None], torch.tensor([int(n)], dtype=torch.int32,
                                        device=dev),
        torch.tensor([int(ninuse)], dtype=torch.int32, device=dev))
    return mtfv[0], nm[0]
