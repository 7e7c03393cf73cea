"""RLE2: MTF ranks -> padded MTF-value stream (zero-run coding), with the
flat symbol histogram of its padded groups: the hand-written CUDA kernel,
its plain PyTorch version and the dispatching wrappers.

Counterpart of lbzip2_tpu/ops/rle2.py::_rle2_batch and of the flat
histogram of lbzip2_tpu/ops/chain.py::_chain_mtf2 (the per-group
histogram summed over the groups).  A zero run of length k becomes the
bijective base-2 RUNA/RUNB digits of k + 1, rank r becomes r + 1, EOB
(ninuse + 1) terminates.  In the plain version ``clz`` becomes an
integer bit length and the stable-sort compaction a cumsum plus scatter;
the kernel is ``csrc/rle2.cu`` (tiles of 4096 lanes summed up as runs
that combine associatively, in one pass: each tile takes the runs before
it by decoupled look-back, then emits the runs that end in it, counting
the histogram from what it emits; a second, write-only launch zeroes the
lanes past nm).  Both give JAX's output exactly.  With ``pads=False``
the histogram leaves out the padded groups' count: the histogram of
mtfv[:nm] that lbzip2_tpu/ops/chain.py::chain_mtf makes (a flag of the
kernel).

``rle2_hist_rows`` and ``_rle2_batch`` take the plain version only for a
CPU tensor.  For a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from lbzip2_tpu_torch import _build
from lbzip2_tpu_torch.core.constants import GROUP_SIZE, MAX_ALPHA_SIZE
from lbzip2_tpu_torch.ops import lookback

WIDTH = MAX_ALPHA_SIZE + 1  # 259: symbols 0..257 + per-row dummy `as`
_INF = 2 ** 31 - 1

launches = 0  # CUDA kernel launches made by rle2_hist_rows/_rle2_batch


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


def _rle2_plain(ranks: torch.Tensor, ns: torch.Tensor,
                ninuse: torch.Tensor):
    """The plain version of ``_rle2_batch``: two cumulative maxima give
    every lane its run, a cumsum and a scatter compact the kept lanes."""
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


_FLAT_WAYS = 32


def _flat_hist(mtfv: torch.Tensor, nm: torch.Tensor,
               ninuse: torch.Tensor, pads: bool = True) -> torch.Tensor:
    """Flat symbol histogram (B, WIDTH) int32 of the padded groups,
    counted from the symbols: the values of
    ``ops/chain.py::_group_hist(...)[0].sum(1)`` (the pad positions at
    lane ``as``, the clamp to lane 258) without the per-group tensor.
    Without ``pads``, the histogram of mtfv[:nm] alone (JAX's
    ``chain_mtf``)."""
    B, NP = mtfv.shape
    dev = mtfv.device
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    pos = torch.arange(NP, dtype=torch.int32, device=dev)[None]
    live = pos < nm[:, None]
    # _FLAT_WAYS counts a row, neighbouring positions in different ones
    # (a text row is mostly two symbols: one count a row would have a
    # card's atomics queue on two addresses); a row's dead positions go
    # to a bin of their own past its lanes
    rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    way = rows * _FLAT_WAYS + pos % _FLAT_WAYS
    idx = torch.where(live, mtfv.clamp(max=WIDTH - 1), WIDTH) + \
        way * (WIDTH + 1)
    hist = torch.bincount(idx.reshape(-1),
                          minlength=B * _FLAT_WAYS * (WIDTH + 1))
    hist = hist.reshape(B, _FLAT_WAYS, WIDTH + 1).sum(1)[:, :WIDTH].int()
    if pads:
        hist.scatter_add_(1,
                          (ninuse + 2).clamp(max=WIDTH - 1).long()[:, None],
                          (G * GROUP_SIZE - live.sum(1)).int()[:, None])
    return hist


def rle2_hist_plain(ranks: torch.Tensor, ns: torch.Tensor,
                    ninuse: torch.Tensor, pads: bool = True):
    """The plain version of ``rle2_hist_rows``: ``_rle2_plain``, then
    ``_flat_hist`` of its output."""
    mtfv, nm = _rle2_plain(ranks, ns, ninuse)
    return mtfv, nm, _flat_hist(mtfv, nm, ninuse, pads)


def _lib():
    lib = _build.load("rle2")
    fn = lib.lbz2t_rle2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lbz2t_rle2_desc_ints.argtypes = [ctypes.c_int] * 2
        lib.lbz2t_rle2_desc_ints.restype = ctypes.c_longlong
        lib.lbz2t_rle2_state_ints.argtypes = [ctypes.c_int]
        lib.lbz2t_rle2_state_ints.restype = ctypes.c_longlong
    return lib


def rle2_hist_cuda(ranks: torch.Tensor, ns: torch.Tensor,
                   ninuse: torch.Tensor, pads: bool = True):
    """Launch the CUDA kernels on the current stream (no synchronize,
    nothing read on the host): ``rle2_scan``, then ``rle2_tail``; the
    tile descriptors and counters are the calling thread's
    (``ops/lookback.py``).  See ``rle2_hist_rows``."""
    global launches
    dev = ranks.device
    if dev.type != "cuda" or ns.device != dev or ninuse.device != dev:
        raise ValueError("rle2_hist_cuda needs ranks, ns and ninuse on one "
                         "CUDA device")
    if any(a.dtype != torch.int32 for a in (ranks, ns, ninuse)):
        raise TypeError("ranks, ns and ninuse must be int32")
    if ranks.dim() != 2 or ns.shape != (ranks.shape[0],) or \
            ninuse.shape != ns.shape:
        raise ValueError(f"bad shapes {tuple(ranks.shape)} / "
                         f"{tuple(ns.shape)} / {tuple(ninuse.shape)}")
    if not all(a.is_contiguous() for a in (ranks, ns, ninuse)):
        raise ValueError("ranks, ns and ninuse must be contiguous")
    lib = _lib()
    B, N = ranks.shape
    with torch.cuda.device(dev):  # the C side launches on it
        mtfv = torch.empty((B, N + 1), dtype=torch.int32, device=dev)
        nm = torch.empty(B, dtype=torch.int32, device=dev)
        hist = torch.empty((B, WIDTH), dtype=torch.int32, device=dev)
        if B == 0:
            return mtfv, nm, hist
        desc, state, epoch = lookback.scratch(
            "rle2", dev, lib.lbz2t_rle2_desc_ints(B, N),
            lib.lbz2t_rle2_state_ints(B))
        err = lib.lbz2t_rle2(ranks.data_ptr(), ns.data_ptr(),
                             ninuse.data_ptr(), mtfv.data_ptr(),
                             nm.data_ptr(), hist.data_ptr(),
                             desc.data_ptr(), state.data_ptr(), B, N,
                             int(pads), epoch,
                             torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rle2 kernel launch failed: cudaError "
                               f"{err}")
    launches += 1
    return mtfv, nm, hist


def rle2_hist_rows(ranks: torch.Tensor, ns: torch.Tensor,
                   ninuse: torch.Tensor, pads: bool = True):
    """RLE2 with the flat histogram of the padded groups.

    ranks (B, N) int32 (entries >= n ignored); ns, ninuse (B,) int32.
    Returns (mtfv (B, N+1) int32 compacted to the front, 0 at and beyond
    nm; nm (B,) int32 MTF-value counts including EOB; hist (B, WIDTH)
    int32: every lane < nm by its value clamped to 258, plus, with
    ``pads``, G * 50 - nm pads at lane min(ninuse + 2, 258),
    G = ceil((N+1)/50)).  The CUDA kernel for CUDA tensors (the flag
    skips the pads' count there), the plain version for CPU ones."""
    if ranks.device.type == "cuda":
        return rle2_hist_cuda(ranks, ns, ninuse, pads)
    if ranks.device.type == "cpu":
        return rle2_hist_plain(ranks, ns, ninuse, pads)
    raise ValueError(f"unsupported device {ranks.device}")


def _rle2_batch(ranks: torch.Tensor, ns: torch.Tensor,
                ninuse: torch.Tensor):
    """ranks (B, N) int32 (entries >= n ignored); ns, ninuse (B,).

    Returns (mtfv (B, N+1) int32 compacted to the front, 0 beyond nm;
    nm (B,) int32 MTF-value counts including EOB): the kernel of
    ``rle2_hist_rows`` (its histogram dropped) for CUDA tensors, the
    plain version for CPU ones."""
    if ranks.device.type == "cuda":
        return rle2_hist_cuda(ranks, ns, ninuse)[:2]
    if ranks.device.type == "cpu":
        return _rle2_plain(ranks, ns, ninuse)
    raise ValueError(f"unsupported device {ranks.device}")


def rle2_from_ranks(ranks: torch.Tensor, n, ninuse):
    """Single-row form of ``_rle2_batch`` (lbzip2_tpu/ops/rle2.py:74):
    ranks (N,) int32 -> (mtfv (N+1,) int32, nm 0-d int32)."""
    dev = ranks.device
    mtfv, nm = _rle2_batch(
        ranks.int()[None].contiguous(),
        torch.tensor([int(n)], dtype=torch.int32, device=dev),
        torch.tensor([int(ninuse)], dtype=torch.int32, device=dev))
    return mtfv[0], nm[0]
