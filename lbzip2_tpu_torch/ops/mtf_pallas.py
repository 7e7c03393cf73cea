"""MTF ranks: the hand-written CUDA kernel, its plain PyTorch version
and the dispatching wrapper.

Counterpart of lbzip2_tpu/ops/mtf_pallas.py (the Pallas TPU kernel
``mtf_ranks_pallas``) and of its batched caller ``_mtf_ranks_rows``
(lbzip2_tpu/ops/chain.py:34-42).  The kernel is
``csrc/mtf_ranks.cu``: chunk-parallel over each row (per-chunk last
positions, an exclusive max-scan over chunks, then one warp per chunk
holding the 256-entry move-to-front list in its registers: run
continuations are skipped, any other symbol is found by one ballot a
32-entry level, so the work grows with the rank).  What bounds it on
the card is instruction throughput, some 20 warp instructions a symbol
found in the first level, against 231 MB of int32 in and out per
(32, 901120) batch; see the source for the design.

``mtf_ranks_bytes_rows`` takes the BWT bytes and the rows' used-byte
maps instead of the symbols: the kernel's byte entry fuses
lbzip2_tpu/ops/chain.py::_compact_syms into both launches that read
the symbols (a table in shared memory, built by one warp a CTA), so the
(B, N) int32 symbols are never written; its plain version is
``_compact_syms`` then ``mtf_ranks_plain``.

``mtf_ranks_rows`` and ``mtf_ranks_bytes_rows`` take the plain version
only for a CPU tensor.  For a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from lbzip2_tpu_torch import _build

PLAIN_CHUNK = 2048   # positions per step of the plain version
KERNEL_CHUNK = 2048  # positions per warp in the CUDA rank pass

launches = 0        # MTF kernel launches, by either entry
bytes_launches = 0  # of those, the byte entry's (mtf_ranks_bytes_rows)


def _compact_syms(bwt: torch.Tensor, cmaps: torch.Tensor) -> torch.Tensor:
    """Raw BWT bytes -> compacted symbol ids (B, N) int32: the number of
    used byte values below each byte, from a per-row 256-entry table
    (lbzip2_tpu/ops/chain.py:48)."""
    cm = cmaps.int()
    tab = torch.cumsum(cm, dim=1, dtype=torch.int32) - cm
    return torch.gather(tab, 1, bwt.long())


def mtf_ranks_plain(syms: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """One-hot cummax formulation (lbzip2_tpu/ops/mtf_pallas.py:9-14),
    batched over rows, walking chunks in a Python loop.

    syms: (B, N) int32 in [0, 256); ns: (B,) int32.  Returns (B, N)
    int32 ranks, 0 at lanes >= n."""
    B, N = syms.shape
    dev = syms.device
    alpha = torch.arange(256, dtype=torch.int32, device=dev)
    last = torch.full((B, 256), -1, dtype=torch.int32, device=dev)
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    for c0 in range(0, N, PLAIN_CHUNK):
        x = syms[:, c0:c0 + PLAIN_CHUNK]
        C = x.shape[1]
        gpos = torch.arange(c0, c0 + C, dtype=torch.int32, device=dev)
        onehot = x[:, :, None] == alpha
        pos = torch.where(onehot, gpos[None, :, None], -1)
        incl = torch.cummax(pos, dim=1).values
        excl = torch.cat([torch.full_like(incl[:, :1], -1),
                          incl[:, :-1]], dim=1)
        comb = torch.maximum(excl, last[:, None, :])
        prev = torch.gather(comb, 2, x[:, :, None].long())
        seen = comb >= 0
        rank_seen = (comb > prev).sum(2, dtype=torch.int32)
        rank_first = (seen | (alpha < x[:, :, None])).sum(
            2, dtype=torch.int32)
        out[:, c0:c0 + C] = torch.where(prev[:, :, 0] >= 0, rank_seen,
                                        rank_first)
        last = torch.maximum(last, incl[:, -1])
    lanes = torch.arange(N, dtype=torch.int32, device=dev)
    return torch.where(lanes[None] < ns[:, None], out, 0)


def _lib():
    lib = _build.load("mtf_ranks")
    if lib.lbz2t_mtf_ranks.argtypes is None:
        lib.lbz2t_mtf_ranks.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lbz2t_mtf_ranks_bytes.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lbz2t_mtf_ranks.restype = lib.lbz2t_mtf_ranks_bytes.restype = \
            ctypes.c_int
    return lib


def mtf_ranks_cuda(syms: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    if syms.device.type != "cuda" or ns.device != syms.device:
        raise ValueError("mtf_ranks_cuda needs syms and ns on one CUDA "
                         "device")
    if syms.dtype != torch.int32 or ns.dtype != torch.int32:
        raise TypeError("syms and ns must be int32")
    if syms.dim() != 2 or ns.shape != (syms.shape[0],):
        raise ValueError(f"bad shapes {tuple(syms.shape)} / "
                         f"{tuple(ns.shape)}")
    if not (syms.is_contiguous() and ns.is_contiguous()):
        raise ValueError("syms and ns must be contiguous")
    fn = _lib().lbz2t_mtf_ranks
    out = _launch(lambda lastc, out, stream: fn(
        syms.data_ptr(), ns.data_ptr(), out.data_ptr(), lastc.data_ptr(),
        *syms.shape, KERNEL_CHUNK, stream), syms.shape, syms.device)
    launches += 1
    return out


def _launch(call, shape, dev) -> torch.Tensor:
    """Allocate the ranks and the chunks' scratch on ``dev`` and run
    ``call(lastc, out, stream)`` on its current stream; raise on the
    launch's error."""
    B, N = shape
    with torch.cuda.device(dev):  # the C side launches on it
        out = torch.empty((B, N), dtype=torch.int32, device=dev)
        nch = -(-N // KERNEL_CHUNK)
        lastc = torch.empty((B, max(nch, 1), 256), dtype=torch.int32,
                            device=dev)
        err = call(lastc, out, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mtf_ranks kernel launch failed: "
                               f"cudaError {err}")
    return out


def mtf_ranks_rows(syms: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Batched MTF ranks (B, N) int32; lanes >= n are 0.  The CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if syms.device.type == "cuda":
        return mtf_ranks_cuda(syms, ns)
    if syms.device.type == "cpu":
        return mtf_ranks_plain(syms, ns)
    raise ValueError(f"unsupported device {syms.device}")


def mtf_ranks_bytes_plain(bwt: torch.Tensor, cmaps: torch.Tensor,
                          ns: torch.Tensor) -> torch.Tensor:
    """The plain version of ``mtf_ranks_bytes_rows``: ``_compact_syms``,
    then ``mtf_ranks_plain``."""
    return mtf_ranks_plain(_compact_syms(bwt, cmaps), ns)


def mtf_ranks_bytes_cuda(bwt: torch.Tensor, cmaps: torch.Tensor,
                         ns: torch.Tensor) -> torch.Tensor:
    """Launch the kernel's byte entry on the current stream (no
    synchronize, nothing read on the host)."""
    global launches, bytes_launches
    dev = bwt.device
    if dev.type != "cuda" or cmaps.device != dev or ns.device != dev:
        raise ValueError("mtf_ranks_bytes_cuda needs bwt, cmaps and ns on "
                         "one CUDA device")
    if bwt.dtype != torch.uint8 or cmaps.dtype != torch.uint8 or \
            ns.dtype != torch.int32:
        raise TypeError("bwt and cmaps must be uint8, ns int32")
    B = bwt.shape[0]
    if bwt.dim() != 2 or cmaps.shape != (B, 256) or ns.shape != (B,):
        raise ValueError(f"bad shapes {tuple(bwt.shape)} / "
                         f"{tuple(cmaps.shape)} / {tuple(ns.shape)}")
    if not all(a.is_contiguous() for a in (bwt, cmaps, ns)):
        raise ValueError("bwt, cmaps and ns must be contiguous")
    fn = _lib().lbz2t_mtf_ranks_bytes
    out = _launch(lambda lastc, out, stream: fn(
        bwt.data_ptr(), cmaps.data_ptr(), ns.data_ptr(), out.data_ptr(),
        lastc.data_ptr(), *bwt.shape, KERNEL_CHUNK, stream), bwt.shape, dev)
    launches += 1
    bytes_launches += 1
    return out


def mtf_ranks_bytes_rows(bwt: torch.Tensor, cmaps: torch.Tensor,
                         ns: torch.Tensor) -> torch.Tensor:
    """MTF ranks (B, N) int32 of the BWT bytes' compacted symbols (lanes
    >= n are 0, never read): bwt (B, N) uint8, cmaps (B, 256) uint8 with
    1 at the row's used byte values, ns (B,) int32.  The kernel's byte
    entry for a CUDA tensor, the plain version for a CPU tensor."""
    if bwt.device.type == "cuda":
        return mtf_ranks_bytes_cuda(bwt, cmaps, ns)
    if bwt.device.type == "cpu":
        return mtf_ranks_bytes_plain(bwt, cmaps, ns)
    raise ValueError(f"unsupported device {bwt.device}")
