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

``mtf_ranks_rows`` takes the plain version only for a CPU tensor.  For
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lbzip2_tpu_torch import _build

PLAIN_CHUNK = 2048   # positions per step of the plain version
KERNEL_CHUNK = 2048  # positions per warp in the CUDA rank pass

launches = 0  # CUDA kernel launches made by mtf_ranks_rows


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
    fn = lib.lbz2t_mtf_ranks
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    B, N = syms.shape
    fn = _lib()
    with torch.cuda.device(syms.device):  # the C side launches on it
        out = torch.empty_like(syms)
        nch = -(-N // KERNEL_CHUNK)
        lastc = torch.empty((B, max(nch, 1), 256), dtype=torch.int32,
                            device=syms.device)
        stream = torch.cuda.current_stream(syms.device).cuda_stream
        err = fn(syms.data_ptr(), ns.data_ptr(), out.data_ptr(),
                 lastc.data_ptr(), B, N, KERNEL_CHUNK, stream)
        if err != 0:
            raise RuntimeError(f"mtf_ranks kernel launch failed: "
                               f"cudaError {err}")
    launches += 1
    return out


def mtf_ranks_rows(syms: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Batched MTF ranks (B, N) int32; lanes >= n are 0.  The CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if syms.device.type == "cuda":
        return mtf_ranks_cuda(syms, ns)
    if syms.device.type == "cpu":
        return mtf_ranks_plain(syms, ns)
    raise ValueError(f"unsupported device {syms.device}")
