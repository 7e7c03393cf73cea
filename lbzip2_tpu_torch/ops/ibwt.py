"""Batched inverse BWT by pointer doubling (Wyllie list ranking).

Counterpart of lbzip2_tpu/ops/ibwt.py (``ibwt_masked`` and its vmap
``ibwt_batched``).  ptr, the successor permutation, is the stable sort
of the row's bytes carrying their positions (pad lanes at and past n
sort last under key 256); start = ptr[idx]; then ceil(log2 N) doubling
steps build visit[k] = ptr^k(start) and the output is bwt[visit], 0 at
lanes >= n.

``ibwt_rows`` runs the hand-written kernel ``csrc/ibwt.cu`` (a stable
counting sort for ptr, one launch per doubling step) for a CUDA tensor,
and the plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lbzip2_tpu_torch import _build

CHUNK = 4096  # positions per counting-sort chunk of the CUDA kernel
KEYS = 257    # 256 byte values and the pad key

launches = 0  # CUDA kernel launches made by ibwt_rows


def steps_for(N: int) -> int:
    """Doubling steps of a width-N row, as the JAX scan counts them."""
    return max(1, math.ceil(math.log2(N)))


def ibwt_plain(bwt: torch.Tensor, ns: torch.Tensor,
               idxs: torch.Tensor) -> torch.Tensor:
    """The JAX ``ibwt_masked`` (lbzip2_tpu/ops/ibwt.py:22-59) batched
    over rows: a stable ``torch.sort`` for ptr, then the doubling loop.

    bwt (B, N) uint8; ns, idxs (B,) int32 (idx in [0, N)).  Returns
    (B, N) uint8, 0 at lanes >= n."""
    B, N = bwt.shape
    dev = bwt.device
    pos = torch.arange(N, device=dev)
    valid = pos[None] < ns.long()[:, None]
    key = torch.where(valid, bwt.long(), KEYS - 1)
    ptr = torch.sort(key, dim=1, stable=True).indices
    start = ptr.gather(1, idxs.long().clamp(0, N - 1)[:, None])
    seq = torch.where(pos[None] == 0, start, 0)
    jump = ptr
    length = 1
    for _ in range(steps_for(N)):
        ext = jump.gather(1, seq)
        shifted = torch.roll(ext, length, dims=1)
        take = (pos >= length) & (pos < 2 * length)
        seq = torch.where(take[None], shifted, seq)
        jump = jump.gather(1, jump)
        length *= 2
    return torch.where(valid, bwt.gather(1, seq), 0).to(torch.uint8)


def _lib():
    fn = _build.load("ibwt").lbz2t_ibwt
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ibwt_cuda(bwt: torch.Tensor, ns: torch.Tensor,
              idxs: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream (no synchronize)."""
    global launches
    dev = bwt.device
    if dev.type != "cuda" or ns.device != dev or idxs.device != dev:
        raise ValueError("ibwt_cuda needs bwt, ns and idxs on one CUDA "
                         "device")
    if bwt.dtype != torch.uint8 or ns.dtype != torch.int32 or \
            idxs.dtype != torch.int32:
        raise TypeError("bwt must be uint8, ns and idxs int32")
    if bwt.dim() != 2 or ns.shape != (bwt.shape[0],) or \
            idxs.shape != ns.shape:
        raise ValueError(f"bad shapes {tuple(bwt.shape)} / "
                         f"{tuple(ns.shape)} / {tuple(idxs.shape)}")
    if not (bwt.is_contiguous() and ns.is_contiguous()
            and idxs.is_contiguous()):
        raise ValueError("bwt, ns and idxs must be contiguous")
    B, N = bwt.shape
    out = torch.empty_like(bwt)
    if B == 0 or N == 0:
        return out
    nch = -(-N // CHUNK)
    i32 = dict(dtype=torch.int32, device=dev)
    hist = torch.empty((B, nch, KEYS), **i32)
    jump = torch.empty((2, B, N), **i32)
    seq = torch.empty((B, N), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(bwt.data_ptr(), ns.data_ptr(), idxs.data_ptr(),
                 out.data_ptr(), hist.data_ptr(), jump[0].data_ptr(),
                 jump[1].data_ptr(), seq.data_ptr(), B, N, CHUNK,
                 steps_for(N), stream)
    if err != 0:
        raise RuntimeError(f"ibwt kernel launch failed: cudaError {err}")
    launches += 1
    return out


def ibwt_rows(bwt: torch.Tensor, ns: torch.Tensor,
              idxs: torch.Tensor) -> torch.Tensor:
    """Batched inverse BWT (B, N) uint8, 0 at lanes >= n: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if bwt.device.type == "cuda":
        return ibwt_cuda(bwt, ns, idxs)
    if bwt.device.type == "cpu":
        return ibwt_plain(bwt, ns, idxs)
    raise ValueError(f"unsupported device {bwt.device}")
