"""Batched inverse BWT: list ranking over sublists on the card, pointer
doubling (Wyllie list ranking) as the plain version.

Counterpart of lbzip2_tpu/ops/ibwt.py (``ibwt_masked`` and its vmap
``ibwt_batched``).  ptr, the successor permutation, is the stable sort
of the row's bytes carrying their positions (pad lanes at and past n
sort last under key 256); seq[k] = ptr^(k+1)(idx) and the output is
bwt[seq], 0 at lanes >= n.

``ibwt_rows`` runs the hand-written kernels of ``csrc/ibwt.cu`` for a
CUDA tensor: a stable counting sort of the live lanes for ptr, then
Helman and JaJa's list ranking (splitters every ``1 << SHIFT`` positions,
one thread a sublist, the splitter list ranked in one block's shared
memory, a second walk that writes the bytes), work proportional to the
live lanes.  A row that is no single cycle over [0, n) cannot be
ranked that way; the kernels flag it and the wrapper redoes it with the
doubling kernels of the same source (``doubling_rows`` counts them).
For a CPU tensor it runs the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from lbzip2_tpu_torch import _build

CHUNK = 4096  # positions per counting-sort chunk of the CUDA kernel
KEYS = 257    # 256 byte values and the pad key (the plain version's)
SHIFT = 5     # a splitter every 2^SHIFT positions, or more (shift_for)
MAX_SPLITTERS = 40960  # a row's splitter list must fit 160 KB of an SM
CAP = 64      # a walk longer than CAP << shift steps gives up: redo
MAX_N = 1 << 23   # ptr << 8 | byte must fit an int32

launches = 0       # calls of ibwt_rows that launched the CUDA kernels
doubling_rows = 0  # rows those calls redid by pointer doubling
_held = threading.local()  # a thread's scratch and pinned redo flags


def steps_for(N: int) -> int:
    """Doubling steps of a width-N row, as the JAX scan counts them."""
    return max(1, math.ceil(math.log2(N)))


def shift_for(N: int) -> int:
    """log2 of the splitter spacing for width-N rows: SHIFT, or what
    keeps the splitters of a row within MAX_SPLITTERS."""
    shift = SHIFT
    while -(-N // (1 << shift)) + 1 > MAX_SPLITTERS:
        shift += 1
    return shift


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
    lib = _build.load("ibwt")
    if lib.lbz2t_ibwt.argtypes is None:
        lib.lbz2t_ibwt.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lbz2t_ibwt_doubling.argtypes = [ctypes.c_void_p] * 9 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lbz2t_ibwt.restype = lib.lbz2t_ibwt_doubling.restype = \
            ctypes.c_int
    return lib


def _workspace(dev: torch.device, B: int, words: int):
    """The calling thread's scratch (words int32 on the card), its (B,)
    int32 redo flags in pinned host memory and their numpy view: views
    of buffers the thread keeps and only ever grows.  A call has waited
    for all it queued on them before it returns, so the thread's next
    call, at any shape no larger, takes them again and allocates
    nothing."""
    mine = _held.__dict__.setdefault("buffers", {})  # device -> buffers
    held = mine.get(dev)
    if held is None or held[0].numel() < words or held[1].numel() < B:
        words = max(words, 0 if held is None else held[0].numel())
        flags = torch.empty(max(B, 0 if held is None else held[1].numel()),
                            dtype=torch.int32, pin_memory=True)
        mine[dev] = held = (
            torch.empty(words, dtype=torch.int32, device=dev), flags,
            flags.numpy())
    return held[0], held[1][:B], held[2][:B]


def ibwt_cuda(bwt: torch.Tensor, ns: torch.Tensor,
              idxs: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream and wait for the
    per-row redo flags (one synchronize of that stream); the flagged
    rows are redone by doubling before the call returns.

    Scratch per (8, 901120) batch, one tensor that the calling thread
    keeps from call to call: ptr 28.8 MB, the chunk histograms 1.8 MB,
    the splitter entries and offsets (a word each a 32 positions) 1.8
    MB: 32.4 MB in all, and B words of pinned host memory for the
    flags.  A redone row takes two jump buffers and seq, 10.8 MB a row,
    only then."""
    global launches, doubling_rows
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
    if N >= MAX_N:
        raise ValueError(f"rows of {N} lanes: the kernel takes fewer "
                         f"than {MAX_N}")
    with torch.cuda.device(dev):  # the C side launches on it
        out = torch.empty_like(bwt)
        if B == 0 or N == 0:
            return out
        nch = -(-N // CHUNK)
        shift = shift_for(N)
        S = -(-N // (1 << shift)) + 1
        # ptr, splitter entries, offsets, chunk histograms, key totals,
        # flags
        scratch, redo, redo_host = _workspace(
            dev, B, B * (N + 2 * S + nch * 256 + 256 + 1))
        lib = _lib()
        stream = torch.cuda.current_stream(dev)
        err = lib.lbz2t_ibwt(bwt.data_ptr(), ns.data_ptr(),
                             idxs.data_ptr(), out.data_ptr(),
                             scratch.data_ptr(), redo.data_ptr(), B, N,
                             CHUNK, shift, CAP << shift, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"ibwt kernel launch failed: cudaError "
                               f"{err}")
        launches += 1
        stream.synchronize()
        if redo_host.any():
            rows = torch.nonzero(redo)[:, 0].to(dev, torch.int32)
            R = rows.numel()
            jump = torch.empty((2, R, N), dtype=torch.int32, device=dev)
            seq = torch.empty((R, N), dtype=torch.int32, device=dev)
            err = lib.lbz2t_ibwt_doubling(
                bwt.data_ptr(), ns.data_ptr(), idxs.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), rows.data_ptr(),
                jump[0].data_ptr(), jump[1].data_ptr(), seq.data_ptr(), R,
                N, steps_for(N), stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"ibwt doubling launch failed: "
                                   f"cudaError {err}")
            doubling_rows += R
            stream.synchronize()  # the kept scratch is free again
    return out


def ibwt_rows(bwt: torch.Tensor, ns: torch.Tensor,
              idxs: torch.Tensor) -> torch.Tensor:
    """Batched inverse BWT (B, N) uint8, 0 at lanes >= n: the CUDA
    kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if bwt.device.type == "cuda":
        return ibwt_cuda(bwt, ns, idxs)
    if bwt.device.type == "cpu":
        return ibwt_plain(bwt, ns, idxs)
    raise ValueError(f"unsupported device {bwt.device}")
