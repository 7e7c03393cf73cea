"""MSB-first bit packer: the hand-written CUDA kernel, its plain PyTorch
version and the dispatching wrapper.

Counterpart of lbzip2_tpu/ops/bitpack.py (``pack_bits_device``, an XLA
op, and its host wrapper ``pack_bits_host``): fields (the low nbits of
each value, MSB first) packed into big-endian 32-bit words.  The JAX
form merges the field starts with the output-bit grid by two sorts over
33N lanes; here each field finds its start by a prefix sum and writes
itself.  The kernel is ``csrc/bitpack.cu``: behind the output's zero
fill, one launch of a single-pass scan with decoupled look-back over
tiles of ``_TILE`` = ``_THREADS`` x ``_PER`` fields by persistent CTAs
(each thread ``_PER`` consecutive fields by vector loads, the next
tile's in flight during the current one's look-back, each tile's start
bit from the earlier tiles' published sums), the tile's words merged in
shared memory, stored whole, and only the words a tile shares with its
neighbours ORed into the output.  Its descriptors and ticket are held
per thread and device (``ops/lookback.py::scratch``), so a call
allocates only its outputs.  ``_THREADS`` and ``_PER`` are passed to
the kernel, which checks them; the CPU tests' model of the kernel reads
the same.  A JAX u32 is an int64 masked to 32 bits here
(``interop.py``): values in, words out.

``pack_bits_device`` takes the plain version only for a CPU tensor.
For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lbzip2_tpu_torch import _build
from lbzip2_tpu_torch.device import resolve, upload
from lbzip2_tpu_torch.interop import M32
from lbzip2_tpu_torch.ops import lookback

# the kernel's: threads a CTA, fields a thread, fields a tile
_THREADS = 256
_PER = 8
_TILE = _THREADS * _PER

launches = 0  # CUDA kernel launches made by pack_bits_device


def pack_bits_plain(values: torch.Tensor, lens: torch.Tensor, nf: int):
    """Prefix sum of the lengths, then every field's aligned high and low
    pieces scatter-added into its words (add == or: no overlap).
    Returns (words (N,) int64, total_bits 0-d int32)."""
    N = values.shape[0]
    dev = values.device
    ln = torch.where(torch.arange(N, device=dev) < nf, lens.long(), 0)
    ends = torch.cumsum(ln, 0)
    starts = ends - ln
    v = values.long() & ((1 << ln) - 1)
    o = starts & 31
    end_in = o + ln
    hi = torch.where(end_in <= 32, v << (32 - end_in).clamp(0, 32),
                     v >> (end_in - 32).clamp(0, 32))
    lo = torch.where(end_in <= 32, 0,
                     (v << (64 - end_in).clamp(0, 31)) & M32)
    w = (starts >> 5).clamp(max=N)
    words = torch.zeros(N + 2, dtype=torch.long, device=dev)
    words.scatter_add_(0, w, hi)
    words.scatter_add_(0, w + 1, lo)
    total = ends[-1].int() if N else torch.zeros((), dtype=torch.int32)
    return words[:N] & M32, total


def _lib():
    lib = _build.load("bitpack")
    fn = lib.lbz2t_pack_bits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lbz2t_pack_bits_desc_words.argtypes = [ctypes.c_int]
        lib.lbz2t_pack_bits_desc_words.restype = ctypes.c_longlong
        lib.lbz2t_pack_bits_state_ints.restype = ctypes.c_longlong
    return lib


def pack_bits_cuda(values: torch.Tensor, lens: torch.Tensor, nf: int):
    """Launch the zero fill and the CUDA kernel on the current stream (no
    synchronize)."""
    global launches
    dev = values.device
    if dev.type != "cuda" or lens.device != dev:
        raise ValueError("pack_bits_cuda needs values and lens on one CUDA "
                         "device")
    if values.dtype != torch.int64 or lens.dtype != torch.int32:
        raise TypeError("values must be int64 (u32 words), lens int32")
    if not (values.is_contiguous() and lens.is_contiguous()):
        raise ValueError("values and lens must be contiguous")
    N = values.shape[0]
    nf = min(max(nf, 0), N)
    with torch.cuda.device(dev):
        words = torch.zeros(N, dtype=torch.int64, device=dev)
        if N == 0:
            return words, torch.zeros((), dtype=torch.int32, device=dev)
        lib = _lib()
        total = torch.empty((), dtype=torch.int32, device=dev)
        desc, state, epoch = lookback.scratch(
            "bitpack", dev, lib.lbz2t_pack_bits_desc_words(N),
            lib.lbz2t_pack_bits_state_ints(), torch.int64)
        err = lib.lbz2t_pack_bits(
            values.data_ptr(), lens.data_ptr(), N, nf, _THREADS, _PER,
            words.data_ptr(), total.data_ptr(), desc.data_ptr(),
            state.data_ptr(), epoch,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bitpack kernel launch failed: cudaError "
                               f"{err}")
    launches += 1
    return words, total


def pack_bits_device(values: torch.Tensor, lens: torch.Tensor, nf):
    """Pack fields (values[i]'s low lens[i] bits, MSB first) into words.

    values (N,) int64 u32 words; lens (N,) int32 in 0..32; entries at
    and past nf are ignored.  Returns (words (N,) int64 big-endian u32
    words, total_bits 0-d int32) on the inputs' device: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    nf = int(nf)
    if values.dim() != 1 or lens.shape != values.shape:
        raise ValueError(f"bad shapes {tuple(values.shape)} / "
                         f"{tuple(lens.shape)}")
    if values.device.type == "cuda":
        return pack_bits_cuda(values, lens, nf)
    if values.device.type == "cpu":
        return pack_bits_plain(values, lens, nf)
    raise ValueError(f"unsupported device {values.device}")


def pack_bits_host(values, lens, nf=None,
                   device: str | torch.device = "cuda") -> bytes:
    """The packed big-endian byte string of host arrays, packed on
    ``device``."""
    dev = resolve(device)
    values = np.asarray(values, np.uint32).astype(np.int64)
    lens = np.asarray(lens, np.int32)
    if nf is None:
        nf = values.size
    words, total = pack_bits_device(upload(values, dev), upload(lens, dev),
                                    nf)
    nbytes = (int(total) + 7) // 8
    return (words.cpu().numpy() & M32).astype(">u4").tobytes()[:nbytes]
