"""bzip2 CRC-32 of a block where it lies: the hand-written CUDA kernel,
its plain PyTorch version and the dispatching wrapper.

Counterpart of lbzip2_tpu/ops/crc.py (``crc32_device``, an XLA op, and
its host wrapper ``crc32_block_device``).  Same math as
``core/crc32.py``: positional byte tables give the zero-init CRC of
each 32-byte leaf, and a logarithmic fold applies "advance by L zero
bytes" operators through byte-indexed tables.  The kernel is
``csrc/crc32.cu`` (one thread a leaf, a shuffle tree in each warp, a
second launch over the CTAs' sums); only the 4-byte register leaves
the device.  A JAX u32 is an int64 here (``interop.py``).

``crc32_device`` takes the plain version only for a CPU tensor.  For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lbzip2_tpu_torch import _build
from lbzip2_tpu_torch.core import crc32 as hostcrc
from lbzip2_tpu_torch.device import resolve, upload

_CHUNK = 32
_MAX_LEVELS = 18  # supports up to 32 * 2^18 = 8 MiB blocks
_SEG_BYTES = 1024 * _CHUNK  # bytes a CTA of the kernel folds

launches = 0  # CUDA kernel launches made by crc32_device

_tables_np: tuple[np.ndarray, np.ndarray] | None = None
_tables_on: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(positional tables (32, 256), level tables (18, 4, 256)) uint32:
    level l advances a register by 32 << l zero bytes."""
    global _tables_np
    if _tables_np is None:
        log2_chunk = 5
        hostcrc._OPS.ensure(log2_chunk + _MAX_LEVELS - 1)
        lvl = np.stack([hostcrc._OPS.pow2_tabs[log2_chunk + level]
                        for level in range(_MAX_LEVELS)])
        _tables_np = (np.asarray(hostcrc._POS_TABLES, np.uint32), lvl)
    return _tables_np


def _tables_for(dev: torch.device, kernel: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tables on ``dev``, made once a device: int64 words for the
    plain version, the uint32 bit patterns as int32 for the kernel."""
    held = _tables_on.get((dev, kernel))
    if held is None:
        held = tuple(torch.from_numpy(
            t.view(np.int32) if kernel else t.astype(np.int64)).to(dev)
            for t in _tables())
        _tables_on[(dev, kernel)] = held
    return held


def _advance(tabs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a linear op given as 4 x 256 byte tables to int64 words."""
    return (tabs[0][x & 0xFF] ^ tabs[1][(x >> 8) & 0xFF]
            ^ tabs[2][(x >> 16) & 0xFF] ^ tabs[3][(x >> 24) & 0xFF])


def crc32_plain(block: torch.Tensor, n: int) -> torch.Tensor:
    """The JAX formulation (lbzip2_tpu/ops/crc.py:49): the valid bytes
    shifted to the end of the (N,) buffer, leaves by positional tables,
    a fold that puts a zero leaf in front of an odd count.  Returns the
    zero-init register as a 0-d int64 tensor."""
    N = block.shape[0]
    pos, lvl = _tables_for(block.device)
    idx = torch.arange(N, device=block.device)
    src = idx - (N - n)
    data = torch.where(src >= 0, block[src.clamp(0, max(N - 1, 0))], 0)
    chunks = data.reshape(N // _CHUNK, _CHUNK).long()
    acc = pos[0][chunks[:, 0]]
    for j in range(1, _CHUNK):
        acc = acc ^ pos[j][chunks[:, j]]
    level = 0
    while acc.shape[0] > 1:
        if acc.shape[0] % 2:
            acc = torch.cat([torch.zeros_like(acc[:1]), acc])
        acc = _advance(lvl[level], acc[0::2]) ^ acc[1::2]
        level += 1
    return acc[0] if acc.numel() else torch.zeros((), dtype=torch.long,
                                                  device=block.device)


def _lib():
    fn = _build.load("crc32").lbz2t_crc32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + \
            [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def crc32_cuda(block: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream (no synchronize)."""
    global launches
    dev = block.device
    if dev.type != "cuda":
        raise ValueError("crc32_cuda needs the block on a CUDA device")
    if not block.is_contiguous():
        raise ValueError("the block must be contiguous")
    with torch.cuda.device(dev):
        pos, lvl = _tables_for(dev, kernel=True)
        seg = torch.empty(max(1, -(-n // _SEG_BYTES)), dtype=torch.int32,
                          device=dev)
        out = torch.empty((), dtype=torch.int64, device=dev)
        err = _lib()(block.data_ptr(), n, pos.data_ptr(), lvl.data_ptr(),
                     seg.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"crc32 kernel launch failed: cudaError {err}")
    launches += 1
    return out


def crc32_device(block: torch.Tensor, n) -> torch.Tensor:
    """Zero-init CRC register of block[:n] (block (N,) uint8, N a
    multiple of 32, at most 8 MiB) as a 0-d int64 tensor on the block's
    device: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor.  The caller folds in the init register's part
    (``crc32_block_device`` does)."""
    n = int(n)
    N = block.shape[0]
    if block.dtype != torch.uint8 or block.dim() != 1:
        raise TypeError("the block must be a (N,) uint8 tensor")
    if N % _CHUNK or N > _CHUNK << _MAX_LEVELS or not 0 <= n <= N:
        raise ValueError(f"bad block: N {N} (a multiple of 32 up to 8 MiB) "
                         f"and n {n}")
    if block.device.type == "cuda":
        return crc32_cuda(block, n)
    if block.device.type == "cpu":
        return crc32_plain(block, n)
    raise ValueError(f"unsupported device {block.device}")


def crc32_block_device(block_np, n: int,
                       device: str | torch.device = "cuda") -> int:
    """Stored CRC of block_np[:n] (init register and final xor applied),
    the register computed on ``device``."""
    dev = resolve(device)
    reg0 = int(crc32_device(upload(np.asarray(block_np, np.uint8), dev), n))
    init_part = hostcrc._OPS.advance_scalar(hostcrc.INIT, int(n))
    return hostcrc.crc_finalize(reg0 ^ init_part)
