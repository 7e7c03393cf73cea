"""bzip2 CRC-32 of a block where it lies: the hand-written CUDA kernel,
its plain PyTorch version and the dispatching wrapper.

Counterpart of lbzip2_tpu/ops/crc.py (``crc32_device``, an XLA op, and
its host wrapper ``crc32_block_device``).  Same math as
``core/crc32.py``: the register is linear over GF(2) in the bytes, so
pieces' zero-init CRCs advanced by "L zero bytes" operators and XORed
give the block's.  The kernel is ``csrc/crc32.cu``, one launch:
persistent CTAs read the block once in 16-byte vectors at its own
alignment (head and tail by bytes) and fold each segment of
``_seg_bytes(n)`` bytes (cut from the block's end back) with positional
and byte tables that each CTA builds in shared memory from the
matrices and bit images of ``_kernel_tables``; each warp's lanes are
folded by one GF(2) matrix a lane and the warp's register advanced to n
by the hex digits of its distance (one matrix a nonzero digit, a warp's
XOR reduction); the CTA that draws the last ticket XORs the CTAs'
slots.  The slots and the ticket are held per thread and device
(``ops/lookback.py::scratch``), so a call allocates only its output.
The kernel's constants (``_THREADS``, ``_ROUND``, the segment size and
the tables' layout) are set here and passed to it, which checks them;
the CPU tests' model of the kernel reads the same.  A JAX u32 is an
int64 here (``interop.py``).

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
from lbzip2_tpu_torch.ops import lookback

_CHUNK = 32
_MAX_LEVELS = 18  # supports up to 32 * 2^18 = 8 MiB blocks
# the kernel's: threads a CTA, bytes a warp reads a round (its lanes'
# vectors at 16 l and _HALF + 16 l), bytes a CTA reads a round, the
# segments a call aims at (a CTA an SM of an H100), and the hex digits of
# a distance (the matrices S^(v 16^p) of the advance to n)
_THREADS = 512
_WARP_BYTES = 1024
_HALF = _WARP_BYTES // 2
_ROUND = _THREADS // 32 * _WARP_BYTES
_SEGMENTS = 132
_DIGITS = 6

launches = 0  # CUDA kernel launches made by crc32_device

_tables_np: tuple[np.ndarray, np.ndarray] | None = None
_tables_on: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_kernel_np: np.ndarray | None = None
_kernel_on: dict[torch.device, torch.Tensor] = {}


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


def _tables_for(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's tables on ``dev`` as int64 words, made once a
    device."""
    held = _tables_on.get(dev)
    if held is None:
        held = tuple(torch.from_numpy(t.astype(np.int64)).to(dev)
                     for t in _tables())
        _tables_on[dev] = held
    return held


def _seg_bytes(n: int) -> int:
    """Bytes of the kernel's segments for a block of n bytes: whole
    rounds of ``_ROUND``, as few as give about ``_SEGMENTS`` segments."""
    body_rounds = -(-n // _ROUND)
    return max(1, -(-body_rounds // _SEGMENTS)) * _ROUND


def _max_segments(n: int) -> int:
    """Segments of n bytes at any alignment (the kernel cuts the
    16-byte-aligned body, at most n + 15 bytes): the slots a call needs."""
    return max(1, -(-(n + 15) // _seg_bytes(n)))


def _leaf_tables() -> np.ndarray:
    """(32, 256) uint32: entry [j, b] the register of byte b at place j
    of a lane's 32-byte leaf relative to the leaf's end.  Places 0..15
    are the vector at 16 l, which lies _HALF bytes before the one at
    _HALF + 16 l: S^(_HALF + 15 - j)(T); places 16..31 S^(31 - j)(T)."""
    ops = hostcrc._OPS
    pos = np.asarray(hostcrc._POS_TABLES, np.uint32)  # S^(31 - j)(T)
    half = _HALF.bit_length() - 1
    front = np.stack([ops.advance_vec(pos[j + 16], half) for j in range(16)])
    return np.concatenate([front, pos[16:]])


def _hex_matrices() -> np.ndarray:
    """(_DIGITS, 15, 32) uint32: [p, v - 1] the matrix of S^(v 16^p),
    column i the image of bit i."""
    ops = hostcrc._OPS
    ops.ensure(4 * (_DIGITS - 1))
    out = np.zeros((_DIGITS, 15, 32), np.uint32)
    for p in range(_DIGITS):
        out[p, 0] = ops.pow2[4 * p]
        for v in range(1, 15):
            out[p, v] = hostcrc._op_compose(out[p, 0], out[p, v - 1])
    return out


def _lane_matrices() -> np.ndarray:
    """(32, 32) uint32: [k, l] column k of lane l's matrix,
    S^(16 (31 - l)), which takes a lane's register to its warp chunk's
    end."""
    return np.array([[hostcrc._OPS.advance_scalar(1 << k, 16 * (31 - lane))
                      for lane in range(32)] for k in range(32)], np.uint32)


def _kernel_tables() -> np.ndarray:
    """The kernel's tables, uint32, 16.25 KB: the matrices of S^(v 16^p)
    (``_hex_matrices``, in that order), the leaf tables' basis, (32, 8):
    entry [j, i] the register of the byte 1 << i at place j, and the
    lanes' matrices (``_lane_matrices``).  Every table is linear in its
    byte over GF(2), so ``csrc/crc32.cu`` builds the positional tables
    and the byte tables of S^(_ROUND) from these in shared memory."""
    global _kernel_np
    if _kernel_np is None:
        basis = _leaf_tables()[:, 1 << np.arange(8)]
        _kernel_np = np.concatenate(
            [_hex_matrices().reshape(-1), basis.reshape(-1),
             _lane_matrices().reshape(-1)]).astype(np.uint32)
    return _kernel_np


def _kernel_tables_on(dev: torch.device) -> torch.Tensor:
    """``_kernel_tables`` on ``dev`` as int32 bit patterns, made once a
    device."""
    held = _kernel_on.get(dev)
    if held is None:
        held = _kernel_on[dev] = torch.from_numpy(
            _kernel_tables().view(np.int32)).to(dev)
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
    lib = _build.load("crc32")
    fn = lib.lbz2t_crc32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lbz2t_crc32_table_words.restype = ctypes.c_longlong
        if lib.lbz2t_crc32_table_words() != _kernel_tables().size:
            raise RuntimeError("csrc/crc32.cu reads another table layout")
    return fn


def crc32_cuda(block: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    dev = block.device
    if dev.type != "cuda":
        raise ValueError("crc32_cuda needs the block on a CUDA device")
    if not block.is_contiguous():
        raise ValueError("the block must be contiguous")
    with torch.cuda.device(dev):
        fn = _lib()
        tables = _kernel_tables_on(dev)
        slots, state, _ = lookback.scratch("crc32", dev, _max_segments(n), 1)
        out = torch.empty((), dtype=torch.int64, device=dev)
        err = fn(block.data_ptr(), n, tables.data_ptr(), _seg_bytes(n),
                 _THREADS, slots.data_ptr(), slots.numel(), state.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
