"""Compare-exchange sweeps: the hand-written CUDA kernel, its plain
PyTorch version and the dispatching wrapper.

Counterpart of tools/tpu_sort_probe.py::pallas_sweeps (the Pallas TPU
kernel ``_sweep_kernel``), the speed-of-light probe of a sort network:
keys (B, R, 128) int32 are cut into ``sub`` blocks of R / sub rows, and
inside each block every lane takes ``sweeps`` times

    kn[r] = k[(r - 1) mod (R / sub)];   k = min(k, kn) ^ (max(k, kn) & 1)

The kernel is ``csrc/sort_sweeps.cu``: a column's rows lie in the
registers of a run of lanes of one warp (or of 2 to 32 warps where the
column is taller), PER consecutive rows a lane,
and each lane takes its neighbour row from the lane before with one
shuffle a sweep; the max of a compare-exchange is a + b - min on the
FMA pipe.  Device memory is read and written once for all sweeps,
staged through shared memory; see the source for the design.

``sweeps`` takes the plain version only for a CPU tensor.  For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lbzip2_tpu_torch import _build

LANES = 128
# rows a lane holds in registers: the kernel's instances (csrc/
# sort_sweeps.cu), in CTAs of 8 warps; CTAs of 32 warps take those up to 32
PERS = (1, 2, 4, 8, 16, 32, 55, 64)
_WIDE = 32  # warps of a CTA whose columns pass 256 lanes

launches = 0  # CUDA kernel launches made by sweeps / sweeps_cuda


def sweeps_plain(keys: torch.Tensor, sweeps: int, sub: int) -> torch.Tensor:
    """``sweeps`` compare-exchange sweeps on each of the ``sub`` row
    blocks of keys (B, R, 128) int32.  Returns a new tensor."""
    B, R, L = keys.shape
    k = keys.reshape(B, sub, R // sub, L).clone()
    for _ in range(sweeps):
        kn = torch.roll(k, 1, dims=2)
        k = torch.minimum(k, kn) ^ (torch.maximum(k, kn) & 1)
    return k.reshape(B, R, L)


def plan(rows: int) -> tuple[int, int, int, int, int]:
    """Launch plan of the kernel for blocks of ``rows`` rows: (PER rows
    a lane, n lanes a column, wpc warps a column, C columns a CTA, warps
    a CTA); rows = n * PER, PER in ``PERS``.

    A column fits one warp of a CTA of 8 where some n <= 32 does (the
    least PER); then C / 8 columns share a warp, as many as fit, up to
    C = 128.  Else it takes the first n <= 256 lanes of wpc = 2, 4 or 8
    warps of a CTA of 8 (the largest PER: the fewest warps), C = 8 /
    wpc; else the first n <= 1024 lanes of 16 or 32 warps of a CTA of
    32, PER <= 32 (64 registers a thread), C = 32 / wpc.  That takes
    every row count of at most 1024 lanes of the largest power of two up
    to 32 that divides it (every prime below 1024, every block of up to
    32768 rows that 32 divides).  Other row counts (1025, 65536) are
    refused."""
    if rows <= 0:
        raise ValueError(f"rows per block must be positive, got {rows}")
    pers = [p for p in PERS if rows % p == 0]
    for per in pers:
        if rows // per <= 32:
            n, segs = rows // per, 1
            while 2 * segs * n <= 32 and 2 * segs * 8 <= LANES:
                segs *= 2
            return per, n, 1, 8 * segs, 8
    for warps, most in ((8, 64), (_WIDE, 32)):
        for per in reversed(pers):
            n = rows // per
            if per <= most and n <= 32 * warps:
                wpc = 2
                while 32 * wpc < n:
                    wpc *= 2
                return per, n, wpc, warps // wpc, warps
    raise ValueError(f"{rows} rows per block are not n * PER with n <= "
                     f"{32 * _WIDE} lanes and PER in {PERS[:-2]}")


def _lib():
    lib = _build.load("sort_sweeps")
    fn = lib.lbz2t_sort_sweeps
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(keys: torch.Tensor, sub: int) -> None:
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if keys.dim() != 3 or keys.shape[2] != LANES:
        raise ValueError(f"keys must be (B, R, {LANES}), got "
                         f"{tuple(keys.shape)}")
    if sub <= 0 or keys.shape[1] % sub:
        raise ValueError(f"sub {sub} does not divide {keys.shape[1]} rows")


def sweeps_cuda(keys: torch.Tensor, sweeps: int, sub: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    if keys.device.type != "cuda":
        raise ValueError("sweeps_cuda needs keys on a CUDA device")
    _check(keys, sub)
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    B, R, _ = keys.shape
    per, n, wpc, C, warps = plan(R // sub)
    fn = _lib()
    with torch.cuda.device(keys.device):  # the C side launches on it
        out = torch.empty_like(keys)
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = fn(keys.data_ptr(), out.data_ptr(), B, R, sub, per, n, wpc,
                 C, warps, sweeps, stream)
        if err != 0:
            raise RuntimeError(f"sort_sweeps kernel launch failed: "
                               f"cudaError {err}")
    launches += 1
    return out


def sweeps(keys: torch.Tensor, sweeps: int, sub: int) -> torch.Tensor:
    """Compare-exchange sweeps (B, R, 128) int32: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if keys.device.type == "cuda":
        return sweeps_cuda(keys, sweeps, sub)
    if keys.device.type == "cpu":
        _check(keys, sub)
        return sweeps_plain(keys, sweeps, sub)
    raise ValueError(f"unsupported device {keys.device}")
