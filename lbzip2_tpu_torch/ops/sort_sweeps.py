"""Compare-exchange sweeps: the hand-written CUDA kernel, its plain
PyTorch version and the dispatching wrapper.

Counterpart of tools/tpu_sort_probe.py::pallas_sweeps (the Pallas TPU
kernel ``_sweep_kernel``), the speed-of-light probe of a sort network:
keys (B, R, 128) int32 are cut into ``sub`` blocks of R / sub rows, and
inside each block every lane takes ``sweeps`` times

    kn[r] = k[(r - 1) mod (R / sub)];   k = min(k, kn) ^ (max(k, kn) & 1)

The kernel is ``csrc/sort_sweeps.cu``: each thread keeps a run of PER
consecutive rows of one lane in registers and passes its last row to
the next thread through shared memory once a sweep, so device memory is
read and written once for all sweeps; see the source for the design.

``sweeps`` takes the plain version only for a CPU tensor.  For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lbzip2_tpu_torch import _build

LANES = 128
_MAX_THREADS = 1024

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


def plan(rows: int) -> tuple[int, int, int]:
    """Launch plan of the kernel for blocks of ``rows`` rows: (PER rows
    per thread, T threads per lane column, C lanes per CTA).  PER is the
    largest power of two up to 64 that divides ``rows``, so T * PER =
    rows exactly; a CTA holds at most 1024 threads (512 at PER = 64,
    whose registers need the larger per-thread budget)."""
    if rows <= 0:
        raise ValueError(f"rows per block must be positive, got {rows}")
    per = min(64, rows & -rows)
    T = rows // per
    cap = _MAX_THREADS if per <= 32 else _MAX_THREADS // 2
    if T > cap:
        raise ValueError(f"{rows} rows per block: {T} threads of {per} "
                         f"rows exceed {cap}")
    C = 32
    while T * C > cap:
        C //= 2
    return per, T, C


def _lib():
    lib = _build.load("sort_sweeps")
    fn = lib.lbz2t_sort_sweeps
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + \
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
    per, T, C = plan(R // sub)
    out = torch.empty_like(keys)
    fn = _lib()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = fn(keys.data_ptr(), out.data_ptr(), B, R, sub, per, T, C, sweeps,
             stream)
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
