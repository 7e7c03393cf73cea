"""Array hand-over between numpy (the JAX package's host side) and torch.

dtype map (numpy -> torch):

  uint8 -> uint8, bool -> bool, int32 -> int32, int64 -> int64,
  float32 -> float32, float64 -> float64,
  uint32 -> int64 masked to 32 bits.

A JAX ``uint32`` word is held as ``int64`` because CPU torch has no
uint32 ``<<``/``>>`` and its int32 ``>>`` is arithmetic; every port
function that computes on such words masks with ``M32`` after each add
and shift.  ``to_numpy(t, like=...)`` gives the JAX dtype back.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

_TO_TORCH = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint32): torch.int64,
}


def to_torch(a, device: torch.device | str = "cpu") -> torch.Tensor:
    """numpy (or array-like) -> torch tensor on ``device`` per the map."""
    a = np.asarray(a)
    if a.dtype not in _TO_TORCH:
        raise TypeError(f"no torch dtype mapped for {a.dtype}")
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.require(a, requirements="CW")).to(device)


def to_numpy(t: torch.Tensor, like=None) -> np.ndarray:
    """torch tensor -> numpy, cast to ``like``'s dtype (a dtype or an
    array; default: the tensor's own).  ``like=np.uint32`` takes the
    low 32 bits of an int64-held word."""
    a = t.detach().cpu().numpy()
    if like is None:
        return a
    dt = like.dtype if isinstance(like, np.ndarray) else np.dtype(like)
    if dt == np.uint32:
        return (a.astype(np.int64) & M32).astype(np.uint32)
    return a.astype(dt)
