"""Single-row MTF ranks.

Counterpart of lbzip2_tpu/ops/mtf.py::mtf_ranks (a ``lax.scan`` over
fixed-size chunks of the order-statistics identity).  The same function
is ``ops/mtf_pallas.py::mtf_ranks_rows``: its CUDA kernel on a card, its
plain version on the CPU.  This is its one-row form, with no kernel of
its own.
"""

from __future__ import annotations

import torch

from lbzip2_tpu_torch.ops.mtf_pallas import mtf_ranks_rows

_CHUNK = 512


def mtf_ranks(syms: torch.Tensor, n, chunk: int = _CHUNK) -> torch.Tensor:
    """MTF ranks of compacted symbols syms[:n] ((N,) int32, N a multiple
    of ``chunk`` as in the JAX op).  Returns (N,) int32 ranks; entries
    >= n are 0."""
    N = syms.shape[0]
    if N % chunk:
        raise ValueError("pad block length to a multiple of chunk")
    ns = torch.full((1,), int(n), dtype=torch.int32, device=syms.device)
    return mtf_ranks_rows(syms.int().reshape(1, N).contiguous(), ns)[0]
