"""Block sharding: a batch's rows split over a list of devices.

Counterpart of lbzip2_tpu/parallel/sharding.py, where a ``shard_map``
over a 1-D ``blocks`` mesh runs each device's share of the rows and the
host gathers them in block order.  Here a mesh is a list of
``torch.device``s (repeats allowed: a card listed twice runs two
shards), and a sharded step splits the rows into contiguous shards, one
a device, runs every shard in a thread of its own with its device
current and a CUDA stream of its own, and gathers the results on the
host in row order.  Every shard is launched before any is waited on.
No collectives: ordering and the stream CRC stay on the host.

JAX pads the batch to a multiple of the mesh with copies of row 0 or
dummy rows; uneven shards need no padding here, so none is made.  The
outputs for the rows given are the JAX functions' outputs.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from lbzip2_tpu_torch.device import on, resolve, upload
from lbzip2_tpu_torch.ops.bwt import bwt_batched
from lbzip2_tpu_torch.ops.bwt2 import bwt2_full, bwt2_tokens
from lbzip2_tpu_torch.ops.ibwt import ibwt_rows
from lbzip2_tpu_torch.ops.mtf_pallas import mtf_ranks_rows

AXIS = "blocks"  # the JAX mesh's axis name: the rows are blocks

# shard k's stream on a card, kept from call to call: the caching
# allocator serves a stream only from blocks freed on that stream, so a
# new stream each call would allocate every buffer anew
_streams: dict[tuple[torch.device, int], torch.cuda.Stream] = {}


def make_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda") -> list[torch.device]:
    """The first ``n_devices`` cards (default: every visible one) for
    ``"cuda"``, raising when there are fewer; ``n_devices`` logical CPU
    devices (default one) for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve(dev)  # raises without CUDA
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise RuntimeError(f"need {n} cards, have {count}")
        return [torch.device("cuda", i) for i in range(n)]
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else
                                        n_devices)
    raise ValueError(f"unsupported device {device!r}")


def row_splits(B: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous row ranges of ``n_shards`` shards, sizes differing by at
    most one (the first B mod n_shards one row more)."""
    per, extra = divmod(B, n_shards)
    out, a = [], 0
    for k in range(n_shards):
        b = a + per + (k < extra)
        out.append((a, b))
        a = b
    return out


def run_shards(devices, fn, *arrays) -> list:
    """Split each of ``arrays`` (numpy arrays or tensors, rows first) over
    ``devices`` and call ``fn(device, *rows)`` for every shard that has
    rows, each in a thread of its own with its device current and, on a
    card, a stream of its own.  All shards start before any is joined.
    Returns the shards' results in row order; the first error of a shard
    is raised once every shard has ended."""
    B = len(arrays[0])
    jobs = [(dev, a, b) for dev, (a, b) in
            zip(devices, row_splits(B, len(devices))) if b > a]
    results: list = [None] * len(jobs)
    errors: list = [None] * len(jobs)
    streams = [_stream(dev, k) for k, (dev, _, _) in enumerate(jobs)]

    def work(k, dev, a, b):
        try:
            with on(dev, streams[k]):
                results[k] = fn(dev, *(x[a:b] for x in arrays))
                if streams[k] is not None:
                    streams[k].synchronize()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[k] = e

    threads = [threading.Thread(target=work, args=(k, *job),
                                name=f"lbz2-shard{k}", daemon=True)
               for k, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _stream(dev: torch.device, k: int) -> torch.cuda.Stream | None:
    """Shard k's stream on ``dev`` (None on the CPU)."""
    if dev.type != "cuda":
        return None
    stream = _streams.get((dev, k))
    if stream is None:
        stream = _streams[(dev, k)] = torch.cuda.Stream(dev)
    return stream


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _block_stage_rows(dev: torch.device, blocks, ns):
    """The per-block stage of a shard: (bwt (B, N) uint8, primary (B,)
    int32, ranks (B, N) int32) tensors on ``dev`` of the rotation BWT of
    blocks[b, :ns[b]] and the MTF ranks of its compacted symbols.

    The BWT is the v1 rotation sort, ``ops/bwt.py::bwt_batched``, as
    JAX's stage runs ``bwt_masked`` (on a card its kernels, periodic
    blocks among them, with nothing read on the host).  Lanes at and past
    n are 0.  The used bytes are counted over the whole row, padding
    included, with byte 0 used only if it occurs more often than the
    padding, as JAX does."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    ns = np.asarray(ns, np.int32)
    B, N = blocks.shape
    blocks_d, ns_d = upload(blocks, dev), upload(ns, dev)
    bwt, primary = bwt_batched(blocks_d, ns_d)
    hist = torch.zeros((B, 256), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, blocks_d.long(), torch.ones_like(blocks_d,
                                                          dtype=torch.int32))
    used = hist > 0
    used[:, 0] = hist[:, 0] > N - ns_d
    cmap = torch.cumsum(used.int(), 1, dtype=torch.int32) - used.int()
    syms = torch.gather(cmap, 1, bwt.long())
    ranks = mtf_ranks_rows(syms.contiguous(), ns_d)
    return bwt, primary.int(), ranks


def _block_stage(block: torch.Tensor, n):
    """Per-block device stage (lbzip2_tpu/parallel/sharding.py:30): BWT
    + MTF ranks of block[:n].  block (N,) uint8 tensor; returns (bwt (N,)
    uint8, primary 0-d int32, ranks (N,) int32) on the block's
    device."""
    bwt, primary, ranks = _block_stage_rows(
        block.device, block.cpu().numpy()[None], np.array([int(n)]))
    return bwt[0], primary[0], ranks[0]


def sharded_encode_step(mesh: list[torch.device], axis: str = AXIS):
    """The sharded per-block stage: step(blocks (B, N) uint8, ns (B,))
    -> host (bwt (B, N) uint8, primary (B,) int32, ranks (B, N) int32)
    in row order."""
    def shard(dev, blocks, ns):
        return tuple(_host(t) for t in _block_stage_rows(dev, blocks, ns))

    def step(blocks, ns):
        return _gather(run_shards(mesh, shard, blocks, ns))
    return step


def _gather(parts: list) -> tuple:
    return tuple(np.concatenate(cols) for cols in zip(*parts))


def _uploads(dev, *arrays):
    return [upload(np.ascontiguousarray(a), dev) for a in arrays]


def _bwt_step(mesh: list[torch.device], bwt):
    """step(blocks (B, N) uint8, ns, ms (B,)) running ``bwt`` on each
    shard, its outputs gathered on the host in row order."""
    def shard(dev, blocks, ns, ms):
        return tuple(_host(t) for t in bwt(*_uploads(dev, blocks, ns, ms)))

    def step(blocks, ns, ms):
        return _gather(run_shards(mesh, shard, blocks,
                                  np.asarray(ns, np.int32),
                                  np.asarray(ms, np.int32)))
    return step


def sharded_encode_step_v2(mesh: list[torch.device], axis: str = AXIS):
    """Sharded production BWT (``bwt2_full``): step(blocks (B, N) uint8,
    ns, ms (B,) int32) -> host (int32-packed BWT rows (B, N // 4),
    primary (B,) int32).  Each device loops its own shard to
    convergence.  ``axis`` names the JAX mesh axis; a list has one."""
    return _bwt_step(mesh, bwt2_full)


def sharded_encode_step_tokens(mesh: list[torch.device], axis: str = AXIS):
    """Sharded production BWT with the run-token emit (``bwt2_tokens``):
    step(blocks, ns, ms) -> host (tokens (B, T) int32 holding u16 pairs,
    raw-packed rows, run counts, primary) in row order."""
    return _bwt_step(mesh, bwt2_tokens)


def encode_batch_sharded_tokens(blocks: np.ndarray, ns: np.ndarray,
                                ms: np.ndarray, mesh=None):
    """Sharded token-emit BWT; returns (tokens u16 (B, 2T), counts, raw
    rows (B, N) uint8, primary) on the host."""
    if mesh is None:
        mesh = make_mesh()
    tokens, raw, counts, primary = sharded_encode_step_tokens(mesh)(
        blocks, ns, ms)
    B = tokens.shape[0]
    return (tokens.view(np.uint16).reshape(B, -1), counts,
            raw.view(np.uint8).reshape(B, -1), primary)


def encode_batch_sharded_v2(blocks: np.ndarray, ns: np.ndarray,
                            ms: np.ndarray, mesh=None):
    """Sharded v2 BWT; returns ((B, N) uint8 BWT rows, primary) on the
    host."""
    if mesh is None:
        mesh = make_mesh()
    packed, primary = sharded_encode_step_v2(mesh)(blocks, ns, ms)
    return packed.view(np.uint8).reshape(packed.shape[0], -1), primary


def sharded_decode_step(mesh: list[torch.device], axis: str = AXIS):
    """Sharded batched inverse BWT (``ibwt_rows``: the csrc/ibwt.cu
    kernel on a card): step(bwts (B, N) uint8, ns, idxs (B,)) -> host
    (B, N) uint8."""
    def shard(dev, bwts, ns, idxs):
        return (_host(ibwt_rows(*_uploads(dev, bwts, ns, idxs))),)

    def step(bwts, ns, idxs):
        return _gather(run_shards(mesh, shard, np.asarray(bwts, np.uint8),
                                  np.asarray(ns, np.int32),
                                  np.asarray(idxs, np.int32)))[0]
    return step


def decode_batch_sharded(bwts: np.ndarray, ns: np.ndarray,
                         idxs: np.ndarray, mesh=None) -> np.ndarray:
    """Run the sharded IBWT; returns host numpy plain-byte blocks."""
    if mesh is None:
        mesh = make_mesh()
    return sharded_decode_step(mesh)(bwts, ns, idxs)


def encode_batch_sharded(blocks: np.ndarray, ns: np.ndarray, mesh=None):
    """Run the sharded encode stage; returns host numpy (bwt, primary,
    ranks) in row order."""
    if mesh is None:
        mesh = make_mesh()
    return sharded_encode_step(mesh)(blocks, np.asarray(ns, np.int32))
