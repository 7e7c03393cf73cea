"""Entry points: the per-block encode stage on one device, and the
multi-device dry run.

Counterpart of ``__graft_entry__.py`` at the repository's root: the
"flagship" stage is the per-block encode (BWT + MTF ranks,
``parallel/sharding._block_stage``), and the step over several devices
is the sharded encode, token emit, entropy chain and decode of one
production-size block a device (lbzip2's block data parallelism).

    python -m lbzip2_tpu_torch.entry [N_DEVICES]

runs the dry run over the first N_DEVICES cards (default: every
visible one).
"""

from __future__ import annotations

import bz2
import pathlib
import sys

import numpy as np
import torch

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.core import crc32
from lbzip2_tpu_torch.device import resolve, upload
from lbzip2_tpu_torch.ops.chain import chain_payloads
from lbzip2_tpu_torch.parallel.sharding import (AXIS, _block_stage,
                                                decode_batch_sharded,
                                                encode_batch_sharded,
                                                encode_batch_sharded_tokens,
                                                encode_batch_sharded_v2,
                                                make_mesh)
from lbzip2_tpu_torch.ref.rle1 import transform_span

WIDTH = 901120  # the -9 bucket's row width
_PKG = pathlib.Path(__file__).resolve().parent


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the per-block encode stage and one block of
    8192 lanes holding 5000 random bytes from seed 0, on ``device``."""
    N, n = 8192, 5000
    rng = np.random.default_rng(0)
    block = np.zeros(N, dtype=np.uint8)
    block[:n] = rng.integers(0, 256, n, dtype=np.uint8)
    return _block_stage, (upload(block, resolve(device)), n)


def repo_text(nbytes: int) -> bytes:
    """At least ``nbytes`` of text: the package's own C and CUDA sources,
    repeated."""
    base = b"".join(p.read_bytes() for p in
                    sorted(_PKG.glob("native/*.c")) +
                    sorted(_PKG.glob("csrc/*.cu")))
    return base * (nbytes // len(base) + 1)


def dryrun_blocks(B: int, width: int = WIDTH):
    """B Lyndon-prepped blocks of ``width`` lanes, as the JAX dry run
    makes them (seed 1; 880000 to 896000 bytes at the -9 width, text
    and random bytes over 32 values in turns): (blocks, ns, ms, raws,
    cmaps, rle_rows)."""
    rng = np.random.default_rng(1)
    blocks = np.zeros((B, width), dtype=np.uint8)
    ns = np.empty(B, dtype=np.int32)
    ms = np.empty(B, dtype=np.int32)
    raws, cmaps, rle_rows = [], [], []
    lo, hi = width * 880000 // WIDTH, width * 896000 // WIDTH
    text = repo_text(B * 997 + hi)
    for b in range(B):
        n = int(rng.integers(lo, hi))
        raw = (rng.integers(0, 32, n, dtype=np.uint8) if b % 2 else
               np.frombuffer(text[b * 997:b * 997 + n], np.uint8))
        blk, cmap = transform_span(raw)
        rot, m = native.lyndon_prep(blk)
        if m < 0 or rot.size > width:
            raise AssertionError(f"row {b}: periodic or too wide")
        blocks[b, :rot.size] = rot
        ns[b] = rot.size
        ms[b] = m
        raws.append(raw)
        cmaps.append(cmap)
        rle_rows.append(blk)
    return blocks, ns, ms, raws, cmaps, rle_rows


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     width: int = WIDTH) -> dict:
    """One Lyndon-prepped block a device of ``make_mesh(n_devices,
    device)``, ``width`` lanes (the -9 bucket; the CPU tests take 8192):
    the sharded bwt2 encode, the sharded token emit, the sharded device
    entropy chain with every payload byte-exact against
    ``native.encode_payload`` and the stream through ``bz2.decompress``,
    and the sharded IBWT decode back to the RLE1 rows; then the sharded
    per-block stage (``_block_stage``: the v1 rotation sort and the MTF
    ranks) on the RLE1 rows as they stand, whose BWT rows and primaries
    must be bwt2's.  Returns what it checked; raises on any
    difference."""
    mesh = make_mesh(n_devices, device)
    B = n_devices
    blocks, ns, ms, raws, cmaps, rle_rows = dryrun_blocks(B, width)

    # sharded encode: the production bwt2, each shard to convergence
    bwt_rows, primary = encode_batch_sharded_v2(blocks, ns, ms, mesh)

    # sharded token emit: the tokens expand to the same rows; a row over
    # the token capacity is read raw, as production does
    tok, counts, raw_rows, tok_primary = encode_batch_sharded_tokens(
        blocks, ns, ms, mesh)
    token_rows = 0
    for b in range(B):
        assert tok_primary[b] == primary[b], b
        if counts[b] <= tok.shape[1]:
            t = tok[b, :counts[b]]
            exp = np.repeat((t >> 8).astype(np.uint8),
                            (t & 0xFF).astype(np.int64))
            assert np.array_equal(exp, bwt_rows[b, :ns[b]]), b
            token_rows += 1
        else:
            assert np.array_equal(raw_rows[b, :ns[b]],
                                  bwt_rows[b, :ns[b]]), b

    # the production entropy chain, sharded: each payload byte-exact
    # against the host C encoder, the stream through libbzip2
    crcs = np.asarray([crc32.crc_of(r) for r in raws], np.uint32)
    cmaps_u8 = np.stack([np.asarray(c, np.uint8) for c in cmaps])
    payloads = chain_payloads(bwt_rows, ns, cmaps_u8,
                              np.asarray(primary, np.int32), crcs,
                              mesh_axis=(mesh, AXIS))
    parts = [b"BZh9"]
    combined = chain_rows = 0
    for b in range(B):
        want = bytes(native.encode_payload(bwt_rows[b, :ns[b]], cmaps_u8[b],
                                           int(primary[b]), int(crcs[b]),
                                           8))
        if payloads[b] is not None:  # None: over the pack width
            assert payloads[b] == want, \
                f"sharded chain payload row {b} differs from the C encoder"
            chain_rows += 1
        parts.append(want)
        combined = crc32.combine_crc(combined, int(crcs[b]))
    parts.append(bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) +
                 combined.to_bytes(4, "big"))
    stream = b"".join(parts)
    assert bz2.decompress(stream) == b"".join(r.tobytes() for r in raws)

    # sharded decode: the IBWT over the same devices
    plains = decode_batch_sharded(bwt_rows, ns, primary, mesh)
    for b in range(B):
        assert np.array_equal(plains[b, :ns[b]], rle_rows[b]), b

    # the v1 stage, sharded, on the unrotated rows: the same BWT
    unrotated = np.zeros_like(blocks)
    for b in range(B):
        unrotated[b, :ns[b]] = rle_rows[b]
    v1_rows, v1_primary, _ = encode_batch_sharded(unrotated, ns, mesh)
    for b in range(B):
        assert v1_primary[b] == primary[b] and np.array_equal(
            v1_rows[b, :ns[b]], bwt_rows[b, :ns[b]]), \
            f"the v1 stage's row {b} differs from bwt2's"
    return {"devices": [str(d) for d in mesh], "blocks": B, "width": width,
            "token_rows": token_rows, "chain_rows": chain_rows,
            "v1_rows": B, "stream_bytes": len(stream)}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else len(make_mesh())
    print(dryrun_multichip(n))
