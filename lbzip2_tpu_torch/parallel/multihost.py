"""Multi-host compression: torch.distributed processes, payloads
reassembled on process 0.

Counterpart of lbzip2_tpu/parallel/multihost.py.  One process a host;
each compresses a window-aligned shard of the input (block boundaries
match the single-host result), and process 0 reassembles the payloads
in stream order and folds the combined CRC.

Payloads go point to point: every worker streams its (ragged) payload
straight to a socket on process 0's host, so the wire carries the
payload bytes once.  The padded allgather (``torch.distributed``'s
``all_gather`` of CPU tensors over gloo) is the fallback
(``LBZ2_MULTIHOST_EXCHANGE=allgather``, or no known address of host 0).
Gloo is the backend on hosts with and without cards alike: everything
exchanged is host bytes.

With a single process the exchange is the identity.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np
import torch
import torch.distributed as dist

from lbzip2_tpu_torch.core import crc32

_P2P_PORT = int(os.environ.get("LBZ2_MULTIHOST_PORT", "29747"))

_coordinator_host: str | None = None  # kept by initialize_distributed


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join ``num_processes`` processes over gloo, the rendezvous at
    ``coordinator`` ("host:port"); a single process initializes
    nothing."""
    global _coordinator_host
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _coordinator_host = coordinator.rsplit(":", 1)[0]


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shard_bounds(total_size: int, level: int, num_processes: int,
                 process_id: int) -> tuple[int, int]:
    """Window-aligned input shard for this process.

    Shards are multiples of in_granul (= level*100000) so every process
    produces exactly the blocks the single-host encoder would."""
    granul = level * 100000
    windows = (total_size + granul - 1) // granul
    per = (windows + num_processes - 1) // num_processes
    a = min(process_id * per * granul, total_size)
    b = min((process_id + 1) * per * granul, total_size)
    return a, b


def compress_multihost(shard: bytes | np.ndarray, level: int = 9,
                       n_workers: int | None = None,
                       engine: str | None = None,
                       device: str | torch.device = "cuda") -> bytes | None:
    """Compress this host's (window-aligned) shard and reassemble on
    process 0.  Returns the full stream on process 0, None elsewhere.

    engine: "hybrid" runs the port's device + host pool
    (``codec.encoder.compress_blocks_hybrid``) on ``device``; "host" the
    C-only pipeline; None reads LBZ2_MULTIHOST_ENGINE (default
    "hybrid")."""
    from lbzip2_tpu_torch.parallel.encode import compress_blocks

    if engine is None:
        engine = os.environ.get("LBZ2_MULTIHOST_ENGINE", "hybrid")

    buf = np.frombuffer(bytes(shard), np.uint8) if not isinstance(
        shard, np.ndarray) else shard
    if engine == "hybrid":
        from lbzip2_tpu_torch.codec.encoder import compress_blocks_hybrid
        block_payloads, crcs = compress_blocks_hybrid(
            buf, level, entropy_workers=n_workers, device=device)
    else:
        block_payloads, crcs = compress_blocks(buf, level,
                                               n_workers=n_workers)
    payload = b"".join(block_payloads)

    nproc = process_count()
    if nproc == 1:
        return _assemble([payload], [crcs], level)

    pid = process_index()
    host0 = _host0_address()
    if host0 is not None and \
            os.environ.get("LBZ2_MULTIHOST_EXCHANGE", "p2p") == "p2p":
        got = _gather_to_zero(payload, list(crcs), pid, nproc, host0)
        if pid != 0:
            return None
        payloads, crclists = got
        return _assemble(payloads, crclists, level)

    # Fallback: padded allgather of CPU tensors (O(P*max) wire).
    all_len = _allgather(np.asarray([len(payload)], np.int64))[:, 0]
    padded = np.zeros(int(all_len.max()), np.uint8)
    padded[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = _allgather(padded)
    all_ncrc = _allgather(np.asarray([len(crcs)], np.int64))[:, 0]
    cpad = np.zeros(int(max(1, all_ncrc.max())), np.int64)
    cpad[:len(crcs)] = np.asarray(crcs, np.uint32)
    gcrcs = _allgather(cpad)

    if pid != 0:
        return None
    payloads = [gathered[p, :all_len[p]].tobytes() for p in range(nproc)]
    crclists = [gcrcs[p, :all_ncrc[p]].tolist() for p in range(nproc)]
    return _assemble(payloads, crclists, level)


def _allgather(x: np.ndarray) -> np.ndarray:
    """Every process's ``x`` (equal shapes), stacked in process order."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _host0_address() -> str | None:
    """Host running process 0: LBZ2_HOST0_ADDR, else the coordinator's
    host that initialize_distributed kept, else MASTER_ADDR."""
    return (os.environ.get("LBZ2_HOST0_ADDR") or _coordinator_host
            or os.environ.get("MASTER_ADDR") or None)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = conn.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


def _gather_to_zero(payload: bytes, crcs: list[int], pid: int,
                    nproc: int, host0: str, timeout_s: float = 600.0):
    """Point-to-point ragged gather: every worker streams
    (pid, payload, crcs) to a TCP socket on host 0; total wire traffic
    is O(sum of payloads).  Returns (payloads, crclists) in process
    order on process 0, None elsewhere."""
    hdr = struct.Struct("<qqq")  # pid, payload_len, ncrc
    if pid == 0:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("", _P2P_PORT))
        srv.listen(nproc)
        srv.settimeout(timeout_s)
        payloads: list[bytes | None] = [None] * nproc
        crclists: list[list[int] | None] = [None] * nproc
        payloads[0] = payload
        crclists[0] = crcs
        try:
            remaining = nproc - 1
            while remaining:
                conn, _ = srv.accept()
                with conn:
                    p, plen, ncrc = hdr.unpack(
                        _recv_exact(conn, hdr.size))
                    payloads[p] = _recv_exact(conn, plen)
                    crclists[p] = np.frombuffer(
                        _recv_exact(conn, 4 * ncrc),
                        np.uint32).tolist()
                remaining -= 1
        finally:
            srv.close()
        return payloads, crclists
    # worker: connect (host 0 may not be listening yet: retry)
    deadline = time.time() + timeout_s
    last = None
    while True:
        try:
            conn = socket.create_connection((host0, _P2P_PORT),
                                            timeout=10.0)
            break
        except OSError as e:  # noqa: PERF203
            last = e
            if time.time() > deadline:
                raise TimeoutError(
                    f"cannot reach host 0 at {host0}:{_P2P_PORT}"
                ) from last
            time.sleep(0.2)
    with conn:
        conn.sendall(hdr.pack(pid, len(payload), len(crcs)))
        conn.sendall(payload)
        conn.sendall(np.asarray(crcs, np.uint32).tobytes())
    return None


def _assemble(payloads: list[bytes], crclists: list[list[int]],
              level: int) -> bytes:
    combined = 0
    for crcs in crclists:
        for c in crcs:
            combined = crc32.combine_crc(combined, c)
    return (bytes([0x42, 0x5A, 0x68, 0x30 + level]) + b"".join(payloads)
            + bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90])
            + combined.to_bytes(4, "big"))
