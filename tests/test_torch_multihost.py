"""The port's multi-host compression (lbzip2_tpu_torch/parallel/
multihost.py) against the JAX package's: window-aligned shards, the
single-process stream, manual shard assembly, and real runs of 4
processes over the point-to-point gather and 2 over the gloo allgather,
each process stream equal to the single-host one."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lbzip2_tpu.parallel import multihost as JMH
from lbzip2_tpu.parallel.encode import compress_parallel as jax_parallel
from lbzip2_tpu_torch.parallel import multihost as MH
from lbzip2_tpu_torch.parallel.encode import (compress_blocks,
                                              compress_parallel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("total", [0, 1, 99999, 100000, 100001, 1234567])
def test_shard_bounds_match_jax(total):
    for level in (1, 9):
        for nproc in (1, 3, 4):
            got = [MH.shard_bounds(total, level, nproc, p)
                   for p in range(nproc)]
            assert got == [JMH.shard_bounds(total, level, nproc, p)
                           for p in range(nproc)]
            assert got[0][0] == 0 and got[-1][1] == total


@pytest.mark.parametrize("engine", ["hybrid", "host"])
def test_single_process_equals_jax_and_parallel(engine):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 9, 250000, dtype=np.uint8).tobytes()
    out = MH.compress_multihost(data, 1, n_workers=2, engine=engine,
                                device="cpu")
    assert out == JMH.compress_multihost(data, 1, n_workers=2,
                                         engine=engine)
    assert out == compress_parallel(data, 1)


def test_hybrid_engine_drives_the_device_path():
    """At level 9 the small blocks ride the device bucket: the hybrid
    engine's stream is the host pipeline's."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 40, 7000, dtype=np.uint8).tobytes()
    out = MH.compress_multihost(data, 9, n_workers=1, engine="hybrid",
                                device="cpu")
    assert out == compress_parallel(data, 9) == jax_parallel(data, 9)


def test_manual_shard_assembly_equals_whole():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 30, 730000, dtype=np.uint8).tobytes()
    level, nproc = 1, 3
    payloads, crclists = [], []
    for p in range(nproc):
        a, b = MH.shard_bounds(len(data), level, nproc, p)
        pl, crcs = compress_blocks(data[a:b], level, n_workers=2)
        payloads.append(b"".join(pl))
        crclists.append(crcs)
    whole = MH._assemble(payloads, crclists, level)
    assert whole == compress_parallel(data, level)
    assert whole == JMH._assemble(payloads, crclists, level)


_WORKER = r"""
import sys
import numpy as np
from lbzip2_tpu_torch.parallel import multihost as MH
nproc, pid = int(sys.argv[4]), int(sys.argv[2])
MH.initialize_distributed(sys.argv[1], nproc, pid)
assert MH.process_count() == nproc and MH.process_index() == pid
rng = np.random.default_rng(7)
data = rng.integers(0, 24, 3 * 100000 + 1234, np.uint8).tobytes()
a, b = MH.shard_bounds(len(data), 1, nproc, pid)
out = MH.compress_multihost(data[a:b], level=1, n_workers=1, device="cpu")
if pid == 0:
    assert out is not None
    open(sys.argv[3], "wb").write(out)
else:
    assert out is None
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run_multihost(tmp_path, nproc, extra_env):
    addr = f"127.0.0.1:{_free_port()}"
    outfile = tmp_path / "mh.bz2"
    env = {k: v for k, v in os.environ.items()
           if k not in ("LBZ2_HOST0_ADDR", "MASTER_ADDR")}
    env.update(extra_env)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, addr, str(i), str(outfile),
         str(nproc)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for i in range(nproc)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    rng = np.random.default_rng(7)
    data = rng.integers(0, 24, 3 * 100000 + 1234, np.uint8).tobytes()
    assert outfile.read_bytes() == compress_parallel(data, 1)


def test_four_process_p2p(tmp_path):
    _run_multihost(tmp_path, 4, {"LBZ2_MULTIHOST_EXCHANGE": "p2p",
                                 "LBZ2_MULTIHOST_PORT": str(_free_port())})


def test_two_process_allgather(tmp_path):
    _run_multihost(tmp_path, 2, {"LBZ2_MULTIHOST_EXCHANGE": "allgather"})


def test_host0_address_order(monkeypatch):
    monkeypatch.setattr(MH, "_coordinator_host", "10.0.0.2")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.3")
    monkeypatch.setenv("LBZ2_HOST0_ADDR", "10.0.0.1")
    assert MH._host0_address() == "10.0.0.1"
    monkeypatch.delenv("LBZ2_HOST0_ADDR")
    assert MH._host0_address() == "10.0.0.2"
    monkeypatch.setattr(MH, "_coordinator_host", None)
    assert MH._host0_address() == "10.0.0.3"
    monkeypatch.delenv("MASTER_ADDR")
    assert MH._host0_address() is None


def test_one_process_initializes_nothing():
    MH.initialize_distributed("127.0.0.1:1", 1, 0)
    assert MH.process_count() == 1 and MH.process_index() == 0
