"""chip_smoke.py's contracts that hold off the card: it imports only the
port, its host reference is the host C pipeline, it refuses to run
without CUDA, and the port's helpers it relies on agree with the
engine's batch builder."""

import ast
import bz2
import os
import subprocess
import sys

import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch.codec import encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="needs C toolchain")


def _smoke_module():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_smoke_imports_only_the_port():
    tree = ast.parse(open(SMOKE).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "lbzip2_tpu_torch" in roots
    assert not roots & {"lbzip2_tpu", "jax", "jaxlib"}, roots


def test_smoke_fails_without_cuda(tmp_path):
    r = subprocess.run([sys.executable, SMOKE], capture_output=True,
                       text=True, cwd=tmp_path,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@needs_native
def test_smoke_host_reference_is_host_pipeline():
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, k, dtype=np.uint8))
             for k in rng.integers(2, 9, 300)]
    data = b" ".join(words[i] for i in rng.integers(0, 300, 400_000))
    data = data[:2_000_000]  # three level-9 blocks
    ref = _smoke_module().host_reference(data)
    assert ref == compress_parallel(data, 9)
    assert bz2.decompress(ref) == data


@needs_native
@pytest.mark.parametrize("kind,want", [
    ("text", 1), ("periodic", 0), ("mid_tail", 1), ("empty", 0)])
def test_device_eligible_matches_build_batch(kind, want, monkeypatch):
    monkeypatch.setattr(encoder, "_BUCKETS", (8192, 131072))
    monkeypatch.setattr(encoder, "_MID_CUTOFF", 65536)
    rng = np.random.default_rng(3)
    if kind == "text":
        data = bytes(rng.integers(97, 123, 8000, dtype=np.uint8))
    elif kind == "periodic":
        data = b"abc" * 2000
    elif kind == "mid_tail":  # one device block, one host-only tail
        data = bytes(rng.integers(0, 256, 130_000, dtype=np.uint8))
    else:
        data = b""
    assert encoder.device_eligible(data, 1) == want


@needs_native
def test_lyndon_rows_matches_native():
    rng = np.random.default_rng(9)
    blocks = [rng.integers(0, 256, 3000, dtype=np.uint8),
              np.frombuffer(b"xy" * 700, np.uint8),  # fully periodic
              rng.integers(65, 68, 4096, dtype=np.uint8)]
    batch, ns, ms = encoder.lyndon_rows(blocks, 4096)
    assert batch.shape == (3, 4096) and batch.dtype == np.uint8
    for r, blk in enumerate(blocks):
        rot, m = native.lyndon_prep(blk)
        assert ns[r] == blk.size and ms[r] == m
        if m >= 0:
            np.testing.assert_array_equal(batch[r, :blk.size], rot)
        assert not batch[r, blk.size:].any()
    assert ms[1] < 0
