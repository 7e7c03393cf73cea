"""The port's entry points (lbzip2_tpu_torch/entry.py): the per-block
stage against JAX's _block_stage (the v1 rotation sort and MTF ranks)
on random, small-alphabet and periodic blocks, entry() against
__graft_entry__.entry(), and the multi-device dry run over three
logical CPU devices at the 8192 width.  Tolerance 0.

JAX's side runs in a child process, at the one shape entry() uses: in
one process, jitting _block_stage at a second shape makes a later call
fail ("Execution supplied 2 buffers but compiled program expected 3"),
and tests/test_sharding.py jits it itself."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbzip2_tpu_torch import entry as E
from lbzip2_tpu_torch.parallel.sharding import _block_stage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["random", "small_alpha", "periodic", "one_byte", "zeros_used",
         "n1"]

_JAX_CHILD = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as graft
fn, (block, n) = graft.entry()
cases = np.load(sys.argv[1])
out = {"entry_block": block, "entry_n": np.int64(n)}
for name, a in [("entry", (block, n))] + [
        (k[6:], (cases[k], np.int32(cases["n_" + k[6:]])))
        for k in cases.files if k.startswith("block_")]:
    for i, r in enumerate(jax.block_until_ready(fn(*a))):
        out[f"{name}_{i}"] = np.asarray(r)
np.savez(sys.argv[2], **out)
"""


def _block(kind, N=8192, seed=0):
    rng = np.random.default_rng(seed)
    block = np.zeros(N, np.uint8)
    if kind == "random":
        n = 3001
        block[:n] = rng.integers(0, 256, n, dtype=np.uint8)
    elif kind == "small_alpha":
        n = 4000
        block[:n] = rng.integers(0, 3, n, dtype=np.uint8)
    elif kind == "periodic":
        n = 2500
        block[:n] = np.tile(np.frombuffer(b"abcab", np.uint8), 500)
    elif kind == "one_byte":
        n = 777
        block[:n] = 0
    elif kind == "zeros_used":  # byte 0 inside the data and as padding
        n = 1500
        block[:n] = rng.integers(0, 2, n, dtype=np.uint8)
    else:
        n = 1
        block[0] = 9
    return block, n


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """JAX's _block_stage (the one jitted by __graft_entry__.entry()) on
    entry()'s own example and every case, all 8192 lanes wide, from a
    child process."""
    tmp = tmp_path_factory.mktemp("jax")
    cases = {}
    for kind in KINDS:
        cases[f"block_{kind}"], cases[f"n_{kind}"] = _block(kind)
    np.savez(tmp / "cases.npz", **cases)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _JAX_CHILD,
                        str(tmp / "cases.npz"), str(tmp / "out.npz")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("kind", KINDS)
def test_block_stage_matches_jax(jax_out, kind):
    block, n = _block(kind)
    got = [t.numpy() for t in _block_stage(torch.from_numpy(block), n)]
    for i, g in enumerate(got):
        w = jax_out[f"{kind}_{i}"]
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.uint8 and got[2].dtype == np.int32


def test_entry_matches_graft_entry(jax_out):
    fn, args = E.entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), jax_out["entry_block"])
    assert args[1] == int(jax_out["entry_n"])
    for i, g in enumerate(fn(*args)):
        np.testing.assert_array_equal(g.numpy(), jax_out[f"entry_{i}"])


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default holds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.entry()


def test_dryrun_multichip_cpu():
    res = E.dryrun_multichip(3, device="cpu", width=8192)
    assert res["blocks"] == 3 and res["devices"] == ["cpu"] * 3
    assert res["chain_rows"] == 3
    assert res["stream_bytes"] > 0


def test_repo_text_is_the_package_sources():
    text = E.repo_text(10)
    assert b"__global__" in text and b"#include" in text
    assert len(E.repo_text(3_000_000)) >= 3_000_000
