"""Port's compare-exchange sweeps (lbzip2_tpu_torch/ops/sort_sweeps.py)
and sort probe (lbzip2_tpu_torch/tools/sort_probe.py) vs the JAX probe.

The reference is the probe tool's own, unedited ``_sweep_kernel``
(tools/tpu_sort_probe.py), loaded by path and run by
``pl.pallas_call(..., interpret=True)`` with the block's leading axis
squeezed, so that its roll moves one row inside each block.  Under the
tool's own ``(1, R // sub, 128)`` block the roll runs along the size-1
batch axis and the kernel returns ``keys & ~1``; that fault is pinned
here too.  Integer outputs: exact equality throughout.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import sort_sweeps
from lbzip2_tpu_torch.tools import sort_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, R, L = 2, 64, 128


@pytest.fixture(scope="module")
def probe_tool():
    """tools/tpu_sort_probe.py loaded by path; its import-time edits of
    os.environ and sys.path are undone."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "tpu_sort_probe", os.path.join(ROOT, "tools", "tpu_sort_probe.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


def _keys(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "extremes":
        vals = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 2,
                         2 ** 31 - 1], np.int32)
        return rng.choice(vals, (B, R, L))
    return rng.integers(-2 ** 31, 2 ** 31, (B, R, L), dtype=np.int32,
                        endpoint=False)


def _pallas(mod, keys, sweeps, sub, block):
    mod.SWEEPS = sweeps
    return np.asarray(pl.pallas_call(
        mod._sweep_kernel, grid=(keys.shape[0], sub),
        in_specs=[pl.BlockSpec(block, lambda b, s: (b, s, 0))],
        out_specs=pl.BlockSpec(block, lambda b, s: (b, s, 0)),
        out_shape=jax.ShapeDtypeStruct(keys.shape, jnp.int32),
        interpret=True)(jnp.asarray(keys)))


@pytest.mark.parametrize("kind", ["random", "extremes"])
@pytest.mark.parametrize("sweeps", [0, 1, 7])
@pytest.mark.parametrize("sub", [1, 4])
def test_plain_matches_pallas_sweep_kernel(probe_tool, kind, sweeps, sub):
    keys = _keys(kind, seed=sweeps + 10 * sub)
    want = _pallas(probe_tool, keys, sweeps, sub, (None, R // sub, L))
    got = sort_sweeps.sweeps(to_torch(keys), sweeps, sub)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_reference_block_compares_each_value_with_itself(probe_tool):
    """The tool's (1, R // sub, 128) block rolls the size-1 batch axis:
    every sweep meets the value itself, so the output is keys & ~1 (the
    fault the port does not carry)."""
    keys = _keys("random", seed=3)
    got = _pallas(probe_tool, keys, 5, 4, (1, R // 4, L))
    np.testing.assert_array_equal(got, keys & ~1)
    assert not np.array_equal(
        to_numpy(sort_sweeps.sweeps_plain(to_torch(keys), 5, 4)), got)


@pytest.mark.parametrize("rows,want", [
    (1760, (55, 32, 1, 8, 8)),    # the probe's (32, 7040, 128) at sub 4
    (7040, (64, 110, 4, 2, 8)),   # the same at sub 1: 110 lanes of 4 warps
    (16, (1, 16, 1, 16, 8)), (64, (2, 32, 1, 8, 8)),
    (105, (1, 105, 4, 2, 8)), (1, (1, 1, 1, 128, 8)),
])
def test_kernel_plan(rows, want):
    per, n, wpc, C, warps = sort_sweeps.plan(rows)
    assert (per, n, wpc, C, warps) == want
    assert per * n == rows and per in sort_sweeps.PERS and 128 % C == 0
    assert n * C // 8 <= 32 if wpc == 1 else \
        n <= 32 * wpc and wpc * C == warps


@pytest.mark.parametrize("rows", [0, 1025, 3 * 1024 * 64])
def test_kernel_plan_refuses(rows):
    with pytest.raises(ValueError):
        sort_sweeps.plan(rows)


def test_wrapper_checks_and_devices():
    before = sort_sweeps.launches
    keys = torch.zeros((1, 8, 128), dtype=torch.int32)
    sort_sweeps.sweeps(keys, 3, 2)
    assert sort_sweeps.launches == before  # the plain version ran
    with pytest.raises(ValueError):
        sort_sweeps.sweeps(keys, 3, 3)  # 3 does not divide 8 rows
    with pytest.raises(TypeError):
        sort_sweeps.sweeps(keys.long(), 3, 2)
    with pytest.raises(ValueError):
        sort_sweeps.sweeps(torch.zeros((1, 8, 64), dtype=torch.int32), 1, 1)
    with pytest.raises(ValueError):
        sort_sweeps.sweeps_cuda(keys, 3, 2)
    with pytest.raises(ValueError):
        sort_sweeps.sweeps(keys.to("meta"), 3, 2)


def test_probe_runs_tiny_on_cpu():
    lines = []
    res = sort_probe.run(rows=2, width=8192, sweeps=3, sub=4, reps=1,
                         device="cpu", log=lines.append)
    assert res["clock"] == "host clock, cpu"
    assert res["rows"] == 2 and res["width"] == 8192
    for key in ("sort1_ms", "sort8_ms", "sweeps_ms", "per_sweep_ms",
                "projection_ms"):
        assert res[key] >= 0
    assert any("projection" in ln for ln in lines)
    assert sort_probe.main(["--rows", "1", "--width", "1024", "--sweeps",
                            "2", "--reps", "1", "--device", "cpu"]) == 0
