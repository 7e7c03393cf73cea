"""A numpy model of the compare-exchange sweep kernel
(lbzip2_tpu_torch/csrc/sort_sweeps.cu) against ``sweeps_plain``.

The kernel computes the max of a compare-exchange as a + b - min in
wrapping int32 (on the FMA pipe), keeps PER rows of a column in each of
n lanes of a warp (or of 2 to 32 warps), passes the neighbour row from
lane to lane with a rotate (lane 0 takes the column's last lane: the
wrap at the block edge; the first lane of each later warp takes the warp
before, through shared memory), and stages a CTA's tile of M rows by C
columns through shared memory.  The model does the same thread by
thread, with the layout ``plan`` gives, and must equal the plain
version exactly.  The kernel itself is held against the plain version
on the card by chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch

from lbzip2_tpu_torch.ops import sort_sweeps

I32 = np.int32
EXTREMES = np.array([-2 ** 31, 2 ** 31 - 1, -1, 0, 1], I32)


def cex(a, b):
    """The kernel's compare-exchange: min, then max = min * -1 + (a * 1
    + b) in wrapping int32, then min ^ (max & 1)."""
    with np.errstate(over="ignore"):
        lo = np.minimum(a, b)
        hi = lo * I32(-1) + (a * I32(1) + b)
    return lo ^ (hi & I32(1))


def test_max_is_the_sum_less_the_min_in_wrapping_int32():
    a, b = (x.ravel() for x in np.meshgrid(EXTREMES, EXTREMES))
    rng = np.random.default_rng(0)
    a = np.concatenate([a, rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=I32)])
    b = np.concatenate([b, rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=I32)])
    with np.errstate(over="ignore"):
        hi = a + b - np.minimum(a, b)
    np.testing.assert_array_equal(hi, np.maximum(a, b))
    np.testing.assert_array_equal(
        cex(a, b), np.minimum(a, b) ^ (np.maximum(a, b) & 1))


def _threads(M):
    """Per thread of a CTA, as the kernel computes them: (column, row
    of its first register, thread that feeds register 0, active), and
    the plan."""
    per, n, wpc, C, warps = sort_sweeps.plan(M)
    tid = np.arange(warps * 32)
    warp, lane = tid >> 5, tid & 31
    if wpc == 1:
        seg = lane // n
        pos = lane - seg * n
        col = warp * (C // warps) + seg
        active = seg < C // warps
        src = np.where(active, seg * n + np.where(pos == 0, n - 1, pos - 1),
                       lane)
        feed = warp * 32 + src
    else:
        wi = warp % wpc
        col = warp // wpc
        pos = wi * 32 + lane
        active = pos < n
        prev_warp = col * wpc + np.where(wi == 0, (n - 1) >> 5, wi - 1)
        last = np.minimum(31, n - 1 - (prev_warp % wpc) * 32)
        feed = np.where(lane == 0, prev_warp * 32 + last,
                        warp * 32 + ((lane + 31) & 31))
    return col, pos * per, feed, active, (per, n, wpc, C, warps)


def kernel_model(keys: np.ndarray, sweeps: int, sub: int) -> np.ndarray:
    """Every CTA of the kernel at once: the tile, each thread's PER
    registers, ``sweeps`` rotates and in-register updates, the tile
    back."""
    B, R, L = keys.shape
    M = R // sub
    col, row0, feed, active, (per, _, _, C, warps) = _threads(M)
    tiles = keys.reshape(B, sub, M, L // C, C).transpose(0, 1, 3, 2, 4)
    tiles = tiles.reshape(-1, M, C)                       # (CTAs, M, C)
    rows = row0[active][:, None] + np.arange(per)           # (act, per)
    regs = np.zeros((tiles.shape[0], warps * 32, per), I32)
    regs[:, active] = tiles[:, rows, col[active][:, None]]
    for _ in range(sweeps):
        nb = regs[:, feed, per - 1]
        regs[:, :, 1:] = cex(regs[:, :, 1:], regs[:, :, :-1])
        regs[:, :, 0] = cex(regs[:, :, 0], nb)
    out = np.empty_like(tiles)
    out[:, rows, col[active][:, None]] = regs[:, active]
    return out.reshape(B, sub, L // C, M, C).transpose(0, 1, 3, 2, 4) \
        .reshape(B, R, L)


@pytest.mark.parametrize("B,R,sub,sweeps", [
    (2, 7040, 4, 7),   # the probe's blocks of 1760: 32 lanes of 55 rows
    (1, 7040, 1, 5),   # 7040 rows: 110 lanes of 4 warps, 64 rows a lane
    (1, 4096, 1, 3),   # 2 warps of 64
    (1, 16384, 1, 2),  # 8 warps of 64
    (2, 67, 1, 6),     # a prime: 67 lanes of 4 warps, the last 2 idle
    (1, 1030, 1, 4),   # 515 lanes of 2 in a CTA of 32 warps
    (1, 1021, 1, 3),   # a prime: 1021 lanes of 32 warps, 3 idle
    (1, 16448, 1, 2),  # 514 lanes of 32 rows: 32 warps, the last idle
    (2, 64, 4, 7),     # 16 rows: two columns of 16 lanes a warp
    (2, 64, 1, 7),     # 32 lanes of 2 rows
    (3, 105, 1, 5),    # odd rows: 105 lanes of 4 warps
    (2, 96, 3, 9),     # 32 lanes of one row
    (1, 4, 4, 3),      # one row: a value meets itself
    (2, 7040, 4, 0),   # no sweep: the keys come back
])
def test_model_matches_plain(B, R, sub, sweeps):
    rng = np.random.default_rng(R + sweeps)
    keys = rng.integers(-2 ** 31, 2 ** 31, (B, R, 128), dtype=I32)
    want = sort_sweeps.sweeps_plain(torch.from_numpy(keys), sweeps, sub)
    np.testing.assert_array_equal(kernel_model(keys, sweeps, sub),
                                  want.numpy())


def test_model_matches_plain_on_int32_extremes_at_210_sweeps():
    rng = np.random.default_rng(1)
    keys = rng.choice(np.r_[EXTREMES, -2 ** 31 + 1, 2 ** 31 - 2].astype(I32),
                      (1, 1760, 128))
    want = sort_sweeps.sweeps_plain(torch.from_numpy(keys), 210, 1)
    np.testing.assert_array_equal(kernel_model(keys, 210, 1), want.numpy())


@pytest.mark.parametrize("rows,want", [
    (257, (1, 257, 16, 2, 32)),      # a prime past 256 lanes: 16 warps
    (32768, (32, 1024, 32, 1, 32)),  # the tallest block: 32 warps
])
def test_plan_of_columns_past_256_lanes(rows, want):
    assert sort_sweeps.plan(rows) == want


def _parent_takes(M):
    """The blocks the kernel took before the one-warp columns: PER the
    largest power of two up to 64 that divides M, at most 1024 threads
    of PER <= 32 rows or 512 of 64."""
    per = min(64, M & -M)
    return M // per <= (1024 if per <= 32 else 512)


def test_every_plan_fits_the_kernel():
    """Each row count up to 4096 (and some past it) is refused or laid
    out as the kernel's launch checks demand, in the 227 kB of shared
    memory a CTA may use; each lane of a column holds distinct rows and
    feeds the next; every block the kernel took before is still taken."""
    taken = 0
    for M in itertools.chain(range(1, 4097), [7040, 16384, 16448, 32768,
                                              32800, 65536]):
        try:
            per, n, wpc, C, warps = sort_sweeps.plan(M)
        except ValueError:
            assert not _parent_takes(M)
            assert all(M % p or M // p > (256 if p > 32 else 1024)
                       for p in sort_sweeps.PERS)
            continue
        taken += 1
        assert per in sort_sweeps.PERS and 128 % C == 0 and n * per == M
        if wpc == 1:
            assert warps == 8 and C % 8 == 0 and n * (C // 8) <= 32
        else:
            assert 32 < n <= 32 * wpc and C * wpc == warps
            assert (warps, per <= 64) == (8, True) or \
                (warps, per <= 32, n > 256) == (32, True, True)
        assert M * C * 4 <= 232448 - 64
        if M in (1760, 105, 7040, 67, 1030, 1021):
            col, row0, feed, active, _ = _threads(M)
            for c in range(C):
                mine = np.flatnonzero(active & (col == c))
                assert sorted(row0[mine]) == list(range(0, M, per))
                # the lane after each lane of the column is fed by it
                nxt = {f: t for t, f in zip(mine, feed[mine])}
                assert len(nxt) == mine.size
    assert taken > 2000
