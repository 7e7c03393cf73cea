"""Port's MTF ranks (lbzip2_tpu_torch/ops/mtf_pallas.py) vs the JAX ops.

On a CPU tensor ``mtf_ranks_rows`` runs the plain PyTorch version; it
must equal the Pallas kernel in interpret mode and the lax.scan form,
exactly (integer ranks, tolerance 0).  The CUDA kernel itself is
compared with the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from lbzip2_tpu.ops.mtf import mtf_ranks
from lbzip2_tpu.ops.mtf_pallas import mtf_ranks_pallas
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import mtf_pallas

N = 2048


def _port(syms, ns):
    return to_numpy(mtf_pallas.mtf_ranks_rows(to_torch(syms), to_torch(ns)))


@pytest.mark.parametrize("seed,n,hi", [
    (0, 256, 4), (1, 1000, 256), (2, 2048, 16), (3, 700, 2),
    (4, 0, 8), (5, N, 1),
])
def test_single_row_matches_jax(seed, n, hi):
    rng = np.random.default_rng(seed)
    padded = np.zeros(N, np.int32)
    padded[:n] = rng.integers(0, hi, n, dtype=np.int32)
    got = _port(padded[None], np.array([n], np.int32))[0]
    np.testing.assert_array_equal(got, np.asarray(mtf_ranks(padded, n)))
    np.testing.assert_array_equal(
        got, np.asarray(mtf_ranks_pallas(padded, n, interpret=True)))


def test_batched_rows_match_jax():
    rng = np.random.default_rng(6)
    B, W = 6, 4096
    his = (2, 256, 40, 1, 256, 7)
    syms = np.stack([rng.integers(0, h, W, dtype=np.int32) for h in his])
    ns = np.array([W, 3000, 0, 1, 4095, 2048], np.int32)
    got = _port(syms, ns)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b], np.asarray(mtf_ranks(syms[b], ns[b])), err_msg=f"{b}")


def test_wrapper_refuses_other_devices():
    syms = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    ns = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mtf_pallas.mtf_ranks_rows(syms, ns)
    with pytest.raises(ValueError):
        mtf_pallas.mtf_ranks_cuda(syms, ns)


def test_cpu_path_does_not_count_launches():
    before = mtf_pallas.launches
    mtf_pallas.mtf_ranks_rows(torch.zeros((1, 64), dtype=torch.int32),
                              torch.tensor([64], dtype=torch.int32))
    assert mtf_pallas.launches == before


# -- the CUDA kernel's algorithm, row by row in numpy ---------------------
#
# csrc/mtf_ranks.cu cannot run without a card.  This model follows it:
# the per-chunk last positions and their exclusive running max, the
# list rebuilt at a chunk's start, run continuations stepped over, the
# walk down the 32-entry levels (a ballot, a rotate by one lane with
# the carry into lane 0, the level that holds the symbol ends it).  It
# must equal the plain version on every case.


def list_model(syms, n, chunk=256):
    N = syms.size
    n = max(0, min(int(n), N))
    out = np.zeros(N, np.int32)
    nch = -(-N // chunk)
    # chunk_last, carry_scan
    lastc = np.full((nch, 256), -1, np.int64)
    for c in range(nch):
        for i in range(c * chunk, min((c + 1) * chunk, n)):
            lastc[c, syms[i] & 255] = i
    incoming = np.vstack([np.full((1, 256), -1, np.int64),
                          np.maximum.accumulate(lastc, 0)[:-1]])
    stats = {"runs": 0, "level0": 0, "deeper": 0, "unseen_at_start": []}
    for c in range(nch):  # rank_pass: one warp a chunk
        lo, end = c * chunk, min((c + 1) * chunk, N)
        lim = min(end, n)
        if lo >= lim:
            continue
        t = np.arange(256)
        key = np.where(incoming[c] >= 0, incoming[c], -1 - t)
        pos = (key[None, :] > key[:, None]).sum(1)
        levels = np.empty(256, np.int64)
        levels[pos] = t
        levels = levels.reshape(8, 32)  # [level, lane]
        stats["unseen_at_start"].append(int((incoming[c] < 0).sum()))
        tail = -1
        for base in range(lo, end, 32):
            sym = np.array([syms[i] & 255 if i < lim else -1
                            for i in range(base, base + 32)])
            prev = np.concatenate([[tail], sym[:-1]])
            tail = sym[31]
            for k in np.flatnonzero((sym >= 0) & (sym != prev)):
                s, carry = sym[k], sym[k]
                for j in range(8):
                    found = np.flatnonzero(levels[j] == s)
                    rot = np.roll(levels[j], 1)
                    shifted = rot.copy()
                    shifted[0] = carry
                    if found.size:
                        hit = found[0]
                        levels[j, :hit + 1] = shifted[:hit + 1]
                        out[base + k] = 32 * j + hit
                        break
                    levels[j] = shifted
                    carry = rot[0]
                stats["level0" if j == 0 else "deeper"] += 1
            stats["runs"] += int(((sym >= 0) & (sym == prev)).sum())
    return out, stats


def _bwt_text_syms(seed, n):
    """Compacted BWT symbols of n bytes of word-level text."""
    from lbzip2_tpu.ref import bwt as ref_bwt

    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 8)).astype(
        np.uint8)) + b" " for _ in range(40)]
    text = b"".join(words[i] for i in rng.zipf(1.3, n) % 40)[:n]
    bw, _ = ref_bwt.bwt(np.frombuffer(text, np.uint8))
    used = np.unique(bw)
    return np.searchsorted(used, bw).astype(np.int32)


def _model_cases():
    """name: (syms, n, chunk)."""
    rng = np.random.default_rng(12)
    text = _bwt_text_syms(4, 3000)
    uni = rng.integers(0, 256, 3000, dtype=np.int32)
    return {
        "text_bwt": (text, 3000, 256),
        "uniform_256": (uni, 3000, 256),
        "alphabet_1": (np.zeros(1000, np.int32), 1000, 256),
        "n_0": (uni[:300], 0, 128),
        "n_1": (uni[:300], 1, 128),
        "n_2": (uni[:300], 2, 128),
        "n_N": (uni[:300], 300, 128),
        # widths and n off the chunk and off the 32-lane load
        "ragged_width_1003_n_777": (uni[:1003] % 40, 777, 128),
        "n_one_past_a_chunk": (uni[:1003] % 7, 257, 128),
        # fewer than 32 symbols seen when a chunk starts: lanes of
        # level 0 hold unseen symbols in order
        "chunk_starts_with_few_seen": (uni[:1200] % 5, 1200, 64),
        # ranks past level 0 after long runs
        "runs_then_deep_ranks": (np.repeat(uni[:150], rng.integers(
            1, 40, 150)).astype(np.int32)[:2000], 2000, 256),
    }


@pytest.mark.parametrize("name", sorted(_model_cases()))
def test_list_model_matches_plain(name):
    syms, n, chunk = _model_cases()[name]
    got, stats = list_model(syms, n, chunk)
    want = _port(syms[None], np.array([n], np.int32))[0]
    np.testing.assert_array_equal(got, want)
    # each case reaches the part of the kernel it is named for
    if name == "text_bwt":
        assert stats["runs"] > n // 4 and stats["level0"] > stats["deeper"]
    if name == "uniform_256":
        assert stats["deeper"] > 4 * stats["level0"]
    if name == "alphabet_1":
        assert stats["runs"] == n - -(-n // chunk)  # all but chunk starts
    if name == "chunk_starts_with_few_seen":
        assert min(stats["unseen_at_start"][1:]) > 256 - 32
    if name == "runs_then_deep_ranks":
        assert stats["runs"] > n // 2 and stats["deeper"] > 50
