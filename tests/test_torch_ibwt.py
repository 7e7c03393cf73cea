"""Port's inverse BWT (lbzip2_tpu_torch/ops/ibwt.py) vs the JAX ops.

On a CPU tensor ``ibwt_rows`` runs the plain PyTorch version; it must
equal the JAX ``ibwt_masked`` / ``ibwt_batched`` on every lane (zeros
past n included) and the sequential oracle ``ref.decoder.ibwt``,
exactly.  The CUDA kernel is held against the plain version on the card
by chip_smoke.py.
"""

import bz2

import numpy as np
import pytest
import torch

from lbzip2_tpu import native
from lbzip2_tpu.ops.ibwt import ibwt_batched, ibwt_masked
from lbzip2_tpu.ref import bwt as ref_bwt
from lbzip2_tpu.ref.decoder import ibwt as oracle_ibwt
from lbzip2_tpu_torch.ops import ibwt


def _port(rows, ns, idxs):
    return ibwt.ibwt_rows(torch.from_numpy(rows),
                          torch.from_numpy(np.asarray(ns, np.int32)),
                          torch.from_numpy(np.asarray(idxs, np.int32)))


@pytest.mark.parametrize("seed,n,hi", [
    (0, 1, 256), (1, 2, 256), (2, 777, 256), (3, 2048, 4), (4, 1500, 2),
])
def test_single_row_matches_jax_and_oracle(seed, n, hi):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, hi, n, dtype=np.uint8)
    bw, idx = ref_bwt.bwt(data)
    N = 2048
    padded = np.zeros(N, np.uint8)
    padded[:n] = bw
    got = _port(padded[None], [n], [idx])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(ibwt_masked(padded, n,
                                                              idx)))
    np.testing.assert_array_equal(got[:n], data)
    np.testing.assert_array_equal(got[:n], oracle_ibwt(bw, idx))


def test_batched_rows_match_jax():
    rng = np.random.default_rng(7)
    N = 1024
    blocks, ns, idxs, raws = [], [], [], []
    for n in [5, 300, 1024, 700]:
        raw = rng.integers(0, 10, n, dtype=np.uint8)
        bw, idx = ref_bwt.bwt(raw)
        p = np.zeros(N, np.uint8)
        p[:n] = bw
        blocks.append(p)
        ns.append(n)
        idxs.append(idx)
        raws.append(raw)
    rows = np.stack(blocks)
    got = _port(rows, ns, idxs).numpy()
    want = np.asarray(ibwt_batched(rows, np.asarray(ns, np.int32),
                                   np.asarray(idxs, np.int32)))
    np.testing.assert_array_equal(got, want)
    for i, raw in enumerate(raws):
        np.testing.assert_array_equal(got[i, :ns[i]], raw)


def test_full_width_rows_match_jax_and_oracle():
    """(2, 901120): a real 900 kB block's BWT and primary, and uniform
    random bytes at the full width (not a BWT, but the same chase)."""
    if not native.native_available():
        pytest.skip("needs C toolchain")
    rng = np.random.default_rng(9)
    N = 901120
    text = np.repeat(rng.integers(97, 123, 600_000, dtype=np.uint8),
                     rng.integers(1, 3, 600_000))[:890_000]
    blob = bz2.compress(text.tobytes(), 9)
    arr = np.frombuffer(blob, np.uint8)
    err, _, bw, idx, rnd = native.retrieve_block(arr, arr.size * 8, 112)
    assert err == 0 and not rnd
    rows = np.zeros((2, N), np.uint8)
    rows[0, :bw.size] = bw
    rows[1] = rng.integers(0, 256, N, dtype=np.uint8)
    ns = np.array([bw.size, N], np.int32)
    idxs = np.array([idx, rng.integers(0, N)], np.int32)
    got = _port(rows, ns, idxs).numpy()
    np.testing.assert_array_equal(got, np.asarray(ibwt_batched(rows, ns,
                                                               idxs)))
    np.testing.assert_array_equal(got[0, :bw.size], oracle_ibwt(bw, idx))


def test_wrapper_refuses_other_devices_and_counts_no_cpu_launch():
    z8 = torch.zeros((1, 8), dtype=torch.uint8, device="meta")
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ibwt.ibwt_rows(z8, z, z)
    with pytest.raises(ValueError):
        ibwt.ibwt_cuda(z8, z, z)
    before = ibwt.launches, ibwt.doubling_rows
    _port(np.zeros((1, 8), np.uint8), [1], [0])
    assert (ibwt.launches, ibwt.doubling_rows) == before
    # the splitter spacing widens so that a row's list fits one SM
    assert ibwt.shift_for(901120) == ibwt.SHIFT
    for n in (1, 901120, 1 << 21, ibwt.MAX_N - 1):
        assert -(-n // (1 << ibwt.shift_for(n))) + 1 <= ibwt.MAX_SPLITTERS
        assert ibwt.CAP << ibwt.shift_for(n) < 1 << 16


# -- the CUDA kernels' algorithm, row by row in numpy ---------------------
#
# csrc/ibwt.cu cannot run without a card.  This model follows it stage
# by stage (the chunked counting sort of the live lanes with the byte
# packed into the pointer, the walks between splitters with their cap,
# the splitter list ranked by the same scheme once more, super
# splitters whose list is cut at the start and ranked by doubling, the
# second walks, the redo flag and the doubling that redoes a flagged
# row) and
# must equal the plain version on every case.

END = -1


def _model_sort(row, n, chunk):
    """ptr << 8 | byte over [0, n): per-chunk histograms, an exclusive
    sum over chunks per key, the keys' totals scanned, stable ranks."""
    nch = -(-n // chunk)
    hist = np.zeros((nch, 256), np.int64)
    for c in range(nch):
        hist[c] = np.bincount(row[c * chunk:min((c + 1) * chunk, n)],
                              minlength=256)
    tot = hist.sum(0)
    first = np.cumsum(hist, 0) - hist + (np.cumsum(tot) - tot)
    packed = np.full(n, -1, np.int64)
    for c in range(nch):
        cnt = first[c].copy()
        for i in range(c * chunk, min((c + 1) * chunk, n)):
            packed[cnt[row[i]]] = (i << 8) | int(row[i])
            cnt[row[i]] += 1
    assert (packed >= 0).all()
    return packed


def _model_doubling(row, n, idx, packed):
    """The kernels that redo a flagged row: ptr unpacked with the
    identity at and past n, then the doubling of the plain version."""
    N = row.size
    jump = np.arange(N)
    jump[:n] = packed >> 8
    seq = np.zeros(N, np.int64)
    seq[0] = jump[idx]
    length = 1
    for _ in range(ibwt.steps_for(N)):
        hi = min(2 * length, N)
        seq[length:hi] = jump[seq[:hi - length]]
        jump = jump[jump]
        length *= 2
    out = np.zeros(N, np.uint8)
    out[:n] = row[seq[:n]]
    return out


def sublist_model(row, n, idx, chunk=64, shift=3, cap=64, sup=4):
    """Returns (out (N,) uint8, redone)."""
    N = row.size
    n = min(max(int(n), 0), N)
    idx = min(max(int(idx), 0), N - 1)
    out = np.zeros(N, np.uint8)
    if n == 0:
        return out, False
    packed = _model_sort(row, n, chunk)
    if idx >= n:
        return _model_doubling(row, n, idx, packed), True
    mask = (1 << shift) - 1
    regular = (n + mask) >> shift
    h = int(packed[idx] >> 8)
    head = regular if h & mask else h >> shift

    def start_of(j):
        if j < regular:
            return j << shift
        return h if head == regular else None

    def is_splitter(v):
        return (v & mask) == 0 or v == h

    link = np.zeros(regular + 1, np.int64)
    dist = np.zeros(regular + 1, np.int64)
    redo = False
    for j in range(regular + 1):  # walk_sublists
        v = start_of(j)
        if v is None:
            link[j] = j
            continue
        steps = 0
        while True:
            v = int(packed[v] >> 8)
            steps += 1
            if is_splitter(v) or steps >= cap:
                break
        if not is_splitter(v):
            redo, link[j] = True, j
            continue
        link[j], dist[j] = (head if v == h else v >> shift), steps
    off = np.zeros(regular + 1, np.int64)
    if not redo:  # rank_splitters: the same scheme over the splitter list
        cnt = regular + 1
        regular2 = -(-cnt // sup)
        head2 = regular2 if head % sup else head // sup

        def start2_of(j):
            if j < regular2:
                return j * sup
            return head if head2 == regular2 else None

        link2 = np.zeros(regular2 + 1, np.int64)
        dist2 = np.zeros(regular2 + 1, np.int64)
        for j in range(regular2 + 1):
            v = start2_of(j)
            if v is None:
                link2[j] = j
                continue
            steps = 0
            while True:
                dist2[j] += dist[v]
                v = int(link[v])
                steps += 1
                if v % sup == 0 or v == head or steps >= 64 * sup:
                    break
            if not (v % sup == 0 or v == head):
                redo = True
                break
            link2[j] = END if v == head else v // sup
        for _ in range(int(regular2).bit_length() if not redo else 0):
            live = link2 != END
            to = link2[live]
            dist2[live] += dist2[to]  # numpy reads before it writes
            link2[live] = link2[to]
        redo = redo or link2[head2] != END or dist2[head2] != n
    if not redo:
        for j in range(regular2 + 1):
            v = start2_of(j)
            if v is None:
                continue
            o = n - dist2[j]
            while True:
                off[v] = o
                o += dist[v]
                v = int(link[v])
                if v % sup == 0 or v == head:
                    break
    if redo:
        return _model_doubling(row, n, idx, packed), True
    for j in range(regular + 1):  # emit_sublists
        v = start_of(j)
        if v is None:
            continue
        o, byte = int(off[j]), int(row[v])
        while o < n:
            out[o] = byte
            o += 1
            e = int(packed[v])
            v, byte = e >> 8, e & 255
            if is_splitter(v):
                break
    return out, False


def _text_bwt(seed, n):
    """BWT and primary of n bytes of word-level text."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 8)).astype(
        np.uint8)) + b" " for _ in range(40)]
    text = b"".join(words[i] for i in rng.zipf(1.3, n) % 40)[:n]
    bw, idx = ref_bwt.bwt(np.frombuffer(text, np.uint8))
    return np.asarray(bw, np.uint8), int(idx)


def _two_cycles(n):
    """A byte row whose ptr is two cycles: 0 -> 1 -> 0 and the rest
    (the stable sort of [1, 0, 2, 2, ...] is [1, 0, 2, 3, ...])."""
    return np.array([1, 0] + [2] * (n - 2), np.uint8)


def _model_cases():
    """name: (row, N, n, idx, redone or None where the seed decides)."""
    rng = np.random.default_rng(11)
    text, tidx = _text_bwt(1, 1500)
    pair, pidx = _text_bwt(2, 2)
    odd, oidx = _text_bwt(3, 1001)
    uni = rng.integers(0, 256, 2048, dtype=np.uint8)
    small = rng.integers(0, 5, 777, dtype=np.uint8)
    return {
        "text": (text, 2048, 1500, tidx, False),
        # another start on the same cycle: a rotation of the text
        "text_idx_0": (text, 2048, 1500, 0, False),
        "text_idx_last": (text, 2048, 1500, 1499, False),
        "uniform_full_width": (uni, 2048, 2048, 99, None),
        "alphabet_1_no_single_cycle": (np.full(900, 0x61, np.uint8), 1024,
                                       900, 123, True),
        "two_cycles": (_two_cycles(600), 640, 600, 5, True),
        "n_0": (uni[:64], 64, 0, 0, False),
        "n_1": (uni[:64], 64, 1, 0, False),
        "n_2": (pair, 64, 2, pidx, False),
        "idx_past_n": (small, 1001, 500, 700, True),
        "ragged_width_off_every_grid": (odd, 1003, 1001, oidx, False),
        "sparse_splitters_overrun_the_cap": (text, 2048, 1500, tidx, True),
    }


@pytest.mark.parametrize("name", sorted(_model_cases()))
def test_sublist_model_matches_plain(name):
    row, N, n, idx, redone = _model_cases()[name]
    padded = np.zeros(N, np.uint8)
    padded[:row.size] = row  # bytes at and past n stay in the row
    kw = {}
    if name == "sparse_splitters_overrun_the_cap":
        kw = dict(shift=7, cap=4)
    got, redo = sublist_model(padded, n, idx, **kw)
    want = ibwt.ibwt_plain(torch.from_numpy(padded[None]),
                           torch.tensor([n], dtype=torch.int32),
                           torch.tensor([idx], dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(got, want)
    if redone is not None:
        assert redo == redone
    if name.startswith("text") or name.startswith("ragged"):
        # a true BWT: the model also inverts it
        np.testing.assert_array_equal(
            got[:n], oracle_ibwt(row[:n], idx))
