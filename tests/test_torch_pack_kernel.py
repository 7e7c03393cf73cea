"""A numpy model of the group bit-packing kernel
(lbzip2_tpu_torch/csrc/pack_groups.cu) held against the plain
``ops/chain.py::_pack_groups_plain`` and the JAX package's
``pack_groups``, exactly.

The model runs the kernel's two launches: chunks of groups (kWarps *
kPerWarp, read from the source, and tiny ones), each group's bits from
the length tables, a total a chunk; then every group's start bit from
the chunk totals before it and its chunk's groups before it, its codes
ORed into a slot of words at its own bit offset, the words the group
covers whole stored (each exactly once, by that group alone) and its
edge words ORed into the zeroed output, words at and past W dropped.
The words are compared as u32 values; the kernel and the plain version
hand them over as int32 bit patterns.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu_torch.core.constants import MAX_TREES
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import chain

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "lbzip2_tpu_torch" / "csrc" / "pack_groups.cu"
WIDTH = 259


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


# (groups a chunk, groups a warp in turn): the kernel's, and tiny ones
CONFIGS = [(_const("kThreads") // 32 * _const("kPerWarp"),
            _const("kPerWarp")), (2, 1), (6, 2)]


def model(mtfv, nm, ninuse, ngroups, sel, codes, lens, start_bit, W,
          chunk: int, per_warp: int):
    """The kernel's two launches: (words (B, W) uint32, total (B,))."""
    B, NP = mtfv.shape
    G = -(-NP // 50)
    chunks = -(-G // chunk)
    slot_words = _const("kSlot")
    words = np.zeros((B, W), np.uint64)
    owned = np.full((B, W), -1, np.int64)
    edged = np.zeros((B, W), bool)
    total = np.full(B, -1, np.int64)
    for b in range(B):
        ng = min(max(int(ngroups[b]), 0), G)
        as_ = int(ninuse[b]) + 2
        packed = ((lens[b].astype(np.int64) << 24) |
                  (codes[b].astype(np.int64) & 0xFFFFFF)).reshape(-1)

        def entry(g, i):
            p = g * 50 + i
            s = (int(mtfv[b, p]) if p < NP else 0) if p < nm[b] else as_
            tree = min(max(int(sel[b, g]), 0), MAX_TREES - 1)
            return int(packed[min(max(tree * WIDTH + s, 0),
                                  MAX_TREES * WIDTH - 1)])

        gbits = [sum(entry(g, i) >> 24 for i in range(50)) if g < ng else 0
                 for g in range(G)]  # launch 1
        csum = [sum(gbits[c * chunk:(c + 1) * chunk]) for c in range(chunks)]
        for c in range(chunks):  # launch 2
            base = int(start_bit[b]) + sum(csum[:c])
            if c == chunks - 1:
                total[b] = base + sum(gbits[c * chunk:(c + 1) * chunk])
            for w in range(chunk // per_warp):
                first = c * chunk + w * per_warp
                gstart = base + sum(gbits[c * chunk:first])
                for g in range(first, min(first + per_warp, ng)):
                    start, bits = gstart, gbits[g]
                    gstart += bits
                    if not bits:
                        continue
                    slot = [0] * slot_words
                    off = start & 31
                    for i in range(50):
                        e = entry(g, i)
                        ln, code = e >> 24, e & 0xFFFFFF
                        if ln:
                            win = code << (64 - (off & 31) - ln)
                            slot[off >> 5] |= win >> 32
                            if (off & 31) + ln > 32:
                                slot[(off >> 5) + 1] |= win & 0xFFFFFFFF
                        off += ln
                    end = start + bits
                    wbase = start >> 5
                    for j in range(((end - 1) >> 5) - wbase + 1):
                        word = wbase + j
                        if word >= W:
                            continue
                        assert owned[b, word] == -1, "a word stored twice"
                        if word * 32 >= start and word * 32 + 32 <= end:
                            assert not edged[b, word] and not words[b, word]
                            owned[b, word] = g
                            words[b, word] = slot[j]
                        elif slot[j]:
                            edged[b, word] = True
                            words[b, word] |= slot[j]
    return words.astype(np.uint32), total


def _inputs(rng, B, NP, nm, ninuse, max_len=20, W=None):
    """mtfv rows of nm - 1 symbols below ninuse + 1 and the EOB, random
    selectors, tables of lengths 1..max_len (0 past the alphabet) and
    canonical-looking codes below 2^len, start bits 0..31."""
    nm, ninuse = np.asarray(nm, np.int32), np.asarray(ninuse, np.int32)
    mtfv = np.zeros((B, NP), np.int32)
    for b in range(B):
        mtfv[b, :nm[b] - 1] = rng.integers(0, ninuse[b] + 1, nm[b] - 1)
        mtfv[b, nm[b] - 1] = ninuse[b] + 1
    G = -(-NP // 50)
    sel = rng.integers(0, MAX_TREES, (B, G)).astype(np.int32)
    lens = rng.integers(1, max_len + 1, (B, MAX_TREES, WIDTH)).astype(
        np.int32)
    for b in range(B):
        lens[b, :, ninuse[b] + 2:] = 0
    codes = (rng.integers(0, 1 << 20, lens.shape) &
             ((1 << lens) - 1)).astype(np.uint32)
    return dict(mtfv=mtfv, nm=nm, ninuse=ninuse,
                ngroups=((nm + 49) // 50).astype(np.int32), sel=sel,
                codes=codes, lens=lens,
                start_bit=rng.integers(0, 32, B).astype(np.int32),
                W=W or -(-NP * max_len // 32) + 2)


def _case(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("start_bit_"):
        args = _inputs(rng, 3, 5001, [5001, 2600, 77], [255, 30, 4])
        args["start_bit"][:] = int(name.rsplit("_", 1)[1])
        return args
    if name == "every_code_20_bits":
        args = _inputs(rng, 2, 3001, [3001, 1800], [256, 100])
        args["lens"] = np.where(args["lens"] > 0, 20, 0).astype(np.int32)
        args["codes"] = (rng.integers(0, 1 << 20, args["lens"].shape) &
                         ((1 << args["lens"]) - 1)).astype(np.uint32)
        return args
    if name == "zero_length_groups":
        # tree 0 gives symbols 0..9 no bits: groups of them have none
        args = _inputs(rng, 2, 2001, [2001, 1500], [60, 200])
        args["lens"][:, 0, :10] = 0
        args["codes"][:, 0, :10] = 0
        args["mtfv"][:, 100:900] %= 10
        args["sel"][:, 2:18] = 0
        return args
    if name == "dummy_symbol_has_a_length":
        args = _inputs(rng, 3, 2001, [1001, 37, 2001], [50, 3, 255])
        for b, nu in enumerate(args["ninuse"]):
            args["lens"][b, :, nu + 2] = rng.integers(1, 21, MAX_TREES)
            args["codes"][b, :, nu + 2] = 1
        return args
    if name == "ngroups_0_and_below_G":
        args = _inputs(rng, 3, 4001, [4001, 4001, 2500], [200, 80, 9])
        args["ngroups"] = np.array([0, 33, 40], np.int32)
        return args
    if name == "rows_overflow_W":
        args = _inputs(rng, 3, 4001, [4001, 900, 3000], [255, 40, 120])
        args["W"] = 700  # row 1 fits, rows 0 and 2 overflow
        return args
    if name == "one_row":
        return _inputs(rng, 1, 1501, [1333], [77])
    raise KeyError(name)


CASES = ["start_bit_0", "start_bit_31", "every_code_20_bits",
         "zero_length_groups", "dummy_symbol_has_a_length",
         "ngroups_0_and_below_G", "rows_overflow_W", "one_row"]
ORDER = ("mtfv", "nm", "ninuse", "ngroups", "sel", "codes", "lens",
         "start_bit")


def _plain(args):
    words, total = chain._pack_groups_plain(
        *(to_torch(args[k]) for k in ORDER), args["W"])
    assert words.dtype == torch.int32
    return to_numpy(words, like=np.uint32), to_numpy(total)


def _jax(args):
    words, total = jchain.pack_groups(
        *(jnp.asarray(args[k]) for k in ORDER), W=args["W"])
    return np.asarray(words), np.asarray(total)


def _check(args):
    want_w, want_t = _plain(args)
    jax_w, jax_t = _jax(args)
    np.testing.assert_array_equal(want_w, jax_w)
    np.testing.assert_array_equal(want_t, jax_t)
    for chunk, per_warp in CONFIGS:
        words, total = model(*(args[k] for k in ORDER), args["W"], chunk,
                             per_warp)
        np.testing.assert_array_equal(words, want_w, err_msg=f"{chunk}")
        np.testing.assert_array_equal(total, want_t)
    return want_w, want_t


@pytest.mark.parametrize("name", CASES)
def test_model_against_plain_and_jax(name):
    words, total = _check(_case(name))
    if name == "start_bit_31":
        assert not (words[:, 0] >> 1).any()  # the first 31 bits are 0
    if name == "rows_overflow_W":
        assert (total > 32 * 700).sum() == 2


def test_text_batch_through_chain_payloads():
    """The arguments chain_payloads gives _pack_groups on a CPU text
    batch (the real tables, selectors and start bits), through the model,
    the plain version and JAX."""
    from test_torch_chain import MIXED, _mk_blocks

    bwts, ns, cmaps, idxs, crcs = _mk_blocks(MIXED)
    got = {}
    real = chain._pack_groups

    def spy(*a):
        got["args"] = a
        return real(*a)

    chain._pack_groups = spy
    try:
        chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs)
    finally:
        chain._pack_groups = real
    *tensors, W = got["args"]
    args = {k: to_numpy(t) for k, t in zip(ORDER, tensors)}
    args["codes"] = args["codes"].astype(np.uint32)
    args["W"] = W
    _check(args)


def test_slot_and_chunk_constants():
    """A group's 50 codes of at most 20 bits from any bit offset touch at
    most kSlot words, and a CTA's chunk is its warps' groups."""
    assert _const("kSlot") >= (31 + 50 * 20 + 31) // 32 + 1
    assert (_const("kThreads"), _const("kPerWarp"), _const("kGroup")) == \
        (256, 8, 50)
    assert "constexpr int kChunk = kWarps * kPerWarp;" in SRC.read_text()


def test_cpu_dispatch_and_both_downloads():
    """On CPU tensors _pack_groups is the plain version (no launch
    counted) and hands over int32 bit patterns; chain_payloads gives the
    same payloads through the flat download and the whole-array one."""
    from test_torch_chain import _mk_blocks

    args = _case("start_bit_31")
    before = chain.pack_launches
    t = [to_torch(args[k]) for k in ORDER]
    for g, w in zip(chain._pack_groups(*t, args["W"]),
                    chain._pack_groups_plain(*t, args["W"])):
        assert g.dtype == w.dtype and g.equal(w)
    assert chain.pack_launches == before
    bwts, ns, cmaps, idxs, crcs = _mk_blocks(
        [(8000, "text"), (6000, "random"), (1, "text")])
    flat = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs)
    flat_w = chain.FLAT_W
    chain.FLAT_W = 0  # every batch takes the whole-array download
    try:
        whole = chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs)
    finally:
        chain.FLAT_W = flat_w
    assert flat == whole and all(p for p in flat)
