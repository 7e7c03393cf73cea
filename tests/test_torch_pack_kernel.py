"""A numpy model of the group bit-packing kernel
(lbzip2_tpu_torch/csrc/pack_groups.cu) held against the plain
``ops/chain.py::_pack_groups_plain`` and the JAX package's
``pack_groups``, exactly.

The model runs the kernel's one launch after the output's zero fill,
its CTAs in ticket order (chunk-major across the rows) one at a time
here (``test_torch_pack_lookback.py`` interleaves them): chunks of
groups (kThreads, a thread a group, read from the source, and tiny
ones), each symbol read once, its (len, code) entry from the row's
tables (the entries of the symbols 0 .. ninuse + 2 in shared memory,
any other from device memory), each group's bits, the chunk's sum
published as its aggregate, the chunks before it added by the look-back
up to the first inclusive sum, its inclusive sum published; then every
group's start bit from those and its chunk's groups before it, its
codes packed MSB first through a 64-bit accumulator, a word out each
time 32 bits fill: the words the group covers whole stored (each
exactly once, by that group alone), its first word (unless it starts on
a word) and its last partial one ORed into the zeroed output, words at
and past W dropped; the chunk of the last valid group writes the total,
chunks past it nothing.
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
from test_torch_rle2_kernel import in_order, look_back, publish

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "lbzip2_tpu_torch" / "csrc" / "pack_groups.cu"
WIDTH = 259


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


# groups a chunk (a thread a group): the kernel's, and tiny ones
CONFIGS = [_const("kThreads"), 2, 6]


def new_state():
    """The kernel's device state between calls: the chunk descriptors
    (any content; epoch-tagged), the ticket (0 between calls), the
    epoch."""
    return {"desc": [], "ticket": 0, "epoch": 0}


def model(mtfv, nm, ninuse, ngroups, sel, codes, lens, start_bit, W,
          chunk: int, schedule=in_order, window: int = 32, state=None,
          seen=None, ends=None, F: int = 0):
    """The kernel's launch after the output's zero fill, its CTAs
    interleaved by ``schedule``: (words (B, W) uint32, total (B,)); in
    the flat mode (``ends`` given, the rows' inclusive word ends) row r's
    words go to flat slots [ends[r - 1], ends[r]) below F instead:
    (flat (F,) uint32, None).  ``seen`` collects the kinds the look-backs
    read, and the count of entries read from device memory (symbols
    outside 0 .. ninuse + 2) under "global"."""
    B, NP = mtfv.shape
    G = -(-NP // 50)
    chunks = -(-G // chunk)
    st = state if state is not None else new_state()
    st["epoch"] += 1
    epoch = st["epoch"]
    while len(st["desc"]) < B * chunks:
        st["desc"].append((0, "X", None, None))
    seen = [] if seen is None else seen
    size = F if ends is not None else B * W
    words = np.zeros(size, np.uint64)  # (B, W) row-major, or the flat slots
    owned = np.full(size, -1, np.int64)
    edged = np.zeros(size, bool)
    total = np.full(B, -1, np.int64)
    read = np.zeros((B, max(NP, 1)), np.int64)  # symbol loads a lane

    def cta(k):
        """A CTA draws ticket k when it starts; its steps run later."""
        assert k == st["ticket"]
        st["ticket"] = 0 if k == B * chunks - 1 else k + 1
        return steps(k)

    def steps(k):
        c, b = divmod(k, B)
        # the row's words: words[b, :W], or flat[start, min(end, F))
        base_slot, row_lim = b * W, W
        if ends is not None:
            base_slot = int(ends[b - 1]) if b else 0
            row_lim = min(int(ends[b]), F) - base_slot
            if row_lim <= 0:
                return  # the row does not fit: nothing to write
        ng = min(max(int(ngroups[b]), 0), G)
        cc = (ng - 1) // chunk if ng else 0
        if c > cc:
            return  # no valid group
        as_ = int(ninuse[b]) + 2
        lim = min(max(as_, 0), WIDTH - 1)
        packed = ((lens[b].astype(np.int64) << 24) |
                  (codes[b].astype(np.int64) & 0xFFFFFF)).reshape(-1)
        shared = {t * WIDTH + s: int(packed[t * WIDTH + s])
                  for t in range(MAX_TREES) for s in range(lim + 1)}

        def entry(g, i):
            p = g * 50 + i
            if p < nm[b] and p < NP:
                read[b, p] += 1
            s = (int(mtfv[b, p]) if p < NP else 0) if p < nm[b] else as_
            tree = min(max(int(sel[b, g]), 0), MAX_TREES - 1)
            if 0 <= s <= lim:
                return shared[tree * WIDTH + s]
            seen.append("global")
            return int(packed[min(max(tree * WIDTH + s, 0),
                                  MAX_TREES * WIDTH - 1)])

        groups = range(c * chunk, min((c + 1) * chunk, ng))
        ents = {g: [entry(g, i) for i in range(50)] for g in groups}
        gbits = {g: sum(e >> 24 for e in ents[g]) for g in groups}
        mine = sum(gbits.values())
        desc, base = st["desc"], b * chunks
        if c == 0:
            publish(desc, base, epoch, "P", mine)
            before = 0
        else:
            publish(desc, base + c, epoch, "A", mine)
            yield
            before = yield from look_back(desc, base, c, epoch, window,
                                          seen, lambda x, y: x + y, 0,
                                          sum)
            publish(desc, base + c, epoch, "P", before + mine)
        yield
        start0 = int(start_bit[b]) + before
        if c == cc and ends is None:
            total[b] = start0 + mine

        def put(w, v, whole, g):
            if w >= row_lim:
                return
            i = base_slot + w
            assert owned[i] == -1, "a word stored twice"
            if whole:
                assert not edged[i] and not words[i]
                owned[i] = g
                words[i] = v
            elif v:
                edged[i] = True
                words[i] |= v

        start = start0
        for g in groups:  # a thread a group
            bits = gbits[g]
            w, nb = start >> 5, start & 31
            start += bits
            if not bits:
                continue
            whole, acc = nb == 0, 0
            for e in ents[g]:
                ln = e >> 24
                if ln > 0:
                    acc = (acc << ln | e & 0xFFFFFF) & (2 ** 64 - 1)
                    nb += ln
                    if nb >= 32:
                        nb -= 32
                        put(w, (acc >> nb) & 0xFFFFFFFF, whole, g)
                        w += 1
                        whole = True
            if nb:
                put(w, (acc << (32 - nb)) & 0xFFFFFFFF, False, g)

    schedule([lambda k=k: cta(k) for k in range(B * chunks)])
    assert st["ticket"] == 0
    assert read.max(initial=0) <= 1, "a symbol read twice"
    if ends is not None:
        return words.astype(np.uint32), None
    return words.astype(np.uint32).reshape(B, W), total


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
    for chunk in CONFIGS:
        words, total = model(*(args[k] for k in ORDER), args["W"], chunk)
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
    """The packing arguments chain_payloads gives its flat pack on a CPU
    text batch (the real tables, selectors and start bits), through the
    model, the plain version and JAX."""
    from test_torch_chain import MIXED, _mk_blocks

    bwts, ns, cmaps, idxs, crcs = _mk_blocks(MIXED)
    got = {}
    real = chain._pack_flat

    def spy(*a):
        got["args"] = a
        return real(*a)

    chain._pack_flat = spy
    try:
        chain.chain_payloads(to_torch(bwts), ns, cmaps, idxs, crcs)
    finally:
        chain._pack_flat = real
    *tensors, W = got["args"][:9]
    args = {k: to_numpy(t) for k, t in zip(ORDER, tensors)}
    args["codes"] = args["codes"].astype(np.uint32)
    args["W"] = W
    _check(args)


def test_slot_and_chunk_constants():
    """A CTA's chunk is a group a thread: 128, whose 6,400 symbols
    (25.6 KB) outweigh the 2.4 KB of a text row's table entries (6 trees
    x 33 symbols x 12 bytes) every CTA reads; a group's words sit at an
    odd stride in shared memory, so a warp's 32 threads walking their
    groups meet 32 distinct banks; a code of at most 24 bits into an
    accumulator holding at most 31 bits stays within its 64."""
    assert (_const("kThreads"), _const("kGroup")) == (128, 50)
    text = SRC.read_text()
    assert "constexpr int kChunk = kThreads;" in text
    assert "constexpr int kStride = kGroup + 1;" in text
    assert len({(t * 51) % 32 for t in range(32)}) == 32
    assert 31 + 24 < 64


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
