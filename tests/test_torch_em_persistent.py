"""The EM loop's persistent E-step (lbzip2_tpu_torch/csrc/em_chain.cu::
em_estep) as a numpy model, held exactly against the port's plain loop
and the JAX package's em_chain.

Each row has the same P CTAs; CTA c takes the c-th of P equal shares of
the row's live groups and of the groups past them.  It copies tiles of
its share's symbols into shared memory (``model_stage``: 16-byte copies
between 4-byte ones at the ragged ends, each word once, at its 16-byte
phase), a pair of lanes sums a group's packed cost words over 25
symbols each and joins the halves with one shuffle, with a warp's lanes
on 32 distinct banks; the pair picks the first cheapest live tree, the
lanes count their symbols into the CTA's shared frequencies, and the
CTA flushes them once.  The model
(``test_torch_em_kernel.model_estep_row``) runs at the kernel's CTA
(read from the source) with the P it takes on these rows, and at
smaller CTAs and larger P, so that shares cross many tiles and rows
end on and just past a share's edge.  Rows: nm = 0, nm < 50, nm not a
multiple of 50, groups ending exactly on a share and one past it,
costs past 1023, 1 to 6 trees, a row still changing at the last
iteration.  Inputs are made with numpy from seeds; every comparison is
exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from lbzip2_tpu.ops import chain as jchain
from lbzip2_tpu.ops import huffenc as jhuff
from lbzip2_tpu_torch.interop import to_numpy, to_torch
from lbzip2_tpu_torch.ops import huffenc
from test_torch_em_kernel import (BUF_WORDS, ETHREADS, NP, SETTLING, TEXT8,
                                  TREES, W, _initial_trees, _pack3,
                                  model_em_loop, model_stage)

G = (NP + 49) // 50
# (P, threads): the kernel's CTA, one a row (no more than a row of NP
# symbols has tiles: ceil(164 / 256)), and small CTAs several a row
CONFIGS = {"kernel": (1, ETHREADS), "p3_t8": (3, 8), "p7_t32": (7, 32)}


def _rows(specs, seed):
    """specs: (nm, ninuse, skew) a row -> mtfv (B, NP), nm, ninuse: nm - 1
    Zipf-like symbols below ninuse + 1 and the end-of-block symbol, none
    for nm = 0; garbage past nm."""
    rng = np.random.default_rng(seed)
    B = len(specs)
    mtfv = rng.integers(-3, 400, (B, NP)).astype(np.int32)
    nm = np.array([s[0] for s in specs], np.int32)
    ninuse = np.array([s[1] for s in specs], np.int32)
    for b, (n, nu, skew) in enumerate(specs):
        if n:
            p = 1.0 / np.arange(1, nu + 2) ** skew
            mtfv[b, :n - 1] = rng.choice(nu + 1, n - 1, p=p / p.sum())
            mtfv[b, n - 1] = nu + 1
    return mtfv, nm, ninuse


def _share_edges(P: int):
    """Rows whose live groups end on a share's edge (3P groups, whole
    or with a partial last group), one group past it, one short of it,
    and a full row."""
    e = 50 * 3 * P
    return [(e, 20, 1.1), (e - 49, 30, 1.2), (e + 1, 20, 1.0),
            (e + 50, 60, 1.3), (e - 50, 10, 1.0), (NP, 90, 1.2)]


CASES = {
    "nm_0_below_50_ragged": lambda P: [
        (0, 5, 1.0), (1, 0, 1.0), (49, 3, 1.0), (50, 3, 1.0), (51, 9, 1.0),
        (777, 40, 1.1), (NP, 90, 1.2), (8190, 60, 1.3)],
    "share_edges": _share_edges,
    "costs_past_1023": lambda P: TEXT8,
    "nt_1_to_6": lambda P: TREES,
    "still_changing_at_the_last_iteration": lambda P: SETTLING,
}
# the rows' seeds; 12 gives SETTLING rows that still move in the eighth
# and last E-step
SEEDS = {"still_changing_at_the_last_iteration": 12}


@functools.lru_cache(maxsize=None)
def _case(name: str, P: int):
    mtfv, nm, ninuse = _rows(CASES[name](P), SEEDS.get(name, len(name) + P))
    nt, lengths = _initial_trees(np.maximum(mtfv, 0), nm, ninuse)
    if name == "costs_past_1023":
        lengths = np.random.default_rng(5).integers(
            1, 31, lengths.shape).astype(np.int32)
    return mtfv, nm, ninuse, nt, lengths


@functools.lru_cache(maxsize=None)
def _plain_and_jax(name: str, P: int):
    """The plain loop's and JAX's (sel, freqs, lengths, iters)."""
    mtfv, nm, ninuse, nt, lengths = _case(name, P)
    plain = tuple(to_numpy(t) for t in huffenc.em_chain_rows(
        *(to_torch(a) for a in (mtfv, nm, ninuse, nt, lengths)), 8))
    hist_g, _, ngroups = jchain.group_hist(
        jnp.asarray(mtfv), jnp.asarray(nm), jnp.asarray(ninuse))
    ref = tuple(np.asarray(r) for r in jhuff.em_chain(
        hist_g, ngroups, jnp.asarray(nt), jnp.asarray(ninuse + 2),
        jnp.asarray(lengths), 8))
    return plain, ref


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", list(CASES))
def test_persistent_estep_loop_against_plain_and_jax(name, config):
    P, threads = CONFIGS[config]
    mtfv, nm, ninuse, nt, lengths = _case(name, P)
    trace = []
    want = model_em_loop(mtfv, nm, ninuse, nt, lengths, 8, trace, P,
                         threads)
    plain, ref = _plain_and_jax(name, P)
    for m, p, j in zip(want, plain, ref):  # sel (all G), freqs, lengths,
        np.testing.assert_array_equal(m, p)  # iters
        np.testing.assert_array_equal(m, j)
    groups = (nm + 49) // 50
    if name == "share_edges" and P > 1:
        assert groups[0] % P == 0 and groups[1] % P == 0
        assert groups[2] % P == 1 and groups[4] % P == P - 1
        # the full row's share takes several tiles at the small CTAs
        assert config == "kernel" or -(-groups[5] // P) > threads // 2
    if name == "nm_0_below_50_ragged":
        assert nm[0] == 0 and 0 < nm[2] < 50 and nm[4] % 50
    if name == "costs_past_1023":
        sym = np.clip(mtfv[0, :8150], 0, W - 1).reshape(-1, 50)
        assert lengths[0][:, sym].sum(2).max() > 1023
        assert ((_pack3(lengths[0, :3])[sym].sum(1) & 0xFFFFFFFF) >>
                30).any(), "lane 2 never carries into the high word"
    if name == "nt_1_to_6":
        assert sorted(set(nt)) == [1, 2, 3, 4, 5, 6]
    if name.startswith("still_changing"):
        # some rows repeat their selectors while another's still move
        assert any(any(m) and not all(m) for m in trace[1:]), trace
        assert want[3] == 8 and any(trace[-1]), "settled before the last"


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_stage_copies_each_word_once_at_its_phase(phase):
    """stage_tile on tiles that start at each 16-byte phase, end at each,
    and hold 0 to a full tile of words: every word once, 16-byte copies
    aligned on both sides, the buffer large enough."""
    full = ETHREADS // 2 * 50
    for w0 in (0, 50, 1250, 12800):
        for n in (0, 1, 3, 4, 5, 49, 50, 4 * 37 + 2, full - 1, full):
            pairs, a = model_stage(phase, w0, w0 + n)
            assert a == (phase + w0) & 3
            assert len(pairs) == n and max((i for i, _ in pairs),
                                           default=0) < BUF_WORDS


def test_model_constants_match_the_source():
    """The E-step as the model takes it: a pair of lanes a group, 25
    symbols a lane kept two to a register, the shuffle that joins them,
    the buffers' size and the persistent shares; both kernels wait for
    the launch before them first."""
    from test_torch_em_kernel import SRC

    src = SRC.read_text()
    assert ETHREADS % 64 == 0
    for line in ("constexpr int kTileGroups = kEThreads / 2;",
                 "constexpr int kHalf = kGroup / 2;",
                 "constexpr int kBufWords = kTileWords + 8;",
                 "lo += __shfl_xor_sync(kFull, lo, 1);",
                 "const int share = (ngroups + P - 1) / P;",
                 "const int tshare = (G - ngroups + P - 1) / P;",
                 "gi * kGroup + half * kHalf;",
                 "const dim3 egrid(lbz2t_em_ctas(B, G), B);"):
        assert line in src, line
    assert BUF_WORDS == ETHREADS // 2 * 50 + 8
    # launched behind the kernel before it, each waits for that one's
    # writes before its first read
    for head in ("em_estep(const int*", "em_mstep(int*"):
        body = src[src.index(head):]
        assert body.index("griddepcontrol.wait;") < body.index("ctl[")
