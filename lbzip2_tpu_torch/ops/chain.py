"""Device entropy chain: BWT bytes -> MTF -> RLE2 -> EM -> packed payload.

Counterpart of lbzip2_tpu/ops/chain.py (chain mode of the level-9 main
path).  Layouts and dtypes at every public function follow the JAX
package, except that a JAX uint32 word is held as int64 masked to 32
bits (see lbzip2_tpu_torch/interop.py).  The host steps are those of
the JAX ``chain_payloads``: ``generate_initial_trees``,
``native.chain_finish`` and the header splice.  The JAX module's other
two device programs are here too, on no path: ``chain_mtf`` (the v1
chain, its histogram of mtfv[:nm] alone) and ``em_estep_batch`` (one
E-step).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from lbzip2_tpu_torch import _build, native
from lbzip2_tpu_torch.core.constants import GROUP_SIZE, MAX_TREES
from lbzip2_tpu_torch.device import upload
from lbzip2_tpu_torch.interop import M32
from lbzip2_tpu_torch.ops import lookback
from lbzip2_tpu_torch.ops.huffenc import em_chain_cuda, em_chain_rows
from lbzip2_tpu_torch.ref.huffman import (generate_initial_trees,
                                          num_trees_for)
from lbzip2_tpu_torch.ops.mtf_pallas import (_compact_syms,
                                              mtf_ranks_bytes_rows,
                                              mtf_ranks_plain)
from lbzip2_tpu_torch.ops.rle2 import (WIDTH, _rle2_batch, _rle2_plain,
                                       rle2_hist_rows)
from lbzip2_tpu_torch.parallel.sharding import run_shards

_SLOT_WORDS = 32            # 1024 bits >= 50 codes * 20 bits + padding

# Flat download: per-row payload words compacted into whole chunks.
FLAT_W = 3_500_032
FLAT_CHUNK = 524_288
# Payload word capacity per row, and the small variant picked when every
# row fits it (lbzip2_tpu/ops/chain.py:400-404).
PACK_W = 160768
PACK_W_SMALL = 80384


def _group_hist(mtfv: torch.Tensor, nm: torch.Tensor,
                ninuse: torch.Tensor):
    """Per-group symbol histogram (B, G, WIDTH) float32, the padded
    groups view (B, G, 50) and ngroups (B,).  Counted with an int32
    scatter_add_ (exact), stored as float32 like the JAX op."""
    B, NP = mtfv.shape
    dev = mtfv.device
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    pad_to = G * GROUP_SIZE
    lanes = torch.arange(pad_to, dtype=torch.int32, device=dev)[None]
    padded = torch.nn.functional.pad(mtfv, (0, pad_to - NP))
    padded = torch.where(lanes < nm[:, None], padded, (ninuse + 2)[:, None])
    groups = padded.reshape(B, G, GROUP_SIZE)
    ngroups = (nm + GROUP_SIZE - 1) // GROUP_SIZE
    hist = torch.zeros((B, G, WIDTH), dtype=torch.int32, device=dev)
    hist.scatter_add_(2, groups.clamp(max=WIDTH - 1).long(),
                      torch.ones_like(groups))
    return hist.float(), groups, ngroups.int()


def _chain_mtf2(bwt: torch.Tensor, ns: torch.Tensor, cmaps: torch.Tensor):
    """BWT bytes -> (mtfv (B, N+1), nm (B,), hist (B, WIDTH) int32 flat
    histogram, hist_g (B, G, WIDTH) float32, ngroups (B,)).  On a CUDA
    device hist_g is None: the EM kernels read the symbols themselves
    (``ops/huffenc.em_chain_rows``) and one kernel gives the RLE2 values
    with their flat histogram (``ops/rle2.py::rle2_hist_rows``), so the
    per-group tensor, five times the symbols it is made from, is never
    built there.  The MTF kernel reads the bytes and maps them to the
    compacted symbols itself (``mtf_ranks_bytes_rows``); on the CPU that
    is ``_compact_syms``, then the plain MTF."""
    ninuse = cmaps.int().sum(1, dtype=torch.int32)
    ranks = mtf_ranks_bytes_rows(bwt, cmaps, ns)
    if ranks.device.type == "cuda":
        mtfv, nm, hist = rle2_hist_rows(ranks, ns, ninuse)
        ngroups = ((nm + GROUP_SIZE - 1) // GROUP_SIZE).int()
        return mtfv, nm, hist, None, ngroups
    mtfv, nm = _rle2_batch(ranks, ns, ninuse)
    hist_g, _, ngroups = _group_hist(mtfv, nm, ninuse)
    hist = hist_g.sum(1).int()  # sums < 2^24: exact in float32
    return mtfv, nm, hist, hist_g, ngroups


def _hist_rows(ids: torch.Tensor, valid: torch.Tensor, nbins: int):
    """Per-row histogram (B, nbins) int32 of ids (B, L) in [0, nbins)
    under the mask ``valid`` (lbzip2_tpu/ops/chain.py:71, which merges
    sorted probes; here a bincount)."""
    B, L = ids.shape
    rows = torch.arange(B, device=ids.device)[:, None] * (nbins + 1)
    idx = torch.where(valid, ids.long(), nbins) + rows
    return torch.bincount(idx.reshape(-1), minlength=B * (nbins + 1)) \
        .reshape(B, nbins + 1)[:, :nbins].int()


def _chain_mtf_plain(bwt: torch.Tensor, ns: torch.Tensor,
                     cmaps: torch.Tensor):
    """The plain version of ``chain_mtf``: ``_compact_syms``, the plain
    MTF, ``_rle2_plain`` and ``_hist_rows`` of mtfv[:nm]."""
    ninuse = cmaps.int().sum(1, dtype=torch.int32)
    ranks = mtf_ranks_plain(_compact_syms(bwt, cmaps), ns)
    mtfv, nm = _rle2_plain(ranks, ns, ninuse)
    lanes = torch.arange(mtfv.shape[1], device=mtfv.device)[None]
    return mtfv, nm, _hist_rows(mtfv, lanes < nm[:, None], WIDTH)


chain_mtf_launches = 0  # chain_mtf calls that ran the kernels


def chain_mtf(bwt: torch.Tensor, ns: torch.Tensor, cmaps: torch.Tensor):
    """BWT bytes -> (mtfv (B, N+1) int32, nm (B,) int32, hist (B, WIDTH)
    int32), hist the count of mtfv[:nm] a row
    (lbzip2_tpu/ops/chain.py:100, the v1 chain).  For a CUDA tensor the
    MTF kernel's byte entry, then the RLE2 kernel with its histogram
    flagged to skip the padded groups' count (``rle2_hist_rows(...,
    pads=False)``); the plain version for a CPU one."""
    global chain_mtf_launches
    if bwt.device.type == "cpu":
        return _chain_mtf_plain(bwt, ns, cmaps)
    ninuse = cmaps.int().sum(1, dtype=torch.int32)
    ranks = mtf_ranks_bytes_rows(bwt, cmaps, ns)
    out = rle2_hist_rows(ranks, ns, ninuse, pads=False)
    chain_mtf_launches += 1
    return out


def _em_estep_hist(hist: torch.Tensor, ngroups: torch.Tensor,
                   nt: torch.Tensor, lengths: torch.Tensor):
    """One batched EM expectation step with the spec's base-1024 lane
    packing (lbzip2_tpu/ops/chain.py:147).

    hist (B, G, WIDTH) float32; ngroups, nt (B,); lengths (B, 6, WIDTH)
    int32.  Returns (selectors (B, G) int32, freqs (B, 6, WIDTH)
    int32).  Both products run in float64, which is exact for these
    integers and untouched by TF32 settings."""
    B, G, _ = hist.shape
    dev = hist.device
    hd = hist.double()
    C = torch.bmm(hd, lengths.double().transpose(1, 2)).long()  # (B,G,T)
    glo = (C[..., 0] + (C[..., 1] << 10) + (C[..., 2] << 20)) & M32
    ghi = (C[..., 3] + (C[..., 4] << 10) + (C[..., 5] << 20)) & M32
    ghi = (ghi + (glo >> 30)) & M32  # lane-2 carry crosses the words
    best = torch.full((B, G), 0x400, dtype=torch.long, device=dev)
    bt = torch.zeros((B, G), dtype=torch.int32, device=dev)
    for t in range(MAX_TREES):
        word = glo if t < 3 else ghi
        c = (word >> (10 * (t % 3))) & 0x3FF
        live = (t < nt)[:, None]
        better = live & (c < best) if t else live  # first minimum wins
        best = torch.where(better, c, best)
        bt = torch.where(better, t, bt)

    gvalid = torch.arange(G, device=dev)[None] < ngroups[:, None]
    trees = torch.arange(MAX_TREES, dtype=torch.int32, device=dev)
    onehot = (bt[:, None, :] == trees[None, :, None]) & gvalid[:, None, :]
    freqs = torch.bmm(onehot.double(), hd).int()  # (B, T, WIDTH)
    return bt, freqs


estep_launches = 0  # em_estep_batch calls that ran the E-step kernel


def _em_estep_batch_plain(mtfv, nm, ninuse, nt, lengths):
    """The plain version of ``em_estep_batch``: ``_group_hist``, then
    ``_em_estep_hist``."""
    hist, _, ngroups = _group_hist(mtfv, nm, ninuse)
    bt, freqs = _em_estep_hist(hist, ngroups, nt, lengths)
    return bt, freqs, ngroups


def em_estep_batch(mtfv: torch.Tensor, nm: torch.Tensor,
                   ninuse: torch.Tensor, nt: torch.Tensor,
                   lengths: torch.Tensor):
    """One EM expectation step from the symbols
    (lbzip2_tpu/ops/chain.py:200): mtfv (B, NP) int32, nm / ninuse / nt
    (B,) int32, lengths (B, 6, WIDTH) int32 -> (selectors (B, G) int32
    of all G = ceil(NP / 50) groups, freqs (B, 6, WIDTH) int32, ngroups
    (B,) int32 = ceil(nm / 50)).  For a CUDA tensor one launch of the
    E-step kernel of ``csrc/em_chain.cu``: the EM loop's entry at one
    iteration (``lbz2t_em_chain`` with cluster_factor 1 launches
    ``em_estep`` once, its control words zero and no M-step), the plain
    version for a CPU one."""
    global estep_launches
    if mtfv.device.type == "cpu":
        return _em_estep_batch_plain(mtfv, nm, ninuse, nt, lengths)
    sel, freqs, _, _ = em_chain_cuda(mtfv, nm, ninuse, nt, lengths, 1)
    estep_launches += 1
    return sel, freqs, ((nm + GROUP_SIZE - 1) // GROUP_SIZE).int()


# the JAX module's jitted names (lbzip2_tpu/ops/chain.py)
group_hist = _group_hist
em_estep_hist = _em_estep_hist
chain_mtf2 = _chain_mtf2


def _pack_groups_plain(mtfv: torch.Tensor, nm: torch.Tensor,
                       ninuse: torch.Tensor, ngroups: torch.Tensor,
                       selectors: torch.Tensor, codes: torch.Tensor,
                       lens: torch.Tensor, start_bit: torch.Tensor, W: int):
    """The plain version of ``_pack_groups``: the u32 shifts run in int64
    with a mask; both scatter-adds and the W+1 dump slot stay."""
    B, NP = mtfv.shape
    dev = mtfv.device
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    lanes = torch.arange(G * GROUP_SIZE, dtype=torch.int32, device=dev)[None]
    padded = torch.nn.functional.pad(mtfv, (0, G * GROUP_SIZE - NP))
    padded = torch.where(lanes < nm[:, None], padded, (ninuse + 2)[:, None])
    groups = padded.reshape(B, G, GROUP_SIZE)

    # per-symbol code + length from one table gather: (len << 24) | code
    tree = selectors.clamp(0, MAX_TREES - 1).long()
    flat_sym = (tree[:, :, None] * WIDTH + groups).reshape(B, -1)
    packed_tab = ((lens.long() << 24) | codes.long()).reshape(
        B, MAX_TREES * WIDTH)
    pv = torch.gather(packed_tab, 1, flat_sym).reshape(B, G, GROUP_SIZE)
    cv = pv & 0x00FFFFFF
    gvalid = torch.arange(G, device=dev)[None] < ngroups[:, None]
    lv = torch.where(gvalid[:, :, None], pv >> 24, 0)

    # level 1: 50 codes into one 33-word slot per group
    ends = torch.cumsum(lv, dim=2)
    gbits = ends[:, :, -1]
    starts = ends - lv
    s_in = starts & 31
    widx = starts >> 5
    end_in = s_in + lv
    hi = torch.where(end_in <= 32,
                     (cv << (32 - end_in).clamp(0, 31)) & M32,
                     cv >> (end_in - 32).clamp(0, 31))
    lo = torch.where(end_in <= 32, 0,
                     (cv << (64 - end_in).clamp(0, 31)) & M32)
    slots = torch.zeros((B, G, _SLOT_WORDS + 1), dtype=torch.long,
                        device=dev)
    slots.scatter_add_(2, widx, hi)
    slots.scatter_add_(2, widx + 1, lo)
    su = slots & M32  # code bit ranges never overlap: add == or

    # level 2: shift each slot to its group's bit offset, scatter-add
    # into W + 2 words (W + 1 is the dump slot for invalid/overflow)
    S = _SLOT_WORDS + 1
    gends = torch.cumsum(gbits, dim=1) + start_bit.long()[:, None]
    gstarts = gends - gbits
    total = gends[:, -1] if G > 0 else start_bit.long()
    sh2 = (gstarts & 31)[:, :, None]
    wbase = (gstarts >> 5)[:, :, None]
    prevw = torch.nn.functional.pad(su[:, :, :-1], (1, 0))
    lsh = (32 - sh2) & 31
    val = torch.where(sh2 == 0, su, ((su >> sh2) | (prevw << lsh)) & M32)
    spill = torch.where(sh2 == 0, 0, (su[:, :, -1:] << lsh) & M32)
    val = torch.cat([val, spill], dim=2)                     # (B,G,S+1)
    ji = torch.arange(S + 1, device=dev)[None, None]
    widx2 = torch.where(gvalid[:, :, None], wbase + ji, W + 1)
    out = torch.zeros((B, W + 2), dtype=torch.long, device=dev)
    out.scatter_add_(1, widx2.clamp(max=W + 1).reshape(B, -1),
                     val.reshape(B, -1))
    words = out[:, :W] & M32
    wpos = torch.arange(W, device=dev)[None] * 32
    words = torch.where(wpos < total[:, None], words, 0)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int(), total


pack_launches = 0  # launches of pack_chunks: _pack_groups and _pack_flat
flat_launches = 0  # of those, the flat mode's (_pack_flat)


def _pack_lib():
    lib = _build.load("pack_groups")
    fn = lib.lbz2t_pack_groups
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lbz2t_pack_flat.argtypes = [ctypes.c_void_p] * 12 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lbz2t_pack_flat.restype = ctypes.c_int
        lib.lbz2t_pack_desc_words.argtypes = [ctypes.c_int] * 2
        lib.lbz2t_pack_desc_words.restype = ctypes.c_longlong
        lib.lbz2t_pack_state_ints.argtypes = [ctypes.c_int]
        lib.lbz2t_pack_state_ints.restype = ctypes.c_longlong
    return lib


def _pack_checked(mtfv, nm, ninuse, ngroups, selectors, codes, lens,
                  start_bit, *more):
    """Raise unless the packing kernel takes these tensors (``more``: the
    flat mode's row ends, int32 (B,)); then the built library (it raises
    without nvcc, before anything is queued)."""
    dev = mtfv.device
    rows = (nm, ninuse, ngroups, start_bit) + more
    ints = rows + (mtfv, selectors, lens)
    if dev.type != "cuda" or any(a.device != dev for a in ints + (codes,)):
        raise ValueError("the packing kernel needs every input on one CUDA "
                         "device")
    if any(a.dtype != torch.int32 for a in ints) or \
            codes.dtype != torch.int64:
        raise TypeError("the packing kernel takes int32 inputs and int64 "
                        "codes")
    if mtfv.dim() != 2:
        raise ValueError(f"bad mtfv shape {tuple(mtfv.shape)}")
    B, NP = mtfv.shape
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    if any(a.shape != (B,) for a in rows) or selectors.shape != (B, G) or \
            codes.shape != (B, MAX_TREES, WIDTH) or lens.shape != codes.shape:
        raise ValueError("bad _pack_groups shapes")
    if not all(a.is_contiguous() for a in ints + (codes,)):
        raise ValueError("the packing kernel's inputs must be contiguous")
    return _pack_lib()


def _pack_groups_cuda(mtfv: torch.Tensor, nm: torch.Tensor,
                      ninuse: torch.Tensor, ngroups: torch.Tensor,
                      selectors: torch.Tensor, codes: torch.Tensor,
                      lens: torch.Tensor, start_bit: torch.Tensor, W: int):
    """Launch the kernel of ``csrc/pack_groups.cu`` on the current stream
    after the output's zero fill (no synchronize, nothing read on the
    host); its chunk descriptors and ticket are the calling thread's
    (``ops/lookback.py``)."""
    global pack_launches
    lib = _pack_checked(mtfv, nm, ninuse, ngroups, selectors, codes, lens,
                        start_bit)
    dev = mtfv.device
    B, NP = mtfv.shape
    with torch.cuda.device(dev):  # the C side launches on it
        words = torch.zeros((B, W), dtype=torch.int32, device=dev)
        if B == 0 or NP == 0:
            return words, start_bit.long()
        total = torch.empty(B, dtype=torch.int64, device=dev)
        desc, state, epoch = lookback.scratch(
            "pack_groups", dev, lib.lbz2t_pack_desc_words(B, NP),
            lib.lbz2t_pack_state_ints(B), torch.int64)
        err = lib.lbz2t_pack_groups(
            mtfv.data_ptr(), nm.data_ptr(), ninuse.data_ptr(),
            ngroups.data_ptr(), selectors.data_ptr(), codes.data_ptr(),
            lens.data_ptr(), start_bit.data_ptr(), words.data_ptr(),
            total.data_ptr(), desc.data_ptr(), state.data_ptr(), B, NP, W,
            epoch, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pack_groups kernel launch failed: "
                               f"cudaError {err}")
    pack_launches += 1
    return words, total


def _pack_groups(mtfv: torch.Tensor, nm: torch.Tensor,
                 ninuse: torch.Tensor, ngroups: torch.Tensor,
                 selectors: torch.Tensor, codes: torch.Tensor,
                 lens: torch.Tensor, start_bit: torch.Tensor, W: int):
    """Pack every group's Huffman codes into the payload bit stream
    (lbzip2_tpu/ops/chain.py:222).

    mtfv (B, NP), nm, ninuse, ngroups (B,), selectors (B, G) int32 (G =
    ceil(NP / 50); clamped to 0..5); codes (B, 6, WIDTH) int64 (< 2^20
    and below 2^len), lens (B, 6, WIDTH) int32 (the dummy symbol's
    length is read like any other), start_bit (B,) int32.  Returns
    (words (B, W) int32 holding the big-endian u32 payload words as bit
    patterns, 0 past the row's bits; total_bits (B,) int64, start_bit
    included).  A row past W keeps its words below W.  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if mtfv.device.type == "cuda":
        return _pack_groups_cuda(mtfv, nm, ninuse, ngroups, selectors,
                                 codes, lens, start_bit, W)
    if mtfv.device.type == "cpu":
        return _pack_groups_plain(mtfv, nm, ninuse, ngroups, selectors,
                                  codes, lens, start_bit, W)
    raise ValueError(f"unsupported device {mtfv.device}")


def _pack_flat_cuda(mtfv, nm, ninuse, ngroups, selectors, codes, lens,
                    start_bit, W: int, ends: torch.Tensor, F: int):
    """Launch the flat mode of ``csrc/pack_groups.cu`` on the current
    stream after the (F,) output's zero fill (no synchronize, nothing read
    on the host); the descriptors are ``_pack_groups``'."""
    global pack_launches, flat_launches
    lib = _pack_checked(mtfv, nm, ninuse, ngroups, selectors, codes, lens,
                        start_bit, ends)
    if F < 0 or F >= 2 ** 31 or W < 0:
        raise ValueError(f"bad flat slots F = {F}, W = {W}")
    dev = mtfv.device
    B, NP = mtfv.shape
    with torch.cuda.device(dev):  # the C side launches on it
        flat = torch.zeros(F, dtype=torch.int32, device=dev)
        if B == 0 or NP == 0 or F == 0:
            return flat
        desc, state, epoch = lookback.scratch(
            "pack_groups", dev, lib.lbz2t_pack_desc_words(B, NP),
            lib.lbz2t_pack_state_ints(B), torch.int64)
        err = lib.lbz2t_pack_flat(
            mtfv.data_ptr(), nm.data_ptr(), ninuse.data_ptr(),
            ngroups.data_ptr(), selectors.data_ptr(), codes.data_ptr(),
            lens.data_ptr(), start_bit.data_ptr(), ends.data_ptr(),
            flat.data_ptr(), desc.data_ptr(), state.data_ptr(), B, NP, W, F,
            epoch, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pack_groups (flat) kernel launch failed: "
                               f"cudaError {err}")
    pack_launches += 1
    flat_launches += 1
    return flat


def _pack_flat(mtfv: torch.Tensor, nm: torch.Tensor, ninuse: torch.Tensor,
               ngroups: torch.Tensor, selectors: torch.Tensor,
               codes: torch.Tensor, lens: torch.Tensor,
               start_bit: torch.Tensor, W: int, ends: torch.Tensor,
               F: int) -> torch.Tensor:
    """The payload words packed and compacted in one step:
    ``_flatten_words(_pack_groups(...)[0], ends, F)``, as
    lbzip2_tpu/ops/chain.py::_flatten_download (:380) composes them.

    The arguments of ``_pack_groups``, then ends (B,) int32, the rows'
    inclusive word ends (non-decreasing; each row's word count ends[r] -
    ends[r - 1] at most W, 0 for a row left out), and F flat slots.
    Returns (F,) int32 (u32 bit patterns): row r's words at [ends[r - 1],
    ends[r]), 0 elsewhere.  For CUDA tensors the flat mode of
    ``csrc/pack_groups.cu``, one launch after the zero fill, with no (B,
    W) words array; for CPU tensors the plain composition."""
    if mtfv.device.type == "cuda":
        return _pack_flat_cuda(mtfv, nm, ninuse, ngroups, selectors, codes,
                               lens, start_bit, W, ends, F)
    if mtfv.device.type == "cpu":
        words, _ = _pack_groups_plain(mtfv, nm, ninuse, ngroups, selectors,
                                      codes, lens, start_bit, W)
        return _flatten_words_plain(words, ends, F)
    raise ValueError(f"unsupported device {mtfv.device}")


def _flatten_words_plain(words: torch.Tensor, ends: torch.Tensor, F: int,
                         base: int = 0) -> torch.Tensor:
    """The plain version of ``_flatten_words``: a searchsorted, then a
    gather."""
    B, W = words.shape
    f = torch.arange(F, dtype=torch.int32, device=words.device) + base
    r = torch.searchsorted(ends, f, right=True)
    rc = r.clamp(max=B - 1)
    starts = torch.cat([torch.zeros_like(ends[:1]), ends[:-1]])
    idx = (f - starts[rc]).clamp(0, W - 1).long()
    return torch.where(r < B, words[rc, idx], 0)


flatten_launches = 0  # CUDA kernel launches made by _flatten_words


def _flatten_cuda(words: torch.Tensor, ends: torch.Tensor, F: int,
                  base: int) -> torch.Tensor:
    """Launch the kernel of ``csrc/flatten_words.cu`` on the current
    stream (no synchronize, nothing read on the host)."""
    global flatten_launches
    dev = words.device
    if dev.type != "cuda" or ends.device != dev:
        raise ValueError("_flatten_cuda needs words and ends on one CUDA "
                         "device")
    if words.dtype != torch.int32 or ends.dtype != torch.int32:
        raise TypeError("words and ends must be int32")
    if words.dim() != 2 or ends.shape != (words.shape[0],):
        raise ValueError(f"bad shapes {tuple(words.shape)} / "
                         f"{tuple(ends.shape)}")
    if not (words.is_contiguous() and ends.is_contiguous()):
        raise ValueError("words and ends must be contiguous")
    if F < 0 or base < 0 or F + base >= 2 ** 31:
        raise ValueError(f"bad flat slots [{base}, {base} + {F})")
    lib = _build.load("flatten_words")
    if lib.lbz2t_flatten_words.argtypes is None:
        lib.lbz2t_flatten_words.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lbz2t_flatten_words.restype = ctypes.c_int
    B, W = words.shape
    with torch.cuda.device(dev):  # the C side launches on it
        if B == 0 or W == 0 or F == 0:
            return torch.zeros(F, dtype=torch.int32, device=dev)
        out = torch.empty(F, dtype=torch.int32, device=dev)
        err = lib.lbz2t_flatten_words(
            words.data_ptr(), ends.data_ptr(), out.data_ptr(), B, W, F,
            base, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flatten_words kernel launch failed: "
                               f"cudaError {err}")
    flatten_launches += 1
    return out


def _flatten_words(words: torch.Tensor, ends: torch.Tensor, F: int,
                   base: int = 0) -> torch.Tensor:
    """Compact per-row payload words into flat slots [base, base + F):
    slot f belongs to row searchsorted(ends, f, right=True), word
    f - start of that row (clamped to the row's width); slots past the
    last row are 0.  ends: (B,) inclusive prefix sum of per-row word
    counts (int32).  The kernel of ``csrc/flatten_words.cu`` for CUDA
    tensors (int32 words, at most 12288 rows), the plain version for CPU
    tensors."""
    if words.device.type == "cuda":
        return _flatten_cuda(words, ends, F, base)
    if words.device.type == "cpu":
        return _flatten_words_plain(words, ends, F, base)
    raise ValueError(f"unsupported device {words.device}")


def chain_payloads(bwt_dev: torch.Tensor, ns, cmaps, idxs, crcs,
                   cluster_factor: int = 8, pack_w: int = PACK_W,
                   _force_full_pack: bool = False,
                   times: dict | None = None, mesh_axis=None):
    """Drive the device entropy chain for one resolved BWT batch.

    bwt_dev: (B, N) uint8 tensor of BWT rows on the compute device;
    ns / idxs / crcs: (B,) host arrays; cmaps: (B, 256) uint8.  Returns
    B payload byte strings, None for rows that exceed the pack width
    (the caller re-encodes those on the host).

    mesh_axis=(devices, axis) shards the batch (lbzip2_tpu/ops/chain.py
    :455-460): the rows (bwt_dev a tensor anywhere or a host array) are
    split over the devices as ``parallel/sharding.run_shards`` splits
    them, each shard's auxiliary arrays follow its rows, one chain runs
    a shard on its own stream, and the payloads come back in row order
    (``times["shards"]``: each shard's stage times).

    Device: MTF + RLE2 + EM + group bit-pack.  Host (C): initial trees,
    final code assignment and headers, stream splice.  Each download
    (``.cpu()``) is the wait on the device; the EM loop runs between two
    of them with nothing read on the host (``times["em_iters"]`` is its
    count of E-steps, downloaded with its outputs)."""

    if mesh_axis is not None:
        return _chain_sharded(bwt_dev, ns, cmaps, idxs, crcs, mesh_axis[0],
                              times, cluster_factor=cluster_factor,
                              pack_w=pack_w,
                              _force_full_pack=_force_full_pack)

    def _mark(key, t0):
        if times is not None:
            times[key] = round(time.time() - t0, 3)
        return time.time()

    dev = bwt_dev.device

    def _put(x):
        return upload(x, dev)

    t0 = time.time()
    B, N = bwt_dev.shape
    ns = np.asarray(ns, np.int32)
    cmaps_u8 = np.ascontiguousarray(cmaps, np.uint8)
    mtfv, nm, hist, _, _ = _chain_mtf2(bwt_dev, _put(ns), _put(cmaps_u8))
    t0 = _mark("dispatch_mtf", t0)
    nm_h = nm.cpu().numpy()
    hist_h = hist.cpu().numpy()
    t0 = _mark("wait_mtf", t0)
    ninuse = cmaps_u8.sum(axis=1, dtype=np.int32)
    as_arr = ninuse + 2
    nt_arr = np.array([num_trees_for(int(v)) for v in nm_h], np.int32)
    ngroups = (nm_h + GROUP_SIZE - 1) // GROUP_SIZE

    # zero the group-padding counts at lane `as` before the initial split
    lane = np.arange(WIDTH, dtype=np.int32)[None]
    hist_h = np.where(lane < as_arr[:, None], hist_h, 0)
    lengths = np.ones((B, MAX_TREES, WIDTH), np.uint8)
    for b in range(B):
        lengths[b] = generate_initial_trees(
            hist_h[b].astype(np.int64), int(nm_h[b]), int(nt_arr[b]))
        lengths[b, :, as_arr[b]:] = 0

    ninuse_dev = _put(ninuse)
    nt_dev = _put(nt_arr)
    t0 = _mark("init_trees", t0)
    sel, freqs, lengths_dev, iters = em_chain_rows(
        mtfv.contiguous(), nm.int(), ninuse_dev, nt_dev,
        _put(lengths.astype(np.int32)), cluster_factor)
    t0 = _mark("dispatch_em", t0)
    if times is not None:
        times["em_iters"] = int(iters.cpu())
    freqs_h = freqs.cpu().numpy().astype(np.uint32)
    lengths = np.ascontiguousarray(
        lengths_dev.cpu().numpy(), np.uint8).reshape(B, MAX_TREES, WIDTH)
    sel_h = sel.cpu().numpy().astype(np.uint8)
    t0 = _mark("wait_em", t0)
    codes, hdr, hdr_bits, payload_bits = native.chain_finish(
        sel_h, ngroups, freqs_h, as_arr, nt_arr, cmaps_u8,
        np.asarray(idxs, np.int32), np.asarray(crcs, np.uint32), lengths)
    t0 = _mark("finish_c", t0)

    start_bit = (hdr_bits % 32).astype(np.int32)
    fits = (payload_bits + start_bit) <= 32 * pack_w
    need = np.where(fits, (payload_bits + start_bit + 31) // 32, 0)
    pw = PACK_W_SMALL if (B and need.max() <= PACK_W_SMALL and
                          pack_w == PACK_W and
                          not _force_full_pack) else pack_w
    fits = (payload_bits + start_bit) <= 32 * pw
    wcnt = np.where(fits, (payload_bits + start_bit + 31) // 32,
                    0).astype(np.int32)
    ends = np.cumsum(wcnt).astype(np.int32)
    args = (mtfv, nm, ninuse_dev, _put(ngroups.astype(np.int32)), sel,
            _put(codes.astype(np.int64)), _put(lengths.astype(np.int32)),
            _put(start_bit), pw)
    if B and ends[-1] <= FLAT_W:
        # packed straight into whole FLAT_CHUNK chunks of flat slots
        F = -(-int(ends[-1]) // FLAT_CHUNK) * FLAT_CHUNK
        flat = _pack_flat(*args, _put(ends), F)
        t0 = _mark("dispatch_pack", t0)
        flat_h = flat.cpu().numpy().view(np.uint32)  # int32 bit patterns
        rows = [flat_h[(ends[b] - wcnt[b]):ends[b]] for b in range(B)]
    else:
        words, _ = _pack_groups(*args)
        t0 = _mark("dispatch_pack", t0)
        words_h = words.cpu().numpy().view(np.uint32)
        rows = [words_h[b, :wcnt[b]] for b in range(B)]
    t0 = _mark("wait_pack", t0)

    out = []
    for b in range(B):
        if not fits[b]:
            out.append(None)
            continue
        hb = (int(hdr_bits[b]) + 7) // 8
        w0 = int(hdr_bits[b]) // 32
        total_bytes = (int(hdr_bits[b]) + int(payload_bits[b])) // 8
        buf = np.zeros(total_bytes, np.uint8)
        buf[:hb] = hdr[b, :hb]
        pb = rows[b].astype(">u4").view(np.uint8)
        buf[4 * w0:] |= pb[:total_bytes - 4 * w0]
        out.append(buf.tobytes())
    _mark("splice", t0)
    return out


def _chain_sharded(bwt, ns, cmaps, idxs, crcs, devices, times, **kw):
    """``chain_payloads`` of each shard of the rows on its device."""
    def shard(dev, rows, *aux):
        rows = rows.to(dev) if isinstance(rows, torch.Tensor) else \
            upload(np.ascontiguousarray(rows, np.uint8), dev)
        mine = {} if times is not None else None
        return chain_payloads(rows, *aux, times=mine, **kw), mine

    parts = run_shards(devices, shard, bwt, np.asarray(ns, np.int32),
                       np.asarray(cmaps, np.uint8), np.asarray(idxs),
                       np.asarray(crcs, np.uint32))
    if times is not None:
        times["shards"] = [t for _, t in parts]
    return [p for payloads, _ in parts for p in payloads]
