"""Batched Huffman code lengths and the EM loop on the device.

Counterpart of lbzip2_tpu/ops/huffenc.py.  Bit-exact with
native/huffman2.c make_code_lengths2: node order is the lexicographic
key (freq, height, nleaf mod 256, tag), tag = MAX_ALPHA - symbol for
leaves and the j-th merge carrying the tag of the j-th smallest leaf;
lengths come from the two-queue merge preferring leaves on ties and are
re-assigned by rank profile.

``make_code_lengths_rows`` runs the hand-written kernel
``csrc/code_lengths.cu`` (a warp a tree, ``csrc/code_lengths.cuh``) for
a CUDA tensor, and the plain PyTorch version for a CPU tensor.  The
plain version is the JAX op step for step: a merge of 257 masked steps
vectorised across the B * 6 rows of a batch, a few dozen small ops a
step, which is why it is not the card's path.

``em_chain_rows`` is the whole EM loop of a batch.  For CUDA tensors it
enqueues the kernels of ``csrc/em_chain.cu``: an E-step that reads the
symbols themselves and an M-step that runs the code-length device
function, ``cluster_factor`` rounds with the convergence test in device
memory, so the host reads nothing inside the loop.  For CPU tensors it
runs the plain loop ``_em_chain`` over the per-group histogram, the JAX
ops step for step.
"""

from __future__ import annotations

import ctypes

import torch

from lbzip2_tpu_torch import _build
from lbzip2_tpu_torch.core.constants import (GROUP_SIZE, MAX_ALPHA_SIZE,
                                             MAX_TREES)

MAX_ALPHA = 258
W = MAX_ALPHA_SIZE + 1          # 259 lanes (symbols 0..257 + dummy)
_NLEAF = MAX_ALPHA              # max leaves per tree (as <= 258)
_NMERGE = _NLEAF - 1
_NN = _NLEAF + _NMERGE          # node slots: sorted leaves, then merges
_HLIM = 30                      # MAX_HUFF_LEN2 profile clamp
_INF32 = 0x7FFFFFFF

# launches of a kernel that runs the code-length device function: the
# stand-alone kernel by make_code_lengths_rows, and the M-step kernels
# that em_chain_rows enqueues (cluster_factor - 1 a loop)
launches = 0
em_launches = 0  # EM loops that em_chain_rows enqueued on a card


def _lt(fa, ta, fb, tb):
    """Lexicographic (f, t) <."""
    return (fa < fb) | ((fa == fb) & (ta < tb))


def _make_code_lengths_rows(freqs: torch.Tensor,
                            as_arr: torch.Tensor) -> torch.Tensor:
    """freqs (R, W) int32, as_arr (R,) int32 -> lengths (R, W) int32,
    symbols >= as zeroed (lbzip2_tpu/ops/huffenc.py:52)."""
    R = freqs.shape[0]
    dev = freqs.device
    lanes = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    live = lanes < as_arr[:, None]
    f = torch.where(live, freqs.clamp(min=1), 0)
    tag = MAX_ALPHA - lanes

    # ascending sort by (f, tag) packed in one int32: f < 2^20, tag < 2^9
    key = torch.where(live, (f << 9) | tag, _INF32)
    skey = torch.sort(key, dim=1).values
    pad = skey == _INF32
    lf = torch.where(pad, _INF32, skey >> 9)
    ltag = torch.where(pad, 0, skey & 511)
    lt_ = torch.where(pad, _INF32, (1 << 9) | ltag)

    nf = torch.full((R, _NN), _INF32, dtype=torch.int32, device=dev)
    nt_ = torch.full((R, _NN), _INF32, dtype=torch.int32, device=dev)
    nf[:, :W] = lf
    nt_[:, :W] = lt_
    child0 = torch.zeros((R, _NMERGE), dtype=torch.int32, device=dev)
    child1 = torch.zeros((R, _NMERGE), dtype=torch.int32, device=dev)
    nmerge = (as_arr - 1).clamp(min=0)

    def g(arr, idx):  # row gather with JAX's index clamping
        return torch.gather(arr, 1, idx.clamp(0, _NN - 1).long()[:, None])[:, 0]

    li = torch.zeros(R, dtype=torch.int32, device=dev)
    ii = torch.zeros(R, dtype=torch.int32, device=dev)
    for s in range(1, _NMERGE + 1):
        act = s <= nmerge
        lf0, lt0 = g(nf, li), g(nt_, li)
        lf1, lt1 = g(nf, li + 1), g(nt_, li + 1)
        if0, it0 = g(nf, _NLEAF + ii), g(nt_, _NLEAF + ii)
        if1, it1 = g(nf, _NLEAF + ii + 1), g(nt_, _NLEAF + ii + 1)
        nleaf = as_arr - li
        nint = (s - 1) - ii
        # decision table (huff_pick_pair): ties prefer leaves
        pick_ii = (nleaf == 0) | ((nint >= 2) & _lt(if1, it1, lf0, lt0))
        pick_ll = ~pick_ii & ((nint == 0) |
                              ((nleaf >= 2) & ~_lt(if0, it0, lf1, lt1)))
        pick_il = ~pick_ii & ~pick_ll
        c0 = torch.where(pick_ll, li, _NLEAF + ii)
        c1 = torch.where(pick_ii, _NLEAF + ii + 1,
                         torch.where(pick_il, li, li + 1))
        li = torch.where(act, li + torch.where(
            pick_ii, 0, torch.where(pick_ll, 2, 1)), li)
        ii = torch.where(act, ii + torch.where(
            pick_ii, 2, torch.where(pick_ll, 0, 1)), ii)
        f0, t0 = g(nf, c0), g(nt_, c0)
        f1, t1 = g(nf, c1), g(nt_, c1)
        height = torch.maximum(t0 >> 17, t1 >> 17) + 1
        nl = (((t0 >> 9) & 255) + ((t1 >> 9) & 255)) & 255
        mt = (height << 17) | (nl << 9) | ltag[:, min(s - 1, W - 1)]
        slot = _NLEAF + s - 1
        nf[:, slot] = torch.where(act, f0 + f1, nf[:, slot])
        nt_[:, slot] = torch.where(act, mt, nt_[:, slot])
        child0[:, s - 1] = torch.where(act, c0, child0[:, s - 1])
        child1[:, s - 1] = torch.where(act, c1, child1[:, s - 1])

    # top-down depths: children of merge j have ids < _NLEAF + j, so one
    # reverse sweep over the merges resolves every depth
    depth = torch.zeros((R, _NN), dtype=torch.int32, device=dev)
    for j in range(_NMERGE - 1, -1, -1):
        act = j <= nmerge - 1
        d = torch.where(act, depth[:, _NLEAF + j] + 1, 0)
        for ch in (child0[:, j], child1[:, j]):
            idx = ch.long()[:, None]
            cur = torch.gather(depth, 1, idx)[:, 0]
            depth.scatter_(1, idx, torch.where(act, d, cur)[:, None])

    # rank profile: the d-th smallest leaf gets the d-th largest depth
    ldep = torch.where(live, depth[:, :W].clamp(max=_HLIM), -1)
    sdep = torch.sort(ldep, dim=1, descending=True).values
    sym = torch.where(live, MAX_ALPHA - ltag, W)  # dead ranks -> extra col
    out = torch.zeros((R, W + 1), dtype=torch.int32, device=dev)
    out.scatter_(1, sym.long(), torch.where(live, sdep, 0))
    out = out[:, :W].clone()
    out[:, W - 1] = 0  # symbol 258 is never real (as <= 258)
    return out


def _lib():
    fn = _build.load("code_lengths").lbz2t_code_lengths
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def make_code_lengths_cuda(freqs: torch.Tensor,
                           as_arr: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    dev = freqs.device
    if dev.type != "cuda" or as_arr.device != dev:
        raise ValueError("make_code_lengths_cuda needs both inputs on one "
                         "CUDA device")
    if any(a.dtype != torch.int32 or not a.is_contiguous()
           for a in (freqs, as_arr)):
        raise TypeError("make_code_lengths_cuda inputs must be contiguous "
                        "int32")
    R = freqs.shape[0]
    if freqs.shape != (R, W) or as_arr.shape != (R,):
        raise ValueError("bad make_code_lengths shapes")
    with torch.cuda.device(dev):  # the C side launches on it
        out = torch.empty((R, W), dtype=torch.int32, device=dev)
        if R == 0:
            return out
        err = _lib()(freqs.data_ptr(), as_arr.data_ptr(), out.data_ptr(),
                     R, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"code_lengths kernel launch failed: cudaError {err}")
    launches += 1
    return out


def make_code_lengths_rows(freqs: torch.Tensor,
                           as_arr: torch.Tensor) -> torch.Tensor:
    """Huffman code lengths of R trees: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    freqs (R, W) int32 symbol counts (< 2^22; 0 counts as 1), as_arr
    (R,) int32 alphabet sizes in 0..258 -> lengths (R, W) int32, at most
    30, symbols >= as zero."""
    if freqs.device.type == "cuda":
        return make_code_lengths_cuda(freqs, as_arr)
    if freqs.device.type == "cpu":
        return _make_code_lengths_rows(freqs, as_arr)
    raise ValueError(f"unsupported device {freqs.device}")


def _em_chain(hist_g: torch.Tensor, ngroups: torch.Tensor,
              nt: torch.Tensor, as_arr: torch.Tensor,
              lengths0: torch.Tensor, cluster_factor: int):
    """Full EM loop on the device (lbzip2_tpu/ops/huffenc.py:184).

    hist_g (B, G, W) float32; ngroups / nt / as_arr (B,) int32;
    lengths0 (B, 6, W) int32.  Returns (selectors (B, G) int32, freqs
    (B, 6, W) int32, lengths (B, 6, W) int32 = the input of the last
    E-step, iters int32).  Each iteration: E-step; stop if the selectors
    repeat the previous iteration's; else M-step unless it was the last.
    The convergence test is read on the host once per iteration."""
    from lbzip2_tpu_torch.ops.chain import _em_estep_hist

    B = hist_g.shape[0]
    R = B * MAX_TREES
    as_rows = as_arr.repeat_interleave(MAX_TREES, output_size=R)
    tree_live = (torch.arange(MAX_TREES, device=hist_g.device)[None, :] <
                 nt[:, None])[:, :, None]
    lengths = lengths0
    prev_sel = None
    it = 0
    while it < cluster_factor:
        sel, freqs = _em_estep_hist(hist_g, ngroups, nt, lengths)
        conv = prev_sel is not None and bool(torch.equal(sel, prev_sel))
        it += 1
        if conv or it >= cluster_factor:
            break
        new = make_code_lengths_rows(freqs.reshape(R, W).contiguous(),
                                     as_rows)
        lengths = torch.where(tree_live, new.reshape(B, MAX_TREES, W),
                              lengths)
        prev_sel = sel
    return sel, freqs, lengths, torch.tensor(it, dtype=torch.int32)


def _em_lib():
    fn = _build.load("em_chain").lbz2t_em_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def em_chain_cuda(mtfv: torch.Tensor, nm: torch.Tensor,
                  ninuse: torch.Tensor, nt: torch.Tensor,
                  lengths0: torch.Tensor, cluster_factor: int):
    """Enqueue the EM loop's kernels on the current stream (no
    synchronize, nothing read on the host); see ``em_chain_rows``."""
    global launches, em_launches
    dev = mtfv.device
    small = (nm, ninuse, nt)
    if dev.type != "cuda" or any(a.device != dev
                                 for a in small + (lengths0,)):
        raise ValueError("em_chain_cuda needs every input on one CUDA "
                         "device")
    if any(a.dtype != torch.int32 or not a.is_contiguous()
           for a in small + (mtfv, lengths0)):
        raise TypeError("em_chain_cuda inputs must be contiguous int32")
    if mtfv.dim() != 2 or mtfv.shape[0] < 1 or mtfv.shape[1] < 1:
        raise ValueError("em_chain_cuda needs mtfv (B, NP) with B, NP >= 1")
    B, NP = mtfv.shape
    if any(a.shape != (B,) for a in small) or \
            lengths0.shape != (B, MAX_TREES, W):
        raise ValueError("bad em_chain shapes")
    if cluster_factor < 1:
        raise ValueError("cluster_factor must be at least 1")
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    with torch.cuda.device(dev):  # the C side launches on it
        lengths = lengths0.clone()
        sel = torch.empty((B, G), dtype=torch.int32, device=dev)
        freqs = torch.zeros((B, MAX_TREES, W), dtype=torch.int32,
                            device=dev)
        ctl = torch.zeros(2 + cluster_factor, dtype=torch.int32, device=dev)
        err = _em_lib()(mtfv.data_ptr(), nm.data_ptr(), ninuse.data_ptr(),
                        nt.data_ptr(), lengths.data_ptr(), sel.data_ptr(),
                        freqs.data_ptr(), ctl.data_ptr(), B, NP, G,
                        cluster_factor,
                        torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"em_chain kernel launch failed: cudaError "
                               f"{err}")
    em_launches += 1
    launches += cluster_factor - 1
    return sel, freqs, lengths, ctl[1]


def em_chain_rows(mtfv: torch.Tensor, nm: torch.Tensor,
                  ninuse: torch.Tensor, nt: torch.Tensor,
                  lengths0: torch.Tensor, cluster_factor: int):
    """The EM loop of one batch from its symbols: the CUDA kernels for
    CUDA tensors, the plain loop for CPU tensors.

    mtfv (B, NP) int32 MTF/RLE2 symbols, nm (B,) their counts, ninuse
    (B,) used byte values (the alphabet is ninuse + 2, which is also the
    dummy symbol of the positions at and past nm), nt (B,) trees in use,
    lengths0 (B, 6, W) int32 initial trees.  Returns what ``_em_chain``
    returns on the histogram of the same symbols: (selectors (B, G)
    int32 of all G = ceil(NP / 50) groups, freqs (B, 6, W) int32,
    lengths (B, 6, W) int32, iters int32 scalar on the inputs' device)."""
    if mtfv.device.type == "cuda":
        return em_chain_cuda(mtfv, nm, ninuse, nt, lengths0, cluster_factor)
    if mtfv.device.type == "cpu":
        from lbzip2_tpu_torch.ops.chain import _group_hist

        hist_g, _, ngroups = _group_hist(mtfv, nm, ninuse)
        return _em_chain(hist_g, ngroups, nt, ninuse + 2, lengths0,
                         cluster_factor)
    raise ValueError(f"unsupported device {mtfv.device}")
