"""Batched BWT by suffix doubling over Lyndon conjugates.

Counterpart of lbzip2_tpu/ops/bwt2.py, both modes: ``bwt2_bytes``
leaves the BWT rows on the device (chain mode), ``bwt2_tokens`` emits
byte/run-length tokens for the host entropy coder (token mode).  The
host rotates each block to its least rotation, whose suffix order is
its rotation order, so ranks at ``i + k`` are read from an ISA extended
with position-coded end sentinels ``n - p - 2^30`` (``_extend``).

The two suffix sorts, ``_seed16`` and ``_passx`` (``_pass8``, and
``_pass4`` with four keys, a template parameter of the pass's kernels),
run the hand-written kernels of ``csrc/bwt2_sort.cu`` for a CUDA tensor;
``seed_into`` and ``pass_into`` also launch their cyclic and tie-break
modes for the rotation sort of ``ops/bwt.py``.  The seed sorts the
lanes < n by their first 4-byte word W0 in 4 stable 8-bit radix passes
that carry the word with the lane; runs of equal W0 of two or more
lanes are then sorted by W1..W3 (gathered once a lane), each in a bin
by its size (``SEG_SMALL``, ``SEG_BLOCKS``), runs above the last bin by
rounds of the same carried radix passes by the next word; the pads'
key rule applies to the run of W0 = FF FF FF FF alone.  A pass is a
segmented sort: key 0 is the ISA, so only the classes of two or more
lanes are sorted, by keys 1 to 7 mapped below 2N, each in a bin by its
size (larger classes by radix passes over their lanes alone), and the
ISA is updated in place.  The kernels' ISA is defined on the lanes < n only: the seed
writes 0 past them and a pass leaves them as they are; no reader looks
there (``_extend``, ``_pass8``'s key 0 and the emits mask them, the
primary index reads a lane < n).  For a CPU tensor they run the plain
versions, ``_seed16_plain`` and ``_passx_plain``, which also fill the
pad lanes as JAX does.  The resolve loop queues its passes on the card
and reads nothing there.

The emits run ``csrc/bwt2_emit.cu`` for a CUDA tensor: ``_emit_bytes``
scatters each lane's previous byte to its ISA (a permutation of [0, n)
on the lanes < n once a pass has run) through buckets of 16384
destinations (``emit_bin`` then ``emit_place``), ``_emit2`` then writes
the run tokens in one pass over tiles of 8192 lanes (a scan with decoupled
look-back, then a write-only tail past the count).  For a CPU tensor
they run JAX's sort formulation (``_emit_bytes_plain``,
``_emit2_plain``).

The plain multi-key stable sorts are ``torch.sort(stable=True)``
passes over keys packed two to an int64, ``(signed hi << 32) +
unsigned lo``, taken from the last key pair to the first (LSD order).
Ties between equal key tuples need no particular order: every lane of
an equal-key class gets the same rank.

Layouts follow the JAX package: blocks (B, N) uint8, ns / ms (B,)
int32, ISA (B, N) int32.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from lbzip2_tpu_torch import _build
from lbzip2_tpu_torch.device import record_event, resolve, to_host, upload
from lbzip2_tpu_torch.ops import lookback

_INF = 2 ** 31 - 1
_BIG = 1 << 30
MAX_N = 1 << 23  # the kernels' mapped keys, below 2N, fit three 8-bit digits
# a pass's size bins (csrc/bwt2_sort.cu kSmall, kBinCap0..2): classes of
# 2 to SEG_SMALL lanes are ranked a thread a lane, the rest up to the
# last block capacity a block a class, larger ones by radix passes
SEG_SMALL = 32
SEG_BLOCKS = (256, 1024, 4096)

launches = 0       # seeds and passes that launched the CUDA kernels
pass_launches = 0  # of those, the passes (_pass8, and the loop's on the card)
pass4_launches = 0  # _pass4's launches (counted apart from the two above)
emit_launches = 0   # emit_bytes' launch pairs (_emit_bytes, _emit2)
token_launches = 0  # emit_tokens calls (_emit2): a scan and its tail each
_held = threading.local()  # a thread's kernel scratch, per device


def _iota(B, N, dev):
    return torch.arange(N, dtype=torch.int32, device=dev)[None].expand(B, N)


def _pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32 keys -> one int64 key with the same lexicographic
    order: signed hi in the top word, lo shifted to unsigned below."""
    return (hi.long() << 32) + (lo.long() + 2 ** 31)


def _lex_sort(keys: list[torch.Tensor]):
    """Stable lexicographic sort of rows by int32 ``keys`` (first key
    most significant; an even count).  Returns (sorted packed key
    pairs, permutation int64)."""
    packed = [_pack(keys[i], keys[i + 1]) for i in range(0, len(keys), 2)]
    perm = None
    for p in reversed(packed):
        k = p if perm is None else torch.gather(p, 1, perm)
        _, idx = torch.sort(k, dim=1, stable=True)
        perm = idx if perm is None else torch.gather(perm, 1, idx)
    return [torch.gather(p, 1, perm) for p in packed], perm


def _starts(sorted_keys: list[torch.Tensor]) -> torch.Tensor:
    """Class-start flags along lanes for sorted key rows."""
    s = None
    for a in sorted_keys:
        d = torch.ones_like(a, dtype=torch.bool)
        d[:, 1:] = a[:, 1:] != a[:, :-1]
        s = d if s is None else (s | d)
    return s


def _rank_from_sorted(starts, lane):
    """Rank = SA slot of the first member of each equal-key class."""
    return torch.cummax(torch.where(starts, lane, 0), dim=1).values


def _unresolved(starts, spos, nB):
    """Per-row count of valid positions in classes of size >= 2."""
    run_end = torch.ones_like(starts)
    run_end[:, :-1] = starts[:, 1:]
    singleton = starts & run_end
    return ((~singleton) & (spos < nB)).sum(1, dtype=torch.int32)


def _invert(newr, spos, nB):
    """ISA[pos] = rank for valid sorted lanes (spos < n per row); pad
    lanes take the ranks of the invalid sorted lanes in order."""
    key = torch.where(spos < nB, spos, _INF)
    _, idx = torch.sort(key, dim=1, stable=True)
    return torch.gather(newr, 1, idx)


def _ranks(sorted_keys, perm, nB):
    B, N = perm.shape
    idxB = _iota(B, N, perm.device)
    spos = perm.int()
    st = _starts(sorted_keys)
    newr = _rank_from_sorted(st, idxB)
    cnt = _unresolved(st, spos, nB)
    return _invert(newr, spos, nB), cnt


def _seed16_plain(blocks: torch.Tensor, ns: torch.Tensor):
    """Initial ISA from the 16-byte suffix prefix (k = 16 afterwards).

    blocks: (B, N) uint8 Lyndon conjugates; ns: (B,) int32.  Returns
    (ISA (B, N) int32, cnt (B,) int32 unresolved counts).  Pad bytes
    beyond a row's end read as 0 (lbzip2_tpu/ops/bwt2.py:81)."""
    B, N = blocks.shape
    dev = blocks.device
    idxB = _iota(B, N, dev)
    nB = ns[:, None]
    bp = torch.where(idxB < nB, blocks.long(), 0)
    ext = torch.cat([bp, torch.zeros((B, 16), dtype=torch.long,
                                     device=dev)], dim=1)

    def key(q):  # bytes 4q..4q+3 big-endian, sign bit flipped
        k = torch.zeros((B, N), dtype=torch.long, device=dev)
        for j in range(4):
            k = (k << 8) | ext[:, 4 * q + j:4 * q + j + N]
        return (k - 2 ** 31).int()

    k0 = torch.where(idxB < nB, key(0), _INF)
    sk, perm = _lex_sort([k0, key(1), key(2), key(3)])
    return _ranks(sk, perm, nB)


def _extend(ISA, idxB, nB, N):
    """ISA with end sentinels in-row and a sentinel tail (width 2N)."""
    body = torch.where(idxB < nB, ISA, nB - idxB - _BIG)
    tail = nB - (idxB + N) - _BIG
    return torch.cat([body, tail], dim=1)


def _passx_plain(ISA: torch.Tensor, k: int, ns: torch.Tensor, nkeys: int):
    """One doubling pass: sort by ranks at offsets 0, k, .., (nkeys-1)k
    (the JAX ``_passx``, lbzip2_tpu/ops/bwt2.py:125; nkeys even).

    Reads at offset j*k use JAX's dynamic_slice semantics: the start is
    clamped to N, so past the window the tail sentinels at i + N are
    read, and for j >= 2 lanes with i + j*k >= 2N are then patched with
    the true sentinel (lbzip2_tpu/ops/bwt2.py:138-148).  Returns (ISA',
    cnt)."""
    B, N = ISA.shape
    idxB = _iota(B, N, ISA.device)
    nB = ns[:, None]
    ext = _extend(ISA, idxB, nB, N)
    rs = [torch.where(idxB < nB, ISA, _INF)]  # pads sort last
    for j in range(1, nkeys):
        off = min(j * k, N)
        r = ext[:, off:off + N]
        if j >= 2:
            far = idxB.long() + j * k
            r = torch.where(far < 2 * N, r,
                            (nB.long() - far - _BIG).int())
        rs.append(r)
    sk, perm = _lex_sort(rs)
    return _ranks(sk, perm, nB)


def _pass8_plain(ISA: torch.Tensor, k: int, ns: torch.Tensor):
    """``_passx_plain`` with 8 keys, the width the main path runs."""
    return _passx_plain(ISA, k, ns, 8)


def _pass4_plain(ISA: torch.Tensor, k: int, ns: torch.Tensor):
    """``_passx_plain`` with 4 keys (lbzip2_tpu/ops/bwt2.py:158)."""
    return _passx_plain(ISA, k, ns, 4)


def _by_bins(sizes: torch.Tensor, last: str) -> dict:
    """{"tied_lanes": .., bin name: [lanes, groups], ..} of group sizes by
    the kernels' size bins, the groups above the last block bin under
    ``last``."""
    sizes = sizes[sizes >= 2]
    edges = (2, SEG_SMALL + 1, *(c + 1 for c in SEG_BLOCKS), None)
    names = (f"small_2_{SEG_SMALL}",
             *(f"block_{lo}_{c}" for lo, c in zip(edges[1:], SEG_BLOCKS)),
             f"{last}_{SEG_BLOCKS[-1] + 1}_up")
    out = {"tied_lanes": int(sizes.sum())}
    for name, lo, hi in zip(names, edges, edges[1:]):
        inside = sizes[(sizes >= lo) & ((sizes < hi) if hi else True)]
        out[name] = [int(inside.sum()), int(inside.numel())]
    return out


def class_bins(ISA: torch.Tensor, ns: torch.Tensor) -> dict:
    """The classes of equal ISA values among the lanes < n that a pass
    over ``ISA`` sorts, by the kernels' size bins, summed over the rows:
    {"tied_lanes": .., bin name: [lanes, classes], ..}.  Plain PyTorch,
    on ISA's device."""
    B, N = ISA.shape
    valid = _iota(B, N, ISA.device) < ns[:, None]
    row = torch.arange(B, device=ISA.device)[:, None] * N
    sizes = torch.bincount((row + ISA.long())[valid], minlength=B * N)
    return _by_bins(sizes, "radix")


def seed_run_bins(blocks: torch.Tensor, ns: torch.Tensor) -> dict:
    """The runs of equal first words W0 (bytes p .. p + 3, 0 at or past
    n) among the lanes < n that the seed's first round leaves, by the
    kernels' size bins, summed over the rows (those above the last block
    bin go to the seed's later rounds).  Plain PyTorch, on the blocks'
    device."""
    B, N = blocks.shape
    idx = _iota(B, N, blocks.device)
    nB = ns[:, None]
    bp = torch.where(idx < nB, blocks.long(), 0)
    ext = torch.cat([bp, torch.zeros((B, 3), dtype=torch.long,
                                     device=blocks.device)], dim=1)
    w0 = torch.zeros((B, N), dtype=torch.long, device=blocks.device)
    for j in range(4):
        w0 = (w0 << 8) | ext[:, j:j + N]
    row = torch.arange(B, device=blocks.device)[:, None] << 32
    _, sizes = torch.unique((row | w0)[idx < nB], return_counts=True)
    return _by_bins(sizes, "rounds")


def _lib():
    lib = _build.load("bwt2_sort")
    if lib.lbz2t_bwt2_seed.argtypes is None:
        lib.lbz2t_bwt2_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.lbz2t_bwt2_scratch_bytes.restype = ctypes.c_longlong
        lib.lbz2t_bwt2_seed.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lbz2t_bwt2_pass.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 2 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.lbz2t_bwt2_seed.restype = lib.lbz2t_bwt2_pass.restype = \
            ctypes.c_int
    return lib


def _workspace(dev: torch.device, nbytes: int, nzeros: int):
    """The calling thread's kernel scratch on ``dev``: ``nbytes`` of
    scratch (two suffix arrays, digit counts, carries and a byte a lane,
    the pass's S, F, compacted lanes, 32 bytes of keys a lane and the
    class lists, and the seed's large-run tables; the seed carves its
    words and runs from the pass's parts: 1.54 GB at (32, 901120)) and
    ``nzeros``
    int32 class counts (115 MB), which are 0 and which every pass leaves
    0.  Both are kept from call to call and only ever grown, so a call
    allocates nothing.  No call waits for its kernels: work queued on it on one
    stream is ordered before the next call's on the same stream, and a
    call on another stream first makes that stream wait for the last
    one's work."""
    mine = _held.__dict__.setdefault("buffers", {})  # device -> dict
    stream = torch.cuda.current_stream(dev)
    held = mine.get(dev)
    if held is not None and held["stream"] != stream:
        stream.wait_stream(held["stream"])
        for buf in (held["scratch"], held["counts"]):
            buf.record_stream(stream)
        held["stream"] = stream
    if held is None:
        held = mine[dev] = {"stream": stream, "scratch": None,
                            "counts": None}
    if held["scratch"] is None or held["scratch"].numel() < nbytes:
        held["scratch"] = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if held["counts"] is None or held["counts"].numel() < nzeros:
        held["counts"] = torch.zeros(nzeros, dtype=torch.int32, device=dev)
    return held["scratch"], held["counts"]


def _checked(src: torch.Tensor, ns: torch.Tensor, dtype):
    """Raise unless ``src`` (B, N) of ``dtype`` and ns (B,) lie on one
    CUDA device and the kernels take them; then the built library (it
    raises without nvcc, before anything is queued)."""
    dev = src.device
    if dev.type != "cuda" or ns.device != dev:
        raise ValueError(f"the bwt2 kernels need src and ns on one CUDA "
                         f"device, got {src.device} and {ns.device}")
    if src.dtype != dtype:
        raise TypeError(f"src must be {dtype}, got {src.dtype}")
    if src.dim() != 2 or ns.shape != (src.shape[0],):
        raise ValueError(f"bad shapes {tuple(src.shape)} / "
                         f"{tuple(ns.shape)}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if src.shape[1] >= MAX_N:
        raise ValueError(f"rows of {src.shape[1]} lanes: the kernels take "
                         f"fewer than {MAX_N}")
    return _lib()


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"bwt2 {name} kernels' launch failed: "
                           f"cudaError {err}")


# the pass's key mappings (csrc/bwt2_sort.cu kSuffix, kCyclic, kTieBreak)
SUFFIX, CYCLIC, TIE_BREAK = 0, 1, 2


def seed_into(lib, blocks: torch.Tensor, ns: torch.Tensor, cyclic: bool):
    """Queue the seed kernels on the current stream of the blocks'
    device (checked by the caller; nothing counted): (ISA (B, N) int32, 0
    at lanes >= n; cnt (B,) int32).  ``cyclic`` picks the rotation sort's
    seed (ops/bwt.py) over bwt2's."""
    B, N = blocks.shape
    dev = blocks.device
    with torch.cuda.device(dev):  # the C side launches on it
        isa = torch.empty((B, N), dtype=torch.int32, device=dev)
        cnt = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0 or N == 0:
            return isa.zero_(), cnt.zero_()
        ns = ns.to(torch.int32).contiguous()
        scratch, _ = _workspace(dev, lib.lbz2t_bwt2_scratch_bytes(B, N),
                                B * N)
        _raise_on("seed", lib.lbz2t_bwt2_seed(
            blocks.data_ptr(), ns.data_ptr(), isa.data_ptr(), cnt.data_ptr(),
            scratch.data_ptr(), B, N, int(cyclic),
            torch.cuda.current_stream(dev).cuda_stream))
    return isa, cnt


def pass_into(lib, isa: torch.Tensor, k: int, ns: torch.Tensor,
              prev: torch.Tensor | None, cnt: torch.Tensor,
              passes: torch.Tensor | None, nkeys: int = 8,
              mapping: int = SUFFIX) -> None:
    """Queue one segmented pass on the card, in place on ``isa``
    (checked by the caller; nothing counted): cnt (B,) gets the
    unresolved counts; a row whose ``prev`` count is 0 is skipped (the
    identity, exactly: its ISA is resolved); ``passes`` (B,) counts the
    rows' passes that were not.  ``nkeys`` and ``mapping`` pick the keys
    (``lbz2t_bwt2_pass``: 8 or 4 keys by SUFFIX, 8 by CYCLIC, 4 by
    TIE_BREAK)."""
    B, N = isa.shape
    if B == 0 or N == 0:
        cnt.zero_()
        return
    dev = isa.device
    with torch.cuda.device(dev):
        ns = ns.to(torch.int32).contiguous()
        scratch, counts = _workspace(
            dev, lib.lbz2t_bwt2_scratch_bytes(B, N), B * N)
        _raise_on("pass", lib.lbz2t_bwt2_pass(
            isa.data_ptr(), ns.data_ptr(),
            None if prev is None else prev.data_ptr(), cnt.data_ptr(),
            None if passes is None else passes.data_ptr(),
            counts.data_ptr(), scratch.data_ptr(), B, N, int(k), int(nkeys),
            int(mapping), torch.cuda.current_stream(dev).cuda_stream))


def _seed16(blocks: torch.Tensor, ns: torch.Tensor):
    """Initial ISA from the 16-byte suffix prefix (k = 16 afterwards):
    (ISA (B, N) int32, cnt (B,) int32).  The kernels of
    ``csrc/bwt2_sort.cu`` for a CUDA tensor (ISA 0 at lanes >= n; they
    run round 0's block bins on a second stream of the calling thread,
    joined back into the current one before the call returns), the
    plain version for a CPU tensor."""
    global launches
    if blocks.device.type == "cpu":
        return _seed16_plain(blocks, ns)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    lib = _checked(blocks, ns, torch.uint8)
    out = seed_into(lib, blocks, ns, cyclic=False)
    launches += 1
    return out


def _pass_in_place(lib, isa: torch.Tensor, k: int, ns: torch.Tensor,
                   prev: torch.Tensor | None, cnt: torch.Tensor,
                   passes: torch.Tensor | None) -> None:
    """One 8-key segmented pass on the card, in place on ``isa``
    (``pass_into``), counted."""
    global launches, pass_launches
    pass_into(lib, isa, k, ns, prev, cnt, passes)
    launches += 1
    pass_launches += 1


def _pass_copy(ISA: torch.Tensor, k: int, ns: torch.Tensor, nkeys: int,
               mapping: int):
    """One pass of the kernels on a copy of ``ISA``, checked: (ISA',
    cnt)."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    lib = _checked(ISA, ns, torch.int32)
    with torch.cuda.device(ISA.device):
        out = ISA.clone()
        cnt = torch.empty(ISA.shape[0], dtype=torch.int32,
                          device=ISA.device)
        pass_into(lib, out, k, ns, None, cnt, None, nkeys, mapping)
    return out, cnt


def _passx(ISA: torch.Tensor, k: int, ns: torch.Tensor, nkeys: int):
    """One doubling pass by ranks at offsets 0, k, .., (nkeys-1)k, nkeys
    4 or 8 (lbzip2_tpu/ops/bwt2.py:125): (ISA', cnt).  The segmented
    kernels of ``csrc/bwt2_sort.cu`` (their key count a template
    parameter) for a CUDA tensor, on a copy of ``ISA`` (ISA values in
    [0, N) at lanes < n, as every ISA of the loop holds; ISA' is defined
    on the lanes < n, the others keep the input's values), the plain
    version for a CPU tensor."""
    global launches, pass_launches, pass4_launches
    if nkeys not in (4, 8):
        raise ValueError(f"nkeys must be 4 or 8, got {nkeys}")
    if ISA.device.type == "cpu":
        return _passx_plain(ISA, k, ns, nkeys)
    if ISA.device.type != "cuda":
        raise ValueError(f"unsupported device {ISA.device}")
    out = _pass_copy(ISA, k, ns, nkeys, SUFFIX)
    if nkeys == 8:
        launches += 1
        pass_launches += 1
    else:
        pass4_launches += 1
    return out


def _pass4(ISA: torch.Tensor, k: int, ns: torch.Tensor):
    """``_passx`` with 4 keys, at offsets 0, k, 2k and 3k
    (lbzip2_tpu/ops/bwt2.py:158)."""
    return _passx(ISA, k, ns, 4)


def _pass8(ISA: torch.Tensor, k: int, ns: torch.Tensor):
    """``_passx`` with 8 keys, the width the main path runs."""
    return _passx(ISA, k, ns, 8)


def _emit_bytes_plain(blocks: torch.Tensor, ISA: torch.Tensor,
                      ns: torch.Tensor, ms: torch.Tensor):
    """The plain version of ``_emit_bytes``, JAX's formulation: a stable
    sort of the lanes by their ISA (lanes >= n last) with the previous
    byte as payload.  Defined on any ISA; lanes >= n hold pad bytes in
    no particular order (JAX sorts them unstably)."""
    B, N = blocks.shape
    idxB = _iota(B, N, blocks.device)
    nB = ns[:, None]
    last = torch.gather(blocks, 1, (nB - 1).clamp(min=0).long())
    prev = torch.cat([last, blocks[:, :N - 1]], dim=1)
    key = torch.where(idxB < nB, ISA, _INF)
    _, idx = torch.sort(key, dim=1, stable=True)
    sbwt = torch.gather(prev, 1, idx)
    i0 = torch.where(ms[:, None] == 0, 0, nB - ms[:, None])
    primary = torch.gather(ISA, 1, i0.long())[:, 0]
    return sbwt, primary


def _emit_lib():
    lib = _build.load("bwt2_emit")
    if lib.lbz2t_emit_bytes.argtypes is None:
        lib.lbz2t_emit_buckets.argtypes = [ctypes.c_int]
        lib.lbz2t_emit_buckets.restype = ctypes.c_int
        lib.lbz2t_emit_bytes.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.lbz2t_emit_tokens_desc_ints.argtypes = [ctypes.c_int] * 2
        lib.lbz2t_emit_tokens_desc_ints.restype = ctypes.c_longlong
        lib.lbz2t_emit_tokens_state_ints.argtypes = []
        lib.lbz2t_emit_tokens_state_ints.restype = ctypes.c_longlong
        lib.lbz2t_emit_tokens.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lbz2t_emit_bytes.restype = lib.lbz2t_emit_tokens.restype = \
            ctypes.c_int
    return lib


def _emit_checked(blocks, ISA, ns, ms):
    """Raise unless the emit kernels take these tensors; then the built
    library (it raises without nvcc, before anything is queued)."""
    dev = blocks.device
    if dev.type != "cuda" or any(a.device != dev for a in (ISA, ns, ms)):
        raise ValueError("the emit kernels need blocks, ISA, ns and ms on "
                         "one CUDA device")
    if blocks.dtype != torch.uint8 or any(
            a.dtype != torch.int32 for a in (ISA, ns, ms)):
        raise TypeError("blocks must be uint8, ISA, ns and ms int32")
    B = blocks.shape[0]
    if blocks.dim() != 2 or ISA.shape != blocks.shape or \
            ns.shape != (B,) or ms.shape != (B,):
        raise ValueError(f"bad shapes {tuple(blocks.shape)} / "
                         f"{tuple(ISA.shape)} / {tuple(ns.shape)} / "
                         f"{tuple(ms.shape)}")
    if not all(a.is_contiguous() for a in (blocks, ISA, ns, ms)):
        raise ValueError("the emit kernels' inputs must be contiguous")
    if blocks.shape[1] > MAX_N:
        raise ValueError(f"rows of {blocks.shape[1]} lanes: the emit "
                         f"kernels take at most {MAX_N}")
    return _emit_lib()


def _emit_bytes_cuda(lib, blocks, ISA, ns, ms):
    """Launch ``emit_bin`` and ``emit_place`` on the current stream
    (nothing read on the host): (bwt (B, N) uint8, primary (B,) int32).
    Their scratch: the (B, N) uint32 bucket entries, carved from the
    calling thread's held sort scratch (``_workspace``: the suffix
    sort's kernels queued before on this stream are done with it by the
    time the emit runs; a call allocates no 4 bytes a lane), and the
    (row, bucket) cursors, zeroed."""
    global emit_launches
    B, N = blocks.shape
    dev = blocks.device
    with torch.cuda.device(dev):  # the C side launches on it
        out = torch.empty((B, N), dtype=torch.uint8, device=dev)
        primary = torch.zeros(B, dtype=torch.int32, device=dev)
        if B == 0 or N == 0:
            return out, primary
        entries, _ = _workspace(dev, 4 * B * N, 0)
        cursors = torch.zeros((B, lib.lbz2t_emit_buckets(N)),
                              dtype=torch.int32, device=dev)
        err = lib.lbz2t_emit_bytes(
            blocks.data_ptr(), ISA.data_ptr(), ns.data_ptr(), ms.data_ptr(),
            out.data_ptr(), primary.data_ptr(), entries.data_ptr(),
            cursors.data_ptr(), B, N,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bwt2 emit_bytes launch failed: cudaError "
                               f"{err}")
    emit_launches += 1
    return out, primary


def _emit_bytes(blocks: torch.Tensor, ISA: torch.Tensor, ns: torch.Tensor,
                ms: torch.Tensor):
    """BWT rows and primary index: (bwt (B, N) uint8, primary (B,)
    int32).  The previous byte of position 0 is the row's last byte;
    primary = ISA[(n - m) mod n].  Chain mode keeps the rows on the
    device.

    For a CUDA tensor the two launches of ``emit_bytes`` in
    ``csrc/bwt2_emit.cu``: its precondition is that the ISA is a
    permutation of [0, n) on the lanes < n, as every ISA the resolve
    loop hands over is (it comes after at least one pass); then the
    emit is the scatter bwt[ISA[p]] = prev[p], lanes >= n are 0, done
    by bucketing the lanes by destination (``emit_bin``) and writing
    each bucket's bytes from shared memory (``emit_place``).  For a
    CPU tensor the plain version (``_emit_bytes_plain``)."""
    if blocks.device.type == "cpu":
        return _emit_bytes_plain(blocks, ISA, ns, ms)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    lib = _emit_checked(blocks, ISA, ns, ms)
    return _emit_bytes_cuda(lib, blocks, ISA, ns, ms)


def _tokens_plain(sbwt: torch.Tensor, ns: torch.Tensor):
    """The plain version of the token kernels: (tokens (B, N//8) int32,
    run_counts (B,) int32) of the BWT rows ``sbwt`` (B, N) uint8, by a
    cummax for each lane's run start and a stable sort that compacts the
    token starts to the front of the row."""
    B, N = sbwt.shape
    idxB = _iota(B, N, sbwt.device)
    nB = ns[:, None]
    valid = idxB < nB
    change = torch.ones_like(valid)
    change[:, 1:] = sbwt[:, 1:] != sbwt[:, :-1]
    start = valid & change
    runstart = torch.cummax(torch.where(start, idxB, 0), dim=1).values
    start = start | (valid & ((idxB - runstart) % 255 == 0) &
                     (idxB != runstart))
    run_counts = start.sum(1, dtype=torch.int32)
    spos, order = torch.sort(torch.where(start, idxB, _INF), dim=1,
                             stable=True)
    sbyte = torch.gather(sbwt, 1, order)
    nxt = torch.cat([spos[:, 1:], torch.full_like(spos[:, :1], _INF)],
                    dim=1)
    length = torch.where(nxt >= _INF, nB - spos, nxt - spos)
    length = length.clamp(0, 255).to(torch.uint8)  # dead lanes -> 0
    TOK = N // 4  # token capacity: mean run >= 4 fits
    tok = torch.stack([length[:, :TOK], sbyte[:, :TOK]], dim=2)
    return tok.reshape(B, 2 * TOK).view(torch.int32), run_counts


def _tokens_cuda(lib, sbwt: torch.Tensor, ns: torch.Tensor):
    """Launch ``emit_tokens`` on the current stream, the scan and its
    write-only tail (nothing read on the host): (tokens (B, N//8) int32,
    run_counts (B,) int32) of the rows ``sbwt`` (B, N) uint8, N a
    multiple of 8; tokens past the count are 0.  The tile descriptors and
    the ticket are the calling thread's (``ops/lookback.py``)."""
    global token_launches
    B, N = sbwt.shape
    if N % 8:
        raise ValueError(f"rows of {N} lanes: the token kernels take a "
                         f"multiple of 8")
    dev = sbwt.device
    with torch.cuda.device(dev):  # the C side launches on it
        tokens = torch.empty((B, N // 8), dtype=torch.int32, device=dev)
        if B == 0 or N == 0:
            return tokens, torch.zeros(B, dtype=torch.int32, device=dev)
        counts = torch.empty(B, dtype=torch.int32, device=dev)
        desc, state, epoch = lookback.scratch(
            "emit_tokens", dev, lib.lbz2t_emit_tokens_desc_ints(B, N),
            lib.lbz2t_emit_tokens_state_ints())
        err = lib.lbz2t_emit_tokens(
            sbwt.data_ptr(), ns.data_ptr(), tokens.data_ptr(),
            counts.data_ptr(), desc.data_ptr(), state.data_ptr(), B, N,
            N // 4, epoch, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bwt2 emit_tokens launch failed: "
                               f"cudaError {err}")
    token_launches += 1
    return tokens, counts


def _emit2_plain(blocks: torch.Tensor, ISA: torch.Tensor, ns: torch.Tensor,
                 ms: torch.Tensor):
    """The plain version of ``_emit2``: ``_emit_bytes_plain``, then
    ``_tokens_plain``."""
    sbwt, primary = _emit_bytes_plain(blocks, ISA, ns, ms)
    tokens, run_counts = _tokens_plain(sbwt, ns)
    return tokens, sbwt.contiguous().view(torch.int32), run_counts, primary


def _emit2(blocks: torch.Tensor, ISA: torch.Tensor, ns: torch.Tensor,
           ms: torch.Tensor):
    """Token-mode output (lbzip2_tpu/ops/bwt2.py::_emit2): (tokens
    (B, N//8) int32, raw (B, N//4) int32, run_counts (B,) int32,
    primary (B,) int32).

    A token is the u16 ``byte << 8 | len`` of one run, runs split so
    none exceeds 255 (a split every 255 bytes from the run's start);
    two tokens pair little-endian into an int32 word, N//4 tokens per
    row at most.  raw holds the BWT bytes four to a little-endian word.
    Tokens past ``run_counts`` and raw bytes past n are unspecified, as
    in JAX (the kernels write 0 there).

    For a CUDA tensor the kernels of ``csrc/bwt2_emit.cu``:
    ``emit_bytes`` (same precondition as ``_emit_bytes``), then
    ``emit_tokens`` on the bytes it wrote (rows of a multiple of 8
    lanes).  For a CPU tensor the plain version (``_emit2_plain``)."""
    if blocks.device.type == "cpu":
        return _emit2_plain(blocks, ISA, ns, ms)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    lib = _emit_checked(blocks, ISA, ns, ms)
    sbwt, primary = _emit_bytes_cuda(lib, blocks, ISA, ns, ms)
    tokens, run_counts = _tokens_cuda(lib, sbwt, ns)
    return tokens, sbwt.view(torch.int32), run_counts, primary


def loop_passes(N: int) -> int:
    """Passes after which every primitive row of width N is resolved:
    the least P >= 1 with 16 * 8**P >= N (6 at 901120, 3 at 8192).
    Then every suffix's key spans more than the row, and suffixes of
    one row differ in length."""
    P = 1
    while 16 * 8 ** P < N:
        P += 1
    return P


def last_passes() -> torch.Tensor | None:
    """(B,) int32, on the blocks' device: the passes of each row of the
    calling thread's last ``_resolve_loop`` that were not skipped (the
    first, then one for each earlier pass that left the row a tie).  A
    CUDA tensor is read only behind the batch's event."""
    return getattr(_held, "passes", None)


def _resolve_loop(blocks, ns):
    """seed16, then x8 passes while any row has unresolved ties, at
    least one.

    On the card the loop is queued whole and reads nothing: the seed,
    then ``loop_passes(N)`` passes in place on one ISA; a pass skips
    each row that the pass before it left with no tie, on the card, so
    a row's work stops where JAX's while loop would stop it
    (lbzip2_tpu/ops/bwt2.py:247).  On the CPU the loop reads its count
    a pass (k = 16, 128, ...).  ``last_passes`` gives the passes each
    row ran.

    The first pass is not skipped when the seed leaves no tie, as JAX
    skips it: the pads' 16-byte key in the seed is FF FF FF FF then
    zeros, so a suffix that starts FF FF FF FF and is larger sorts after
    all N - n pads and keeps a rank n - 1 .. N - 1 past them.  Its order
    stays right, but the primary index read from it does not.  A pass
    sorts the pads after every valid lane and gives each lane its slot
    among the valid ones."""
    B, N = blocks.shape
    ISA, cnt = _seed16(blocks, ns)
    if blocks.device.type == "cuda":
        lib = _lib()
        with torch.cuda.device(blocks.device):
            passes = torch.zeros(B, dtype=torch.int32, device=blocks.device)
            prev, spare = None, torch.empty_like(cnt)
            k = 16
            for _ in range(loop_passes(N)):
                _pass_in_place(lib, ISA, k, ns, prev, spare, passes)
                prev, spare = spare, (cnt if prev is None else prev)
                k *= 8
    else:
        ISA, cnt = _pass8(ISA, 16, ns)
        passes = torch.ones(B, dtype=torch.int32)
        k = 128
        while int(cnt.max()) > 0:
            passes += (cnt > 0).int()
            ISA, cnt = _pass8(ISA, k, ns)
            k *= 8
    _held.passes = passes
    return ISA


def bwt2_bytes(blocks: torch.Tensor, ns: torch.Tensor, ms: torch.Tensor):
    """Batched BWT leaving rows on the device (chain mode).

    blocks (B, N) uint8, ns (B,) int32, ms (B,) int32 -> (bwt (B, N)
    uint8, primary (B,) int32)."""
    ISA = _resolve_loop(blocks, ns)
    return _emit_bytes(blocks, ISA, ns, ms)


def bwt2_tokens(blocks: torch.Tensor, ns: torch.Tensor, ms: torch.Tensor):
    """Batched BWT emitting run tokens (token mode): blocks (B, N)
    uint8, ns (B,) int32, ms (B,) int32 -> (tokens, raw, run_counts,
    primary) as ``_emit2`` returns them, on the blocks' device."""
    ISA = _resolve_loop(blocks, ns)
    return _emit2(blocks, ISA, ns, ms)


def bwt2_full(blocks: torch.Tensor, ns: torch.Tensor, ms: torch.Tensor):
    """Batched BWT returning (raw (B, N//4) int32 packed rows, primary
    (B,) int32): the rows four bytes to a little-endian word."""
    bwt, primary = bwt2_bytes(blocks, ns, ms)
    return bwt.contiguous().view(torch.int32), primary


class Bwt2Task:
    """Resumable BWT of one (B, N) batch of Lyndon conjugates on
    ``device`` (lbzip2_tpu/ops/bwt2.py::Bwt2Task).

    Drive with ready() / step() round-robin across tasks, then take
    result() (rows downloaded, emit="tokens") or result_device()
    (bytes left on the device, emit="bytes").  The seed and the first
    pass are dispatched when the task is made (see ``_resolve_loop``),
    then each step dispatches one ``_pass8``.  Up to ``_AHEAD`` passes
    run ahead of the unresolved counts the host has read: a pass over an
    ISA that a pass resolved is the identity, so one pass too many is
    harmless and the count's trip to the host overlaps the next pass.

    blocks_np: pre-rotated rows; ns: true lengths; ms: rotation offsets
    (from native.lyndon_prep).  Rows must be primitive (m >= 0).
    """

    _AHEAD = 2

    def __init__(self, blocks_np, ns, ms, emit: str = "tokens",
                 device: str | torch.device = "cuda"):
        if emit not in ("tokens", "bytes"):
            raise ValueError(f"emit must be 'tokens' or 'bytes', got "
                             f"{emit!r}")
        self.dev = resolve(device)
        self.N = np.asarray(blocks_np).shape[1]
        self.ns_np = np.asarray(ns, np.int32)
        self.blocks = upload(np.asarray(blocks_np, np.uint8), self.dev)
        self.ns = upload(self.ns_np, self.dev)
        self.ms = upload(np.asarray(ms, np.int32), self.dev)
        # the first pass always runs (see _resolve_loop)
        self.ISA, cnt = _pass8(_seed16(self.blocks, self.ns)[0], 16,
                               self.ns)
        self.pending = [self._count(cnt)]  # unread counts, oldest first
        self.k = 128
        self.emit = emit
        self.out = None
        self.out_ev = None
        self.done = False

    def _count(self, cnt):
        """(max unresolved count on its way to the host, event behind
        the copy)."""
        return to_host(cnt.max()), record_event(self.dev)

    @staticmethod
    def _is_ready(ev) -> bool:
        return ev is None or ev.query()

    @staticmethod
    def _read(pending) -> int:
        m, ev = pending
        if ev is not None:
            ev.synchronize()
        return int(m)

    def ready(self) -> bool:
        if self.out is not None:
            return self._is_ready(self.out_ev)
        if self.pending and self._is_ready(self.pending[0][1]):
            return True
        # room to dispatch another speculative pass?
        return len(self.pending) < self._AHEAD and self.k <= 8 * self.N

    def _emit(self):
        self.pending.clear()
        if self.emit == "bytes":
            self.out = _emit_bytes(self.blocks, self.ISA, self.ns, self.ms)
        else:
            tokens, raw, counts, primary = _emit2(self.blocks, self.ISA,
                                                  self.ns, self.ms)
            # raw is fetched only for rows over the token capacity
            self.out = (to_host(tokens), raw, to_host(counts),
                        to_host(primary))
        self.out_ev = record_event(self.dev)

    def step(self) -> bool:
        """Advance one step; True once the output is dispatched."""
        if self.done:
            return True
        if self.out is not None:
            self.done = True
            return True
        # consume any landed counts (oldest first)
        while self.pending and self._is_ready(self.pending[0][1]):
            if self._read(self.pending.pop(0)) == 0:
                # resolved; later speculative passes were identities
                self._emit()
                return False
        if len(self.pending) < self._AHEAD and self.k <= 8 * self.N:
            self.ISA, cnt = _pass8(self.ISA, self.k, self.ns)
            self.pending.append(self._count(cnt))
            self.k *= 8
        elif not self.pending:
            self._emit()  # k exceeded every possible tie distance
        elif self._read(self.pending.pop(0)) == 0:
            self._emit()  # ahead limit reached: waited on the oldest
        return False

    def result_device(self):
        """(bwt (B, N) uint8, primary (B,) int32) on the device
        (emit="bytes"); nothing is downloaded."""
        if self.emit != "bytes":
            raise ValueError("result_device needs emit='bytes'")
        while not self.done:
            self.step()
        return self.out

    def result(self):
        """(rows, primary): rows is a list of per-row uint8 BWT arrays
        (emit="tokens").  Rows come from the run tokens when every row
        fits the token capacity, else from the raw packed rows."""
        if self.emit != "tokens":
            raise ValueError("result needs emit='tokens'")
        while not self.done:
            self.step()
        if self.out_ev is not None:
            self.out_ev.synchronize()
        tokens, raw, run_counts, primary = self.out
        counts = run_counts.numpy()
        cap = tokens.shape[1] * 2
        rows = []
        if int(counts.max()) <= cap:
            tok = tokens.numpy().view(np.uint16)
            for b in range(counts.shape[0]):
                t = tok[b, :counts[b]]
                rows.append(np.repeat((t >> 8).astype(np.uint8),
                                      t & 0xFF)[:self.ns_np[b]])
        else:
            rb = raw.cpu().numpy().view(np.uint8)
            for b in range(counts.shape[0]):
                rows.append(rb[b, :self.ns_np[b]])
        return rows, primary.numpy()


# the JAX module's jitted names (lbzip2_tpu/ops/bwt2.py:240-244)
seed16 = _seed16
pass4 = _pass4
pass8 = _pass8
emit2 = _emit2
emit_bytes = _emit_bytes


def bwt2_batch(blocks_np, ns, ms, device: str | torch.device = "cuda"):
    """Synchronous BWT of a batch on ``device``: (bwt (B, N) uint8,
    primary (B,) int32) as numpy arrays."""
    rows, primary = Bwt2Task(blocks_np, ns, ms, device=device).result()
    out = np.zeros((len(rows), np.asarray(blocks_np).shape[1]), np.uint8)
    for b, r in enumerate(rows):
        out[b, :r.size] = r
    return out, primary
