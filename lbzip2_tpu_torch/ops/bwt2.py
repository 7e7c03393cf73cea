"""Batched BWT by suffix doubling over Lyndon conjugates (chain mode).

Counterpart of the ``bwt2_bytes`` path of lbzip2_tpu/ops/bwt2.py: the
host rotates each block to its least rotation, whose suffix order is
its rotation order, so ranks at ``i + k`` are read from an ISA extended
with position-coded end sentinels ``n - p - 2^30`` (``_extend``).

The multi-key stable sorts become ``torch.sort(stable=True)`` passes
over keys packed two to an int64, ``(signed hi << 32) + unsigned lo``,
taken from the last key pair to the first (LSD order).  Ties between
equal key tuples need no particular order: every lane of an equal-key
class gets the same rank.

Layouts follow the JAX package: blocks (B, N) uint8, ns / ms (B,)
int32, ISA (B, N) int32.
"""

from __future__ import annotations

import torch

_INF = 2 ** 31 - 1
_BIG = 1 << 30


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


def _seed16(blocks: torch.Tensor, ns: torch.Tensor):
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


def _pass8(ISA: torch.Tensor, k: int, ns: torch.Tensor):
    """One doubling pass: sort by ranks at offsets 0, k, .., 7k (the
    JAX ``_passx`` with m = 8, the only width its main path runs).

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
    for j in range(1, 8):
        off = min(j * k, N)
        r = ext[:, off:off + N]
        if j >= 2:
            far = idxB.long() + j * k
            r = torch.where(far < 2 * N, r,
                            (nB.long() - far - _BIG).int())
        rs.append(r)
    sk, perm = _lex_sort(rs)
    return _ranks(sk, perm, nB)


def _emit_bytes(blocks: torch.Tensor, ISA: torch.Tensor, ns: torch.Tensor,
                ms: torch.Tensor):
    """BWT rows and primary index: (bwt (B, N) uint8, primary (B,)
    int32).  The previous byte of position 0 is the row's last byte;
    primary = ISA[(n - m) mod n]."""
    B, N = blocks.shape
    idxB = _iota(B, N, blocks.device)
    nB = ns[:, None]
    last = torch.gather(blocks, 1, (nB - 1).long())
    prev = torch.cat([last, blocks[:, :N - 1]], dim=1)
    key = torch.where(idxB < nB, ISA, _INF)
    _, idx = torch.sort(key, dim=1, stable=True)
    sbwt = torch.gather(prev, 1, idx)
    i0 = torch.where(ms[:, None] == 0, 0, nB - ms[:, None])
    primary = torch.gather(ISA, 1, i0.long())[:, 0]
    return sbwt, primary


def _resolve_loop(blocks, ns):
    """seed16, then x8 passes while any row has unresolved ties.  The
    loop condition is read on the host once per pass (k = 16, 128, ...:
    at most 6 passes at n = 900k)."""
    ISA, cnt = _seed16(blocks, ns)
    k = 16
    while int(cnt.max()) > 0:
        ISA, cnt = _pass8(ISA, k, ns)
        k *= 8
    return ISA


def bwt2_bytes(blocks: torch.Tensor, ns: torch.Tensor, ms: torch.Tensor):
    """Batched BWT leaving rows on the device (chain mode).

    blocks (B, N) uint8, ns (B,) int32, ms (B,) int32 -> (bwt (B, N)
    uint8, primary (B,) int32)."""
    ISA = _resolve_loop(blocks, ns)
    return _emit_bytes(blocks, ISA, ns, ms)
