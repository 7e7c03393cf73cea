"""Batched BWT by rotation sort (the v1 sort).

Counterpart of lbzip2_tpu/ops/bwt.py.  It sorts the *rotations* of each
block as it stands, with no host rotation to a Lyndon word: ranks at
``(i + k) mod n``, and equal rotations (a fully periodic block) ordered
by descending start, as ``ref/bwt.py`` and ``native/sais.c`` order them.
Any correct rotation sort gives the same BWT rows; the primary index is
the rank of rotation 0.

On a CUDA tensor every entry (``bwt_masked``, ``bwt_batched``,
``bwt_batched_uniform``, ``SparseBwtTask`` and ``bwt_batched_sparse``)
runs the cyclic mode of the kernels of ``csrc/bwt2_sort.cu``:

- the seed (``_seed_cyclic``): the 16-byte cyclic prefix of each
  rotation, words at ``(p + 4q + d) mod n``; ranks and counts equal to
  JAX's ``_seed_sparse`` (a valid lane of sixteen FF bytes ties with the
  pads' key there and counts as unresolved when the row has pads);
- ``loop_passes(N)`` 8-key passes (``_pass_cyclic``), key j the ISA at
  ``(p + j k) mod n``, k = 16, 128, .., queued on the card with a row
  skipped once resolved; the prefix then spans every row, so the ties
  left are equal rotations;
- one tie-break pass (``_tie_break``), the identity on a row with no
  tie: a class of equal rotations by descending start;
- the emit of ``ops/bwt2.py::_emit_bytes`` with no rotation (m = 0):
  bwt[ISA[p]] = row[p - 1 mod n], primary ISA[0].

On a CPU tensor each entry runs its plain twin, which follows JAX step
by step: ``_doubling_pass`` for ``bwt_masked`` and ``bwt_batched``,
``_seed_sparse``, ``_sparse_level`` and ``_emit_sparse_plain`` for the
sparse task, ``_shift_cyclic`` for ``bwt_batched_uniform``.  JAX's full
doubling and uniform kernels read their 4-byte seed keys with one
subtraction of n, which for n = 2 reads a byte past the row; on rows
that are zero past n (as every caller gives them) that byte changes no
result, and the kernels' true cyclic keys give JAX's rows and primaries.

Layouts follow the JAX package: blocks (B, N) uint8, ns (B,) int32,
ISA (B, N) int32, rows n >= 1.
"""

from __future__ import annotations

import numpy as np
import torch

from lbzip2_tpu_torch.device import record_event, resolve, to_host, upload
from lbzip2_tpu_torch.ops import bwt2

_INF = 2 ** 30
_INT32_MAX = 2 ** 31 - 1
_SEED_KEYS = 4  # 16-byte seed prefix (k starts at 16)
_MIN_CAP = 2048

seed_launches = 0  # the cyclic seed's launches
pass_launches = 0  # the cyclic passes' (the loop's and _pass_cyclic's)
tie_launches = 0   # the tie-break passes'
emit_launches = 0  # emits through ops/bwt2.py::_emit_bytes' kernels


# ---- plain twins: JAX's formulation, step by step ---------------------------

def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.long())


def _dense_rank(k1: torch.Tensor, k2: torch.Tensor):
    """Dense ranks along lanes of (k1, k2) int32 rows."""
    _, si = torch.sort((k1.long() << 32) + (k2.long() + 2 ** 31), dim=-1,
                       stable=True)
    sk1, sk2 = _gather(k1, si), _gather(k2, si)
    neq = torch.zeros_like(k1)
    neq[..., 1:] = ((sk1[..., 1:] != sk1[..., :-1]) |
                    (sk2[..., 1:] != sk2[..., :-1])).int()
    return torch.zeros_like(k1).scatter_(
        -1, si, torch.cumsum(neq, -1, dtype=torch.int32))


def _doubling_pass(rank: torch.Tensor, k, n, idx: torch.Tensor):
    """One rank-doubling round (lbzip2_tpu/ops/bwt.py:26): sort by
    (rank_i, rank_{i+k mod n}), dense ranks.  rank (..., N) int32; k and
    n scalars or (B, 1) columns; idx (N,) lane indices."""
    valid = idx < n
    j = torch.where(valid, idx + k, 0)
    j = torch.where(j >= n, j - n, j)
    return _dense_rank(torch.where(valid, rank, _INF), torch.where(
        valid, _gather(rank, j.expand_as(rank)), _INF))


def _seed_key0(blocks: torch.Tensor, n: torch.Tensor, idx: torch.Tensor,
               shift):
    """The 4-byte seed key of bwt_masked / bwt_batched_uniform, biased to
    int32 order, INT32_MAX at the lanes >= n.  ``shift(b0, d)`` reads
    the byte at lane + d as JAX's kernel does (one subtraction of n)."""
    b0 = blocks.long()
    ku = (b0 << 24) + (shift(b0, 1) << 16) + (shift(b0, 2) << 8) + \
        shift(b0, 3)
    key0 = (ku - 2 ** 31).int()
    return torch.where(idx < n, key0, _INT32_MAX)


def _tie_and_emit(blocks: torch.Tensor, rank: torch.Tensor, nB: torch.Tensor,
                  idx: torch.Tensor):
    """JAX's last steps (lbzip2_tpu/ops/bwt.py:90-104): ties by
    descending start, then out[final_rank[p]] = block[p - 1 mod n],
    zeros past n, primary final_rank[0]."""
    B, N = blocks.shape
    valid = idx < nB
    k1 = torch.where(valid, rank, _INF)
    _, si = torch.sort((k1.long() << 32) + (N - 1 - idx).long(), dim=-1,
                       stable=True)
    final = torch.zeros_like(rank).scatter_(
        -1, si, idx.expand(B, N).int().contiguous())
    prev = torch.where(idx == 0, nB - 1, idx - 1)
    prev_b = _gather(blocks, prev.expand(B, N).clamp(min=0))
    out = torch.zeros((B, N + 1), dtype=torch.uint8, device=blocks.device)
    out.scatter_(1, torch.where(valid, final, N).long(),
                 torch.where(valid, prev_b, 0).to(torch.uint8))
    return out[:, :N].contiguous(), final[:, 0].contiguous()


def _bwt_rows_plain(blocks: torch.Tensor, ns: torch.Tensor):
    """The plain twin of ``bwt_batched``: JAX's ``bwt_masked`` on each
    row as ``jax.vmap`` runs it (the doubling loop over the batch, a row
    changed only while its own loop condition holds).  Returns (out
    (B, N) uint8, primary (B,) int32)."""
    B, N = blocks.shape
    dev = blocks.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    nB = ns.to(torch.int32)[:, None]
    valid = idx < nB

    def cyc(b0, d):
        j = idx + d
        j = torch.where(j >= nB, j - nB, j)
        return _gather(b0, j.clamp(max=N - 1))

    key0 = _seed_key0(blocks, nB, idx, cyc)
    rank = _dense_rank(key0, torch.zeros_like(key0))

    def done_rows(rank):
        return torch.where(valid, rank, -1).max(1).values == nB[:, 0] - 1

    k = torch.full((B, 1), 4, dtype=torch.int32, device=dev)
    done = done_rows(rank)
    while True:
        live = (k[:, 0] < nB[:, 0]) & ~done
        if not bool(live.any()):
            break
        new = _doubling_pass(rank, k, nB, idx)
        rank = torch.where(live[:, None], new, rank)
        done = torch.where(live, done_rows(rank), done)
        k = torch.where(live[:, None], k * 2, k)
    return _tie_and_emit(blocks, rank, nB, idx)


def _shift_cyclic(rank: torch.Tensor, k: int, n: int):
    """rank[:, (i + k) mod n] for i < n (lbzip2_tpu/ops/bwt.py:402): two
    copies of the rows at 0 and n in a 2N buffer, then the N lanes from
    k (JAX's dynamic_slice clamps the start to N)."""
    B, N = rank.shape
    buf = torch.zeros((B, 2 * N), dtype=rank.dtype, device=rank.device)
    buf[:, :N] = rank
    n = min(max(int(n), 0), N)
    buf[:, n:n + N] = rank
    k = min(max(int(k), 0), N)
    return buf[:, k:k + N]


def _bwt_uniform_plain(blocks: torch.Tensor, n: int):
    """The plain twin of ``bwt_batched_uniform``: JAX's formulation with
    gather-free cyclic shifts.  Returns (out (B, N) uint8, primary (B,)
    int32)."""
    B, N = blocks.shape
    dev = blocks.device
    n = int(n)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    valid = (idx < n)[None]
    key0 = _seed_key0(blocks, n, idx,
                      lambda b0, d: _shift_cyclic(b0, d, n))
    rank = _dense_rank(key0, torch.zeros_like(key0))

    def done_all(rank):
        return int(torch.where(valid, rank, -1).max(1).values.min()) == n - 1

    k, done = 4, done_all(rank)
    while k < n and not done:
        k2 = torch.where(valid, _shift_cyclic(rank, k, n), _INF)
        k1 = torch.where(valid, rank, _INF)
        rank = _dense_rank(k1, k2)
        done = done_all(rank)
        k *= 2
    nB = torch.full((B, 1), n, dtype=torch.int32, device=dev)
    return _tie_and_emit(blocks, rank, nB, idx)


def _seed_sparse(blocks: torch.Tensor, ns: torch.Tensor):
    """Initial ranks from the 16-byte cyclic prefix
    (lbzip2_tpu/ops/bwt.py:157): (ISA (B, N) int32, r1, wpos (B, N) the
    unresolved lanes compacted in sorted order (INF / N at dead lanes),
    cnt (B,) int32).  A rank is the SA slot of the first member of its
    class; the classes are formed over the four words alone, so a valid
    lane of sixteen FF bytes shares the pads' class."""
    B, N = blocks.shape
    dev = blocks.device
    idxB = torch.arange(N, dtype=torch.int32, device=dev)[None].expand(B, N)
    nB = ns.to(torch.int32)[:, None]
    valid = idxB < nB
    b0 = blocks.long()

    def key(q):
        def sh(d):
            jv = idxB + d
            jv = torch.where(jv >= nB, jv - nB, jv)
            jv = torch.where(jv >= nB, jv % nB.clamp(min=1), jv)
            return _gather(b0, torch.where(valid, jv, 0))
        ku = (sh(4 * q) << 24) + (sh(4 * q + 1) << 16) + \
            (sh(4 * q + 2) << 8) + sh(4 * q + 3)
        return torch.where(valid, (ku - 2 ** 31).int(), _INT32_MAX)

    keys = [key(q) for q in range(_SEED_KEYS)]
    # the lane index is the last key: pads sort after the valid lanes of
    # the all-FF class
    sk, perm = bwt2._lex_sort(keys + [idxB, torch.zeros_like(idxB)])
    spos = perm.int()
    neq = bwt2._starts(sk[:2])
    rank_sorted = bwt2._rank_from_sorted(neq, idxB)
    ISA = torch.full((B, N), N, dtype=torch.int32, device=dev)
    ISA.scatter_(1, perm, rank_sorted)
    run_end = torch.ones_like(neq)
    run_end[:, :-1] = neq[:, 1:]
    keep = ~(neq & run_end) & (spos < nB)
    cnt = keep.sum(1, dtype=torch.int32)
    r1, wpos = _compact(keep, rank_sorted, spos, N)
    return ISA, r1, wpos, cnt


def _compact(keep, r, w, N):
    """The kept lanes to the front in their order (INF / N behind)."""
    _, order = torch.sort((~keep).int(), dim=1, stable=True)
    ck = _gather((~keep).int(), order)
    r1 = torch.where(ck == 0, _gather(r, order), _INF)
    wpos = torch.where(ck == 0, _gather(w, order), N)
    return r1, wpos


def _sparse_level(ISA, r1, wpos, k: int, cnt, ns, *, tie_break: bool):
    """Doubling rounds at one capacity C = r1.shape[1]
    (lbzip2_tpu/ops/bwt.py:218): until every tie resolves, the count
    fits in C // 2, or k >= max(ns); with ``tie_break`` one pass by
    descending start.  Returns (ISA, r1, wpos, k, cnt)."""
    B, N = ISA.shape
    C = r1.shape[1]
    dev = ISA.device
    laneC = torch.arange(C, dtype=torch.int32, device=dev)[None].expand(B, C)
    nB = ns.to(torch.int32)[:, None]
    maxn = int(ns.max())

    def one_pass(ISA, r1, wpos, k, cnt):
        dead = wpos >= nB
        if tie_break:
            r2 = torch.where(dead, laneC - _INF, nB - 1 - wpos)
        else:
            j = (wpos.long() + k) % nB.clamp(min=1)
            r2 = _gather(ISA, torch.where(dead, 0, j))
            r2 = torch.where(dead, laneC - _INF, r2)
        _, order = torch.sort((r1.long() << 32) + (r2.long() + 2 ** 31),
                              dim=1, stable=True)
        sr1, sr2, sw = (_gather(a, order) for a in (r1, r2, wpos))
        g = torch.ones_like(sr1, dtype=torch.bool)
        g[:, 1:] = sr1[:, 1:] != sr1[:, :-1]
        s = g.clone()
        s[:, 1:] |= sr2[:, 1:] != sr2[:, :-1]
        grp = torch.cummax(torch.where(g, laneC, 0), dim=1).values
        run = torch.cummax(torch.where(s, laneC, 0), dim=1).values
        newr = sr1 + (run - grp)
        run_end = torch.ones_like(s)
        run_end[:, :-1] = s[:, 1:]
        resolved = s & run_end
        ISA = ISA.clone()
        live = sw < N  # sw = N: a dead lane, dropped
        ISA_ext = torch.cat([ISA, torch.zeros_like(ISA[:, :1])], 1)
        ISA_ext.scatter_(1, torch.where(live, sw, N).long(), newr)
        ISA = ISA_ext[:, :N].contiguous()
        keep = ~resolved & (sw < nB)
        cnt = keep.sum(1, dtype=torch.int32)
        nr1, nw = _compact(keep, newr, sw, N)
        return ISA, nr1, nw, k * 2, cnt

    if tie_break:
        return one_pass(ISA, r1, wpos, k, cnt)
    floor = C <= _MIN_CAP
    while True:
        m = int(cnt.max())
        shrinkable = True if floor else m > C // 2
        if not (shrinkable and k < maxn and m > 0):
            return ISA, r1, wpos, k, cnt
        ISA, r1, wpos, k, cnt = one_pass(ISA, r1, wpos, k, cnt)


def pack_u8_rows(out: torch.Tensor) -> torch.Tensor:
    """(B, N) uint8 -> (B, N // 4) int32, four bytes to a little-endian
    word (lbzip2_tpu/ops/bwt.py:110): a view, no kernel."""
    return out.contiguous().view(torch.int32)


def _emit_sparse_plain(blocks: torch.Tensor, ISA: torch.Tensor, ns):
    """BWT bytes from the final ISA (lbzip2_tpu/ops/bwt.py:289): (packed
    (B, N // 4) int32, primary ISA[:, 0])."""
    B, N = blocks.shape
    idxB = torch.arange(N, dtype=torch.int32,
                        device=blocks.device)[None].expand(B, N)
    nB = ns.to(torch.int32)[:, None]
    valid = idxB < nB
    pidx = torch.where(idxB == 0, nB - 1, idxB - 1)
    prev = _gather(blocks, torch.where(valid, pidx, 0))
    out = torch.zeros((B, N + 1), dtype=torch.uint8, device=blocks.device)
    out.scatter_(1, torch.where(valid, ISA, N).long(),
                 torch.where(valid, prev, 0).to(torch.uint8))
    return pack_u8_rows(out[:, :N]), ISA[:, 0].contiguous()


def _pow2ceil(x: int) -> int:
    c = _MIN_CAP
    while c < x:
        c *= 2
    return c


class _PlainSteps:
    """The sparse task's steps as JAX takes them (lbzip2_tpu/ops/bwt.py:
    344), on the tensors' device: the plain twin of the card's."""

    def __init__(self, blocks: torch.Tensor, ns: torch.Tensor):
        self.blocks, self.ns = blocks, ns
        self.maxn, self.N = int(ns.max()), blocks.shape[1]
        self.ISA, self.r1, self.wpos, self.cnt = _seed_sparse(blocks, ns)
        self.k = 4 * _SEED_KEYS
        self.out = None

    def step(self) -> None:
        m = int(self.cnt.max())
        if m == 0:
            self.out = _emit_sparse_plain(self.blocks, self.ISA, self.ns)
        elif self.k >= self.maxn:
            (self.ISA, self.r1, self.wpos, self.k,
             self.cnt) = _sparse_level(self.ISA, self.r1, self.wpos, self.k,
                                       self.cnt, self.ns, tie_break=True)
        else:
            cap = min(_pow2ceil(m), self.N)
            (self.ISA, self.r1, self.wpos, self.k,
             self.cnt) = _sparse_level(self.ISA, self.r1[:, :cap],
                                       self.wpos[:, :cap], self.k, self.cnt,
                                       self.ns, tie_break=False)


def bwt_sparse_plain(blocks: torch.Tensor, ns: torch.Tensor):
    """The plain twin of the sparse task on the tensors' device: (packed
    (B, N // 4) int32, primary (B,) int32)."""
    run = _PlainSteps(blocks, ns)
    while run.out is None:
        run.step()
    return run.out


# ---- the kernels: the cyclic mode of csrc/bwt2_sort.cu ----------------------

def _seed_cyclic_plain(blocks: torch.Tensor, ns: torch.Tensor):
    """The plain version of ``_seed_cyclic``: ``_seed_sparse``'s (ISA,
    cnt)."""
    ISA, _, _, cnt = _seed_sparse(blocks, ns)
    return ISA, cnt


def _seed_cyclic(blocks: torch.Tensor, ns: torch.Tensor):
    """Ranks by the 16-byte cyclic prefix of each rotation: (ISA (B, N)
    int32, cnt (B,) int32), as ``_seed_sparse`` gives them on the lanes
    < n.  The seed kernels of ``csrc/bwt2_sort.cu`` in their cyclic mode
    for a CUDA tensor (ISA 0 at the lanes >= n), the plain version for
    a CPU one."""
    global seed_launches
    if blocks.device.type == "cpu":
        return _seed_cyclic_plain(blocks, ns)
    lib = bwt2._checked(blocks, ns, torch.uint8)
    out = bwt2.seed_into(lib, blocks, ns, cyclic=True)
    seed_launches += 1
    return out


def _cyclic_keys_plain(ISA, k: int, ns, nkeys: int, tie: bool):
    """The key rows of a pass: key 0 the ISA, key j the ISA at (p + j k)
    mod n (``tie``: key 1 n - 1 - p, the others 0); the lanes >= n INF
    in every key."""
    B, N = ISA.shape
    idxB = torch.arange(N, dtype=torch.int32, device=ISA.device)[None]
    nB = ns.to(torch.int32)[:, None]
    valid = idxB < nB
    keys = [torch.where(valid, ISA, _INT32_MAX)]
    for j in range(1, nkeys):
        if tie:
            r = (nB - 1 - idxB).expand(B, N) if j == 1 else \
                torch.zeros_like(ISA)
        else:
            q = (idxB.long() + j * k) % nB.long().clamp(min=1)
            r = _gather(ISA, torch.where(valid, q, 0))
        keys.append(torch.where(valid, r, _INT32_MAX))
    return keys, nB


def _pass_cyclic_plain(ISA: torch.Tensor, k: int, ns: torch.Tensor,
                       tie: bool = False):
    """The plain version of ``_pass_cyclic`` (``tie``: of ``_tie_break``):
    a stable sort of the lanes by their key rows, each lane the slot of
    the first of its class, the lanes of classes of two or more
    counted."""
    keys, nB = _cyclic_keys_plain(ISA, k, ns, 4 if tie else 8, tie)
    sk, perm = bwt2._lex_sort(keys)
    return bwt2._ranks(sk, perm, nB)


def _pass_cyclic(ISA: torch.Tensor, k: int, ns: torch.Tensor):
    """One doubling pass of the rotation sort: ranks by 8 keys, the ISA
    at (p + j k) mod n for j = 0 .. 7 (the prefix grows from k to 8k):
    (ISA', cnt).  The segmented kernels in their cyclic mode for a CUDA
    tensor, on a copy of ``ISA`` (ranks in [0, n) at the lanes < n, the
    first slot of each class), the plain version for a CPU one."""
    global pass_launches
    if ISA.device.type == "cpu":
        return _pass_cyclic_plain(ISA, k, ns)
    out = bwt2._pass_copy(ISA, k, ns, 8, bwt2.CYCLIC)
    pass_launches += 1
    return out


def _tie_break(ISA: torch.Tensor, ns: torch.Tensor):
    """Each class of the ISA ordered by descending start (the last step
    of JAX's loops, lbzip2_tpu/ops/bwt.py:90-95 and :235-236): (ISA',
    cnt), cnt 0.  The segmented kernels' tie-break mapping for a CUDA
    tensor, on a copy of ``ISA``; the plain version for a CPU one."""
    global tie_launches
    if ISA.device.type == "cpu":
        return _pass_cyclic_plain(ISA, 1, ns, tie=True)
    out = bwt2._pass_copy(ISA, 1, ns, 4, bwt2.TIE_BREAK)
    tie_launches += 1
    return out


def _cyclic_loop(blocks: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """The final ISA of the rotation sort, a permutation of [0, n) on the
    lanes < n of each row.

    On the card the loop is queued whole and reads nothing there: the
    seed, ``bwt2.loop_passes(N)`` passes in place on one ISA, a row
    skipped once a pass (or the seed) left it no tie, then the tie-break
    pass under the same rule.  After them every rotation's key spans its
    row, so a tie left is two equal rotations.  On the CPU the plain
    versions, the count read a pass."""
    global seed_launches, pass_launches, tie_launches
    B, N = blocks.shape
    if blocks.device.type == "cpu":
        ISA, cnt = _seed_cyclic_plain(blocks, ns)
        k = 16
        for _ in range(bwt2.loop_passes(N)):
            if int(cnt.max()) == 0:
                return ISA
            ISA, cnt = _pass_cyclic_plain(ISA, k, ns)
            k *= 8
        return _pass_cyclic_plain(ISA, 1, ns, tie=True)[0] \
            if int(cnt.max()) else ISA
    lib = bwt2._checked(blocks, ns, torch.uint8)
    ISA, prev = bwt2.seed_into(lib, blocks, ns, cyclic=True)
    seed_launches += 1
    with torch.cuda.device(blocks.device):
        spare = torch.empty_like(prev)
        k = 16
        for _ in range(bwt2.loop_passes(N)):
            bwt2.pass_into(lib, ISA, k, ns, prev, spare, None, 8,
                           bwt2.CYCLIC)
            prev, spare = spare, prev
            pass_launches += 1
            k *= 8
        bwt2.pass_into(lib, ISA, 1, ns, prev, spare, None, 4,
                       bwt2.TIE_BREAK)
        tie_launches += 1
    return ISA


def _emit_rows(blocks: torch.Tensor, ISA: torch.Tensor, ns: torch.Tensor):
    """(out (B, N) uint8, primary (B,) int32) from the final ISA by the
    emit kernels of ``csrc/bwt2_emit.cu`` with no rotation (ms = 0:
    prev[0] is the row's last byte, primary ISA[0]); they need the ISA a
    permutation of [0, n) on the lanes < n."""
    global emit_launches
    ns = ns.to(torch.int32).contiguous()
    out = bwt2._emit_bytes(blocks, ISA.contiguous(), ns, torch.zeros_like(ns))
    emit_launches += 1
    return out


def _emit_sparse(blocks: torch.Tensor, ISA: torch.Tensor, ns: torch.Tensor):
    """BWT bytes from the final ISA: (packed (B, N // 4) int32, primary
    (B,) int32).  For a CUDA tensor the emit kernels (``_emit_rows``),
    the plain version for a CPU one."""
    if blocks.device.type == "cpu":
        return _emit_sparse_plain(blocks, ISA, ns)
    out, primary = _emit_rows(blocks, ISA, ns)
    return pack_u8_rows(out), primary


def _bwt_rows(blocks: torch.Tensor, ns: torch.Tensor):
    """(out (B, N) uint8, primary (B,) int32) by the kernels."""
    ns = ns.to(torch.int32).contiguous()
    return _emit_rows(blocks, _cyclic_loop(blocks, ns), ns)


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def bwt_masked(block: torch.Tensor, n, max_doublings: int | None = None):
    """BWT of block[:n], block (N,) uint8 padded to N: (out (N,) uint8,
    zeros past n; primary 0-d int32, the rank of rotation 0).  The
    kernels for a CUDA tensor, ``_bwt_rows_plain`` for a CPU one.
    ``max_doublings`` is unused, as in JAX."""
    ns = torch.tensor([int(n)], dtype=torch.int32, device=block.device)
    run = _bwt_rows if _device_of(block) == "cuda" else _bwt_rows_plain
    out, primary = run(block[None].contiguous(), ns)
    return out[0], primary[0]


def bwt_batched(blocks: torch.Tensor, ns: torch.Tensor):
    """BWT of each row of blocks (B, N) uint8 to its length ns (B,):
    (out (B, N) uint8, primary (B,) int32), JAX's ``vmap`` of
    ``bwt_masked``.  The kernels for a CUDA tensor, ``_bwt_rows_plain``
    for a CPU one."""
    if _device_of(blocks) == "cuda":
        return _bwt_rows(blocks.contiguous(), ns)
    return _bwt_rows_plain(blocks, ns)


def bwt_batched_uniform(blocks: torch.Tensor, n):
    """BWT of a (B, N) batch whose rows all have length n: (out (B, N)
    uint8, primary (B,) int32).  The kernels for a CUDA tensor,
    ``_bwt_uniform_plain`` for a CPU one."""
    if _device_of(blocks) == "cuda":
        ns = torch.full((blocks.shape[0],), int(n), dtype=torch.int32,
                        device=blocks.device)
        return _bwt_rows(blocks.contiguous(), ns)
    return _bwt_uniform_plain(blocks, int(n))


class SparseBwtTask:
    """Resumable BWT of one (B, N) batch on ``device``, row lengths ns
    free (lbzip2_tpu/ops/bwt.py:314); drive with ready() / step()
    round-robin across tasks, then take result().

    On a card, in the form of ``ops/bwt2.py::Bwt2Task``: the seed is
    dispatched when the task is made, then each step dispatches one
    cyclic pass (k = 16, 128, ..), up to ``_AHEAD`` ahead of the counts
    the host has read (a pass over a resolved ISA is the identity).  A
    count of 0 ends the loop; once k covers every row, the tie-break
    pass does.  Then the emit, its outputs on their way to the host.  On
    the CPU the steps are JAX's (``_PlainSteps``)."""

    _AHEAD = 2

    def __init__(self, blocks_np, ns, device: str | torch.device = "cuda"):
        blocks_np = np.asarray(blocks_np, np.uint8)
        ns = np.broadcast_to(np.asarray(ns, np.int32),
                             (blocks_np.shape[0],)).copy()
        self.dev = resolve(device)
        self.maxn = int(ns.max())
        self.N = blocks_np.shape[1]
        self.blocks = upload(np.ascontiguousarray(blocks_np), self.dev)
        self.ns = upload(ns, self.dev)
        self.out = None
        self.out_ev = None
        self.done = False
        if self.dev.type == "cpu":
            self.plain = _PlainSteps(self.blocks, self.ns)
            return
        self.plain = None
        self.ISA, cnt = _seed_cyclic(self.blocks, self.ns)
        self.pending = [self._count(cnt)]  # unread counts, oldest first
        self.k = 16

    def _count(self, cnt):
        """(max unresolved count on its way to the host, event behind
        the copy)."""
        return to_host(cnt.max()), record_event(self.dev)

    _is_ready = staticmethod(bwt2.Bwt2Task._is_ready)
    _read = staticmethod(bwt2.Bwt2Task._read)

    def ready(self) -> bool:
        if self.plain is not None:
            return True
        if self.out is not None:
            return self._is_ready(self.out_ev)
        if self.pending and self._is_ready(self.pending[0][1]):
            return True
        return len(self.pending) < self._AHEAD

    def _emit(self, tie: bool = False):
        self.pending.clear()
        if tie:
            self.ISA = _tie_break(self.ISA, self.ns)[0]
        packed, primary = _emit_sparse(self.blocks, self.ISA, self.ns)
        self.out = (to_host(packed), to_host(primary))
        self.out_ev = record_event(self.dev)

    def step(self) -> bool:
        """Advance once; True when the BWT is finished."""
        if self.done:
            return True
        if self.out is not None:
            self.done = True
            return True
        if self.plain is not None:
            self.plain.step()
            self.out = self.plain.out
            return False
        while self.pending and self._is_ready(self.pending[0][1]):
            if self._read(self.pending.pop(0)) == 0:
                self._emit()  # later speculative passes were identities
                return False
        if self.k >= self.maxn:
            # every key spans its row: a tie left is equal rotations
            self._emit(tie=True)
        elif len(self.pending) < self._AHEAD:
            self.ISA, cnt = _pass_cyclic(self.ISA, self.k, self.ns)
            self.pending.append(self._count(cnt))
            self.k *= 8
        elif self._read(self.pending.pop(0)) == 0:
            self._emit()  # ahead limit reached: waited on the oldest
        return False

    def result(self):
        """(bwt_packed int32 (B, N // 4), primary (B,)) as numpy."""
        while not self.done:
            self.step()
        if self.out_ev is not None:
            self.out_ev.synchronize()
        packed, primary = self.out
        return packed.cpu().numpy(), primary.cpu().numpy()


def bwt_batched_sparse(blocks_np, ns, device: str | torch.device = "cuda"):
    """Synchronous ``SparseBwtTask``: (bwt_out (B, N) uint8, primary
    (B,)) as numpy; ns a scalar or per-row lengths."""
    packed, primary = SparseBwtTask(np.asarray(blocks_np), ns,
                                    device=device).result()
    return packed.view(np.uint8).reshape(packed.shape[0], -1), primary
