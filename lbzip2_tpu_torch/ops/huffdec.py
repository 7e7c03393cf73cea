"""Device Huffman decode of one block: all 50-symbol groups at once.

Counterpart of lbzip2_tpu/ops/huffdec.py.  The host walks the block's
code lengths to find every group's start bit
(``native.retrieve_boundaries``); the device then decodes all groups in
parallel, the host checks that each group's end cursor meets the next
group's start and runs IMTF + RLE2 (``native.imtf_rle2``).

``decode_groups`` runs the hand-written kernels ``csrc/huffdec.cu`` (a
table of each tree's 10-bit prefixes, built once a call; then one thread
per group through a bit buffer, one table lookup a symbol) for a CUDA
tensor, and the plain PyTorch version for a CPU tensor.  Words are u32
bit patterns held in int32 tensors; every other input holds small
non-negative values in int32.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from lbzip2_tpu_torch import _build, native
from lbzip2_tpu_torch.core.constants import Error
from lbzip2_tpu_torch.device import to_host
from lbzip2_tpu_torch.interop import M32

GROUP_SIZE = 50
MAX_CODE_LENGTH = 20
NTREES, NBASE, NPERM = 6, 22, 258  # table shapes of retrieve_boundaries
LUT_BITS = 10  # prefix bits a table entry of the kernel keys on

launches = 0  # decode_groups calls that launched the CUDA kernels


def decode_groups_plain(words: torch.Tensor, group_start: torch.Tensor,
                        group_tree: torch.Tensor, base: torch.Tensor,
                        count: torch.Tensor, perm: torch.Tensor):
    """The JAX ``decode_groups`` (lbzip2_tpu/ops/huffdec.py:32-76) lane
    for lane: 50 steps over all groups, u32 words as int64 masked to 32
    bits.  Returns (syms (G, 50) int32, end (G,) int32)."""
    dev = words.device
    w64 = words.long() & M32
    W = w64.shape[0]
    t = group_tree.long()
    base_g = (base.long() & M32)[t]                 # (G, 22)
    count_g = count.long()[t]                        # (G, 22)
    perm_flat = perm.long().reshape(-1)
    p = group_start.long()
    syms = torch.empty((p.shape[0], GROUP_SIZE), dtype=torch.int32,
                       device=dev)
    for step in range(GROUP_SIZE):
        w = p >> 5
        o = p & 31
        w0 = w64[w.clamp(0, W - 1)]
        w1 = w64[(w + 1).clamp(max=W - 1).clamp(min=0)]
        v = torch.where(o == 0, w0,
                        ((w0 << o) | (w1 >> (32 - o))) & M32) >> 12
        k = 1 + (v[:, None] >= base_g[:, 2:]).sum(1)  # code length 1..20
        off = count_g.gather(1, k[:, None])[:, 0]
        b = base_g.gather(1, k[:, None])[:, 0]
        # JAX promotes u32 >> int32 to int32: the difference wraps to a
        # signed value and shifts arithmetically (garbage lanes only)
        d = (v - b) & M32
        slot = off + ((d - ((d >> 31) << 32)) >> (MAX_CODE_LENGTH - k))
        syms[:, step] = perm_flat[t * NPERM + slot.clamp(0, NPERM - 1)].int()
        p = p + k
    return syms, p.int()


def _lib():
    fn = _build.load("huffdec").lbz2t_huffdec
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_groups_cuda(words, group_start, group_tree, base, count, perm):
    """Launch the CUDA kernels on the current stream (no synchronize):
    the prefix tables, then the decode; one launch counted."""
    global launches
    args = (words, group_start, group_tree, base, count, perm)
    dev = words.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("decode_groups_cuda needs every input on one "
                         "CUDA device")
    if any(a.dtype != torch.int32 or not a.is_contiguous() for a in args):
        raise TypeError("decode_groups_cuda inputs must be contiguous "
                        "int32")
    G, W, nt = group_start.shape[0], words.shape[0], base.shape[0]
    if words.dim() != 1 or W == 0 or group_tree.shape != (G,) or \
            not 1 <= nt <= NTREES or base.shape != (nt, NBASE) or \
            count.shape != (nt, NBASE) or perm.shape != (nt, NPERM):
        raise ValueError("bad decode_groups shapes")
    with torch.cuda.device(dev):  # the C side launches on it
        syms = torch.empty((G, GROUP_SIZE), dtype=torch.int32, device=dev)
        end = torch.empty(G, dtype=torch.int32, device=dev)
        if G == 0:
            return syms, end
        lut = torch.empty(nt << LUT_BITS, dtype=torch.int16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(words.data_ptr(), group_start.data_ptr(),
                     group_tree.data_ptr(), base.data_ptr(),
                     count.data_ptr(), perm.data_ptr(), lut.data_ptr(),
                     syms.data_ptr(), end.data_ptr(), G, W, nt, stream)
        if err != 0:
            raise RuntimeError(f"huffdec kernel launch failed: cudaError "
                               f"{err}")
    launches += 1
    return syms, end


def decode_groups(words, group_start, group_tree, base, count, perm):
    """Decode 50 symbols per group: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.

    words (W,) int32 (u32 bits of the big-endian word window);
    group_start (G,) bit offsets into it; group_tree (G,); base, count
    (nt, 22); perm (nt, 258); all int32.  Returns (syms (G, 50) int32
    internal symbol values, end (G,) int32 cursor after each group's
    50th symbol); symbols past a group's EOB are garbage, as in JAX."""
    if words.device.type == "cuda":
        return decode_groups_cuda(words, group_start, group_tree, base,
                                  count, perm)
    if words.device.type == "cpu":
        return decode_groups_plain(words, group_start, group_tree, base,
                                   count, perm)
    raise ValueError(f"unsupported device {words.device}")


def group_inputs(arr: np.ndarray, nbits: int, payload_pos: int):
    """Host half of the block decode: the boundary walk
    (``native.retrieve_boundaries``) and the inputs of ``decode_groups``
    as numpy int32 arrays over the block's own word window (cursors stay
    int32 for streams of any size, and the upload is bounded by the
    block's payload, as in JAX).  Returns (err, end_pos, meta, inputs);
    meta and inputs are None when err != 0."""
    err, end_pos, meta = native.retrieve_boundaries(arr, nbits,
                                                    payload_pos)
    if err != 0:
        return err, payload_pos, None, None
    ng = meta["ngroups"]
    starts_abs = meta["group_start"].astype(np.int64)
    base_word = int(starts_abs[0] // 32)
    end_word = (max(int(end_pos), int(starts_abs[ng - 1])) + 31) // 32
    lo, hi = 4 * base_word, min(4 * (end_word + 1), arr.size)
    win = arr[lo:hi]
    if win.size % 4:
        win = np.concatenate([win, np.zeros(4 - win.size % 4, np.uint8)])
    inputs = (win.view(">u4").astype(np.uint32).view(np.int32),
              (starts_abs - 32 * base_word).astype(np.int32),
              meta["group_tree"].astype(np.int32),
              meta["base"].view(np.int32), meta["count"],
              meta["perm"].astype(np.int32))
    return 0, end_pos, meta, inputs


def pack_inputs(inputs, out: np.ndarray) -> list[tuple[int, ...]]:
    """Copy the six int32 inputs of ``decode_groups`` end to end into
    ``out`` (int32, at least their total size): one upload.  Returns
    their shapes, for ``unpack_inputs``."""
    pos = 0
    for a in inputs:
        out[pos:pos + a.size] = a.reshape(-1)
        pos += a.size
    return [a.shape for a in inputs]


def unpack_inputs(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Views of ``flat`` (1-D) in the shapes ``pack_inputs`` returned."""
    sizes = [int(np.prod(sh)) for sh in shapes]
    parts = torch.split(flat[:sum(sizes)], sizes)
    return [p.view(sh) for p, sh in zip(parts, shapes)]


_local = threading.local()  # each decode thread's stream and staging


def _staging(device: torch.device, n: int):
    """This thread's CUDA stream on ``device`` and its pinned int32
    upload buffer of at least ``n`` words (kept across blocks: a block
    waits for its stream before the next one refills the buffer)."""
    st = getattr(_local, "state", None)
    if st is None or st[0] != device:
        st = _local.state = [device, torch.cuda.Stream(device),
                             torch.empty(0, dtype=torch.int32,
                                         pin_memory=True)]
    if st[2].numel() < n:
        st[2] = torch.empty(max(n, 2 * st[2].numel()), dtype=torch.int32,
                            pin_memory=True)
    return st[1], st[2]


def decode_block_device(arr: np.ndarray, nbits: int, payload_pos: int,
                        device: torch.device, stage=None):
    """One block with its Huffman stage on ``device`` (a resolved
    torch.device); the counterpart of lbzip2_tpu/ops/huffdec.py:79-130.

    Host boundary walk -> device group decode -> reconcile cursors ->
    host IMTF + RLE2.  Returns (err, end_pos, bwt, idx, rand) like
    ``native.retrieve_block``.  On CUDA the six inputs go up as one
    pinned buffer, on a stream of the calling thread's own (made once),
    and the thread waits on that stream's event only, so concurrent
    workers do not serialise on a device-wide synchronize.  ``stage``,
    if given (a tracer's ``add``), is called with (name, start, end) by
    ``time.perf_counter_ns()`` for the boundary walk ("decode.walk"), the
    device stage from upload to download ("decode.huffman") and IMTF +
    RLE2 with the reconcile ("decode.imtf_rle2")."""
    t0 = time.perf_counter_ns() if stage else 0
    err, end_pos, meta, inputs = group_inputs(arr, nbits, payload_pos)
    if stage:
        t1 = time.perf_counter_ns()
        stage("decode.walk", t0, t1)
    if err != 0:
        return err, payload_pos, None, 0, 0
    if device.type == "cuda":
        total = sum(a.size for a in inputs)
        stream, pinned = _staging(device, total)
        shapes = pack_inputs(inputs, pinned.numpy())
        with torch.cuda.stream(stream):
            flat = pinned[:total].to(device, non_blocking=True)
            syms, end = decode_groups(*unpack_inputs(flat, shapes))
            syms, end = to_host(syms), to_host(end)
            done = torch.cuda.Event(blocking=True)
            done.record(stream)
        done.synchronize()
    else:
        syms, end = decode_groups(*(torch.from_numpy(np.require(
            a, requirements="CW")) for a in inputs))
    syms, end = syms.numpy(), end.numpy()
    if stage:
        t2 = time.perf_counter_ns()
        stage("decode.huffman", t1, t2)
    try:
        # reconcile: the cursor after group g must hit group g+1's start
        # (the last group ends at EOB mid-group; the host walk bounds it)
        ng, starts = meta["ngroups"], inputs[1]
        if ng > 1 and not np.array_equal(end[:ng - 1], starts[1:ng]):
            return Error.ERR_PREFIX.value, payload_pos, None, 0, 0
        flat_syms = syms[:ng].reshape(-1)[:meta["nsyms"]].astype(np.uint16)
        try:
            bwt = native.imtf_rle2(flat_syms, meta["used"])
        except ValueError:
            return Error.ERR_OVERFLOW.value, payload_pos, None, 0, 0
    finally:
        if stage:
            stage("decode.imtf_rle2", t2, time.perf_counter_ns())
    if meta["idx"] >= bwt.size:
        return Error.ERR_BWTIDX.value, payload_pos, None, 0, 0
    return 0, end_pos, bwt, meta["idx"], meta["rand"]
