"""Native host kernels: build at first use + ctypes bindings.

gcc -O3 compiles this package's own lbz2_native.c (which includes the
other C sources beside it) into ``build/lbzip2_tpu_torch/lbz2_native.so``
beside the package, rebuilt when a source is newer; no pip/pybind11
needed.  A compile that fails raises.  With no ``gcc`` at all
``native_available()`` is False and callers take their numpy paths.

Profile-guided build: while ``build/lbzip2_tpu_torch/pgo/`` holds a
profile newer than every source (``tools/gen_pgo.py`` writes it; the
benchmark, bench_torch.py, runs it), the library is built with
``-fprofile-use``; a profile older than a source is skipped with one
message.  Under ``LBZ2_PGO_GEN=<dir>`` the library
is built instrumented into ``<dir>``, writing its profile there.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "lbz2_native.c"
_SO = _DIR.parent.parent / "build" / "lbzip2_tpu_torch" / "lbz2_native.so"
_PGO = _SO.parent / "pgo"

_lib = None
_lock = threading.Lock()
last_build: dict = {}  # command, profile state and stderr of the last gcc


def pgo_inputs(pgo: pathlib.Path = _PGO) -> tuple[float, list[float]]:
    """The newest source's mtime and the mtimes of the profile's files."""
    newest_src = max(p.stat().st_mtime for p in _DIR.glob("*.c"))
    profiles = [p.stat().st_mtime for p in pgo.glob("*.gcda")] \
        if pgo.is_dir() else []
    return newest_src, profiles


def pgo_flags(newest_src: float, profiles: list[float], pgo: pathlib.Path,
              gen: str | None = None) -> tuple[list[str], str]:
    """gcc's profile flags and the profile's state: ``"gen"`` (``gen``,
    the value of LBZ2_PGO_GEN, is set: instrumented, with exact counts
    from the threads that call the library at once), ``"use"`` (every
    profile file at least as new as the newest source), ``"stale"`` (a
    profile file older than a source: no profile) or ``"none"``.  A
    profile that does not match the sources fails the build."""
    if gen:
        return [f"-fprofile-generate={gen}", "-fprofile-update=atomic"], "gen"
    if not profiles:
        return [], "none"
    if min(profiles) < newest_src:
        return [], "stale"
    return [f"-fprofile-use={pgo}", "-Werror=missing-profile"], "use"


def _build(so: pathlib.Path = _SO,
           pgo: pathlib.Path = _PGO) -> pathlib.Path | None:
    """The library at ``so`` (instrumented, in LBZ2_PGO_GEN's directory,
    when that is set), built if a source or a fresh profile in ``pgo``
    is newer than it."""
    gen = os.environ.get("LBZ2_PGO_GEN")
    if gen:
        pgo = pathlib.Path(gen).resolve()
        so = pgo / so.name
    newest_src, profiles = pgo_inputs(pgo)
    flags, state = pgo_flags(newest_src, profiles, pgo,
                             str(pgo) if gen else None)
    if state == "stale":
        print(f"lbzip2_tpu_torch: stale PGO profile in {pgo} ignored "
              "(bench_torch.py makes a fresh one)", file=sys.stderr)
    stamp = max([newest_src] + (profiles if state == "use" else []))
    if so.exists() and so.stat().st_mtime >= stamp:
        return so
    gcc = shutil.which("gcc")
    if gcc is None:
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gcc, "-O3", "-march=native", "-shared", "-fPIC", *flags]
    cwd = None
    if flags:
        # gcc names a profile file after its working directory and the
        # aux name, which comes from -o unless -dumpdir fixes it: the
        # instrumented and the profiled build run in the profile's
        # directory with one -dumpdir, so that the second finds what the
        # first wrote whatever their temporary outputs are called
        pgo.mkdir(parents=True, exist_ok=True)
        cmd += ["-dumpdir", "lbz2-"]
        cwd = pgo
    cmd += [str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd)
    last_build.clear()
    last_build.update(cmd=cmd, state=state, stderr=proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"gcc failed for {_SRC.name}:\n{proc.stderr}")
    # atomic: a concurrent process never loads half a library
    os.replace(tmp, so)
    return so


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _build(_SO, _PGO)
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.lbz2_init()  # one-time CRC table init (thread-safety)
        lib.lbz2_crc32_block.restype = ctypes.c_uint32
        lib.lbz2_crc32_block.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_uint32]
        lib.lbz2_rle1_collect.restype = ctypes.c_long
        lib.lbz2_rle1_collect.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long]
        lib.lbz2_retrieve_block.restype = ctypes.c_long
        lib.lbz2_retrieve_block.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.lbz2_ibwt_emit.restype = ctypes.c_long
        lib.lbz2_ibwt_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p]
        lib.lbz2_encode_payload.restype = ctypes.c_long
        lib.lbz2_encode_payload.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.lbz2_encode_payload_from_mtfv.restype = ctypes.c_long
        lib.lbz2_encode_payload_from_mtfv.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
        lib.lbz2_encode_payload_bytewise.restype = ctypes.c_long
        lib.lbz2_encode_payload_bytewise.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.lbz2_encode_payload_from_tokens.restype = ctypes.c_long
        lib.lbz2_encode_payload_from_tokens.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.lbz2_bwt.restype = ctypes.c_long
        lib.lbz2_bwt.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.lbz2_encode_window.restype = ctypes.c_long
        lib.lbz2_encode_window.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.itb_bwt.restype = ctypes.c_long
        lib.itb_bwt.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32]
        lib.lbz2_bwt_sais_rot.restype = ctypes.c_long
        lib.lbz2_bwt_sais_rot.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long]
        lib.lbz2_ibwt_links.restype = ctypes.c_long
        lib.lbz2_ibwt_links.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
        lib.lbz2_emit_init.restype = None
        lib.lbz2_emit_init.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.lbz2_emit_chunk.restype = ctypes.c_long
        lib.lbz2_emit_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.lbz2_emit_done.restype = ctypes.c_int
        lib.lbz2_emit_done.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.lbz2_lyndon_prep.restype = ctypes.c_long
        lib.lbz2_lyndon_prep.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.lbz2_encode_block.restype = ctypes.c_long
        lib.lbz2_encode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.lbz2_retrieve_boundaries.restype = ctypes.c_long
        lib.lbz2_retrieve_boundaries.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.lbz2_imtf_rle2.restype = ctypes.c_long
        lib.lbz2_imtf_rle2.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.lbz2_scan_magic.restype = ctypes.c_long
        lib.lbz2_scan_magic.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_uint64,
            ctypes.c_void_p]
        lib.lbz2_ibwt_order.restype = ctypes.c_long
        lib.lbz2_ibwt_order.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.lbz2_rle_init.restype = None
        lib.lbz2_rle_init.argtypes = [ctypes.c_void_p]
        lib.lbz2_rle1_expand_chunk.restype = ctypes.c_long
        lib.lbz2_rle1_expand_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_long]
        lib.lbz2_rle_done.restype = ctypes.c_int
        lib.lbz2_rle_done.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.lbz2_ibwt_emit2.restype = ctypes.c_long
        lib.lbz2_ibwt_emit2.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.lbz2_retr_new.restype = ctypes.c_void_p
        lib.lbz2_retr_new.argtypes = []
        lib.lbz2_retr_free.restype = None
        lib.lbz2_retr_free.argtypes = [ctypes.c_void_p]
        lib.lbz2_retr_step.restype = ctypes.c_long
        lib.lbz2_retr_step.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.lbz2_em_mstep.restype = None
        lib.lbz2_em_mstep.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_void_p]
        lib.lbz2_chain_finish.restype = ctypes.c_long
        lib.lbz2_chain_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def crc32_block(data: np.ndarray, crc: int = 0xFFFFFFFF) -> int:
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return int(lib.lbz2_crc32_block(
        data.ctypes.data_as(ctypes.c_void_p), data.size, crc & 0xFFFFFFFF))


class _CollectArena(threading.local):
    """Reusable collect output buffers: a 1 GB stream's fresh 1.26 GB
    output allocation costs seconds of first-touch page faults INSIDE
    the timed pipeline; reuse keeps the pages warm across calls."""

    def ensure(self, out_cap: int, max_blocks: int):
        """Grow each buffer that is too small, on its own; never shrink
        one (the output buffer keeps its warm pages when only the block
        count grows)."""
        if getattr(self, "out_buf", None) is None or \
                self.out_buf.size < out_cap:
            self.out_buf = np.empty(out_cap, np.uint8)
        if getattr(self, "starts", None) is None or \
                self.starts.size < max_blocks:
            self.starts = np.empty(max_blocks, np.int64)
            self.ends = np.empty(max_blocks, np.int64)
            self.out_lens = np.empty(max_blocks, np.int64)
            self.cmaps = np.empty(max_blocks * 256, np.uint8)


_collect_arena = _CollectArena()


def collect_chunks(n: int, granul: int | None, threads: int) -> int:
    """How many runs of whole granule windows ``rle1_collect`` walks at
    once on ``threads`` threads: 1 (one walk on the calling thread)
    unless a granule is given, ``threads`` is above 1 and the input
    spans at least two windows a thread; else up to four a thread, so
    that windows of unequal cost balance over the threads."""
    nwin = -(-n // granul) if granul else 1
    if threads < 2 or nwin < 2 * threads:
        return 1
    return min(nwin, 4 * threads)


def _collect_bounds(n: int, mbs: int, granul: int | None):
    """Upper bounds on the RLE1 output bytes and the block count of a
    collect of ``n`` input bytes."""
    # every granule window yields at least one block, so a granule
    # smaller than the block capacity dominates the block count
    nwin = (n + granul - 1) // granul if granul else 1
    max_blocks = max(4, 2 * (n // mbs + 2) + nwin + 8)
    return (n * 5) // 4 + 16 * max_blocks + 64, max_blocks


def rle1_collect(data: np.ndarray, mbs: int, granul: int | None,
                 reuse_arena: bool = False, threads: int = 1):
    """Returns list of (start, end, block_bytes, cmap_bool).

    reuse_arena=True returns block_bytes as VIEWS into a per-thread
    arena valid until this thread's next reuse_arena collect — the
    hybrid pool's fast path (skips one full-stream copy and the fresh
    page-fault tax); default False returns owning copies.

    No state crosses a granule window, so with ``threads`` above 1 the
    input is cut at window boundaries into ``collect_chunks`` runs of
    windows, each collected into its own region of the buffers on one
    of ``threads`` threads (the caller's among them, the others joined
    before the return): the same blocks, in the same order, as one
    walk."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.size
    chunks = collect_chunks(n, granul, threads)
    nwin = -(-n // granul) if granul else 1
    cuts = [0] + [c * nwin // chunks * granul
                  for c in range(1, chunks)] + [n]
    caps, blks = [0], [0]  # each chunk's region of the output buffers
    for lo, hi in zip(cuts, cuts[1:]):
        cap, mb = _collect_bounds(hi - lo, mbs, granul)
        caps.append(caps[-1] + cap)
        blks.append(blks[-1] + mb)
    if reuse_arena:
        _collect_arena.ensure(caps[-1], blks[-1])
        a = _collect_arena
        out_buf, starts, ends = a.out_buf, a.starts, a.ends
        out_lens, cmaps = a.out_lens, a.cmaps
    else:
        out_buf = np.empty(caps[-1], np.uint8)
        starts = np.empty(blks[-1], np.int64)
        ends = np.empty(blks[-1], np.int64)
        out_lens = np.empty(blks[-1], np.int64)
        cmaps = np.empty(blks[-1] * 256, np.uint8)
    caps[-1], blks[-1] = out_buf.size, starts.size  # the last runs to the end
    g = granul if granul is not None else 0
    counts = [0] * chunks

    def ptr(arr):
        return arr.ctypes.data_as(ctypes.c_void_p)

    def walk(c):
        b0 = blks[c]
        counts[c] = lib.lbz2_rle1_collect(
            ptr(data[cuts[c]:]), cuts[c + 1] - cuts[c], mbs, g,
            ptr(out_buf[caps[c]:]), caps[c + 1] - caps[c],
            ptr(starts[b0:]), ptr(ends[b0:]), ptr(out_lens[b0:]),
            ptr(cmaps[b0 * 256:]), blks[c + 1] - b0)

    todo = iter(range(chunks))  # shared: each chunk is taken once

    def work():
        for c in todo:
            walk(c)

    helpers = [threading.Thread(target=work, name=f"lbz2-collect{k}",
                                daemon=True)
               for k in range(1, min(threads, chunks))]
    for t in helpers:
        t.start()
    try:
        work()
    finally:
        for t in helpers:
            t.join()
    assert min(counts) >= 0, "rle1_collect buffer overflow"
    res = []
    for c in range(chunks):
        pos = caps[c]
        for i in range(blks[c], blks[c] + counts[c]):
            ln = int(out_lens[i])
            blk = out_buf[pos:pos + ln]
            if not reuse_arena:
                blk = blk.copy()
            res.append((int(starts[i]) + cuts[c], int(ends[i]) + cuts[c],
                        blk, cmaps[i * 256:(i + 1) * 256].astype(bool)))
            pos += ln
    return res


class _DecArena(threading.local):
    """Per-thread reusable decode scratch (~9 MB/worker): the
    retrieve output row and the IBWT chase temporaries.  Safe to reuse
    because every consumer either copies (ibwt_emit -> chunks bytes)
    or materializes its own state before returning (EmitCursor builds
    _rle in __init__ and never touches bwt again)."""

    def ensure(self):
        if getattr(self, "ret_out", None) is None:
            self.ret_out = np.empty(900008, np.uint8)
            self.ptr = np.empty(900000, np.int32)
            self.pred = np.empty(900000, np.int32)

    def ensure_enc(self):
        if getattr(self, "mtfv", None) is None:
            self.mtfv = np.empty(900000 + 64, np.uint16)
            self.pay_out = np.empty(900000 + 450000 + 8192, np.uint8)
            self.bwt_out = np.empty(900008, np.uint8)


_dec_arena = _DecArena()


def retrieve_block(data: np.ndarray, nbits: int, bitpos: int):
    """Decode one block payload; returns (err, newpos, bwt, idx, rand).

    The returned bwt is a view into a per-thread arena: valid until
    this thread's next retrieve_block call (every production consumer
    finishes with it before then; copy if retaining)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    _dec_arena.ensure()
    out = _dec_arena.ret_out
    pos = ctypes.c_long(bitpos)
    size = ctypes.c_long(0)
    idx = ctypes.c_long(0)
    rnd = ctypes.c_int(0)
    err = lib.lbz2_retrieve_block(
        data.ctypes.data_as(ctypes.c_void_p), nbits, ctypes.byref(pos),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(size),
        ctypes.byref(idx), ctypes.byref(rnd))
    if err != 0:
        return int(err), bitpos, None, 0, 0
    # read-only view: a consumer that holds this across the thread's
    # next retrieve_block (e.g. future batched speculative decode)
    # would silently read corrupted data; writes fail loudly instead,
    # and anyone retaining it must .copy()
    bwt = out[:size.value]
    bwt.flags.writeable = False
    return 0, int(pos.value), bwt, int(idx.value), int(rnd.value)


def encode_payload(bwt_bytes: np.ndarray, cmap_bool: np.ndarray,
                   bwt_idx: int, crc_stored: int,
                   cluster_factor: int = 8) -> bytes:
    """Entropy-encode one block from its BWT bytes (C MTF+RLE2+EM+pack)."""
    lib = get_lib()
    bwt_bytes = np.ascontiguousarray(bwt_bytes, dtype=np.uint8)
    cmap = np.ascontiguousarray(cmap_bool, dtype=np.uint8)
    _dec_arena.ensure_enc()
    mtfv = _dec_arena.mtfv
    out = _dec_arena.pay_out
    ln = lib.lbz2_encode_payload(
        bwt_bytes.ctypes.data_as(ctypes.c_void_p), bwt_bytes.size,
        cmap.ctypes.data_as(ctypes.c_void_p), bwt_idx,
        crc_stored & 0xFFFFFFFF, cluster_factor,
        mtfv.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    assert ln > 0
    return out[:ln].tobytes()


def encode_payload_bytewise(bwt_bytes: np.ndarray, cmap_bool: np.ndarray,
                            bwt_idx: int, crc_stored: int,
                            cluster_factor: int = 8) -> bytes:
    """Byte-loop MTF variant (differential oracle for the token MTF)."""
    lib = get_lib()
    bwt_bytes = np.ascontiguousarray(bwt_bytes, dtype=np.uint8)
    cmap = np.ascontiguousarray(cmap_bool, dtype=np.uint8)
    mtfv = np.empty(900000 + 50 + 2, np.uint16)
    out = np.empty(len(bwt_bytes) + (len(bwt_bytes) >> 1) + 4096, np.uint8)
    ln = lib.lbz2_encode_payload_bytewise(
        bwt_bytes.ctypes.data_as(ctypes.c_void_p), bwt_bytes.size,
        cmap.ctypes.data_as(ctypes.c_void_p), bwt_idx,
        crc_stored & 0xFFFFFFFF, cluster_factor,
        mtfv.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    assert ln > 0
    return out[:ln].tobytes()


def encode_payload_from_tokens(tokens: np.ndarray, cmap_bool: np.ndarray,
                               bwt_idx: int, crc_stored: int,
                               cluster_factor: int = 8,
                               n_bytes: int | None = None) -> bytes:
    """Entropy-encode one block straight from (byte<<8)|len run tokens
    (the device BWT's download format) — no byte-row expansion."""
    lib = get_lib()
    tokens = np.ascontiguousarray(tokens, dtype=np.uint16)
    cmap = np.ascontiguousarray(cmap_bool, dtype=np.uint8)
    _dec_arena.ensure_enc()
    mtfv = _dec_arena.mtfv
    if n_bytes is None:
        n_bytes = int((tokens & 0xFF).sum())
    out = _dec_arena.pay_out
    ln = lib.lbz2_encode_payload_from_tokens(
        tokens.ctypes.data_as(ctypes.c_void_p), tokens.size,
        cmap.ctypes.data_as(ctypes.c_void_p), bwt_idx,
        crc_stored & 0xFFFFFFFF, cluster_factor,
        mtfv.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    assert ln > 0
    return out[:ln].tobytes()


def encode_payload_from_mtfv(mtfv: np.ndarray, cmap_bool: np.ndarray,
                             bwt_idx: int, crc_stored: int,
                             cluster_factor: int = 8) -> bytes:
    """Entropy-encode from precomputed MTF values (device MTF path)."""
    lib = get_lib()
    nm = mtfv.size
    buf = np.empty(nm + 50 + 2, np.uint16)
    buf[:nm] = mtfv
    cmap = np.ascontiguousarray(cmap_bool, dtype=np.uint8)
    out = np.empty(nm * 2 + 8192, np.uint8)
    ln = lib.lbz2_encode_payload_from_mtfv(
        buf.ctypes.data_as(ctypes.c_void_p), nm,
        cmap.ctypes.data_as(ctypes.c_void_p), bwt_idx,
        crc_stored & 0xFFFFFFFF, cluster_factor,
        out.ctypes.data_as(ctypes.c_void_p))
    assert ln > 0
    return out[:ln].tobytes()


def bwt(block: np.ndarray, scratch: bool = False
        ) -> tuple[np.ndarray, int]:
    """Rotation BWT (two-stage/SA-IS); identical output to the
    prefix-doubling oracle.  scratch=True returns a per-thread arena
    view valid until this thread's next scratch call."""
    lib = get_lib()
    block = np.ascontiguousarray(block, dtype=np.uint8)
    if scratch:
        _dec_arena.ensure_enc()
        out = _dec_arena.bwt_out
    else:
        out = np.empty(block.size, np.uint8)
    idx = lib.lbz2_bwt(block.ctypes.data_as(ctypes.c_void_p), block.size,
                       out.ctypes.data_as(ctypes.c_void_p))
    assert idx >= 0
    return out[:block.size], int(idx)


def itb_bwt_rot(R: np.ndarray, want: int = -1) -> tuple[np.ndarray, int]:
    """Two-stage B*-subset BWT over a least rotation R (differential
    test entry).  Raises where itbwt.c gives up: ValueError on -9 (no B*
    suffix) and -7 (a row of more than 2^23 - 1 bytes: its packed
    entries), MemoryError on -8."""
    lib = get_lib()
    R = np.ascontiguousarray(R, dtype=np.uint8)
    out = np.empty(R.size, np.uint8)
    idx = lib.itb_bwt(R.ctypes.data_as(ctypes.c_void_p), R.size,
                      out.ctypes.data_as(ctypes.c_void_p), want)
    if idx == -9:
        raise ValueError("no B* suffix")
    if idx == -7:
        raise ValueError(f"a row of {R.size} bytes: itb_bwt packs "
                         f"positions in 23 bits")
    if idx == -8:
        raise MemoryError("itb_bwt: out of memory")
    if idx < -1:
        raise ValueError(f"itb_bwt failed: {idx}")
    return out, int(idx)


def bwt_sais_rot(R: np.ndarray, want: int = -1) -> tuple[np.ndarray, int]:
    """SA-IS BWT over a least rotation R (differential oracle)."""
    lib = get_lib()
    R = np.ascontiguousarray(R, dtype=np.uint8)
    out = np.empty(R.size, np.uint8)
    idx = lib.lbz2_bwt_sais_rot(R.ctypes.data_as(ctypes.c_void_p), R.size,
                                out.ctypes.data_as(ctypes.c_void_p), want)
    assert idx >= -1
    return out, int(idx)


class _EmitState(ctypes.Structure):
    _fields_ = [("k", ctypes.c_long), ("cur", ctypes.c_long),
                ("rand_i", ctypes.c_long), ("rand_j", ctypes.c_long),
                ("pending", ctypes.c_long), ("run", ctypes.c_int),
                ("last", ctypes.c_int), ("crc", ctypes.c_uint32)]


class _RleState(ctypes.Structure):
    _fields_ = [("k", ctypes.c_long), ("pending", ctypes.c_long),
                ("run", ctypes.c_int), ("last", ctypes.c_int)]


class EmitCursor:
    """Resumable IBWT+RLE1 emitter over one decoded block.

    Mirrors the reference's suspendable emit (decode.c:944-1144): call
    next_chunk(cap) repeatedly; None signals completion.  crc is valid
    once done.  Raises ValueError on a truncated final run.

    Internals: the decode order is materialized once at construction
    (bidirectional chase — two overlapped pointer chains), then each
    chunk is a linear RLE1 expansion with the slice-by-8 CRC folded
    over the produced bytes."""

    def __init__(self, bwt: np.ndarray, idx: int, rand_flag: int):
        self._lib = get_lib()
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        self._n = bwt.size
        _dec_arena.ensure()
        ptr = _dec_arena.ptr          # scratch only (order build)
        pred = _dec_arena.pred
        self._rle = np.empty(self._n, np.uint8)
        r = self._lib.lbz2_ibwt_order(
            bwt.ctypes.data_as(ctypes.c_void_p), self._n, idx,
            rand_flag, ptr.ctypes.data_as(ctypes.c_void_p),
            pred.ctypes.data_as(ctypes.c_void_p),
            self._rle.ctypes.data_as(ctypes.c_void_p))
        if r < 0:
            raise ValueError("bad BWT index")
        self._st = _RleState()
        self._lib.lbz2_rle_init(ctypes.byref(self._st))
        self._crc = 0xFFFFFFFF
        self.done = False

    def next_chunk(self, cap: int) -> bytes | None:
        if self.done:
            return None
        out = np.empty(cap, np.uint8)
        r = self._lib.lbz2_rle1_expand_chunk(
            self._rle.ctypes.data_as(ctypes.c_void_p), self._n,
            ctypes.byref(self._st),
            out.ctypes.data_as(ctypes.c_void_p), cap)
        if r == -2:
            raise ValueError("missing run length")
        self._crc = int(self._lib.lbz2_crc32_block(
            out.ctypes.data_as(ctypes.c_void_p), r,
            self._crc & 0xFFFFFFFF))
        if self._lib.lbz2_rle_done(ctypes.byref(self._st), self._n):
            self.done = True
        return out[:r].tobytes()

    @property
    def crc(self) -> int:
        return (self._crc ^ 0xFFFFFFFF) & 0xFFFFFFFF


def lyndon_prep(block: np.ndarray, out: np.ndarray | None = None
                ) -> tuple[np.ndarray, int]:
    """Least rotation of `block` + rotation index m, or m = -1 if the
    block is fully periodic (device path must fall back to host bwt)."""
    lib = get_lib()
    block = np.ascontiguousarray(block, dtype=np.uint8)
    if out is None:
        out = np.empty(block.size, np.uint8)
    m = lib.lbz2_lyndon_prep(block.ctypes.data_as(ctypes.c_void_p),
                             block.size,
                             out.ctypes.data_as(ctypes.c_void_p))
    return out, int(m)


class _EncArena(threading.local):
    """Per-thread reusable scratch for encode_window (the analogue of
    the reference's persistent per-worker encoder arena,
    src/encode.c:109-132): ~8 MB/worker at -9, allocated lazily on
    each worker thread's first window and reused for its lifetime."""

    def ensure(self, wn: int, mbs: int):
        need_blk = wn + (wn >> 2) + 64
        if getattr(self, "blk", None) is None or self.blk.size < need_blk \
                or self.R.size < mbs + 16:
            self.blk = np.empty(need_blk, np.uint8)
            self.R = np.empty(mbs + 16, np.uint8)
            self.bwt = np.empty(mbs + 16, np.uint8)
            self.mtfv = np.empty(mbs + 64, np.uint16)
            self.out = np.empty(wn + (wn >> 1) + 16384, np.uint8)
            self.starts = np.empty(512, np.int64)
            self.ends = np.empty(512, np.int64)
            self.pay_lens = np.empty(512, np.int64)
            self.crcs = np.empty(512, np.uint32)


_enc_arena = _EncArena()


def encode_window(window: np.ndarray, mbs: int,
                  cluster_factor: int = 8
                  ) -> tuple[list[bytes], list[int], list[int], list[int]]:
    """Fused collect+CRC+BWT+entropy of one RLE1 window in one C call.

    Returns (payloads, starts, ends, crcs) for the window's blocks.
    """
    lib = get_lib()
    window = np.ascontiguousarray(window, dtype=np.uint8)
    wn = window.size
    a = _enc_arena
    a.ensure(wn, mbs)
    nb = lib.lbz2_encode_window(
        window.ctypes.data_as(ctypes.c_void_p), wn, mbs, cluster_factor,
        a.blk.ctypes.data_as(ctypes.c_void_p), a.blk.size,
        a.R.ctypes.data_as(ctypes.c_void_p),
        a.bwt.ctypes.data_as(ctypes.c_void_p),
        a.mtfv.ctypes.data_as(ctypes.c_void_p),
        a.out.ctypes.data_as(ctypes.c_void_p), a.out.size,
        a.starts.ctypes.data_as(ctypes.c_void_p),
        a.ends.ctypes.data_as(ctypes.c_void_p),
        a.pay_lens.ctypes.data_as(ctypes.c_void_p),
        a.crcs.ctypes.data_as(ctypes.c_void_p), 512)
    assert nb >= 0, f"encode_window failed: {nb}"
    pays = []
    pos = 0
    for i in range(nb):
        ln = int(a.pay_lens[i])
        pays.append(a.out[pos:pos + ln].tobytes())
        pos += ln
    return (pays, [int(x) for x in a.starts[:nb]],
            [int(x) for x in a.ends[:nb]],
            [int(x) for x in a.crcs[:nb]])


def encode_block(block: np.ndarray, cmap_bool: np.ndarray,
                 crc_stored: int, cluster_factor: int = 8) -> bytes:
    """Full native block encode: SA-IS BWT + MTF/RLE2/EM/bitpack."""
    lib = get_lib()
    block = np.ascontiguousarray(block, dtype=np.uint8)
    cmap = np.ascontiguousarray(cmap_bool, dtype=np.uint8)
    bwt_scr = np.empty(block.size, np.uint8)
    mtfv_scr = np.empty(block.size + 50 + 2, np.uint16)
    out = np.empty(block.size + (block.size >> 1) + 8192, np.uint8)
    ln = lib.lbz2_encode_block(
        block.ctypes.data_as(ctypes.c_void_p), block.size,
        cmap.ctypes.data_as(ctypes.c_void_p), crc_stored & 0xFFFFFFFF,
        cluster_factor, bwt_scr.ctypes.data_as(ctypes.c_void_p),
        mtfv_scr.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    assert ln > 0
    return out[:ln].tobytes()


def retrieve_boundaries(data: np.ndarray, nbits: int, bitpos: int):
    """Parse a block header and length-walk its payload (host half of
    the device Huffman decode).

    Returns (err, end_pos, meta) where meta is a dict with idx, rand,
    used (256 u8), alpha, ntrees, group_start (ng,) int64 bit offsets,
    group_tree (ng,) uint8 resolved tree ids, ngroups, nsyms, and the
    device decode tables base (nt, 22) uint32 / count (nt, 22) int32 /
    perm (nt, 258) uint16."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    pos = ctypes.c_long(bitpos)
    idx = np.zeros(1, np.int32)
    rnd = np.zeros(1, np.int32)
    used = np.zeros(256, np.uint8)
    alpha = np.zeros(1, np.int32)
    ntrees = np.zeros(1, np.int32)
    gstart = np.zeros(18003, np.int64)
    gtree = np.zeros(18003, np.uint8)
    ngroups = np.zeros(1, np.int32)
    nsyms = np.zeros(1, np.int32)
    base = np.zeros((6, 22), np.uint32)
    count = np.zeros((6, 22), np.int32)
    perm = np.zeros((6, 258), np.uint16)
    err = lib.lbz2_retrieve_boundaries(
        data.ctypes.data_as(ctypes.c_void_p), nbits, ctypes.byref(pos),
        idx.ctypes.data_as(ctypes.c_void_p),
        rnd.ctypes.data_as(ctypes.c_void_p),
        used.ctypes.data_as(ctypes.c_void_p),
        alpha.ctypes.data_as(ctypes.c_void_p),
        ntrees.ctypes.data_as(ctypes.c_void_p),
        gstart.ctypes.data_as(ctypes.c_void_p),
        gtree.ctypes.data_as(ctypes.c_void_p),
        ngroups.ctypes.data_as(ctypes.c_void_p),
        nsyms.ctypes.data_as(ctypes.c_void_p),
        base.ctypes.data_as(ctypes.c_void_p),
        count.ctypes.data_as(ctypes.c_void_p),
        perm.ctypes.data_as(ctypes.c_void_p))
    if err != 0:
        return int(err), bitpos, None
    ng = int(ngroups[0])
    return 0, int(pos.value), {
        "idx": int(idx[0]), "rand": int(rnd[0]), "used": used,
        "alpha": int(alpha[0]), "ntrees": int(ntrees[0]),
        "group_start": gstart[:ng], "group_tree": gtree[:ng],
        "ngroups": ng, "nsyms": int(nsyms[0]),
        "base": base, "count": count, "perm": perm}


class ResumableRetriever:
    """Suspend-anywhere block retrieve over a sliding input window
    (the reference retrieve()'s MORE continuation, src/decode.c:387).

    step(window, base_bit, start_bit) -> (err, end_pos, size, idx,
    rand): err == Error.MORE (1) means feed more input and call step
    again; window holds absolute bits [base_bit, base_bit+8*len);
    base_bit must be byte-aligned.  The 900k bwt output accumulates in
    self.bwt across steps."""

    def __init__(self):
        self._lib = get_lib()
        self._st = self._lib.lbz2_retr_new()
        self.bwt = np.empty(900000, np.uint8)

    def step(self, window: np.ndarray, base_bit: int, start_bit: int):
        assert base_bit % 8 == 0
        window = np.ascontiguousarray(window, np.uint8)
        end = ctypes.c_long(0)
        size = ctypes.c_long(0)
        idx = ctypes.c_long(0)
        rnd = ctypes.c_int(0)
        err = self._lib.lbz2_retr_step(
            self._st, window.ctypes.data_as(ctypes.c_void_p),
            base_bit, base_bit + window.size * 8, start_bit,
            self.bwt.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(end), ctypes.byref(size), ctypes.byref(idx),
            ctypes.byref(rnd))
        return (int(err), int(end.value), int(size.value),
                int(idx.value), int(rnd.value))

    def close(self):
        if self._st:
            self._lib.lbz2_retr_free(self._st)
            self._st = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def scan_magic(data: np.ndarray, magic: int) -> np.ndarray:
    """All bit offsets of the 48-bit magic in data (int64 array)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty(data.size // 6 + 2, np.int64)
    cnt = lib.lbz2_scan_magic(
        data.ctypes.data_as(ctypes.c_void_p), data.size,
        ctypes.c_uint64(magic), out.ctypes.data_as(ctypes.c_void_p))
    return out[:cnt]


def imtf_rle2(syms: np.ndarray, used_flags: np.ndarray) -> np.ndarray:
    """IMTF + RLE2-expand device-decoded symbols into BWT bytes."""
    lib = get_lib()
    syms = np.ascontiguousarray(syms, dtype=np.uint16)
    out = np.empty(900000, np.uint8)
    r = lib.lbz2_imtf_rle2(
        syms.ctypes.data_as(ctypes.c_void_p), syms.size,
        np.ascontiguousarray(used_flags, np.uint8).ctypes.data_as(
            ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    if r < 0:
        raise ValueError(f"imtf_rle2 error {-r}")
    return out[:r]


def em_mstep(freqs: np.ndarray, as_arr: np.ndarray, nt_arr: np.ndarray,
             lengths: np.ndarray) -> None:
    """Batch EM maximization step: per-tree Huffman refit, in place.

    freqs: (B, 6, 259) uint32; as_arr/nt_arr: (B,) int32;
    lengths: (B, 6, 259) uint8, updated for trees < nt per row."""
    lib = get_lib()
    freqs = np.ascontiguousarray(freqs, np.uint32)
    assert lengths.dtype == np.uint8 and lengths.flags.c_contiguous
    lib.lbz2_em_mstep(
        freqs.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(as_arr, np.int32).ctypes.data_as(
            ctypes.c_void_p),
        np.ascontiguousarray(nt_arr, np.int32).ctypes.data_as(
            ctypes.c_void_p),
        freqs.shape[0], lengths.ctypes.data_as(ctypes.c_void_p))


_HDR_CAP = 24576  # > worst-case block header (~21.2 KB of bits)


def chain_finish(selectors: np.ndarray, ngroups: np.ndarray,
                 freqs: np.ndarray, as_arr: np.ndarray,
                 nt_arr: np.ndarray, cmaps: np.ndarray,
                 bwt_idx: np.ndarray, crcs: np.ndarray,
                 lengths: np.ndarray):
    """Batch final model + header build for the device chain.

    selectors: (B, G) uint8 old-ids; lengths: (B, 6, 259) uint8 EM
    state, replaced by the final lengths in place.  Returns
    (codes (B, 6, 259) uint32, hdr (B, HDR_CAP) uint8,
    hdr_bits (B,) int32, payload_bits (B,) int64)."""
    lib = get_lib()
    B, G = selectors.shape
    selectors = np.ascontiguousarray(selectors, np.uint8)
    freqs = np.ascontiguousarray(freqs, np.uint32)
    assert lengths.dtype == np.uint8 and lengths.flags.c_contiguous
    codes = np.zeros((B, 6, 259), np.uint32)
    hdr = np.empty((B, _HDR_CAP), np.uint8)
    hdr_bits = np.empty(B, np.int32)
    payload_bits = np.empty(B, np.int64)
    r = lib.lbz2_chain_finish(
        selectors.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ngroups, np.int32).ctypes.data_as(
            ctypes.c_void_p),
        freqs.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(as_arr, np.int32).ctypes.data_as(
            ctypes.c_void_p),
        np.ascontiguousarray(nt_arr, np.int32).ctypes.data_as(
            ctypes.c_void_p),
        B, G,
        np.ascontiguousarray(cmaps, np.uint8).ctypes.data_as(
            ctypes.c_void_p),
        np.ascontiguousarray(bwt_idx, np.int32).ctypes.data_as(
            ctypes.c_void_p),
        np.ascontiguousarray(crcs, np.uint32).ctypes.data_as(
            ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
        codes.ctypes.data_as(ctypes.c_void_p),
        hdr.ctypes.data_as(ctypes.c_void_p), _HDR_CAP,
        hdr_bits.ctypes.data_as(ctypes.c_void_p),
        payload_bits.ctypes.data_as(ctypes.c_void_p))
    assert r == 0, f"chain_finish header overflow on row {-r - 1}"
    return codes, hdr, hdr_bits, payload_bits


def ibwt_emit(bwt: np.ndarray, idx: int, rand_flag: int,
              out_cap: int | None = None):
    """Fused IBWT + derandomize + RLE1-expand + CRC.

    Returns (out_bytes, crc_register) or raises ValueError on
    missing-run-length / overflow.  Internals: bidirectional-chase
    ordering + linear expansion + slice-by-8 CRC (lbz2_ibwt_emit2)."""
    lib = get_lib()
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = bwt.size
    _dec_arena.ensure()
    ptr = _dec_arena.ptr
    pred = _dec_arena.pred
    rle = np.empty(n, np.uint8)
    # staged capacity: most blocks expand < 4x; retry with the 255x
    # worst case only when needed (a single 256n allocation costs more
    # page-fault time than the whole expansion)
    caps = (out_cap,) if out_cap is not None else \
        (4 * n + 4096, 256 * n + 4096)
    for cap in caps:
        out = np.empty(cap, np.uint8)
        crc = ctypes.c_uint32(0)
        r = lib.lbz2_ibwt_emit2(
            bwt.ctypes.data_as(ctypes.c_void_p), n, idx, rand_flag,
            ptr.ctypes.data_as(ctypes.c_void_p),
            pred.ctypes.data_as(ctypes.c_void_p),
            rle.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(crc))
        if r != -1:
            break
    if r == -2:
        raise ValueError("missing run length")
    if r == -1:
        raise MemoryError("output capacity exceeded")
    if r == -3:
        raise ValueError("bad BWT index")
    return out[:r], int(crc.value)
