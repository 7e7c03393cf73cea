"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--seed S] [--measure]
    python3 chip_smoke.py --kernels [--tree DIR] [--profile]
    python3 chip_smoke.py --measure --tree DIR

The second form runs no phase: it builds the kernels of this checkout
(or of the checkout at DIR, whose wrappers have the same signatures:
run both in turns inside one call to compare two trees), holds them
against their plain versions on the timed inputs of phases 3, 4, 8, 9,
12, 13, 14, 15 (the CRC also at 8 MiB, the bit packer also on 4,194,304
random fields), 19, 20, 21 and 22 (a checkout without the CRC and the bit
packer times the six it has; one without the BWT's suffix-sort kernels
times the plain suffix sorts its main path ran; one without the emits,
the MTF byte entry or the flat compaction skips them, one without the
v1 rotation sort its cyclic modes and pass4), and prints their
CUDA-event times, with
--profile each CUDA kernel's device time too, the sweep loop's SASS,
and the peak of device memory over one text batch through
chain_payloads, as one JSON line.  The third runs no phase either:
with the package of the checkout at DIR it prints the device time per
op of one text batch (op_table, which --measure adds to phase 13), the
device's busy time over one device-only compress of the phase-6 stream
and takes the stream runs that --measure adds to phase 6 (stream_runs):
the phase-6 stream through compress
in the shipped default (host stealing and steal-back on: the device's
share, stale rows, every batch's claim->deliver time), device-only and
in token mode device-only (each run's cudaMalloc count), and through
decompress_parallel and decompress_stream with both device
stages and the host C path (the decoder's stage times), each checked,
as one JSON line.

Phases (any failure exits non-zero before the last line is printed):

  1. card:   nvidia-smi name and power limit, torch and nvcc versions
  2. build:  nvcc builds every CUDA kernel of lbzip2_tpu_torch/csrc into
             build/lbzip2_tpu_torch, one nvcc per source, all at once
  3. mtf:    the MTF-rank kernel against its plain PyTorch version at
             (32, 901120) on real compacted BWT rows, uniform random
             symbols, an alphabet of 1 and rows with n = 0, 1 and N,
             plus the (8, 8192) bucket and a ragged (4, 12289) width;
             tolerance 0 (integer ranks must be equal); CUDA-event times
             on the real rows and on the uniform symbols (every rank
             equally likely: the kernel's worst case)
  4. sweeps: the compare-exchange sweep kernel against its plain
             version at the probe's (32, 7040, 128), sub 4, 210 sweeps,
             and at sweeps 0, 1 and 2, sub 1, int32 extremes and small,
             odd, prime and multi-warp row blocks, and columns past 256
             lanes in CTAs of 32 warps; tolerance 0;
             CUDA-event and device times; the sweep loop's SASS
             (cuobjdump; a toolkit without it fails the phase):
             instructions a compare-exchange issues on the ALU and FMA
             pipes, and the max must stay on the FMA pipe
  5. probe:  lbzip2_tpu_torch.tools.sort_probe at (32, 901120): torch.sort
             1 key + payload, the BWT's 8-key pass, the sweep kernel at
             210 sweeps, with its launch count
  6. chain:  lbzip2_tpu_torch.codec.encoder.compress(data, 9,
             device="cuda") on ~60 MB generated from the seed, run
             twice; the warm run is timed and its MTF and EM launches
             read: every chain batch must have gone through the EM
             kernels (one loop a batch, cluster_factor - 1 M-step
             launches each) and none through the plain loop, its E-step
             or a stand-alone M-step, through one RLE2 and one packing
             launch and none of their plain versions, and every batch
             must have shipped exactly the rows it held.  The output
             must equal the repo's host C pipeline, run out of process as
             `bin/lbzip2 -9 -c`, byte for byte and
             round-trip through bz2; every device-eligible block must
             have gone through the device.  Then the same call once
             under torch.profiler for the device's idle share; with
             --measure also once with the plain EM loop in the kernels'
             place (plain E-steps, the M-step kernel between them, the
             convergence test read on the host: the main path before the
             loop moved to the card), then stream_runs: three warm runs in
             the shipped default (host stealing and steal-back on), one
             device-only and three in token mode device-only, with the
             blocks the device took, every batch's times and each run's
             cudaMalloc count, and both decoders with the device stages and
             the host C path, with each stage's seconds.
  7. tokens: the same stream in token mode, in a child process of this
             script with LBZ2_DEVICE_CHAIN=0 (the mode is read when the
             pool is made): warm, timed, the same bytes, every
             eligible block on the device, bwt2_tokens dispatched and
             bwt2_bytes never.
  8. huffdec: the Huffman group-decode kernels against their plain
             version on every block of the phase-6 stream (lbzip2's
             layout), of bz2.compress of a three-block prefix (bzip2's
             layout), a tiny block, a skewed block with long codes, a
             one-symbol block (b"zzz"), a block written bit by bit whose
             six trees each have codes of every length 1 to 20, and
             20,000 groups over unordered random tables (lanes where
             v < base, the signed shift; starts too far apart for a
             CTA's window, some negative); every lane of syms and end,
             tolerance 0; CUDA-event and device times on one full
             900 kB text block
  9. ibwt:   the inverse-BWT kernel against its plain version at
             (8, 901120) on real rows and primaries of phase 8's text
             blocks, on rows of n = 1 and 2, one repeated byte and
             uniform random bytes, on a batch with 3 live rows padded
             with n = 1, idx = 0, on n = 1 rows only, on rows that are
             no single cycle (two cycles; idx at and past n), at a
             ragged (3, 10001) and at a width of 2^21, where the
             splitters stand 64 apart; tolerance 0; the rows each case redid
             by pointer doubling, which must be none for the text
             rows; CUDA-event times on the text batch, the 3-live batch
             and the n = 1 batch, and each CUDA kernel's device time on
             them by torch.profiler: the two smaller batches' shares of
             the text batch's time must stay under IBWT_DEVICE_SHARES
             and IBWT_CALL_SHARES (work that follows the live lanes)
 10. decode: lbzip2_tpu_torch.parallel.decode.decompress_parallel(blob,
             device="cuda") and decompress_stream (the CLI's default
             engine) with both device stages on, on the phase-6 stream
             and on bz2.compress(data, 9): equal to data, both kernels
             launched, one Huffman launch and one IBWT row for every
             block (no block decoded twice), no row redone by pointer
             doubling; warm MB/s beside the host
             C path (both switches off); with --measure also a run
             under torch.profiler for the idle share
 11. cli:    python -m lbzip2_tpu_torch in child processes with
             LBZIP2_TPU_ENGINE=device and both switches on, on a
             three-block input: -9 -c equals bin/lbzip2 -9 -c, -d -c and
             lbzcat return the data, a flipped CRC byte exits with the
             JAX CLI's code and message, and CUDA_VISIBLE_DEVICES=""
             makes compress fail (no CPU fallback).
 12. code lengths: the M-step's code-length kernel against its plain
             version, tolerance 0, on the (192, 259) frequencies of
             every M-step of one text batch of the stream, random
             frequencies with heavy ties, all-equal frequencies,
             alphabets of 0 to 4, 257 and 258 symbols, Fibonacci
             frequencies up to the key limit (the deepest tree, the
             clamp at 30), at R = 6 and R = 192, and on the same inputs
             against the host C make_code_lengths2 (native.em_mstep);
             CUDA-event times at R = 192 on the text batch's first
             M-step and on alphabets of 2 to 258.  The real inputs come
             from the plain EM loop run on the card.  (It runs after
             phase 13, on that phase's inputs.)
 13. em:     the EM loop's kernels (em_chain_rows: E-step from the
             symbols, M-step a warp a tree, loop control in device
             memory) against the plain loop on the card, tolerance 0 on
             the selectors of all G groups, the frequencies, the lengths
             and the iteration count: the 32-row text batch, 1, 3 and 5
             of its rows, 1 to 6 trees in one batch, short rows that
             settle beside text rows that still move, cluster_factor 1
             and 2, rows of one group, random lengths up to 30 (costs
             past the 1023 of a 10-bit lane), alphabets of 2 and 258,
             rows whose live groups end on a share of the E-step's
             persistent CTAs, one group past it and one short of it;
             the loop once under torch.cuda.set_sync_debug_mode("error")
             (no host read); then the whole entropy chain of the text batch
             (chain_payloads) with the kernels and with the plain loop
             in their place, the same payloads, with the stage times of
             both; CUDA-event times of the loop and each kernel's
             device time, a loop and a step.  (It runs right after
             phase 3, on that phase's BWT batch.)  With --measure also
             the device time of each op of the batch through bwt2_bytes
             and chain_payloads.
 14. crc:    the CRC kernel (ops/crc.py::crc32_device, csrc/crc32.cu: one
             launch, segments folded to n, a last-CTA XOR) against its
             plain version, tolerance 0, at n = 0, 1, 31, 32, 33 and 9999
             in N = 16384, n = 900000 in N = 901632, a full 901120-byte
             text block, the 8 MiB limit, the CPU tests' cases at N =
             1 MiB (n = 0, 1, 15, 16, 17, one byte before, at and after a
             segment boundary, N, garbage past n; the block at byte
             offset 3 of a larger buffer) and blocks at odd offsets of an
             8 MiB buffer with n about its segment boundaries; the stored
             CRC of each against the host's; two calls on two streams
             left unwaited; one call under torch.cuda.set_sync_debug_mode
             ("error"); the device kernels of three calls by
             torch.profiler (crc_segments alone); CUDA-event and device
             times on the text block and at 8 MiB.  (It and phase 15 run
             after phase 12, on phase 3's batch.)
 15. bitpack: the bit packer (ops/bitpack.py::pack_bits_device, csrc/
             bitpack.cu: the zero fill, then one look-back scan) against
             its plain version, tolerance 0, on random fields of 0 to 32
             bits, mostly zero-length fields, full-width fields, one
             field, the Huffman fields of one text block's _pack_groups,
             whose words it must reproduce, the CPU tests' tile cases at
             8192 fields, fields at odd offsets of larger buffers and
             4,194,304 random fields; two calls on two streams left
             unwaited; one call under set_sync_debug_mode("error"); the
             device kernels of three calls (the fill and pack_scan);
             CUDA-event and device times on the Huffman fields and the
             4,194,304 random ones.
 16. sharded: entry.dryrun_multichip over every visible card at 901120
             (sharded bwt2, token emit, entropy chain, IBWT decode; every
             payload against native.encode_payload, the stream through
             bz2; then the sharded per-block stage, _block_stage, on the
             v1 rotation sort's kernels, its rows and primaries bwt2's),
             with the launches of its kernels, the v1 ones among them;
             then the same four
             steps over [cuda:0, cuda:0] (two shards, a stream each, on
             one card) against the unsharded port and
             native.encode_payload, sharded and unsharded walls in turns.
 17. cards:  compress(data, 9, device="cuda") of the phase-6 stream: the
             engine on every visible card, the same bytes as
             bin/lbzip2 -9, every card in batch_trace[*]["dev"].
 18. multihost: parallel.multihost.compress_multihost in two child
             processes (gloo on localhost, the point-to-point gather,
             engine "hybrid" on cuda:0) over a four-block level-9 prefix
             of the stream: process 0's stream equals the single-host
             compress; each process's shard went through the card's
             kernels.
 19. bwt2:   the BWT's suffix-sort kernels (csrc/bwt2_sort.cu behind
             ops/bwt2.py::_seed16 and _pass8) against their plain
             versions, tolerance 0 on the ISA's lanes < n and on the
             unresolved counts: the first 32 text blocks as Lyndon rows
             at (32, 901120), the stream's uniform random, 16-value and
             random-run blocks, deep repeats (periods 1 to 450,560) and
             an (8, 8192) bucket with n = 0, 1, 2 and N and a row whose
             first suffix the seed ranks past the pads; on each the
             seed, every pass of the resolve loop and one identity pass
             past it; the whole loop on the card under
             torch.cuda.set_sync_debug_mode("error") (no host read), its
             ISA and each row's passes that did work against the plain
             loop's (text 1, deep repeats 6); then bwt2_bytes' rows and
             primaries against the plain loop and emit (the bucket's also
             against the host C BWT); the seed's runs of equal first
             words (round 0's routes: the lanes and runs of each size
             bin, and those above it, which take the seed's later
             rounds), and the tied lanes the seed leaves with the lanes
             and classes of each of the pass's size bins;
             CUDA-event times of both functions and of the loop
             against their plain versions on each case and of one
             torch.sort(stable=True) of a (32, 901120) int64 key, their
             library_ms.  (It runs after phase 15.)  Phases 6, 7, 16, 17
             and 18 assert that their paths launched both, and phase 6
             that every batch's trace holds its BWT passes.
 20. entropy: the RLE2 kernel with its flat histogram (csrc/rle2.cu
             behind ops/rle2.py::rle2_hist_rows) and the group-packing
             kernel (csrc/pack_groups.cu behind ops/chain.py::
             _pack_groups) against their plain versions, tolerance 0 on
             every output (values, nm, histogram; words, total bits): the
             text batch's MTF ranks at (32, 901120), the MTF ranks of the
             BWT of phase 19's random, 16-value and runs blocks, deep
             repeats and (8, 8192) bucket (n = 0, 1, 2), and synthetic
             rows (runs of 2^j - 2 to 2^j across tile edges, a run over
             three tiles, runs that touch n, garbage past n, n = 0 and
             1, a row of one run of 901120, a row whose EOB is its last
             lane, ninuse 1 and 256, and the look-back's stress rows:
             all-zero ranks at n = N, one run after a nonzero, n = 0, 1
             and 2 at (5, 901120) and one run of a (1, 901120) row); the
             packing on the arguments chain_payloads gives it on each of
             those batches and on synthetic rows (start bit 31, codes of
             20 bits, a dummy symbol with a length, selectors out of
             range, ngroups 0 and below G, every row at ngroups 0, rows
             past W, at full width too); the packing's flat mode
             (ops/chain.py::_pack_flat, the packing and the payload
             download's compaction in one launch, which chain_payloads
             runs) against the plain packing then the plain compaction
             on every one of those packing cases, with the row ends
             chain_payloads makes (rows past W left out), and on the text
             batch with its first and last rows left out and F of three
             chunks; each case three times, each call against the plain
             version (the per-call state on the card resets itself); the
             three wrappers once on the text batch under
             torch.cuda.set_sync_debug_mode("error") (no host read); the
             device kernels three calls run, by torch.profiler
             (rle2_scan and rle2_tail; the zero fill and pack_chunks,
             for either mode; nothing else); CUDA-event times of the
             three and of their plain versions on the text batch in
             turns, and each kernel's device time.  (It runs after phase
             19.)  Phases 6, 16 and 17 assert that their paths launched
             the RLE2, the packing and its flat mode and called no plain
             version, phase 18 that each process launched them.
 21. emits:  the BWT's emits (csrc/bwt2_emit.cu behind ops/bwt2.py::
             _emit_bytes, a scatter, and _emit2's run tokens, a single-
             pass scan with decoupled look-back and a write-only tail),
             the MTF kernel's byte entry with _compact_syms fused into
             its loads (ops/mtf_pallas.py::mtf_ranks_bytes_rows) and the
             standalone flat payload compaction (csrc/flatten_words.cu
             behind ops/chain.py::_flatten_words, on no path since the
             flat pack) against their plain versions, tolerance 0: the
             emits (rows below n, zeros past n, primary; run counts,
             tokens below the count and the capacity, zeros past the
             count, raw below n; the tokens three calls a case) on the
             resolve loop's ISA of every case of phase 19 and on designed
             rows under random permutations (runs of 254 to 765 bytes
             across the token tiles' edges, one run of a row, runs that
             touch n, counts past N / 4, n = 0, 1 and 4097, full-width
             rows, n = 0, 1, 2, S - 1, S, S + 1, 2S + 17 and N at the
             emit's buckets of S = 16384 destinations, rows off 16-byte
             alignment, and the look-back's stress rows at (32, 901120)
             and (8, 8192): one run of the row, runs of 255 k ending at a
             tile edge and one lane before and after it, a run over
             several tiles, alternating bytes past N / 4, n = 0, 1, 2),
             each ISA first asserted a permutation on the lanes < n; the
             byte
             entry on the text batch, every emitted batch and rows of 1
             and 256 used values with garbage past n; the compaction on
             the arguments chain_payloads gives it and on rows of 0
             words, base > 0, F past the end and one row; every wrapper
             once under torch.cuda.set_sync_debug_mode("error");
             CUDA-event times in turns of each kernel, its plain version
             and its library call (scatter_, gather) where one exists,
             and each kernel's device time.  (It runs after phase 20.)
             Phases 6, 16, 17 and 18 assert that their paths launched
             the emit and the byte entry, phase 7's child the emit and
             the tokens, and that none ran a plain twin; phase 6 that
             the main path ran the flat pack and not the standalone
             compaction.
 22. bwt v1: the v1 rotation sort (ops/bwt.py) on the cyclic and 4-key
             modes of csrc/bwt2_sort.cu and the emit of csrc/bwt2_emit.cu
             (ms = 0) against its plain twins on the card, tolerance 0:
             the first 32 text blocks as they stand at (32, 901120), the
             stream's random blocks, periodic stress rows (period 1 at
             n = 900,000, one class of every lane; period 3; period
             65,537) and an (8, 8192) bucket (n = 1, 2, 3, 15, 17, N, a
             periodic row, a row with one lane of sixteen FF bytes): the
             cyclic seed against _seed_sparse's ranks and counts, every
             pass and the tie-break, the whole loop under
             torch.cuda.set_sync_debug_mode("error"), bwt_batched against
             the doubling twin, SparseBwtTask driven by step against
             JAX's sparse steps, bwt_batched_uniform on the uniform-n
             cases, every row and primary against bwt2_bytes after
             native.lyndon_prep (primitive rows) or native.bwt
             (periodic); then the v1 path (the sharded per-block stage
             over [cuda:0] on the text rows) with its launches counted
             and no plain twin; pass4, chain_mtf and em_estep_batch
             against their plain twins on the text batch; CUDA-event
             times of each at (32, 901120) against the plain versions
             and the library call (torch.sort(stable=True) of a
             (32, 901120) int64 key; scatter_ for the emit), each
             kernel's device time.  (It runs after phase 21.)
 23. bench:  bench_torch.py --size 50400000 --seed 0 (56 blocks) in a
             child process started without the switches this smoke
             sets: the host C library's profile-guided build, then its
             six legs (host compress and decompress, level parity,
             chain and token mode, decompress with both device stages);
             its last line logged, bit_identical_1_5_9 true, every
             *_MBps positive, the card's name not empty, and in its
             telemetry the device's blocks in chain and token mode and
             in level parity at levels 5 and 9 each above 0.

Every kernel record carries its bound: the larger of the bytes it must
move over 3.35 TB/s and the operations its function needs on this run's
inputs over 33.45 T a second, the most 32-bit integer instructions the
card issues (one warp instruction a clock on each of the four
schedulers of the 132 SMs at 1.98 GHz: the published 67 TFLOP/s float32
rate without the FMA's factor of two).  Beside it the log gives, where
the bound is out of reach by the function's nature, a floor from a
model: for the sweeps the ALU pipe's (64 results a clock an SM, for
the ALU instructions a compare-exchange takes in the SASS), for the
Huffman decode the chain of 50 dependent shared-memory lookups a thread
walks, at a published latency of 23 cycles not measured on this card.
Those floors stay out of the JSON record, whose numbers are measured,
or, for bound_ms, counted from this run's inputs.

This process imports only the port (lbzip2_tpu_torch), never the JAX
package or JAX.

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import bz2
import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BLOCK = 900_000
ROWS, WIDTH = 32, 901120
TEXT_BLOCKS = 64
SWEEPS, SUB = 210, 4  # the probe's sweep count and row blocks
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def make_data(seed: int, text_blocks: int = TEXT_BLOCKS):
    """Word-level text from a fixed vocabulary (text_blocks x 900 kB),
    then one block each of uniform random bytes (pack overflow), random
    bytes over 16 values (full-width pack) and random runs of random
    lengths (not periodic).  Returns (data, text)."""
    rng = np.random.default_rng(seed)
    nv = 4096
    lens = rng.integers(2, 11, nv)
    letters = rng.integers(97, 123, int(lens.sum())).astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    seps = [b" "] * 12 + [b", ", b".\n", b"\n"]
    vocab = [letters[offs[i]:offs[i + 1]].tobytes() +
             seps[i % len(seps)] for i in range(nv)]
    p = 1.0 / np.arange(1, nv + 1) ** 1.1
    want = text_blocks * BLOCK
    ntok = want // 6 + 1024
    text = b"".join([vocab[i] for i in rng.choice(nv, ntok, p=p / p.sum())])
    while len(text) < want:
        text += text[:want - len(text)]
    text = text[:want]
    rand = rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
    nib = (rng.integers(0, 16, BLOCK, dtype=np.uint8) + 0x40).tobytes()
    vals = rng.integers(0, 256, BLOCK // 4, dtype=np.uint8)
    reps = rng.integers(1, 40, BLOCK // 4)
    runs = np.repeat(vals, reps)[:BLOCK].tobytes()
    return text + rand + nib + runs, text


def deep_codes_stream(seed: int = 0, groups: int = 600):
    """A one-block bzip2 stream written bit by bit: 19 used bytes (an
    alphabet of 21), six trees whose codes take every length 1 to 20
    (the end-of-block's 20, the other 20 symbols a permutation of 1..20
    in each tree), every symbol in the first group of every tree, the
    rest uniform with lone RUNA and RUNB digits.  Returns (stream,
    data); the data is what any decoder makes of it."""
    from lbzip2_tpu_torch import native
    from lbzip2_tpu_torch.core.bits import BitWriter

    rng = np.random.default_rng(seed)
    AS, NT, GROUP = 21, 6, 50
    lengths = np.full((NT, AS), 20, np.int64)
    codes = np.zeros((NT, AS), np.int64)
    for t in range(NT):  # canonical codes, shorter first
        lengths[t, :AS - 1] = rng.permutation(np.arange(1, AS))
        code = 0
        for ln in range(1, 21):
            for s in np.flatnonzero(lengths[t] == ln):
                codes[t, s] = code
                code += 1
            code <<= 1
    sel = rng.integers(0, NT, groups)
    syms = rng.integers(2, AS - 1, groups * GROUP)  # MTF ranks 1..18
    digit = rng.random(syms.size) < 0.05
    digit[1:] &= ~digit[:-1]  # runs of one digit: no block overflow
    syms[digit] = rng.integers(0, 2, int(digit.sum()))
    for t in range(NT):
        g = int(np.flatnonzero(sel == t)[0])
        syms[g * GROUP:g * GROUP + AS - 1] = np.r_[0, 2, 1, 3:AS - 1]
    nsym = syms.size - int(rng.integers(1, GROUP))
    syms = syms[:nsym]
    syms[-1] = AS - 1  # end of block
    sel = sel[:(nsym + GROUP - 1) // GROUP]
    used = np.zeros(256, np.uint8)
    used[97:97 + AS - 2] = 1
    # the decoder's internal values: 0 EOB, ranks, 257 RUNA, 258 RUNB
    internal = np.where(syms < 2, syms + 257, syms - 1)
    internal[-1] = 0
    bwt = native.imtf_rle2(internal.astype(np.uint16), used)
    idx = int(rng.integers(0, bwt.size))
    data, crcreg = native.ibwt_emit(bwt, idx, 0)
    crc = (crcreg ^ 0xFFFFFFFF) & 0xFFFFFFFF
    w = BitWriter()
    for value, nbits in ((0x425A6839, 32), (0x314159265359, 48), (crc, 32),
                         (0, 1), (idx, 24)):
        w.put(value, nbits)
    buckets = used.reshape(16, 16)
    w.put(int("".join("1" if b.any() else "0" for b in buckets), 2), 16)
    for b in buckets:
        if b.any():
            w.put(int("".join(map(str, b)), 2), 16)
    w.put(NT, 3)
    w.put(sel.size, 15)
    order = list(range(NT))
    for t in sel.tolist():  # selectors, move-to-front, in unary
        j = order.index(t)
        order.insert(0, order.pop(j))
        w.put((1 << (j + 1)) - 2, j + 1)
    for t in range(NT):  # code lengths, delta-coded
        a = int(lengths[t, 0])
        w.put(a, 5)
        for c in lengths[t].tolist():
            while a != c:
                w.put(0b10 if a < c else 0b11, 2)
                a += 1 if a < c else -1
            w.put(0, 1)
    tree = np.repeat(sel, GROUP)[:nsym]
    w.put_arrays(codes[tree, syms], lengths[tree, syms])
    w.put(0x177245385090, 48)
    w.put(crc, 32)
    w.pad_to_byte()
    return w.getvalue(), data.tobytes()


def host_reference(data: bytes) -> bytes:
    """The repo's host C pipeline on ``data``, run as its own process
    through the lbzip2 front end (bin/lbzip2)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("LBZIP2", "BZIP2", "BZIP", "LBZIP2_TPU_ENGINE")}
    r = subprocess.run([sys.executable, os.path.join(root, "bin", "lbzip2"),
                        "-9", "-c"], input=data, capture_output=True,
                       env=env, check=True)
    return r.stdout


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


HBM_BYTES_S = 3.35e12  # H100 SXM device memory
SMS, BOOST_HZ = 132, 1.98e9  # H100 SXM: SMs, the published boost clock
# the most 32-bit integer instructions the card issues a second: one warp
# instruction a clock on each of an SM's four schedulers (128 lanes), the
# ALU pipe (min, max, logic, IADD3: 64 a clock) and the FMA pipe (IMAD: 64
# a clock) both busy; the published 67 TFLOP/s float32 without the FMA's
# factor of two
INT_OPS_S = 128 * SMS * BOOST_HZ
# results a clock an SM issues on the integer ALU pipe (32-bit min, max,
# compare and logic: the CUDA programming guide's throughput table for
# compute capability 9.0) and, for the Huffman chain's model, the latency
# of a dependent shared-memory load in cycles (published, not measured
# here)
ALU_PER_CLOCK, LDS_CYCLES = 64, 23
# instructions a compare-exchange of the sweep needs: a min, an add and a
# LOP3 (min & ~1 | sum & 1), the fewest an exact variant compiled to
SWEEP_INSTRUCTIONS = 3


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the bytes the function must
    move (each input read once, each output written once) over the
    memory rate, or the integer instructions it needs on this run's
    inputs, one an operation, over INT_OPS_S, whichever is larger.  No
    single PyTorch call computes any of the first eight kernels'
    functions (the EM loop least of all: a data-dependent number of
    rounds of a packed argmin and a Huffman construction), so there is
    no library time to set beside them; the BWT's records set the sort
    their radix passes compute (bwt2_phase), the emit's a scatter_ and
    the fused MTF load's its compaction's gather (emits_phase)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT_OPS_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "library_ms": None,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def sweep_keys(dev):
    """The sweep kernel's timed keys: (32, 7040, 128) random int32 of
    seed 2, and the generator that made them."""
    rng = np.random.default_rng(2)
    k = rng.integers(INT32_MIN, INT32_MAX, (ROWS, WIDTH // 128, 128),
                     dtype=np.int32, endpoint=True)
    return torch.from_numpy(k).to(dev), rng


# the pipe that issues each SASS opcode of an integer loop on Hopper
ALU_OPS = {"IMNMX", "LOP3", "IADD3", "ISETP", "SHF", "SEL", "LEA", "PRMT",
           "MOV", "PLOP3", "IABS", "VIMNMX", "VIMNMX3"}
FMA_OPS = {"IMAD", "FFMA", "FADD", "FMUL"}


def cuobjdump_path() -> str:
    """cuobjdump of the CUDA toolkit (on PATH or beside nvcc) or of
    Triton's package; raises where there is none."""
    import importlib.util
    import shutil

    from lbzip2_tpu_torch import _build

    spots = [shutil.which("cuobjdump"), os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        spots.append(os.path.join(spec.submodule_search_locations[0],
                                  "backends", "nvidia", "bin", "cuobjdump"))
    for tool in spots:
        if tool and os.path.exists(tool):
            return tool
    raise RuntimeError(f"no cuobjdump to read the SASS with: {spots}")


def sweep_sass(lib: str, per: int, warps: int | None) -> dict:
    """Opcodes of the compare-exchange loop of the sweep kernel built in
    ``lib`` for ``per`` rows a thread (in CTAs of ``warps`` warps; None
    for a tree whose kernel has no such parameter), by cuobjdump: the
    backward branch whose body holds the most mins (IMNMX or VIMNMX with
    a true PT operand; a max has !PT) is the sweep, one min a
    compare-exchange.  Returns each opcode's count a compare-exchange
    and the instructions a compare-exchange issues on the ALU and FMA
    pipes; raises where the loop is not found."""
    name = f"sweep_kernelILi{per}E" + (f"Li{warps}E" if warps else "")
    text = subprocess.run([cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next(f for f in funcs if name in f.split("\n", 1)[0])
    ops, labels = [], {}  # (address, opcode, is a min); label -> address
    pending = []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"([^;]*);", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            labels[label] = addr
        pending = []
        is_min = m.group(3).split(".")[0] in ("IMNMX", "VIMNMX") and \
            re.search(r"(?<!!)\bPT\s*$", m.group(4)) is not None
        ops.append((addr, m.group(3), m.group(4), is_min))
    best = None
    for addr, op, rest, _ in ops:  # backward branches: loops
        if not op.startswith("BRA"):
            continue
        t = re.search(r"`\((\.L_x_\d+)\)", rest)
        target = labels.get(t.group(1)) if t else None
        if target is None:
            t = re.search(r"\b0x([0-9a-f]+)\b", rest)
            target = int(t.group(1), 16) if t else None
        if target is None or target > addr:
            continue
        loop = [(o, mn) for a, o, _, mn in ops if target <= a <= addr]
        n = sum(mn for _, mn in loop)
        if n and (best is None or n > best[0]):
            best = (n, [o for o, _ in loop])
    if best is None:
        raise RuntimeError(f"no compare-exchange loop in {name}'s SASS")
    n, loop = best
    counts: dict = {}
    for o in loop:
        counts[o] = counts.get(o, 0) + 1
    base = [o.split(".")[0] for o in loop]
    return {"per_cex": {o: round(c / n, 3) for o, c in sorted(counts.items())},
            "alu_per_cex": round(sum(b in ALU_OPS for b in base) / n, 3),
            "fma_per_cex": round(sum(b in FMA_OPS for b in base) / n, 3),
            "cex_in_loop": n, "loop_instructions": len(loop)}


def pipe_floor_ms(alu_per_cex: float, cex: float) -> float:
    """The least time the ALU pipe takes to issue ``cex``
    compare-exchanges of ``alu_per_cex`` instructions each, on every SM
    at the boost clock."""
    return alu_per_cex * cex / (ALU_PER_CLOCK * SMS * BOOST_HZ) * 1e3


def device_busy(prof) -> tuple[float, int]:
    """(seconds the device was busy, device intervals) of a profile: the
    union of its device intervals (kernels, copies, memsets)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6, len(spans)  # the profiler's microseconds


def idle_share(name: str, fn):
    """Run ``fn`` once under torch.profiler and log the device's idle
    share: 1 - (device busy) / wall.  Returns fn's result."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    busy, spans = device_busy(prof)
    assert spans, f"{name}: the profiler recorded no device interval"
    log(f"idle share [{name}]: {1 - busy / wall:.3f} (device busy "
        f"{busy:.3f} s of {wall:.3f} s profiled wall, {spans} "
        f"device intervals)")
    return out


def max_err_of(got, want) -> int:
    """Largest absolute difference of two tensors, or of two tuples of
    tensors pair by pair."""
    if isinstance(got, tuple):
        return max(max_err_of(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def device_us(fn, reps: int = 5) -> dict:
    """Device time of each CUDA kernel and copy of one call of ``fn``,
    in microseconds by torch.profiler: the mean over the launches it
    recorded in ``reps`` calls, times the launches of one call.

    The profiler does not record every launch (as a rule the last
    call's last kernels are missing, now and then half of a window), so
    a sum over the window divided by ``reps`` reads a kernel at 0.8 or
    0.5 of itself.  The launches of one call are the recorded ones over
    ``reps``, rounded up: right while less than one call's worth is
    missing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: round(e.device_time_total / e.count *
                              -(-e.count // reps), 2)
            for e in prof.key_averages() if e.device_time_total}


OPS = (("bwt2", ("_seed16", "_pass8", "_pass_in_place", "_emit_bytes")),
       ("chain", ("_compact_syms", "mtf_ranks_rows", "mtf_ranks_bytes_rows",
                  "_rle2_batch",
                  "_flat_hist", "rle2_hist_rows", "em_chain_rows",
                  "_pack_groups", "_pack_flat", "_flatten_words")))


def op_table(text: bytes, batch, dev, nrows: int = ROWS) -> None:
    """--measure: device time of each op of the main path for the text
    batch (its first nrows rows), through bwt2_bytes and chain_payloads.  Each op runs
    under a torch.profiler of its own between two synchronizes (so the
    batch's wall is not the pool's); its time is the union of its device
    intervals.  What the table leaves out is what runs between the ops:
    the uploads, the downloads and a few small tensor ops."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    from lbzip2_tpu_torch.codec.encoder import lyndon_rows

    table: dict = {}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            busy, spans = device_busy(prof)
            row = table.setdefault(name, {"calls": 0, "device_ms": 0.0,
                                          "device_intervals": 0})
            row["calls"] += 1
            row["device_ms"] += busy * 1e3
            row["device_intervals"] += spans
            return out
        return call

    tb = np.frombuffer(text, np.uint8)
    blocks = [tb[(r * BLOCK) % tb.size:][:BLOCK] for r in range(nrows)]
    rows, ns, ms = lyndon_rows(blocks, WIDTH)
    _, _, cmaps, primary = batch
    cmaps, primary = cmaps[:nrows], primary[:nrows]
    mods = {m: importlib.import_module(f"lbzip2_tpu_torch.ops.{m}")
            for m, _ in OPS}
    kept = {(m, n): getattr(mods[m], n) for m, names in OPS for n in names
            if hasattr(mods[m], n)}  # names a tree lacks are skipped
    for (m, n), fn in kept.items():
        setattr(mods[m], n, timed(f"{m}.{n}", fn))
    try:
        bwt, _ = mods["bwt2"].bwt2_bytes(*(torch.from_numpy(a).to(dev)
                                           for a in (rows, ns, ms)))
        mods["chain"].chain_payloads(
            bwt, ns, cmaps, primary.cpu().numpy().astype(np.int32),
            np.zeros(nrows, np.uint32))
    finally:
        for (m, n), fn in kept.items():
            setattr(mods[m], n, fn)
    total = sum(r["device_ms"] for r in table.values())
    log(f"device time per op, one ({nrows}, {WIDTH}) text batch through "
        f"bwt2_bytes and chain_payloads, {total:.3f} ms in all:")
    for name, row in sorted(table.items(),
                            key=lambda kv: -kv[1]["device_ms"]):
        log(f"  op {name}: {row['device_ms']:.3f} ms = "
            f"{row['device_ms'] / total:.3f} of it, {row['calls']} calls, "
            f"{row['device_intervals']} device intervals")


def mtf_timed_cases(text: bytes, dev):
    """The MTF kernel's two timed inputs at (32, 901120), as (syms, ns):
    the compacted BWT rows of the first 32 text blocks and uniform
    random symbols; and the BWT batch (bwt, ns, cmaps, primary)."""
    from lbzip2_tpu_torch.codec.encoder import lyndon_rows
    from lbzip2_tpu_torch.ops.bwt2 import bwt2_bytes
    from lbzip2_tpu_torch.ops.chain import _compact_syms

    tb = np.frombuffer(text, np.uint8)
    blocks = [tb[(r * BLOCK) % tb.size:][:BLOCK] for r in range(ROWS)]
    batch, ns, ms = lyndon_rows(blocks, WIDTH)
    assert (ms >= 0).all(), "a text block is periodic"
    cmaps = np.stack([np.bincount(b, minlength=256) > 0
                      for b in blocks]).astype(np.uint8)
    t0 = time.time()
    bwt, primary = bwt2_bytes(torch.from_numpy(batch).to(dev),
                              torch.from_numpy(ns).to(dev),
                              torch.from_numpy(ms).to(dev))
    torch.cuda.synchronize()
    log(f"bwt2_bytes (32, 901120) text batch: {time.time() - t0:.3f} s")
    real = _compact_syms(bwt, torch.from_numpy(cmaps).to(dev)).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    uni = torch.randint(0, 256, (ROWS, WIDTH), generator=gen, device=dev,
                        dtype=torch.int32)
    n_full = torch.full((ROWS,), WIDTH, dtype=torch.int32, device=dev)
    return {"real_text_rows": (real, torch.from_numpy(ns).to(dev)),
            "uniform_256": (uni, n_full)}, (bwt, ns, cmaps, primary)


def kernel_phase(text: bytes, dev):
    """MTF kernel vs plain version at (32, 901120); returns the record
    and the BWT batch it was taken on (bwt, ns, cmaps, primary)."""
    from lbzip2_tpu_torch.ops import mtf_pallas

    timed, text_batch = mtf_timed_cases(text, dev)
    uni, n_full = timed["uniform_256"]
    gen = torch.Generator(device=dev).manual_seed(2)
    n_edge = torch.tensor([(0, 1, WIDTH)[r % 3] for r in range(ROWS)],
                          dtype=torch.int32, device=dev)
    # widths off the kernel's 4096-symbol chunk and 32-lane grid
    ragged = torch.randint(0, 7, (4, 12289), generator=gen, device=dev,
                           dtype=torch.int32)
    n_ragged = torch.tensor([0, 4096, 4097, 12289], dtype=torch.int32,
                            device=dev)
    cases = {
        **timed,
        "alphabet_1": (torch.zeros_like(uni), n_full),
        "n_0_1_N": (uni, n_edge),
        "small_bucket_8x8192": (uni[:8, :8192], n_full[:8].clamp(max=8192)),
        "ragged_4x12289": (ragged, n_ragged),
    }
    max_err = 0
    for name, (syms, nn) in cases.items():
        k = mtf_pallas.mtf_ranks_rows(syms.contiguous(), nn)
        p = mtf_pallas.mtf_ranks_plain(syms, nn)
        torch.cuda.synchronize()
        err = int((k.long() - p.long()).abs().max())
        max_err = max(max_err, err)
        log(f"mtf kernel vs plain [{name}]: max_abs_err {err}")
        assert err == 0, f"MTF kernel disagrees with plain on {name}"

    syms, nn = timed["real_text_rows"]
    ms_k = cuda_ms(lambda: mtf_pallas.mtf_ranks_rows(syms, nn), 10)
    ms_p = cuda_ms(lambda: mtf_pallas.mtf_ranks_plain(syms, nn), 2)
    ms_u = cuda_ms(lambda: mtf_pallas.mtf_ranks_rows(uni, n_full), 10)
    log(f"mtf_ranks (32, 901120) real rows: kernel {ms_k:.3f} ms, "
        f"plain {ms_p:.3f} ms; uniform_256 rows: kernel {ms_u:.3f} ms")
    # in and out (B, N) int32 and ns; a rank needs no fewer than one
    # operation a symbol, whatever the algorithm
    record = {"name": "mtf_ranks", "route": "cuda",
              "source": "lbzip2_tpu_torch/csrc/mtf_ranks.cu",
              "replaces": "lbzip2_tpu/ops/mtf_pallas.py:81",
              "launches": 0, "max_abs_err": max_err, "ms": ms_k,
              "plain_ms": ms_p, "uniform_256_ms": ms_u,
              **bound(2 * syms.numel() * 4 + nn.numel() * 4,
                      int(nn.sum()))}
    return record, text_batch


def code_length_cases(real: list, dev) -> dict:
    """name -> (freqs (B, 6, 259) int32, as (B,) int32) on the host; a
    row is one tree, its alphabet size that of its block."""
    rng = np.random.default_rng(5)
    fib = [1, 1]
    while fib[-1] + fib[-2] < 2 ** 22:  # f << 9 must stay below 2^31
        fib.append(fib[-1] + fib[-2])
    fibs = np.ones((4, 6, 259), np.int64)
    fibs[0, :, :len(fib)] = fib
    fibs[1, :, :len(fib)] = fib[::-1]
    fibs[2, :, 100:100 + len(fib)] = fib
    fibs[3] = 2 ** 20 - 1
    edge_as = np.array([0, 1, 2, 3, 4, 257, 258, 258], np.int32)
    cases = {f"real_mstep_{i}": fa for i, fa in enumerate(real)}
    cases.update({
        "heavy_ties_192": (rng.integers(0, 4, (32, 6, 259)),
                           rng.integers(2, 259, 32)),
        "all_equal": (np.full((8, 6, 259), 7), edge_as),
        "edge_alphabets_random": (rng.integers(0, 900000, (8, 6, 259)),
                                  edge_as),
        "edge_alphabets_zero_freqs": (np.zeros((8, 6, 259)), edge_as),
        "fibonacci": (fibs, np.array([len(fib), 258, 258, 258])),
        "one_block_6_rows": (rng.integers(0, 50, (1, 6, 259)),
                             np.array([200])),
        "random_192": (rng.integers(0, 900000, (32, 6, 259)),
                       rng.integers(2, 259, 32)),
    })
    return {k: (np.asarray(f, np.int32), np.asarray(a, np.int32))
            for k, (f, a) in cases.items()}


def em_case(mtfv, nm, ninuse, dev, lengths="trees"):
    """Inputs of the EM loop on the card from host arrays, as
    chain_payloads makes them: (mtfv (B, NP), nm, ninuse, nt, lengths0
    (B, 6, 259)), all int32.  nt and the initial trees come from each
    row's flat histogram; lengths="random30" draws every length,
    the dummy's lane and the dead trees too, from 1..30 instead (a
    group's cost then passes the 1023 a 10-bit lane holds)."""
    from lbzip2_tpu_torch.ref.huffman import (generate_initial_trees,
                                              num_trees_for)

    B = mtfv.shape[0]
    nt = np.array([num_trees_for(int(v)) for v in nm], np.int32)
    lengths0 = np.ones((B, 6, 259), np.int32)
    for b in range(B):
        hist = np.bincount(mtfv[b, :nm[b]], minlength=259).astype(np.int64)
        lengths0[b] = generate_initial_trees(hist, int(nm[b]), int(nt[b]))
        lengths0[b, :, ninuse[b] + 2:] = 0
    if lengths == "random30":
        lengths0 = np.random.default_rng(6).integers(
            1, 31, lengths0.shape).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in (mtfv, nm, ninuse, nt, lengths0))


def text_symbols(batch, dev):
    """(mtfv, nm, ninuse) on the host of a BWT batch (bwt, ns, cmaps,
    primary): the MTF half of the chain, run on the card."""
    from lbzip2_tpu_torch.ops import chain

    bwt, ns, cmaps, _ = batch
    mtfv, nm, _, _, _ = chain._chain_mtf2(
        bwt, torch.from_numpy(ns).to(dev), torch.from_numpy(cmaps).to(dev))
    return (mtfv.cpu().numpy(), nm.cpu().numpy().astype(np.int32),
            cmaps.sum(1, dtype=np.int32))


def em_plain(args, cf: int, plain_mstep: bool = True):
    """The plain EM loop on the card on the inputs of em_chain_rows: the
    per-group histogram, then huffenc._em_chain (plain E-steps, the
    convergence test read on the host), its M-steps by the plain version
    or, as the main path ran them before the loop moved to the card,
    through make_code_lengths_rows."""
    from lbzip2_tpu_torch.ops import chain, huffenc

    mtfv, nm, ninuse, nt, lengths0 = args
    hist_g, _, ngroups = chain._group_hist(mtfv, nm, ninuse)
    wrapper = huffenc.make_code_lengths_rows
    if plain_mstep:
        huffenc.make_code_lengths_rows = huffenc._make_code_lengths_rows
    try:
        return huffenc._em_chain(hist_g, ngroups, nt, ninuse + 2, lengths0,
                                 cf)
    finally:
        huffenc.make_code_lengths_rows = wrapper


def first_mstep_inputs(args):
    """(freqs (B * 6, 259), as (B * 6,)) int32 on the card: what the
    first M-step of a batch is given, from one plain E-step."""
    from lbzip2_tpu_torch.ops import chain

    mtfv, nm, ninuse, nt, lengths0 = args
    hist_g, _, ngroups = chain._group_hist(mtfv, nm, ninuse)
    _, freqs = chain._em_estep_hist(hist_g, ngroups, nt, lengths0)
    return (freqs.reshape(-1, 259).contiguous(),
            (ninuse + 2).repeat_interleave(6).int())


def code_lengths_phase(text_args, dev):
    """Code-length kernel vs its plain version and vs the host C
    make_code_lengths2; returns the record.  The real inputs are those
    of every M-step of the text batch's plain EM loop on the card (the
    main path's own loop runs inside the EM kernels and passes through
    no Python wrapper)."""
    from lbzip2_tpu_torch import native
    from lbzip2_tpu_torch.ops import huffenc

    real = []  # (freqs (32, 6, 259), as (32,)) of every M-step
    wrapper = huffenc.make_code_lengths_rows

    def recorder(freqs, as_rows):
        real.append((freqs.reshape(-1, 6, huffenc.W).cpu().numpy(),
                     as_rows[::6].cpu().numpy()))
        return wrapper(freqs, as_rows)

    huffenc.make_code_lengths_rows = recorder
    try:
        em_plain(text_args, 8, plain_mstep=False)
    finally:
        huffenc.make_code_lengths_rows = wrapper
    assert real, "the text batch ran no M-step"

    def on_card(f, a):
        """(freqs (B * 6, 259), as (B * 6,)) on the card of one case."""
        return (torch.from_numpy(f.reshape(-1, huffenc.W)).to(dev),
                torch.from_numpy(np.repeat(a, 6)).to(dev))

    cases = code_length_cases(real, dev)
    max_err = 0
    for name, (f, a) in cases.items():
        rows, as_rows = on_card(f, a)
        got = huffenc.make_code_lengths_rows(rows, as_rows)
        want = huffenc._make_code_lengths_rows(rows, as_rows)
        torch.cuda.synchronize()
        err = max_err_of(got, want)
        # host C: alphabets of 2 and more, every tree of a block live
        ok = a >= 2
        c_len = np.zeros(f[ok].shape, np.uint8)
        native.em_mstep(np.maximum(f[ok], 0).astype(np.uint32), a[ok],
                        np.full(int(ok.sum()), 6, np.int32), c_len)
        got_c = got.reshape(f.shape).cpu().numpy()[ok]
        err_c = int(np.abs(got_c.astype(np.int64) - c_len).max()) \
            if ok.any() else 0
        max_err = max(max_err, err, err_c)
        log(f"code_lengths kernel [{name}] {tuple(rows.shape)}: vs plain "
            f"max_abs_err {err}, vs host C ({int(ok.sum()) * 6} rows) "
            f"{err_c}, longest {int(got.max())}")
        assert err == 0, f"code_lengths kernel disagrees with plain: {name}"
        assert err_c == 0, f"code_lengths kernel disagrees with C: {name}"

    a = real[0][1]
    rows, as_rows = on_card(*real[0])
    ms_k = cuda_ms(lambda: huffenc.make_code_lengths_rows(rows, as_rows), 50)
    ms_p = cuda_ms(lambda: huffenc._make_code_lengths_rows(rows, as_rows), 2)
    w_rows, w_as = on_card(*cases["random_192"])
    ms_w = cuda_ms(lambda: huffenc.make_code_lengths_rows(w_rows, w_as), 50)
    # the kernel alone runs shorter than Python takes to call it: its own
    # device time by the profiler (None when the profiler dropped it)
    us_k = sum(device_us(lambda: huffenc.make_code_lengths_rows(
        rows, as_rows)).values()) or None
    us_w = sum(device_us(lambda: huffenc.make_code_lengths_rows(
        w_rows, w_as)).values()) or None
    log(f"code_lengths (192, 259) first M-step of a text batch (alphabets "
        f"of {int(a.min())} to {int(a.max())}): call {ms_k:.4f} ms, the "
        f"kernel's device time {us_k} us, plain {ms_p:.3f} ms; random_192 "
        f"(alphabets of 2 to 258): call {ms_w:.4f} ms, device {us_w} us")
    # a row needs a comparison sort of its `as` leaves, as - 1 merges and
    # one depth and one length for each leaf, whatever the algorithm
    alpha = np.repeat(a, 6).astype(np.int64)
    ops = int((alpha * np.ceil(np.log2(np.maximum(alpha, 2))) +
               3 * alpha).sum())
    return {"name": "code_lengths", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/code_lengths.cu",
            "replaces": "lbzip2_tpu/ops/huffenc.py:52",
            "launches": 0, "max_abs_err": max_err, "ms": ms_k,
            "plain_ms": ms_p, "random_192_ms": ms_w, "device_us": us_k,
            "random_192_device_us": us_w,
            **bound(2 * rows.numel() * 4 + as_rows.numel() * 4, ops)}


def em_cases(text_h, dev) -> dict:
    """name -> (inputs of em_chain_rows on the card, cluster_factor).
    text_h: (mtfv, nm, ninuse) of the 32-row text batch on the host."""
    from lbzip2_tpu_torch.ops import huffenc

    mtfv, nm, ninuse = text_h
    NP = mtfv.shape[1]
    rng = np.random.default_rng(7)

    def cut(rows, lens):
        """Text rows cut to lens symbols, the last the end-of-block."""
        m = np.zeros((len(rows), NP), np.int32)
        n = np.minimum(np.array(lens, np.int32), nm[rows])
        for k, (r, ln) in enumerate(zip(rows, n)):
            m[k, :ln] = mtfv[r, :ln]
            m[k, ln - 1] = ninuse[r] + 1
        return m, n, ninuse[rows]

    def synth(specs):
        """(nm, ninuse) a row: uniform symbols and the end-of-block."""
        m = np.zeros((len(specs), NP), np.int32)
        for k, (n, nu) in enumerate(specs):
            if nu and n > 1:
                m[k, :n - 1] = rng.integers(0, nu + 1, n - 1)
            m[k, n - 1] = nu + 1
        return (m, np.array([s[0] for s in specs], np.int32),
                np.array([s[1] for s in specs], np.int32))

    whole = np.arange(8)
    full = int(nm.max())
    # the E-step's persistent CTAs: P a row, each an equal share of the
    # row's live groups; rows whose groups end on a share's edge (whole
    # or with a partial last group), one group past it, one short of
    # it, and a full text row (shares of more than one tile)
    P = huffenc.estep_ctas(6, (NP + 49) // 50)
    edge = 50 * P * 3
    cases = {
        "text_32_rows": (em_case(mtfv, nm, ninuse, dev), 8),
        "rows_1": (em_case(mtfv[:1], nm[:1], ninuse[:1], dev), 8),
        "rows_3": (em_case(mtfv[1:4], nm[1:4], ninuse[1:4], dev), 8),
        "rows_5": (em_case(mtfv[4:9], nm[4:9], ninuse[4:9], dev), 8),
        # a tree more past 150, 300, 600, 1200 and 2400 symbols
        "nt_1_to_6": (em_case(*cut(whole, [100, 151, 301, 601, 1201, 2401,
                                           150, 2400]), dev), 8),
        # rows of a few symbols settle at once, the text rows keep moving
        "one_row_still_changing": (em_case(*cut(whole, [
            30, full, 51, 120, 49, full, 200, 1]), dev), 8),
        "cluster_factor_1": (em_case(mtfv, nm, ninuse, dev), 1),
        "cluster_factor_2": (em_case(mtfv, nm, ninuse, dev), 2),
        "one_group_rows": (em_case(*cut(whole[:3], [50, 7, 1]), dev), 8),
        "lengths_to_30_costs_past_1023": (
            em_case(mtfv, nm, ninuse, dev, "random30"), 8),
        "as_2_and_258": (em_case(*synth([
            (1, 0), (2, 0), (NP, 256), (NP - 60, 256), (50, 7), (51, 7),
            (100, 0), (300_000, 256)]), dev), 8),
        "as_2_and_258_lengths_to_30": (em_case(*synth([
            (1, 0), (NP, 256), (700_001, 256), (2, 0)]), dev, "random30"), 8),
        "shares_straddle": (em_case(*cut(whole[:6], [
            edge, edge - 49, edge + 1, edge + 50, edge - 50, full]), dev), 8),
    }
    return cases


def em_phase(text_h, batch, dev):
    """The EM kernels (em_chain_rows) against the plain loop on the card,
    tolerance 0 on the selectors of all G groups, the frequencies, the
    lengths and the iteration count, on every case; the text batch's
    payloads with the kernels and with the plain loop in their place;
    times.  Returns the record and the text batch's inputs."""
    from lbzip2_tpu_torch.ops import chain, huffenc

    cases = em_cases(text_h, dev)
    max_err, iters_of = 0, {}
    for name, (args, cf) in cases.items():
        got = huffenc.em_chain_rows(*args, cf)
        want = em_plain(args, cf)
        torch.cuda.synchronize()
        errs = [max_err_of(g, w.to(dev)) for g, w in zip(got, want)]
        max_err = max(max_err, *errs)
        iters_of[name] = int(got[3])
        log(f"em kernels vs plain loop [{name}] rows {args[0].shape[0]}, "
            f"cluster_factor {cf}: max_abs_err sel {errs[0]} (all "
            f"{got[0].shape[1]} groups) freqs {errs[1]} lengths {errs[2]} "
            f"iters {errs[3]}; {iters_of[name]} E-steps, trees "
            f"{sorted(set(args[3].tolist()))}, alphabets "
            f"{int(args[2].min()) + 2} to {int(args[2].max()) + 2}")
        assert not any(errs), f"the EM kernels disagree with plain: {name}"
    assert iters_of["cluster_factor_1"] == 1 and \
        iters_of["cluster_factor_2"] == 2, iters_of
    args, cf = cases["shares_straddle"]
    P = huffenc.estep_ctas(6, (args[0].shape[1] + 49) // 50)
    groups = ((args[1] + 49) // 50).tolist()
    log(f"shares_straddle: {P} E-step CTAs a row, live groups {groups}, "
        f"shares of {[-(-g // P) for g in groups]}")
    assert groups[0] % P == 0 and groups[2] % P == 1, groups
    # no wrapper waits for the card (no host read)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        huffenc.em_chain_rows(*args, cf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert iters_of["one_row_still_changing"] > 2, iters_of
    assert sorted(set(cases["nt_1_to_6"][0][3].tolist())) == \
        [1, 2, 3, 4, 5, 6]
    costly = cases["lengths_to_30_costs_past_1023"][0]
    sym = costly[0][:, :50 * 4000].long()
    cost = torch.gather(costly[4], 2, sym[:, None, :].expand(-1, 6, -1))
    cost = int(cost.reshape(-1, 6, 4000, 50).sum(3).max())
    log(f"lengths_to_30_costs_past_1023: the dearest group costs {cost}")
    assert cost > 1023, "no cost overflows its 10-bit lane"

    # the text batch's whole entropy chain: the kernels, then the plain
    # loop in their place (its M-steps through the code-length kernel)
    bwt, ns, cmaps, primary = batch
    idxs = primary.cpu().numpy().astype(np.int32)
    wrapper = chain.em_chain_rows
    payloads, stages = {}, {}
    for which, fn in (("kernels", wrapper), ("plain_loop", lambda *a: em_plain(
            a[:5], a[5], plain_mstep=False))):
        chain.em_chain_rows = fn
        try:
            for _ in range(2):  # the second run is warm
                stages[which] = {}
                t0 = time.time()
                payloads[which] = chain.chain_payloads(
                    bwt, ns, cmaps, idxs, np.zeros(ROWS, np.uint32),
                    times=stages[which])
                stages[which]["total"] = round(time.time() - t0, 3)
        finally:
            chain.em_chain_rows = wrapper
        log(f"chain_payloads of the text batch, EM by the {which}: "
            f"{json.dumps(stages[which])}")
    assert payloads["kernels"] == payloads["plain_loop"], \
        "the batch's payloads differ between the EM kernels and the plain loop"

    args, cf = cases["text_32_rows"]
    ms_k = cuda_ms(lambda: huffenc.em_chain_rows(*args, cf), 20)
    ms_p = cuda_ms(lambda: em_plain(args, cf), 1)
    ms_l = cuda_ms(lambda: em_plain(args, cf, plain_mstep=False), 3)
    us = device_us(lambda: huffenc.em_chain_rows(*args, cf))
    iters = iters_of["text_32_rows"]
    log(f"em_chain (32 rows, {int(args[1].sum())} live symbols, {iters} "
        f"E-steps): kernels {ms_k:.4f} ms, plain loop {ms_p:.3f} ms, plain "
        f"loop with the M-step kernel {ms_l:.3f} ms; device time of one "
        f"loop, us: {json.dumps(us)}")
    for k, v in us.items():
        if "em_estep" in k or "em_mstep" in k:
            steps = iters if "em_estep" in k else iters - 1
            log(f"  {k.split('::')[-1].split('(')[0]}: {v} us a loop, "
                f"{v / max(steps, 1):.2f} us a step")
    # in: the live symbols, the initial trees and the small vectors; out:
    # sel, freqs, lengths, each once.  Six additions a symbol of a valid
    # group an executed iteration
    live = int(args[1].sum())
    groups = int(((args[1] + 49) // 50).sum())
    small = sum(a.numel() for a in args[1:4]) * 4
    nbytes = live * 4 + small + args[4].numel() * 4 * 3 + \
        args[0].shape[0] * ((args[0].shape[1] + 49) // 50) * 4
    record = {"name": "em_chain", "route": "cuda",
              "source": "lbzip2_tpu_torch/csrc/em_chain.cu",
              "replaces": "lbzip2_tpu/ops/huffenc.py:184",
              "launches": 0, "max_abs_err": max_err, "ms": ms_k,
              "plain_ms": ms_p, "plain_loop_mstep_kernel_ms": ms_l,
              "iters": iters, "kernels_us": us,
              **bound(nbytes, 6 * groups * 50 * iters)}
    return record, args


def sweep_record(full, ms_k: float, ms_p: float, lib: str):
    """The sweep kernel's record at the probe's keys, with its bound
    (SWEEP_INSTRUCTIONS a value a sweep); and, for the log, the sweep
    loop's SASS and the floor the ALU pipe's published rate gives for
    the ALU instructions a compare-exchange takes there."""
    from lbzip2_tpu_torch.ops import sort_sweeps

    cex = SWEEPS * full.numel()
    p = sort_sweeps.plan(full.shape[1] // SUB)
    sass = sweep_sass(lib, p[0], p[4] if len(p) > 4 else None)
    record = {"name": "sort_sweeps", "route": "cuda",
              "source": "lbzip2_tpu_torch/csrc/sort_sweeps.cu",
              "replaces": "tools/tpu_sort_probe.py:77",
              "launches": 0, "max_abs_err": 0, "ms": ms_k, "plain_ms": ms_p,
              **bound(2 * full.numel() * 4, SWEEP_INSTRUCTIONS * cex)}
    return record, sass, pipe_floor_ms(sass["alu_per_cex"], cex)


def sweep_phase(dev):
    """Sweep kernel vs plain version on every case; returns the record."""
    from lbzip2_tpu_torch import _build
    from lbzip2_tpu_torch.ops import sort_sweeps

    full, rng = sweep_keys(dev)

    def keys(shape, values=None):
        if values is None:
            k = rng.integers(INT32_MIN, INT32_MAX, shape, dtype=np.int32,
                             endpoint=True)
        else:
            k = rng.choice(np.array(values, np.int32), shape)
        return torch.from_numpy(k).to(dev)

    ext = keys((ROWS, WIDTH // 128, 128),
               (INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX - 1,
                INT32_MAX))
    cases = {  # name: (keys, sweeps, sub)
        "probe_32x7040x128_sub4": (full, SWEEPS, SUB),
        "sweeps_0": (full, 0, SUB),
        "sweeps_1": (full, 1, SUB),
        "sweeps_2": (full, 2, SUB),
        "sub_1": (full, SWEEPS, 1),
        "int32_extremes": (ext, SWEEPS, SUB),
        "small_2x64x128_sub4": (keys((2, 64, 128)), 7, 4),
        "small_2x64x128_sub1": (keys((2, 64, 128)), 7, 1),
        "odd_rows_3x105x128": (keys((3, 105, 128)), 5, 1),
        "rows_32_2x96x128_sub3": (keys((2, 96, 128)), 9, 3),
        # a prime: the first 67 lanes of 4 warps a column
        "prime_rows_2x67x128": (keys((2, 67, 128)), 6, 1),
        # 515 lanes of 2 rows over 32 warps, the wrap from the last
        "rows_1030_2x1030x128": (keys((2, 1030, 128)), 4, 1),
        # a prime past 256 lanes: 16 warps a column, 2 a CTA of 32
        "prime_rows_2x509x128": (keys((2, 509, 128)), 5, 1),
        # the tallest block: 1024 lanes of 32 rows, a CTA of 32 warps
        "rows_32768_1x32768x128": (keys((1, 32768, 128)), 3, 1),
    }
    max_err = 0
    for name, (k, s, sub) in cases.items():
        got = sort_sweeps.sweeps(k, s, sub)
        want = sort_sweeps.sweeps_plain(k, s, sub)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        log(f"sweep kernel vs plain [{name}] plan "
            f"{sort_sweeps.plan(k.shape[1] // sub)}: max_abs_err {err}")
        assert err == 0, f"sweep kernel disagrees with plain on {name}"

    ms_k = cuda_ms(lambda: sort_sweeps.sweeps(full, SWEEPS, SUB), 10)
    ms_p = cuda_ms(lambda: sort_sweeps.sweeps_plain(full, SWEEPS, SUB), 2)
    us = device_us(lambda: sort_sweeps.sweeps(full, SWEEPS, SUB))
    record, sass, floor = sweep_record(
        full, ms_k, ms_p, str(_build.BUILD / "libsort_sweeps.so"))
    record.update(max_abs_err=max_err, device_us=us)
    log(f"sort_sweeps (32, 7040, 128) sub {SUB}, {SWEEPS} sweeps: kernel "
        f"{ms_k:.4f} ms (device {json.dumps(us)} us), plain {ms_p:.3f} ms; "
        f"bound {record['bound_ms']:.4f} ms ({record['bound_by']}: "
        f"{SWEEP_INSTRUCTIONS} instructions a compare-exchange at "
        f"{INT_OPS_S / 1e12:.2f} T a second); floor of the ALU pipe for "
        f"the SASS's {sass['alu_per_cex']} ALU instructions a "
        f"compare-exchange {floor:.4f} ms (a model: {ALU_PER_CLOCK} a "
        f"clock an SM at {BOOST_HZ / 1e9} GHz); SASS of the sweep loop "
        f"{json.dumps(sass)}")
    # the max stays on the FMA pipe (no IADD3)
    assert sass["fma_per_cex"] >= 2 and sass["alu_per_cex"] <= 2.5, \
        f"ptxas moved the max back to the ALU: {sass}"
    return record


def token_run(eligible: int) -> int:
    """Child process of the token phase (LBZ2_DEVICE_CHAIN=0 in its
    environment): compress the stream read from stdin twice, warm, and
    print one JSON line of what the parent checks."""
    from lbzip2_tpu_torch.codec import encoder
    from lbzip2_tpu_torch.ops import bwt2

    data = sys.stdin.buffer.read()
    dev = torch.device("cuda", 0)
    calls = {"bwt2_tokens": 0, "bwt2_bytes": 0}

    def spy(name):
        fn = getattr(encoder, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        setattr(encoder, name, counted)

    spy("bwt2_tokens")
    spy("bwt2_bytes")
    warm = encoder.warm_device(device=dev)
    t0 = time.time()
    cold = encoder.compress(data, 9, device=dev)
    first = time.time() - t0
    for name in calls:
        calls[name] = 0
    bwt2.launches = bwt2.pass_launches = 0
    bwt2.emit_launches = bwt2.token_launches = 0
    plain: dict = {}
    t0 = time.time()
    with plain_twins_counted(plain):
        out = encoder.compress(data, 9, device=dev)
    dt = time.time() - t0
    stats = encoder.last_stats
    calls["bwt2_seed16"] = bwt2.launches - bwt2.pass_launches
    calls["bwt2_pass8"] = bwt2.pass_launches
    calls["emit_bytes"] = bwt2.emit_launches
    calls["emit_tokens"] = bwt2.token_launches
    print(json.dumps({
        "warm_device_s": warm, "first_s": first, "s": dt,
        "mbps": len(data) / dt / 1e6, "bytes": len(out),
        "sha256": hashlib.sha256(out).hexdigest(), "same_as_first":
        out == cold, "roundtrip": bz2.decompress(out) == data,
        "device_blocks": stats["device_blocks"], "eligible": eligible,
        "calls": calls, "plain": plain, "batches": [
            {k: t.get(k) for k in ("rows", "prep_s", "dispatch_s",
                                   "ready_s", "expand_s")}
            for t in stats["batch_trace"]]}), flush=True)
    return 0


def token_phase(data: bytes, eligible: int, ref: bytes) -> dict:
    """Token-mode run of the stream in a child process; checks it."""
    env = {**os.environ, "LBZ2_DEVICE_CHAIN": "0"}
    t0 = time.time()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--token-run", str(eligible)], input=data,
                       capture_output=True, env=env, timeout=600)
    sys.stderr.write(r.stderr.decode(errors="replace"))
    assert r.returncode == 0, f"token-mode child exited {r.returncode}"
    res = json.loads(r.stdout.decode().strip().splitlines()[-1])
    log(f"token mode child: {time.time() - t0:.1f} s, warm_device "
        f"{res['warm_device_s']:.2f} s, first call {res['first_s']:.2f} s")
    for i, b in enumerate(res["batches"]):
        log(f"  token batch {i}: {json.dumps(b)}")
    assert res["sha256"] == hashlib.sha256(ref).hexdigest(), \
        "token-mode compress differs from the host pipeline"
    assert res["same_as_first"], "token-mode runs differ"
    assert res["roundtrip"], "token-mode bz2 round trip failed"
    assert res["device_blocks"] == eligible, \
        f"token mode: device did {res['device_blocks']} of {eligible}"
    assert res["calls"]["bwt2_tokens"] > 0 and \
        res["calls"]["bwt2_bytes"] == 0, f"token mode ran {res['calls']}"
    assert res["calls"]["bwt2_seed16"] > 0 and \
        res["calls"]["bwt2_pass8"] > 0, \
        f"token mode missed the BWT kernels: {res['calls']}"
    assert res["calls"]["emit_bytes"] > 0 and \
        res["calls"]["emit_tokens"] == res["calls"]["bwt2_tokens"] and \
        not any(res["plain"].values()), \
        f"token mode missed the emit kernels: {res['calls']}, " \
        f"{res['plain']}"
    return res


def huffdec_record(timed, ms_k: float, ms_p: float) -> dict:
    """The group-decode kernel's record on one block's inputs: the bytes
    bound (every input once, syms (G, 50) and end (G,) out; a symbol's
    20 compares and 6 more operations are 0.06 of it)."""
    groups = timed[1].numel()
    return {"name": "huffdec", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/huffdec.cu",
            "replaces": "lbzip2_tpu/ops/huffdec.py:32",
            "launches": 0, "max_abs_err": 0, "ms": ms_k, "plain_ms": ms_p,
            **bound(sum(a.numel() for a in timed) * 4 + groups * 51 * 4,
                    groups * 50 * 26)}


def chain_floor_ms() -> float:
    """A model of the Huffman decode's floor: the chain of 50 dependent
    shared-memory lookups each thread walks, at LDS_CYCLES each (a
    published latency, not measured on this card) and the boost clock."""
    return 50 * LDS_CYCLES / BOOST_HZ * 1e3


def text_block_inputs(text: bytes, dev):
    """decode_groups' inputs on the card for the first block of the
    text in lbzip2's layout (the host C pipeline's bytes, which compress
    writes too): a 900 kB block."""
    from lbzip2_tpu_torch.ops import huffdec
    from lbzip2_tpu_torch.parallel.decode import block_payloads
    from lbzip2_tpu_torch.parallel.encode import compress_parallel

    blob = compress_parallel(text[:2 * BLOCK], 9)
    arr = np.frombuffer(blob, np.uint8)
    _, _, _, inputs = huffdec.group_inputs(arr, arr.size * 8,
                                           block_payloads(blob)[0])
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in inputs]


def huffdec_phase(chain_blob: bytes, data: bytes, dev):
    """Group-decode kernel vs plain version on every block of several
    streams; returns the record."""
    from lbzip2_tpu_torch.ops import huffdec
    from lbzip2_tpu_torch.parallel.decode import block_payloads

    rng = np.random.default_rng(3)
    skew = np.where(rng.random(80000) < 0.995, 120,
                    rng.integers(0, 256, 80000)).astype(np.uint8)
    deep, deep_data = deep_codes_stream(0)
    assert bz2.decompress(deep) == deep_data
    streams = {
        "chain_stream": chain_blob,
        "bz2_prefix_3_blocks": bz2.compress(data[:3 * BLOCK], 9),
        "tiny": bz2.compress(b"abracadabra", 9),
        "long_codes": bz2.compress(skew.tobytes(), 9),
        "one_symbol": bz2.compress(b"zzz", 9),  # RLE1 keeps 3 alone
        # six trees, each with codes of every length 1 to 20
        "deep_codes_6_trees_lengths_1_to_20": deep,
    }
    max_err, timed = 0, None
    for name, blob in streams.items():
        arr = np.frombuffer(blob, np.uint8)
        errs, groups = [], 0
        for pos in block_payloads(blob):
            err, _, meta, inputs = huffdec.group_inputs(arr, arr.size * 8,
                                                        pos)
            assert err == 0, f"{name}: boundary walk error {err}"
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in inputs]
            k_syms, k_end = huffdec.decode_groups(*args)
            p_syms, p_end = huffdec.decode_groups_plain(*args)
            torch.cuda.synchronize()
            errs.append(max(int((k_syms.long() - p_syms.long()).abs().max()),
                            int((k_end.long() - p_end.long()).abs().max())))
            groups += meta["ngroups"]
            if timed is None:  # the stream's first block: 900 kB of text
                timed = args
        max_err = max(max_err, *errs)
        log(f"huffdec kernel vs plain [{name}]: {len(errs)} blocks, "
            f"{groups} groups, max_abs_err {max(errs)}")
        assert max(errs) == 0, f"huffdec kernel disagrees on {name}"
    # unordered tables: lanes with v < base[k] (the signed shift), and
    # starts far apart (a CTA's window too wide to stage) and negative
    base = rng.integers(0, 2**20 + 2**18, (6, 22)).astype(np.uint32)
    base[:, 21] = 2**20
    starts = rng.integers(0, 32 * 4096, 20000).astype(np.int32)
    starts[::97] = -rng.integers(1, 3000, starts[::97].size)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(
            np.uint32).view(np.int32), starts,
        rng.integers(0, 6, 20000).astype(np.int32), base.view(np.int32),
        rng.integers(-300, 300, (6, 22)).astype(np.int32),
        rng.integers(0, 258, (6, 258)).astype(np.int32))]
    k_syms, k_end = huffdec.decode_groups(*args)
    p_syms, p_end = huffdec.decode_groups_plain(*args)
    torch.cuda.synchronize()
    err = max(int((k_syms.long() - p_syms.long()).abs().max()),
              int((k_end.long() - p_end.long()).abs().max()))
    log(f"huffdec kernel vs plain [arbitrary_tables]: 20000 groups, "
        f"max_abs_err {err}")
    assert err == 0, "huffdec kernel disagrees on arbitrary tables"
    max_err = max(max_err, err)
    ms_k = cuda_ms(lambda: huffdec.decode_groups(*timed), 20)
    ms_p = cuda_ms(lambda: huffdec.decode_groups_plain(*timed), 3)
    us = device_us(lambda: huffdec.decode_groups(*timed))
    record = huffdec_record(timed, ms_k, ms_p)
    record.update(max_abs_err=max_err, device_us=us)
    log(f"huffdec one 900 kB text block ({timed[1].numel()} groups): "
        f"call {ms_k:.4f} ms, the kernels' device time {json.dumps(us)} "
        f"us, plain {ms_p:.3f} ms; bound {record['bound_ms']:.4f} ms "
        f"({record['bound_by']}); the chain's floor {chain_floor_ms():.4f} "
        f"ms (a model: 50 lookups of {LDS_CYCLES} cycles)")
    return record


IBWT_TIMED = ("text_8x901120", "padded_3_live", "n1_only")
# the most that 3 live rows of 8, and n = 1 rows only, may take of the 8
# text rows' time.  Of the kernels' own time on the card, which follows
# the live lanes, the limits the design set itself; of the whole call's
# CUDA-event time, where seven launches and the wait for the flags cost
# every batch the same 50 to 60 us of an idle card and the host's load
# moves the reading (0.58 to 0.62 and 0.11 to 0.15 in a quiet run),
# limits that only a fixed cost grown by half again would cross
IBWT_DEVICE_SHARES = (0.6, 0.2)
IBWT_CALL_SHARES = (0.7, 0.3)


def ibwt_batch(rows, dev, width: int):
    """(bwt, ns, idxs) on the card from (bwt, idx) rows, padded to 8
    rows of n = 1, idx = 0: the JAX batcher's shape (the port's batcher
    ships its live rows), which the kernel must take at the cost of its
    live lanes."""
    b = np.zeros((8, width), np.uint8)
    ns = np.ones(8, np.int32)
    idxs = np.zeros(8, np.int32)
    for r, (bwt, idx) in enumerate(rows):
        b[r, :bwt.size], ns[r], idxs[r] = bwt, bwt.size, idx
    return tuple(torch.from_numpy(a).to(dev) for a in (b, ns, idxs))


def ibwt_timed_cases(text: list, dev) -> dict:
    """The inverse BWT's three timed batches at (8, 901120) from the
    (bwt, idx) of 8 text blocks: all 8, 3 of them, none."""
    return {"text_8x901120": ibwt_batch(text, dev, WIDTH),
            "padded_3_live": ibwt_batch(text[:3], dev, WIDTH),
            "n1_only": ibwt_batch([], dev, WIDTH)}


def ibwt_phase(chain_blob: bytes, dev):
    """Inverse-BWT kernel vs plain version at (8, 901120) and edge
    cases; returns the record."""
    from lbzip2_tpu_torch.ops import huffdec, ibwt
    from lbzip2_tpu_torch.parallel.decode import block_payloads

    B = 8
    arr = np.frombuffer(chain_blob, np.uint8)
    text = []  # (bwt, idx) of the stream's first 8 blocks (text)
    for pos in block_payloads(chain_blob)[:B]:
        err, _, bwt, idx, rnd = huffdec.decode_block_device(
            arr, arr.size * 8, pos, dev)
        assert err == 0 and not rnd
        text.append((bwt, idx))

    def batch(rows, width=WIDTH):
        return ibwt_batch(rows, dev, width)

    def random_bwt(n):
        """BWT and primary of n random bytes (8-byte windows sort the
        rotations: they are distinct at this n)."""
        data = rng.integers(0, 256, n, dtype=np.uint8)
        ext = np.concatenate([data, data[:8]])
        keys = np.zeros(n, np.uint64)
        for k in range(8):
            keys = keys << np.uint64(8) | ext[k:k + n].astype(np.uint64)
        assert np.unique(keys).size == n
        order = np.argsort(keys, kind="stable")
        return data[(order - 1) % n], int(np.flatnonzero(order == 0)[0])

    rng = np.random.default_rng(4)
    uni = rng.integers(0, 256, WIDTH, dtype=np.uint8)
    small = rng.integers(0, 5, 10001, dtype=np.uint8)
    wide = 1 << 21  # past 40,960 splitters at 32 positions: 64 apart
    assert ibwt.shift_for(wide) > ibwt.shift_for(WIDTH)
    cases = {
        **ibwt_timed_cases(text, dev),
        "edges_n1_n2_repeat_uniform": batch([
            (uni[:1], 0), (uni[:2], 1),
            (np.full(BLOCK, 0x61, np.uint8), 12345),
            (uni, int(rng.integers(0, WIDTH)))]),
        # ptr of [1, 0, 2, 2, ...] is 0 -> 1 -> 0 and the rest; a start
        # at n - 1, at n and far past n
        "two_cycles_idx_at_and_past_n": batch([
            (np.array([1, 0] + [2] * 4998, np.uint8), 5),
            (text[0][0], text[0][0].size - 1), (uni[:1000], 1000),
            (uni[:1000], 5000)]),
        "ragged_3x10001": batch([(small, 7), (small[:5000], 4999),
                                 (small[:1], 0)], width=10001),
        "wide_2097152_bwt_and_uniform": batch([
            random_bwt(wide - 77), (uni, 3)], width=wide),
    }
    max_err, redone = 0, {}
    for name, args in cases.items():
        ibwt.doubling_rows = 0
        got = ibwt.ibwt_rows(*args)
        want = ibwt.ibwt_plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        redone[name] = ibwt.doubling_rows
        log(f"ibwt kernel vs plain [{name}]: max_abs_err {err}, "
            f"{redone[name]} rows redone by doubling")
        assert err == 0, f"ibwt kernel disagrees with plain on {name}"
    for name in ("text_8x901120", "padded_3_live", "n1_only"):
        assert redone[name] == 0, f"{name}: rows went to doubling"
    # the one-byte row, the two-cycle row and the starts at and past n;
    # of the wide rows the true BWT is ranked, the uniform bytes redone
    assert redone["edges_n1_n2_repeat_uniform"] >= 1 and \
        redone["two_cycles_idx_at_and_past_n"] == 3 and \
        redone["wide_2097152_bwt_and_uniform"] == 1, redone
    ms, us = {}, {}
    for name in IBWT_TIMED:
        # the wrapper waits for its stream in every call, so one stall
        # of the host shows in a mean: the median of five means of 10
        ms[name] = sorted(cuda_ms(lambda: ibwt.ibwt_rows(*cases[name]), 10)
                          for _ in range(5))[2]
    # the card's clock moves between two profiles (the same kernel reads
    # 100 or 130 us), and the shares below compare two of them: three
    # rounds over the three batches in turns, each kernel's median
    rounds = [{name: device_us(lambda: ibwt.ibwt_rows(*cases[name]))
               for name in IBWT_TIMED} for _ in range(3)]
    for name in IBWT_TIMED:
        us[name] = {k: sorted(r[name].get(k, 0.0) for r in rounds)[1]
                    for k in rounds[0][name]}
        log(f"ibwt device time [{name}], us: {json.dumps(us[name])}")
    args = cases["text_8x901120"]
    ms_k = ms["text_8x901120"]
    ms_p = cuda_ms(lambda: ibwt.ibwt_plain(*args), 2)
    call = [ms[name] / ms_k for name in IBWT_TIMED[1:]]
    device = [sum(us[name].values()) / sum(us[IBWT_TIMED[0]].values())
              for name in IBWT_TIMED[1:]]
    log(f"ibwt (8, 901120) text rows: kernel {ms_k:.3f} ms, plain "
        f"{ms_p:.3f} ms; 3 live rows of 8: {ms['padded_3_live']:.3f} ms = "
        f"{call[0]:.3f} of it ({device[0]:.3f} of its device time); "
        f"n = 1 rows only: {ms['n1_only']:.3f} ms = {call[1]:.3f} of it "
        f"({device[1]:.3f} of its device time)")
    assert all(d <= lim for d, lim in zip(device, IBWT_DEVICE_SHARES)), \
        f"ibwt's device time does not follow the live lanes: {device}"
    assert all(c <= lim for c, lim in zip(call, IBWT_CALL_SHARES)), \
        f"ibwt's time does not follow the live lanes: {call}"
    return {"name": "ibwt", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/ibwt.cu",
            "replaces": "lbzip2_tpu/ops/ibwt.py:22",
            "launches": 0, "max_abs_err": max_err, "ms": ms_k,
            "plain_ms": ms_p, "padded_3_live_ms": ms["padded_3_live"],
            "n1_only_ms": ms["n1_only"],
            "padded_3_live_device_share": device[0],
            "n1_only_device_share": device[1],
            "doubling_rows": redone["text_8x901120"],
            # bytes in and out; an inverse BWT is linear, no fewer than
            # one operation a position
            **bound(2 * args[0].numel() + 8 * B, int(args[1].sum()))}


def decode_phase(name: str, blob: bytes, data: bytes, dev,
                 profiled: bool = False) -> dict:
    """decompress_parallel and decompress_stream with both device stages
    on (cold, then warm with the launch counts reset), then the host C
    path; checks all three."""
    from lbzip2_tpu_torch.ops import huffdec, ibwt
    from lbzip2_tpu_torch.parallel import decode

    decode.DEVICE_HUFF = decode.DEVICE_IBWT = True
    ibwt.doubling_rows = 0
    t0 = time.time()
    assert decode.decompress_parallel(blob, device=dev) == data, \
        f"{name}: device decode (first run) differs from the data"
    first = time.time() - t0
    huffdec.launches = ibwt.launches = 0
    t0 = time.time()
    out = decode.decompress_parallel(blob, device=dev)
    dt = time.time() - t0
    res = {"huffdec_launches": huffdec.launches,
           "ibwt_launches": ibwt.launches, **decode.last_stats}
    assert out == data, f"{name}: device decode differs from the data"
    # one launch and one row for each block: none decoded twice
    assert res["huffdec_launches"] == res["blocks"] > 0, res
    assert res["ibwt_launches"] > 0 and \
        res["ibwt_rows"] == res["blocks"], res
    if profiled:
        again = idle_share(
            f"decompress_parallel {name}, device stages",
            lambda: decode.decompress_parallel(blob, device=dev))
        assert again == data, f"{name}: profiled device decode differs"
    # the CLI's default engine: the streaming decoder, same switches
    huffdec.launches = ibwt.launches = 0
    parts, view = [], memoryview(blob)
    cursor = [0]

    def read_chunk(n):
        chunk = view[cursor[0]:cursor[0] + n]
        cursor[0] += len(chunk)
        return bytes(chunk)

    t0 = time.time()
    n_in, n_out = decode.decompress_stream(read_chunk, parts.append,
                                           device=dev)
    dt_stream = time.time() - t0
    st = {"huffdec_launches": huffdec.launches,
          "ibwt_launches": ibwt.launches, **decode.last_stats}
    assert b"".join(parts) == data and (n_in, n_out) == \
        (len(blob), len(data)), f"{name}: stream decode differs"
    assert st["huffdec_launches"] == st["blocks"] == res["blocks"] and \
        st["ibwt_launches"] > 0 and st["ibwt_rows"] == st["blocks"], st
    log(f"decompress_stream {name}: device stages {dt_stream:.3f} s = "
        f"{len(data) / dt_stream / 1e6:.3f} MB/s; {json.dumps(st)}")
    assert ibwt.doubling_rows == 0, \
        f"{name}: {ibwt.doubling_rows} IBWT rows went to pointer doubling"
    decode.DEVICE_HUFF = decode.DEVICE_IBWT = False
    t0 = time.time()
    host = decode.decompress_parallel(blob, device=dev)
    dt_host = time.time() - t0
    assert host == data, f"{name}: host decode differs from the data"
    log(f"decompress {name} ({len(blob)} bytes -> {len(data)}): device "
        f"stages {dt:.3f} s = {len(data) / dt / 1e6:.3f} MB/s (first run "
        f"{first:.2f} s), host C path {dt_host:.3f} s = "
        f"{len(data) / dt_host / 1e6:.3f} MB/s; {json.dumps(res)}")
    return res


LBZCAT = ("import sys; from lbzip2_tpu_torch.cli import main; "
          "sys.exit(main(['lbzcat']))")


def cli_phase(few: bytes) -> None:
    """The port's front end in child processes on a few-block input."""
    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items()
            if k not in ("LBZIP2", "BZIP2", "BZIP", "LBZIP2_TPU_ENGINE",
                         "LBZ2_DEVICE_HUFF", "LBZ2_DEVICE_DECODE")}
    env = {**base, "LBZIP2_TPU_ENGINE": "device", "LBZ2_DEVICE_HUFF": "1",
           "LBZ2_DEVICE_DECODE": "1"}
    port = [sys.executable, "-m", "lbzip2_tpu_torch"]

    def run(cmd, inp, env):
        t0 = time.time()
        r = subprocess.run(cmd, input=inp, capture_output=True, env=env,
                           cwd=root, timeout=300)
        log(f"  cli {' '.join(cmd[1:])[:60]}: exit {r.returncode}, "
            f"{len(r.stdout)} bytes out, {time.time() - t0:.1f} s")
        return r

    ref = host_reference(few)
    c = run(port + ["-9", "-c"], few, env)
    assert c.returncode == 0 and c.stdout == ref, \
        f"port CLI compress differs from bin/lbzip2: {c.stderr[-2000:]}"
    d = run(port + ["-d", "-c"], c.stdout, env)
    assert d.returncode == 0 and d.stdout == few, d.stderr[-2000:]
    z = run([sys.executable, "-c", LBZCAT], c.stdout, env)
    assert z.returncode == 0 and z.stdout == few, z.stderr[-2000:]
    bad = bytearray(ref)
    bad[10] ^= 0xFF  # the first block's stored CRC
    mine = run(port + ["-d", "-c"], bytes(bad), env)
    theirs = run([sys.executable, os.path.join(root, "bin", "lbzip2"),
                  "-d", "-c"], bytes(bad),
                 {**base, "LBZIP2_TPU_ENGINE": "device"})
    last = [r.stderr.decode(errors="replace").strip().splitlines()[-1:]
            for r in (mine, theirs)]
    log(f"  corrupt stream: port {mine.returncode} {last[0]}, JAX CLI "
        f"{theirs.returncode} {last[1]}")
    assert mine.returncode == theirs.returncode != 0 and last[0] == last[1]
    nocuda = run(port + ["-9", "-c"], few, {**env,
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert nocuda.returncode != 0 and not nocuda.stdout, \
        "the port CLI compressed without a CUDA device"


def kernels_only(seed: int, profiled: bool, dev) -> int:
    """--kernels: the kernels of the package on the path (MTF ranks,
    sweeps, Huffman group decode, inverse BWT, code lengths, the EM loop,
    CRC, bit packer, the BWT's seed, pass and loop, all three
    also on phase 19's other kinds of rows; a checkout without the CRC
    and the bit packer times the six it has, one without the BWT's
    kernels its plain suffix sorts), held against their plain versions
    (tolerance 0; the BWT's on the ISA's lanes < n and the counts) and timed
    on the smoke's timed inputs; the sweep loop's SASS; and the peak of
    device memory over one text batch through chain_payloads.  One JSON
    line.  A checkout from before the EM loop moved to the card has no
    em_chain_rows: there the loop timed is the one its main path ran,
    the plain E-steps with the M-step kernel between them."""
    from lbzip2_tpu_torch import _build
    from lbzip2_tpu_torch.ops import (bwt2, chain, huffdec, huffenc, ibwt,
                                      mtf_pallas, rle2, sort_sweeps)

    data, text = make_data(seed, text_blocks=ROWS)
    mtf_cases, batch = mtf_timed_cases(text, dev)
    bwt, ns, cmaps, primary = batch
    rows = [(bwt[r, :ns[r]].cpu().numpy(), int(primary[r])) for r in range(8)]
    calls = {f"mtf_{name}": (mtf_pallas.mtf_ranks_rows,
                             mtf_pallas.mtf_ranks_plain, a)
             for name, a in mtf_cases.items()}
    calls.update({f"ibwt_{name}": (ibwt.ibwt_rows, ibwt.ibwt_plain, a)
                  for name, a in ibwt_timed_cases(rows, dev).items()})
    full, _ = sweep_keys(dev)
    calls["sort_sweeps_32x7040x128_sub4"] = (
        lambda k: sort_sweeps.sweeps(k, SWEEPS, SUB),
        lambda k: sort_sweeps.sweeps_plain(k, SWEEPS, SUB), (full,))
    timed = text_block_inputs(text, dev)
    calls["huffdec_text_block"] = (huffdec.decode_groups,
                                   huffdec.decode_groups_plain, timed)
    text_args = em_case(*text_symbols(batch, dev), dev)
    calls["code_lengths_192x259_text"] = (
        huffenc.make_code_lengths_rows, huffenc._make_code_lengths_rows,
        first_mstep_inputs(text_args))
    f, a = code_length_cases([], dev)["random_192"]  # alphabets of 2 to 258
    calls["code_lengths_192x259_random"] = (
        huffenc.make_code_lengths_rows, huffenc._make_code_lengths_rows,
        (torch.from_numpy(f.reshape(-1, 259)).to(dev),
         torch.from_numpy(np.repeat(a, 6)).to(dev)))
    try:
        from lbzip2_tpu_torch.ops import bitpack, crc
    except ImportError:  # a checkout from before the two kernels
        bitpack = crc = None
    if crc is not None:
        block = torch.from_numpy(np.frombuffer(text[:WIDTH],
                                               np.uint8).copy()).to(dev)
        calls["crc32_text_901120"] = (
            lambda b: crc.crc32_device(b, WIDTH),
            lambda b: crc.crc32_plain(b, WIDTH), (block,))
        values, nbits, _, _ = pack_groups_fields(batch, dev)
        calls["bitpack_huffman_text_block"] = (
            lambda v, ln: bitpack.pack_bits_device(v, ln, v.numel()),
            lambda v, ln: bitpack.pack_bits_plain(v, ln, v.numel()),
            (values, nbits))
        # the aims' other sizes: the 8 MiB limit, 4,194,304 fields
        rng = np.random.default_rng(20)
        big = torch.from_numpy(rng.integers(0, 256, CRC_LIMIT,
                                            dtype=np.uint8)).to(dev)
        calls["crc32_8MiB"] = (lambda b: crc.crc32_device(b, CRC_LIMIT),
                               lambda b: crc.crc32_plain(b, CRC_LIMIT),
                               (big,))
        M = 4_194_304
        calls["bitpack_random_4194304"] = (
            lambda v, ln: bitpack.pack_bits_device(v, ln, M),
            lambda v, ln: bitpack.pack_bits_plain(v, ln, M),
            (torch.from_numpy(rng.integers(0, 1 << 32, M, dtype=np.uint64)
                              .astype(np.int64)).to(dev),
             torch.from_numpy(rng.integers(0, 33, M).astype(np.int32))
             .to(dev)))
    # the RLE2 with its histogram and the group packing of the text batch;
    # a checkout from before their kernels times the plain versions its
    # main path ran
    syms, ns_d = mtf_cases["real_text_rows"]
    ranks = (mtf_pallas.mtf_ranks_rows(syms, ns_d), ns_d,
             torch.from_numpy(cmaps).to(dev).int().sum(1, dtype=torch.int32))

    def rle2_then_hist(r, n, u):
        mtfv, nm = rle2._rle2_batch(r, n, u)
        return mtfv, nm, chain._flat_hist(mtfv, nm, u)

    if hasattr(rle2, "rle2_hist_rows"):
        calls["rle2_hist_text_32x901120"] = (
            rle2.rle2_hist_rows, rle2.rle2_hist_plain, ranks)
    else:
        calls["rle2_hist_text_32x901120"] = (rle2_then_hist, rle2_then_hist,
                                             ranks)
    calls["pack_groups_text_32x901120"] = (
        chain._pack_groups, getattr(chain, "_pack_groups_plain",
                                    chain._pack_groups),
        pack_args(bwt, ns, cmaps, primary.cpu().numpy())[0])
    # the suffix sorts on the text rows; a checkout from before their
    # kernels times its plain versions, which its main path ran
    rows_h, ns_h, _ = text_rows(text)
    rows_d, ns_d = (torch.from_numpy(a).to(dev) for a in (rows_h, ns_h))
    seed_plain = getattr(bwt2, "_seed16_plain", bwt2._seed16)
    pass_plain = getattr(bwt2, "_pass8_plain", bwt2._pass8)
    seed_isa = seed_plain(rows_d, ns_d)[0]
    calls["bwt2_seed16_text_32x901120"] = (bwt2._seed16, seed_plain,
                                           (rows_d, ns_d))
    calls["bwt2_pass8_text_32x901120"] = (
        lambda i, n: bwt2._pass8(i, 16, n),
        lambda i, n: pass_plain(i, 16, n), (seed_isa, ns_d))
    # the loop its main path runs, and on phase 19's other kinds of rows
    # (their random blocks from this run's shorter data) the seed and the
    # pass too
    cases = [("text_32x901120", rows_d, ns_d)] + [
        (case, *(torch.from_numpy(a).to(dev) for a in host[:2]))
        for case, host in bwt2_cases(data, text).items()
        if case != "text_32x901120"]
    none = torch.zeros(1, device=dev)
    for case, r, n in cases:
        if case != "text_32x901120":
            calls[f"bwt2_seed16_{case}"] = (bwt2._seed16, seed_plain, (r, n))
            calls[f"bwt2_pass8_{case}"] = (
                lambda i, m: bwt2._pass8(i, 16, m),
                lambda i, m: pass_plain(i, 16, m), (seed_plain(r, n)[0], n))
        if hasattr(bwt2, "_seed16_plain"):
            calls[f"bwt2_loop_{case}"] = (
                lambda i, m: (bwt2._resolve_loop(i, m), none),
                lambda i, m: (plain_loop(bwt2, i, m)[0], none), (r, n))
    # the emits on the text rows' ISA, the MTF byte entry on the text
    # batch and the flat compaction of its payload words; a checkout from
    # before their kernels has none of the four
    emit_ns = {}
    if hasattr(bwt2, "_emit_bytes_plain"):
        ea = (rows_d, bwt2._resolve_loop(rows_d, ns_d), ns_d,
              torch.from_numpy(text_rows(text)[2]).to(dev))
        sbwt = bwt2._emit_bytes(*ea)[0]
        lib = bwt2._emit_lib()
        calls["emit_bytes_text_32x901120"] = (
            bwt2._emit_bytes, bwt2._emit_bytes_plain, ea)
        calls["emit_tokens_text_32x901120"] = (
            lambda b, n: bwt2._tokens_cuda(lib, b, n), bwt2._tokens_plain,
            (sbwt, ns_d))
        emit_ns = {"emit_bytes_text_32x901120": ns_d,
                   "emit_tokens_text_32x901120": ns_d}
    if hasattr(mtf_pallas, "mtf_ranks_bytes_rows"):
        calls["mtf_ranks_bytes_text_32x901120"] = (
            mtf_pallas.mtf_ranks_bytes_rows, mtf_pallas.mtf_ranks_bytes_plain,
            (bwt, torch.from_numpy(cmaps).to(dev),
             torch.from_numpy(ns).to(dev)))
    if hasattr(chain, "_flatten_words_plain"):
        calls["flatten_words_text_32x901120"] = (
            chain._flatten_words, chain._flatten_words_plain,
            flatten_args(bwt, ns, cmaps, primary.cpu().numpy()))
    if hasattr(chain, "_pack_flat"):  # the packing and the compaction
        calls["pack_flat_text_32x901120"] = (
            chain._pack_flat, flat_plain,
            flat_args(bwt, ns, cmaps, primary.cpu().numpy()))
    try:  # the v1 rotation sort's modes; a checkout from before has none
        from lbzip2_tpu_torch.ops import bwt as v1
    except ImportError:
        v1 = None
    if v1 is not None:
        v1_rows, v1_ns = (torch.from_numpy(a).to(dev) for a in
                          v1_cases(data, text)["text_32x901120"])
        calls["bwt_cyclic_seed_text_32x901120"] = (
            v1._seed_cyclic, v1._seed_cyclic_plain, (v1_rows, v1_ns))
        calls["bwt_cyclic_pass_text_32x901120"] = (
            lambda i, m: v1._pass_cyclic(i, 16, m),
            lambda i, m: v1._pass_cyclic_plain(i, 16, m),
            (v1._seed_cyclic_plain(v1_rows, v1_ns)[0], v1_ns))
        calls["bwt_v1_batched_text_32x901120"] = (
            v1.bwt_batched, v1._bwt_rows_plain, (v1_rows, v1_ns))
        calls["bwt2_pass4_text_32x901120"] = (
            lambda i, m: bwt2.pass4(i, 16, m),
            lambda i, m: bwt2._passx_plain(i, 16, m, 4), (seed_isa, ns_d))
    res = {"package": os.path.dirname(mtf_pallas.__file__),
           "card": card_line(), "ms": {}, "max_abs_err": {}}
    for name, (kernel, plain, a) in calls.items():
        got, want = kernel(*a), plain(*a)
        torch.cuda.synchronize()
        if name.startswith(("bwt2", "bwt_cyclic")):  # ISA's lanes < n, cnt
            got, want = ((valid_lanes(x[0], a[-1]), x[1])
                         for x in (got, want))
        if name in emit_ns:
            res["max_abs_err"][name] = max(
                emit_errs(got, want, emit_ns[name]).values())
        else:
            res["max_abs_err"][name] = max_err_of(got, want)
        res["ms"][name] = cuda_ms(lambda: kernel(*a), 50 if name.startswith(
            ("code", "huff", "crc", "bitpack")) else 10)
        if profiled:
            res.setdefault("kernels_us", {})[name] = device_us(
                lambda: kernel(*a))
    sweep, sass, floor = sweep_record(
        full, res["ms"]["sort_sweeps_32x7040x128_sub4"], None,
        str(_build.BUILD / "libsort_sweeps.so"))
    res["records"] = {
        "huffdec": huffdec_record(timed, res["ms"]["huffdec_text_block"],
                                  None), "sort_sweeps": sweep}
    res["models"] = {"sort_sweeps_sass": sass, "sort_sweeps_alu_floor_ms":
                     floor, "huffdec_chain_floor_ms": chain_floor_ms()}
    first = ibwt.ibwt_rows(*calls["ibwt_text_8x901120"][2])[0, :BLOCK]
    assert first.cpu().numpy().tobytes() == text[:BLOCK], \
        "the inverse BWT of a text row is not the block"
    # the EM loop of the text batch, and the batch's whole entropy chain
    want = em_plain(text_args, 8)
    if hasattr(huffenc, "em_chain_rows"):
        res["em_loop"] = "em_chain_rows: the EM kernels"

        def loop():
            return huffenc.em_chain_rows(*text_args, 8)
    else:
        res["em_loop"] = "_em_chain: plain E-steps, the M-step kernel"

        def loop():
            return em_plain(text_args, 8, plain_mstep=False)
    got = loop()
    torch.cuda.synchronize()
    res["max_abs_err"]["em_text_32_rows"] = max(
        max_err_of(g, w.to(dev)) for g, w in zip(got, want))
    res["ms"]["em_text_32_rows"] = cuda_ms(loop, 5)
    res["em_iters"] = int(got[3])
    if profiled:
        res["kernels_us"]["em_text_32_rows"] = device_us(loop, 2)
    del got, want

    def peak_over(fn) -> int:
        """Peak of device memory during fn above what was held before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - held

    put = [torch.from_numpy(a).to(dev) for a in (ns, cmaps)]
    res["peak_bytes"] = {
        "chain_mtf2": peak_over(lambda: chain._chain_mtf2(bwt, *put)),
        "em_loop": peak_over(loop)}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    outs = chain._chain_mtf2(bwt, *put)
    torch.cuda.synchronize()
    res["chain_mtf2_outputs_bytes"] = torch.cuda.memory_allocated(dev) - held
    del outs
    idxs = primary.cpu().numpy().astype(np.int32)
    stages: dict = {}
    for _ in range(2):  # the second run is warm
        t0 = time.time()
        res["peak_bytes"]["chain_payloads"] = peak_over(
            lambda: chain.chain_payloads(bwt, ns, cmaps, idxs,
                                         np.zeros(ROWS, np.uint32),
                                         times=stages))
        res["chain_payloads_text_batch_s"] = time.time() - t0
    res["chain_stages"] = stages
    print(json.dumps(res), flush=True)
    assert not any(res["max_abs_err"].values()), "a kernel disagrees"
    return 0


def stream_runs(data: bytes, ref: bytes, dev) -> dict:
    """The stream through the package on the path as a user runs it.
    Compress in the shipped default (host stealing and steal-back on)
    four times, the first not kept (the process's first call may be
    cold), then once device-only (stealing off, as the rest of the smoke
    runs), then in token mode device-only (warm_device of the mode, then
    four times, the first not kept), each equal to ``ref`` (bin/lbzip2
    -9), each run with its batches' dispatch, ready and expand seconds
    summed; then
    decompress_parallel three times and decompress_stream once with both
    device stages on, and the host C path, each equal to the data; per
    run its MB/s, the engines' block counts, every batch's times and the
    decoder's stats (its stage seconds); each compress run's peak of
    device memory; each decompress_parallel run's process_state before
    it and the segments it allocated."""
    from lbzip2_tpu_torch.codec import encoder
    from lbzip2_tpu_torch.ops import huffdec, ibwt
    from lbzip2_tpu_torch.parallel import decode

    res = {"package": os.path.dirname(encoder.__file__), "card": card_line(),
           "bytes": len(data), "compress": [], "decompress": []}
    batch_keys = ("rows", "claimed_t", "claim_s", "prep_s", "dispatch_s",
                  "ready_s", "expand_s", "done_t", "bwt2_passes",
                  "chain_stages")

    def allocator():
        """The caching allocator's cudaMalloc calls, cudaFree calls and
        retries (a retry frees the cache and synchronizes) so far."""
        st = torch.cuda.memory_stats(dev)
        return {k: st.get(k, 0) for k in ("num_device_alloc",
                                          "num_device_free",
                                          "num_alloc_retries")}

    def compress_turns(config: str, turns: int, keep_first: bool):
        for turn in range(turns):
            torch.cuda.reset_peak_memory_stats(dev)
            before = allocator()
            t0 = time.time()
            out = encoder.compress(data, 9, device=dev)
            dt = time.time() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            grown = {k: v - before[k] for k, v in allocator().items()}
            st = encoder.last_stats
            assert out == ref, f"compress ({config}) differs from " \
                "bin/lbzip2 -9"
            if turn == 0 and not keep_first:
                continue  # the first call of the process or mode is cold
            batches = [{k: t.get(k) for k in batch_keys}
                       for t in st["batch_trace"]]
            res["compress"].append({
                "config": config, "s": dt, "mbps": len(data) / dt / 1e6,
                "peak_bytes": peak, "allocator": grown,
                **{k: st[k] for k in ("device_blocks", "host_blocks",
                                      "stale_rows")},
                **{f"sum_{k}": round(sum(t.get(k) or 0 for t in batches), 3)
                   for k in ("dispatch_s", "ready_s", "expand_s")},
                "batches": batches})

    for steal, turns in ((True, 4), (False, 1)):
        encoder._HOST_STEAL = encoder._STEALBACK = steal
        compress_turns("default" if steal else "device_only", turns,
                       not steal)
    # token mode (ROADMAP F10), device-only as phase 7's child runs it:
    # the pool reads the mode when it is made; warm the mode's device path
    # first, then three kept turns after a cold one
    chain_mode = encoder._DEVICE_CHAIN
    encoder._DEVICE_CHAIN = False
    try:
        res["token_warm_device_s"] = encoder.warm_device(device=dev)
        compress_turns("token_device_only", 4, False)
    finally:
        encoder._DEVICE_CHAIN = chain_mode
    out = ref  # what every compress run above gave

    def process_state():
        """What a decode run may find left behind in the process: the
        caching allocator's reserved bytes and segments (cudaMalloc calls
        so far), and the live Python threads."""
        st = torch.cuda.memory_stats(dev)
        return {"reserved_bytes": st.get("reserved_bytes.all.current", 0),
                "segments": st.get("segment.all.allocated", 0),
                "threads": threading.active_count()}

    for huff_ibwt, runs in ((True, 3), (False, 1)):
        decode.DEVICE_HUFF = decode.DEVICE_IBWT = huff_ibwt
        for _ in range(runs):
            huffdec.launches = ibwt.launches = 0
            before = process_state()
            t0 = time.time()
            assert decode.decompress_parallel(out, device=dev) == data
            dt = time.time() - t0
            after = process_state()
            res["decompress"].append({
                "entry": "decompress_parallel",
                "stages": "device" if huff_ibwt else "host_c", "s": dt,
                "mbps": len(data) / dt / 1e6,
                "huffdec_launches": huffdec.launches,
                "ibwt_launches": ibwt.launches, "before": before,
                "new_segments": after["segments"] - before["segments"],
                **decode.last_stats})
        if not huff_ibwt:
            continue
        parts, view, cursor = [], memoryview(out), [0]

        def read_chunk(n):
            chunk = view[cursor[0]:cursor[0] + n]
            cursor[0] += len(chunk)
            return bytes(chunk)
        t0 = time.time()
        decode.decompress_stream(read_chunk, parts.append, device=dev)
        dt = time.time() - t0
        assert b"".join(parts) == data, "decompress_stream differs"
        res["decompress"].append({
            "entry": "decompress_stream", "stages": "device", "s": dt,
            "mbps": len(data) / dt / 1e6, **decode.last_stats})
    decode.DEVICE_HUFF = decode.DEVICE_IBWT = False
    return res


def stream_tree(seed: int, dev) -> int:
    """--measure --tree DIR: the per-op table of one text batch at 32,
    16 and 8 rows (op_table), the device's busy time over one device-only compress of
    the phase-6 stream under torch.profiler, then stream_runs on that
    stream as one JSON line, all with the package of DIR."""
    from lbzip2_tpu_torch.codec import encoder

    data, text = make_data(seed)
    ref = host_reference(data)
    warm = encoder.warm_device(device=dev)
    _, batch = mtf_timed_cases(text, dev)
    for nrows in (ROWS, 16, 8):  # the engine's three claim sizes
        op_table(text, batch, dev, nrows)
    del batch
    encoder._HOST_STEAL = encoder._STEALBACK = False
    encoder.compress(data, 9, device=dev)  # warm
    assert idle_share("compress, chain mode, device-only", lambda:
                      encoder.compress(data, 9, device=dev)) == ref
    print(json.dumps({"warm_device_s": warm, **stream_runs(data, ref, dev)}),
          flush=True)
    return 0


CRC_LIMIT = 8 << 20  # the CRC kernel's widest block (JAX's 18 levels)


BENCH_SIZE = 56 * 900_000  # the device's first claim lands well before
                           # the host ends the stream (at 16 blocks it
                           # did not: the device took none)


def bench_phase() -> None:
    """Phase 23: the port's benchmark at 56 blocks in a child process,
    in the shipped default (the switches this smoke sets removed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("LBZ2_")}
    t0 = time.time()
    r = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py"),
                        "--size", str(BENCH_SIZE), "--seed", "0"],
                       capture_output=True, text=True, env=env, cwd=root,
                       timeout=900)
    sys.stderr.write(r.stderr)
    assert r.returncode == 0, f"bench_torch.py exited {r.returncode}"
    line = r.stdout.strip().splitlines()[-1]
    log(f"bench_torch.py --size {BENCH_SIZE}: {time.time() - t0:.1f} s, "
        f"{line}")
    head = json.loads(line)
    assert head["bit_identical_1_5_9"] is True, "bench: level parity failed"
    rates = {k: v for k, v in head.items() if k.endswith("_MBps")}
    assert len(rates) == 6 and all(
        isinstance(v, (int, float)) and v > 0 for v in rates.values()), \
        f"bench: a rate is not positive: {rates}"
    assert head["device"]["name"], "bench: no card name"
    with open(os.path.join(root, "bench_torch_telemetry.json")) as fh:
        tele = json.load(fh)
    took = {"chain": tele["chain"]["stats"]["device_blocks"],
            "token": tele["token"]["stats"]["device_blocks"],
            **{f"parity_{lvl}": tele["level_parity"][lvl]["device_blocks"]
               for lvl in ("5", "9")}}
    log(f"bench: device blocks {took}")
    assert all(n > 0 for n in took.values()), \
        f"bench: the device took no block in a leg: {took}"


def crc_phase(text: bytes, dev) -> dict:
    """14. The CRC kernel against its plain version and the host CRC."""
    from lbzip2_tpu_torch.core import crc32
    from lbzip2_tpu_torch.ops import crc

    rng = np.random.default_rng(14)
    cases = {f"n{n}_N16384": (torch.from_numpy(
        rng.integers(0, 256, 16384, dtype=np.uint8)).to(dev), n)
        for n in (0, 1, 31, 32, 33, 9999)}
    cases["n900000_N901632"] = (torch.from_numpy(
        rng.integers(0, 256, 901632, dtype=np.uint8)).to(dev), 900000)
    textblk = torch.from_numpy(np.frombuffer(text[:WIDTH],
                                             np.uint8).copy()).to(dev)
    cases["text_901120"] = (textblk, WIDTH)
    big = torch.from_numpy(rng.integers(0, 256, CRC_LIMIT + 64,
                                        dtype=np.uint8)).to(dev)
    cases["n8MiB"] = (big[:CRC_LIMIT], CRC_LIMIT)
    # tests/test_torch_crc_segments.py's cases (N = 1 MiB, n at the small
    # edges and one byte before, at and after a segment boundary, garbage
    # past n, the block at byte offset 3 of a larger buffer), then blocks
    # at odd offsets of the 8 MiB buffer, n about its segment boundaries
    mib = 1 << 20
    s1, s8 = crc._seg_bytes(mib), crc._seg_bytes(CRC_LIMIT)
    for n, a in ((0, 0), (1, 0), (15, 0), (16, 0), (17, 0), (5 * s1 - 1, 0),
                 (5 * s1, 0), (5 * s1 + 1, 0), (mib, 0), (700001, 0),
                 (17, 3), (5 * s1 + 1, 3), (mib, 3)):
        cases[f"n{n}_N1MiB_at{a}"] = (big[a:a + mib], n)
    for a, n in ((1, CRC_LIMIT), (7, 100 * s8 - 1), (15, 100 * s8 + 1),
                 (5, 3 * s8), (9, CRC_LIMIT - 1000)):
        cases[f"n{n}_N8MiB_at{a}"] = (big[a:a + CRC_LIMIT], n)
    max_err = 0
    for name, (b, n) in cases.items():
        reg = crc.crc32_device(b, n)
        err = max_err_of(reg, crc.crc32_plain(b, n))
        stored = crc32.crc_finalize(
            int(reg) ^ crc32._OPS.advance_scalar(crc32.INIT, n))
        assert stored == crc32.crc_of(b[:n].cpu().numpy()), \
            f"crc {name}: stored CRC"
        max_err = max(max_err, err)
        log(f"crc kernel vs plain [{name}]: max_abs_err {err}, stored "
            f"{stored:#010x}, address mod 16 {b.data_ptr() % 16}")
        assert err == 0, f"CRC kernel disagrees with plain on {name}"
    assert crc.crc32_block_device(textblk.cpu().numpy(), WIDTH,
                                  device=dev) == crc32.crc_of(text[:WIDTH]), \
        "crc32_block_device"
    # two calls on two streams, neither waited for: the second call's
    # slots and ticket are the first's, held (ops/lookback.py)
    one, two = cases["n8MiB"], cases[f"n{5 * s1 + 1}_N1MiB_at3"]
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        r1 = crc.crc32_device(*one)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        r2 = crc.crc32_device(*two)
    torch.cuda.synchronize()
    assert max_err_of(r1, crc.crc32_plain(*one)) == 0 and \
        max_err_of(r2, crc.crc32_plain(*two)) == 0, "CRC on two streams"
    torch.cuda.set_sync_debug_mode("error")  # no host read
    try:
        crc.crc32_device(textblk, WIDTH)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ran = launched_kernels(lambda: crc.crc32_device(textblk, WIDTH),
                           {"crc_segments": ("crc_segments",)})
    log(f"crc32: device kernels of 3 calls {json.dumps(ran)}")
    ms_k = cuda_ms(lambda: crc.crc32_device(textblk, WIDTH), 200)
    ms_p = cuda_ms(lambda: crc.crc32_plain(textblk, WIDTH), 3)
    us = device_us(lambda: crc.crc32_device(textblk, WIDTH))
    b8 = cases["n8MiB"][0]
    ms_k8 = cuda_ms(lambda: crc.crc32_device(b8, CRC_LIMIT), 100)
    ms_p8 = cuda_ms(lambda: crc.crc32_plain(b8, CRC_LIMIT), 2)
    us8 = device_us(lambda: crc.crc32_device(b8, CRC_LIMIT))
    log(f"crc32 (901120-byte text block): kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.3f} ms; device us {json.dumps(us)}; 8 MiB: kernel "
        f"{ms_k8:.4f} ms, plain {ms_p8:.3f} ms, device us "
        f"{json.dumps(us8)}")
    # the block read once and the register written; one lookup a byte
    return {"name": "crc32", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/crc32.cu",
            "replaces": "lbzip2_tpu/ops/crc.py:49", "launches": 0,
            "max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_p,
            "device_us": us, "kernels_a_call": ran,
            **bound(WIDTH + 8, WIDTH),
            "ms_8MiB": ms_k8, "plain_ms_8MiB": ms_p8, "device_us_8MiB": us8,
            "bound_ms_8MiB": bound(CRC_LIMIT + 8, CRC_LIMIT)["bound_ms"]}


def pack_groups_fields(batch, dev):
    """The fields one text block's ``_pack_groups`` packs: a zero field
    of start_bit bits, then every code of every valid group; and that
    call's words and total bits.  Taken from chain_payloads on row 0 of
    the BWT batch (bwt, ns, cmaps, primary)."""
    from lbzip2_tpu_torch.core.constants import GROUP_SIZE
    from lbzip2_tpu_torch.interop import M32

    bwt, ns, cmaps, primary = batch
    args, (words, total) = pack_args(bwt[:1].contiguous(), ns[:1],
                                     cmaps[:1], primary[:1].cpu().numpy())
    mtfv, nm, ninuse, ngroups, sel, codes, lens, start_bit, _ = args
    NP = mtfv.shape[1]
    G = -(-NP // GROUP_SIZE)
    lanes = torch.arange(G * GROUP_SIZE, device=dev)
    padded = torch.nn.functional.pad(mtfv[0], (0, G * GROUP_SIZE - NP))
    padded = torch.where(lanes < nm[0], padded, ninuse[0] + 2)
    g = int(ngroups[0])
    groups = padded.reshape(G, GROUP_SIZE)[:g].long()
    tree = sel[0, :g].long()[:, None]
    values = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        codes[0][tree, groups].reshape(-1).long()])
    nbits = torch.cat([start_bit[:1].int(),
                       lens[0][tree, groups].reshape(-1).int()])
    return (values.contiguous(), nbits.contiguous(),
            words[0].long() & M32, int(total[0]))


def bitpack_tile_cases(rng, dev) -> dict:
    """tests/test_torch_bitpack_tiles.py's cases at 8192 fields: tile
    edges 7 bits into a word and on a word edge, zero-length fields at
    the tiles' ends, a tile of no bits, all 32-bit fields, nf < N, one
    field, nf = 0 (random values, garbage past nf)."""
    from lbzip2_tpu_torch.ops import bitpack

    N, tile, out = 8192, bitpack._TILE, {}
    for name in ("mid_word", "word_edge", "zero_at_tile_ends", "empty_tile",
                 "all_32_bits", "nf_below_n", "one_field", "nf_zero"):
        lens = rng.integers(0, 33, N).astype(np.int32)
        vals = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.int64)
        nf = N
        if name in ("mid_word", "word_edge"):
            lens[:] = 5
            lens[0] = 7 if name == "mid_word" else 5
        elif name == "zero_at_tile_ends":
            for c in range(1, N // tile):
                lens[c * tile - 5:c * tile + 5] = 0
            lens[:3] = lens[-3:] = 0
        elif name == "empty_tile":
            lens[tile:2 * tile] = 0
            lens[tile - 1] = lens[2 * tile] = 3
        elif name == "all_32_bits":
            lens[:] = 32
        elif name == "nf_below_n":
            nf = 3 * tile + 77
        elif name == "one_field":
            nf, lens[0] = 1, 13
        elif name == "nf_zero":
            nf = 0
        out[f"{name}_8192"] = (torch.from_numpy(vals).to(dev),
                               torch.from_numpy(lens).to(dev), nf)
    return out


def bitpack_phase(batch, dev) -> dict:
    """15. The bit packer against its plain version, and on one text
    block's Huffman fields against that block's ``_pack_groups``."""
    from lbzip2_tpu_torch.ops import bitpack

    rng = np.random.default_rng(15)
    N = 100_000
    lens = rng.integers(0, 33, N).astype(np.int32)
    vals = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.int64)
    zero = np.where(rng.random(N) < 0.9, 0, lens).astype(np.int32)
    cases = {"random_0_to_32_bits": (vals, lens, N - 7),
             "zero_length_fields": (vals, zero, N),
             "full_width_fields": (vals, np.full(N, 32, np.int32), N),
             "one_field": (vals[:1], lens[:1] | 1, 1)}
    cases = {k: (torch.from_numpy(v).to(dev), torch.from_numpy(ln).to(dev),
                 nf) for k, (v, ln, nf) in cases.items()}
    values, nbits, words_want, total_want = pack_groups_fields(batch, dev)
    cases["huffman_text_block"] = (values, nbits, values.numel())
    cases.update(bitpack_tile_cases(rng, dev))
    # fields at odd offsets of larger buffers (the scalar loads)
    M = 4_194_304
    v4 = torch.from_numpy(rng.integers(0, 1 << 32, M + 8, dtype=np.uint64)
                          .astype(np.int64)).to(dev)
    l4 = torch.from_numpy(rng.integers(0, 33, M + 8).astype(np.int32)
                          ).to(dev)
    cases["random_100001_at1"] = (v4[1:100002], l4[1:100002], 100001)
    cases["random_100001_at3_nf_half"] = (v4[3:100004], l4[3:100004], 50000)
    n = values.numel()
    hv = torch.zeros(n + 5, dtype=torch.int64, device=dev)
    hl = torch.zeros(n + 5, dtype=torch.int32, device=dev)
    hv[5:], hl[5:] = values, nbits
    cases["huffman_text_block_at5"] = (hv[5:], hl[5:], n)
    cases["random_4194304"] = (v4[:M], l4[:M], M)
    max_err = 0
    for name, (v, ln, nf) in cases.items():
        got = bitpack.pack_bits_device(v, ln, nf)
        err = max_err_of(got, bitpack.pack_bits_plain(v, ln, nf))
        max_err = max(max_err, err)
        log(f"bitpack kernel vs plain [{name}]: {v.numel()} fields, nf "
            f"{nf}, {int(got[1])} bits, max_abs_err {err}")
        assert err == 0, f"bitpack kernel disagrees with plain on {name}"
    words, total = bitpack.pack_bits_device(values, nbits, n)
    nw = -(-total_want // 32)
    assert int(total) == total_want and torch.equal(
        words[:nw], words_want[:nw]) and not words[nw:].any(), \
        "the packed Huffman fields differ from _pack_groups"
    # two calls on two streams, neither waited for: the second call's
    # descriptors and ticket are the first's, held (ops/lookback.py)
    one, two = cases["random_4194304"], cases["huffman_text_block_at5"]
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        g1 = bitpack.pack_bits_device(*one)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        g2 = bitpack.pack_bits_device(*two)
    torch.cuda.synchronize()
    assert max_err_of(g1, bitpack.pack_bits_plain(*one)) == 0 and \
        max_err_of(g2, bitpack.pack_bits_plain(*two)) == 0, \
        "bit packer on two streams"
    torch.cuda.set_sync_debug_mode("error")  # no host read
    try:
        bitpack.pack_bits_device(values, nbits, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ran = launched_kernels(
        lambda: bitpack.pack_bits_device(values, nbits, n),
        {"pack_scan": ("pack_scan",),
         "zero fill": ("FillFunctor", "Memset", "memset")})
    log(f"bitpack: device kernels of 3 calls {json.dumps(ran)}")
    ms_k = cuda_ms(lambda: bitpack.pack_bits_device(values, nbits, n), 50)
    ms_p = cuda_ms(lambda: bitpack.pack_bits_plain(values, nbits, n), 5)
    us = device_us(lambda: bitpack.pack_bits_device(values, nbits, n))
    ms_k4 = cuda_ms(lambda: bitpack.pack_bits_device(v4[:M], l4[:M], M), 50)
    ms_p4 = cuda_ms(lambda: bitpack.pack_bits_plain(v4[:M], l4[:M], M), 3)
    us4 = device_us(lambda: bitpack.pack_bits_device(v4[:M], l4[:M], M))
    log(f"bitpack ({n} Huffman fields of a text block, {total_want} bits, "
        f"the same words as _pack_groups): kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.3f} ms; device us {json.dumps(us)}; {M} random fields of "
        f"0 to 32 bits: kernel {ms_k4:.4f} ms, plain {ms_p4:.3f} ms, "
        f"device us {json.dumps(us4)}")
    # values int64 and lengths int32 in, int64 words and the total out;
    # a field takes at least one operation
    return {"name": "bitpack", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/bitpack.cu",
            "replaces": "lbzip2_tpu/ops/bitpack.py:31", "launches": 0,
            "max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_p,
            "device_us": us, "kernels_a_call": ran,
            **bound(n * (8 + 4 + 8) + 4, n), "ms_4194304": ms_k4,
            "plain_ms_4194304": ms_p4, "device_us_4194304": us4,
            "bound_ms_4194304": bound(M * (8 + 4 + 8) + 4, M)["bound_ms"]}


def bwt2_rows(blocks: list, width: int):
    """Lyndon rows of byte blocks at ``width``, an empty block a row of
    n = 0: (rows, ns, ms) on the host."""
    from lbzip2_tpu_torch import native

    rows = np.zeros((len(blocks), width), np.uint8)
    ns = np.array([b.size for b in blocks], np.int32)
    ms = np.zeros(len(blocks), np.int32)
    for r, blk in enumerate(blocks):
        if blk.size:
            _, ms[r] = native.lyndon_prep(blk, out=rows[r, :blk.size])
    assert (ms >= 0).all(), "a periodic block among the BWT cases"
    return rows, ns, ms


def text_rows(text: bytes):
    """The first 32 text blocks as Lyndon rows at (32, 901120)."""
    tb = np.frombuffer(text, np.uint8)
    return bwt2_rows([tb[(r * BLOCK) % tb.size:][:BLOCK]
                      for r in range(ROWS)], WIDTH)


def bwt2_cases(data: bytes, text: bytes) -> dict:
    """Phase 19's inputs, name -> (rows, ns, ms) on the host: the text
    rows, the stream's uniform random, 16-value and random-run blocks,
    deep repeats (periods 1 to 450,560) and an (8, 8192) bucket with
    n = 0, 1, 2 and N among its rows, whose blocks come fourth."""
    tail = np.frombuffer(data[-3 * BLOCK:], np.uint8)
    rng, small = np.random.default_rng(19), np.random.default_rng(20)
    deep = []
    for n, p in ((BLOCK, 256), (BLOCK, 7), (BLOCK * 7 // 9, 1),
                 (WIDTH, WIDTH // 2), (BLOCK * 5 // 9, 33)):
        b = np.tile(rng.integers(0, 256, p, np.uint8), n // p + 1)[:n].copy()
        b[-1] ^= 1  # keep primitive
        deep.append(b)
    bucket = [small.integers(0, 256, n, np.uint8)
              for n in (0, 1, 2, 8192, 100, 8191, 3)]
    # 16 values, FF FF FF FF 01 first, 00 00 at 1000: the seed leaves no
    # tie and ranks the first suffix past the pads (ops/bwt2.py's
    # _resolve_loop)
    ff = (small.integers(0, 16, 6000) + 0x40).astype(np.uint8)
    ff[:5] = (0xFF, 0xFF, 0xFF, 0xFF, 1)
    ff[1000:1002] = 0
    return {
        "text_32x901120": text_rows(text),
        "random_uniform_16_runs": bwt2_rows(
            [tail[i * BLOCK:(i + 1) * BLOCK] for i in range(3)], WIDTH),
        "deep_repeats": bwt2_rows(deep, WIDTH),
        "bucket_8x8192": bwt2_rows(bucket + [ff], 8192) + (bucket + [ff],)}


def valid_lanes(isa, ns):
    """The ISA with its lanes at and past n set to 0: the kernels define
    the lanes < n only."""
    lane = torch.arange(isa.shape[1], device=isa.device)
    return torch.where(lane[None] < ns.long()[:, None], isa, 0)


def sort_library_ms(dev) -> float:
    """One torch.sort(stable=True) of a (32, 901120) int64 key (its
    indices the payload): the library call that computes a radix pass's
    sort."""
    gen = torch.Generator(device=dev).manual_seed(3)
    key = torch.randint(0, 2 ** 62, (ROWS, WIDTH), generator=gen,
                        device=dev, dtype=torch.int64)
    return cuda_ms(lambda: torch.sort(key, dim=1, stable=True), 10)


def plain_loop(bwt2, rows, ns):
    """The resolve loop on the plain suffix sorts, on rows' device:
    (ISA, passes (B,) int32), a row's passes counted as the kernels'
    loop counts them: the first, then one for each pass before that left
    the row a tie."""
    isa, cnt = bwt2._pass8_plain(bwt2._seed16_plain(rows, ns)[0], 16, ns)
    passes = torch.ones(rows.shape[0], dtype=torch.int32, device=rows.device)
    k = 128
    while int(cnt.max()) > 0:
        passes += (cnt > 0).int()
        isa, cnt = bwt2._pass8_plain(isa, k, ns)
        k *= 8
    return isa, passes


def bwt2_phase(data: bytes, text: bytes, dev) -> list:
    """19. The suffix-sort kernels (csrc/bwt2_sort.cu) against their
    plain versions on every case of bwt2_cases, tolerance 0 on the valid
    lanes of the ISA and on the counts: the seed, every pass of the
    resolve loop and one identity pass past it (which must give back its
    input); the whole loop on the card under
    torch.cuda.set_sync_debug_mode("error") (no host read), its ISA and
    each row's passes against the plain loop's; then bwt2_bytes' rows
    and primaries against the plain loop and emit (the bucket's also
    against the host C BWT); the classes the seed leaves, by the pass's
    size bins; CUDA-event times of both functions and of the loop
    against their plain versions on each case.  Returns the two kernel
    records."""
    from lbzip2_tpu_torch import native
    from lbzip2_tpu_torch.ops import bwt2

    errs = {"seed": 0, "pass": 0}
    times = {}
    for name, host in bwt2_cases(data, text).items():
        rows, ns, ms = (torch.from_numpy(a).to(dev) for a in host[:3])

        def check(which, got, want):
            e = max_err_of((valid_lanes(got[0], ns), got[1]),
                           (valid_lanes(want[0], ns), want[1]))
            errs[which] = max(errs[which], e)
            assert e == 0, f"bwt2 {which} kernel disagrees on {name}"

        isa, cnt = bwt2._seed16(rows, ns)
        check("seed", (isa, cnt), bwt2._seed16_plain(rows, ns))
        bins = bwt2.class_bins(isa, ns)
        runs = bwt2.seed_run_bins(rows, ns)
        seed_isa, k, passes = isa, 16, 0
        while True:  # the loop's passes (at least one), then one more
            out = bwt2._pass8(isa, k, ns)
            check("pass", out, bwt2._pass8_plain(isa, k, ns))
            if passes and int(cnt.max()) == 0:  # past the end: identity
                assert torch.equal(valid_lanes(out[0], ns),
                                   valid_lanes(isa, ns)) and \
                    int(out[1].max()) == 0, f"{name}: no identity pass"
                break
            isa, cnt = out
            k, passes = k * 8, passes + 1
            assert passes <= 8, f"{name}: the loop does not end"
        # the whole loop on the card: nothing may wait for the card
        want_isa, want_passes = plain_loop(bwt2, rows, ns)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop_isa = bwt2._resolve_loop(rows, ns)
            row_passes = bwt2.last_passes()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(valid_lanes(loop_isa, ns),
                           valid_lanes(want_isa, ns)), \
            f"{name}: the loop on the card differs from the plain loop"
        assert torch.equal(row_passes, want_passes) and \
            int(row_passes.max()) == passes, \
            f"{name}: the loop's passes {row_passes.tolist()} against " \
            f"{want_passes.tolist()}"
        # the emit reads byte n - 1 of a row: rows of n = 0 are never
        # shipped, and take no part here
        kept = torch.nonzero(ns > 0)[:, 0]
        rows1, ns1, ms1 = rows[kept], ns[kept], ms[kept]
        bwt_k, prim_k = bwt2.bwt2_bytes(rows1, ns1, ms1)
        bwt_p, prim_p = bwt2._emit_bytes(rows1, want_isa[kept], ns1, ms1)
        assert torch.equal(prim_k, prim_p) and torch.equal(
            valid_lanes(bwt_k, ns1), valid_lanes(bwt_p, ns1)), \
            f"bwt2_bytes with the kernels differs on {name}"
        if len(host) > 3:  # the bucket: also against the host C BWT
            for r, b in enumerate(x for x in host[3] if x.size):
                want_row, want_idx = native.bwt(b)
                assert int(prim_k[r]) == want_idx and np.array_equal(
                    bwt_k[r, :b.size].cpu().numpy(), want_row), \
                    f"bwt2_bytes differs from the host BWT, {name} row {r}"
        t = {"passes": passes,
             "seed_ms": cuda_ms(lambda: bwt2._seed16(rows, ns), 10),
             "seed_plain_ms": cuda_ms(lambda: bwt2._seed16_plain(rows, ns),
                                      3),
             "pass_ms": cuda_ms(lambda: bwt2._pass8(seed_isa, 16, ns), 10),
             "pass_plain_ms": cuda_ms(
                 lambda: bwt2._pass8_plain(seed_isa, 16, ns), 3),
             "loop_ms": cuda_ms(lambda: bwt2._resolve_loop(rows, ns), 5),
             "loop_plain_ms": cuda_ms(lambda: plain_loop(bwt2, rows, ns),
                                      2)}
        times[name] = t
        log(f"bwt2 kernels vs plain [{name}, {tuple(rows.shape)}]: equal "
            f"on the seed, {passes} passes and the identity pass, on the "
            f"loop under sync debug mode (passes a row "
            f"{row_passes.tolist()}) and on bwt2_bytes; the seed's runs of "
            f"equal first words, [lanes, runs] by bin: {json.dumps(runs)}; "
            f"after the seed, [lanes, classes] by bin: {json.dumps(bins)}; "
            f"{json.dumps(t)}")
    lib_ms = sort_library_ms(dev)
    log(f"bwt2: torch.sort(stable=True), (32, {WIDTH}) int64: "
        f"{lib_ms:.3f} ms; launches in this phase {bwt2.launches} "
        f"({bwt2.pass_launches} passes)")
    lanes = ROWS * WIDTH
    live = int(text_rows(text)[1].sum())

    def record(which, name, replaces, nbytes):
        text_t = times["text_32x901120"]
        return {"name": name, "route": "cuda",
                "source": "lbzip2_tpu_torch/csrc/bwt2_sort.cu",
                "replaces": replaces, "launches": 0,
                "max_abs_err": errs[which], "ms": text_t[f"{which}_ms"],
                "plain_ms": text_t[f"{which}_plain_ms"],
                "cases": {c: {k: v for k, v in t.items()
                              if k.startswith((which, "loop"))
                              or k == "passes"}
                          for c, t in times.items()},
                **bound(nbytes, live), "library_ms": lib_ms}

    # bytes once in and once out: the rows (uint8) or the ISA (int32) in,
    # the ISA and the counts out; a lane takes at least one operation
    return [record("seed", "bwt2_seed16", "lbzip2_tpu/ops/bwt2.py:81",
                   lanes + 4 * lanes + 8 * ROWS),
            record("pass", "bwt2_pass8", "lbzip2_tpu/ops/bwt2.py:125",
                   8 * lanes + 8 * ROWS)]


def reset_counts() -> None:
    """Set the launch counts of the kernels the sharded and engine paths
    run to 0, just before a path runs (read_counts just after)."""
    from lbzip2_tpu_torch.ops import (bwt, bwt2, chain, huffenc, ibwt,
                                      mtf_pallas, rle2)

    mtf_pallas.launches = huffenc.em_launches = huffenc.launches = 0
    ibwt.launches = bwt2.launches = bwt2.pass_launches = 0
    rle2.launches = chain.pack_launches = chain.flat_launches = 0
    bwt2.emit_launches = bwt2.token_launches = 0
    mtf_pallas.bytes_launches = chain.flatten_launches = 0
    bwt.seed_launches = bwt.pass_launches = bwt.tie_launches = 0
    bwt.emit_launches = 0


def read_counts() -> dict:
    from lbzip2_tpu_torch.ops import (bwt, bwt2, chain, huffenc, ibwt,
                                      mtf_pallas, rle2)

    return {"mtf_ranks": mtf_pallas.launches, "em_chain":
            huffenc.em_launches, "code_lengths": huffenc.launches,
            "ibwt": ibwt.launches,
            "bwt2_seed16": bwt2.launches - bwt2.pass_launches,
            "bwt2_pass8": bwt2.pass_launches, "rle2_hist": rle2.launches,
            "pack_groups": chain.pack_launches,
            "emit_bytes": bwt2.emit_launches,
            "emit_tokens": bwt2.token_launches,
            "mtf_ranks_bytes": mtf_pallas.bytes_launches,
            "pack_flat": chain.flat_launches,
            "bwt_cyclic_seed": bwt.seed_launches,
            "bwt_cyclic_pass": bwt.pass_launches,
            "bwt_tie_break": bwt.tie_launches,
            "bwt_emit_v1": bwt.emit_launches}


def sharded_phase(dev) -> dict:
    """16. dryrun_multichip over every card at 901120; then the sharded
    encode, token emit, chain and decode over [cuda:0, cuda:0] (two
    shards, a stream each, on one card) against the unsharded port and
    native.encode_payload, each path's wall in turns."""
    from lbzip2_tpu_torch import entry, native
    from lbzip2_tpu_torch.core import crc32
    from lbzip2_tpu_torch.ops import bwt2, chain, ibwt
    from lbzip2_tpu_torch.parallel import sharding

    count = torch.cuda.device_count()
    reset_counts()
    plain: dict = {}
    t0 = time.time()
    with plain_twins_counted(plain):
        res = entry.dryrun_multichip(count, dev.type, WIDTH)
    wall = time.time() - t0
    counts = read_counts()
    log(f"sharded: dryrun_multichip({count}) over {count} card(s) at "
        f"{WIDTH}: {wall:.2f} s, {json.dumps(res)}; launches "
        f"{json.dumps(counts)}; plain versions {json.dumps(plain)}")
    assert all(counts.values()) and not any(plain.values()), \
        f"the dry run missed a kernel of its path: {counts}, {plain}"
    blocks, ns, ms, raws, cmaps, rle_rows = entry.dryrun_blocks(4, WIDTH)
    cmaps = np.stack([np.asarray(c, np.uint8) for c in cmaps])
    crcs = np.asarray([crc32.crc_of(r) for r in raws], np.uint32)
    mesh = [dev, dev]

    def step(marks):
        """Mark the end of a step: its device work done."""
        torch.cuda.synchronize()
        marks.append(time.time())

    def sharded(marks):
        rows, prim = sharding.encode_batch_sharded_v2(blocks, ns, ms, mesh)
        step(marks)
        tok = sharding.encode_batch_sharded_tokens(blocks, ns, ms, mesh)
        step(marks)
        pay = chain.chain_payloads(rows, ns, cmaps, prim.astype(np.int32),
                                   crcs, mesh_axis=(mesh, sharding.AXIS))
        step(marks)
        dec = sharding.decode_batch_sharded(rows, ns, prim, mesh)
        step(marks)
        return rows, prim, tok, pay, dec

    def unsharded(marks):
        B = len(ns)
        up = [torch.from_numpy(a).to(dev) for a in (blocks, ns, ms)]
        packed, prim = bwt2.bwt2_full(*up)
        rows = packed.view(torch.uint8)
        step(marks)
        tok, raw, cnt, tprim = bwt2.bwt2_tokens(*up)
        tok = (tok.cpu().numpy().view(np.uint16).reshape(B, -1),
               cnt.cpu().numpy(), raw.cpu().numpy().view(np.uint8)
               .reshape(B, -1), tprim.cpu().numpy())
        step(marks)
        pay = chain.chain_payloads(rows, ns, cmaps, prim.cpu().numpy(),
                                   crcs)
        step(marks)
        dec = ibwt.ibwt_rows(rows, up[1], prim).cpu().numpy()
        step(marks)
        return (rows.cpu().numpy(), prim.cpu().numpy(), tok, pay, dec)

    steps = ("bwt2_full", "bwt2_tokens", "chain_payloads", "ibwt")
    walls = {"sharded_2x_cuda0": [], "unsharded_cuda0": []}
    outs = {}
    for i, name in enumerate(("sharded_2x_cuda0", "unsharded_cuda0",
                              "unsharded_cuda0", "sharded_2x_cuda0")):
        fn = sharded if name.startswith("sharded") else unsharded
        torch.cuda.synchronize()
        reset_counts()
        marks = [time.time()]
        with plain_twins_counted(plain):
            outs[name] = fn(marks)
        walls[name].append({"s": marks[-1] - marks[0], **{
            k: b - a for k, a, b in zip(steps, marks, marks[1:])}})
        if i == 0:  # the sharded chain ran the entropy kernels
            shard_counts = read_counts()
            assert all(shard_counts[k] for k in (
                "rle2_hist", "pack_groups", "emit_bytes", "emit_tokens",
                "mtf_ranks_bytes", "pack_flat")) and \
                not any(plain.values()), \
                f"the sharded chain missed a kernel: {shard_counts}, {plain}"
    (rows, prim, tok, pay, dec), (rows1, prim1, tok1, pay1, dec1) = \
        outs["sharded_2x_cuda0"], outs["unsharded_cuda0"]
    assert np.array_equal(prim, prim1) and np.array_equal(tok[3], prim1)
    assert np.array_equal(tok[1], tok1[1])
    for b in range(len(ns)):
        n = ns[b]
        assert np.array_equal(rows[b, :n], rows1[b, :n]), f"bwt row {b}"
        c = min(int(tok[1][b]), tok[0].shape[1])
        assert np.array_equal(tok[0][b, :c], tok1[0][b, :c]), f"tokens {b}"
        assert np.array_equal(tok[2][b, :n], tok1[2][b, :n]), f"raw {b}"
        want = bytes(native.encode_payload(rows[b, :n], cmaps[b],
                                           int(prim[b]), int(crcs[b]), 8))
        assert pay[b] == pay1[b] == want, f"payload row {b}"
        assert np.array_equal(dec[b, :n], dec1[b, :n]) and \
            np.array_equal(dec[b, :n], rle_rows[b]), f"decode row {b}"
    log(f"sharded over [cuda:0, cuda:0], 4 blocks at {WIDTH}: equal to the "
        f"unsharded port and native.encode_payload; launches of the first "
        f"sharded turn {json.dumps(shard_counts)}; walls (s, in turns) "
        f"{json.dumps(walls)}")
    assert not any(plain.values()), f"plain versions on the card: {plain}"
    return {"cards": count, "dryrun_s": wall, "dryrun": res,
            "launches": counts, "walls": walls}


def engine_cards_phase(data: bytes, ref: bytes, dev) -> dict:
    """17. compress with device="cuda": every visible card, batch i on
    card i mod D."""
    from lbzip2_tpu_torch.codec import encoder

    count = torch.cuda.device_count()
    reset_counts()
    plain: dict = {}
    t0 = time.time()
    with plain_twins_counted(plain):
        out = encoder.compress(data, 9, device=dev.type)  # every card
    dt = time.time() - t0
    counts = read_counts()
    devs = [t["dev"] for t in encoder.last_stats["batch_trace"]]
    log(f"engine on every card ({count}): {dt:.3f} s = "
        f"{len(data) / dt / 1e6:.3f} MB/s, batch devices {devs}, launches "
        f"{json.dumps(counts)}")
    assert out == ref, "compress over every card differs from bin/lbzip2"
    assert set(devs) == set(range(count)), f"cards driven: {set(devs)}"
    assert counts["mtf_ranks"] and counts["em_chain"] and \
        counts["bwt2_seed16"] and counts["bwt2_pass8"] and \
        counts["rle2_hist"] and counts["pack_groups"] and \
        counts["emit_bytes"] and counts["mtf_ranks_bytes"] and \
        counts["pack_flat"] and not any(plain.values()), (counts, plain)
    return {"cards": count, "s": dt, "batch_devs": devs, "launches": counts}


MULTIHOST_WORKER = r"""
import json, sys
import torch
from lbzip2_tpu_torch.ops import bwt2, chain, huffenc, mtf_pallas, rle2
from lbzip2_tpu_torch.parallel import multihost as MH
addr, pid, nproc, src, dst, dev = sys.argv[1:7]
pid, nproc = int(pid), int(nproc)
MH.initialize_distributed(addr, nproc, pid)
data = open(src, "rb").read()
a, b = MH.shard_bounds(len(data), 9, nproc, pid)
mtf_pallas.launches = huffenc.em_launches = bwt2.launches = 0
rle2.launches = chain.pack_launches = chain.flat_launches = 0
bwt2.emit_launches = mtf_pallas.bytes_launches = 0
out = MH.compress_multihost(data[a:b], 9, engine="hybrid", device=dev)
if pid == 0:
    open(dst, "wb").write(out)
print(json.dumps({"pid": pid, "shard": [a, b], "mtf_ranks":
                  mtf_pallas.launches, "em_chain": huffenc.em_launches,
                  "bwt2": bwt2.launches, "rle2_hist": rle2.launches,
                  "pack_groups": chain.pack_launches,
                  "emit_bytes": bwt2.emit_launches,
                  "mtf_ranks_bytes": mtf_pallas.bytes_launches,
                  "pack_flat": chain.flat_launches,
                  "stream": out is not None}), flush=True)
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multihost_phase(data: bytes, dev) -> dict:
    """18. compress_multihost in two child processes (gloo on
    localhost, engine "hybrid" on cuda:0, the point-to-point gather)
    over a four-block level-9 prefix: process 0's stream must equal the
    single-host compress of the same bytes."""
    import tempfile

    from lbzip2_tpu_torch.codec import encoder

    prefix = data[:4 * BLOCK]
    single = encoder.compress(prefix, 9, device=dev)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out.bz2")
        with open(src, "wb") as f:
            f.write(prefix)
        addr = f"127.0.0.1:{free_port()}"
        env = {**os.environ, "LBZ2_MULTIHOST_PORT": str(free_port()),
               "LBZ2_MULTIHOST_EXCHANGE": "p2p"}
        env.pop("LBZ2_HOST0_ADDR", None)
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-c", MULTIHOST_WORKER, addr, str(i), "2", src,
             dst, str(dev)], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for i in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        recs = []
        for p, (so, se) in zip(procs, outs):
            assert p.returncode == 0, \
                f"multihost child exited {p.returncode}: " \
                f"{se.decode()[-3000:]}"
            recs.append(json.loads(so.decode().strip().splitlines()[-1]))
        with open(dst, "rb") as f:
            stream = f.read()
    log(f"multihost: 2 processes, {len(prefix)} bytes, {wall:.2f} s; "
        f"{json.dumps(recs)}")
    assert stream == single, "the two-process stream differs from one host"
    assert bz2.decompress(stream) == prefix
    assert all(r["mtf_ranks"] and r["em_chain"] and r["bwt2"] and
               r["rle2_hist"] and r["pack_groups"] and r["emit_bytes"] and
               r["mtf_ranks_bytes"] and r["pack_flat"] for r in recs), \
        f"a process's shard missed the card's kernels: {recs}"
    return {"s": wall, "processes": recs}


def chain_call_args(bwt, ns, cmaps, idxs) -> dict:
    """The packing calls chain_payloads makes on a BWT batch (bwt on the
    card; ns, cmaps, idxs on the host), their arguments by name:
    "_pack_flat" on its flat branch (the packing's arguments, the rows'
    word ends, F); "_pack_groups" and "_flatten_words" in a checkout from
    before the flat pack."""
    from lbzip2_tpu_torch.ops import chain

    names = [k for k in ("_pack_flat", "_pack_groups", "_flatten_words")
             if hasattr(chain, k)]
    real = {k: getattr(chain, k) for k in names}
    got = {}

    def spy(name):
        def call(*a):
            got[name] = a
            return real[name](*a)
        return call

    try:
        for k in names:
            setattr(chain, k, spy(k))
        chain.chain_payloads(bwt, ns, cmaps, np.asarray(idxs, np.int32),
                             np.zeros(len(ns), np.uint32))
    finally:
        for k, fn in real.items():
            setattr(chain, k, fn)
    return got


def pack_args(bwt, ns, cmaps, idxs) -> tuple:
    """The packing arguments chain_payloads gives _pack_groups (or the
    first nine of _pack_flat's) on a BWT batch, and _pack_groups' output
    on them."""
    from lbzip2_tpu_torch.ops import chain

    got = chain_call_args(bwt, ns, cmaps, idxs)
    args = got["_pack_flat"][:9] if "_pack_flat" in got else \
        got["_pack_groups"]
    return args, chain._pack_groups(*args)


@contextlib.contextmanager
def plain_twins_counted(counts: dict):
    """Count the calls of the plain versions of the main path's kernels
    while the block runs: the EM loop, its E-step and stand-alone M-step,
    the RLE2, its flat histogram, the group packing, the BWT's emits, the
    compaction of the MTF's byte load and the flat payload compaction.
    A path on the card makes none; nor does the v1 rotation sort's, of
    its plain twins."""
    from lbzip2_tpu_torch.ops import (bwt, bwt2, chain, huffenc, mtf_pallas,
                                      rle2)

    saved = []
    for mod, name in ((huffenc, "_em_chain"), (chain, "_em_estep_hist"),
                      (huffenc, "make_code_lengths_rows"),
                      (rle2, "_rle2_plain"), (rle2, "_flat_hist"),
                      (chain, "_pack_groups_plain"),
                      (bwt2, "_emit_bytes_plain"), (bwt2, "_emit2_plain"),
                      (bwt2, "_tokens_plain"), (mtf_pallas, "_compact_syms"),
                      (mtf_pallas, "mtf_ranks_bytes_plain"),
                      (chain, "_flatten_words_plain"),
                      (bwt, "_bwt_rows_plain"), (bwt, "_seed_cyclic_plain"),
                      (bwt, "_pass_cyclic_plain"),
                      (bwt, "_emit_sparse_plain")):
        fn = getattr(mod, name)
        counts.setdefault(name, 0)

        def call(*a, _name=name, _fn=fn, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(mod, name, call)
        saved.append((mod, name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def entropy_edge_rows():
    """Synthetic RLE2 rows for each place a run meets a tile edge, as host
    (ranks, ns, ninuse): (8, 65536) rows and (4, 901120) full-width ones."""
    rng = np.random.default_rng(20)
    N = 65536
    r = rng.integers(1, 256, (8, N)).astype(np.int32)
    p = 3
    for j in range(1, 17):  # runs of 2^j - 2, 2^j - 1 and 2^j, one after
        for k in (2 ** j - 2, 2 ** j - 1, 2 ** j):  # another
            r[1, p:p + k] = 0
            p += k + 1
    r[2, 4000:4000 + 3 * 4096 + 5] = 0  # a run over three tiles
    r[3, 30000:] = 0  # a run that touches n = 50000
    r[4, 12345:] = rng.integers(INT32_MIN, INT32_MAX, N - 12345)  # past n
    r[4, :12345] = np.where(rng.random(12345) < 0.6, 0, r[4, :12345])
    r[5] = rng.integers(INT32_MIN, INT32_MAX, N)  # n = 0: nothing read
    r[6, 0] = 0  # n = 1, one zero
    r[0] = 0  # one run of N
    # row 7: n = 4096, every rank nonzero: the EOB at lane 4096, past the
    # first tile
    ns = np.array([N, N, N, 50000, 12345, 0, 1, 4096], np.int32)
    nu = np.array([1, 255, 200, 256, 90, 3, 1, 256], np.int32)
    F = WIDTH
    w = np.zeros((4, F), np.int32)
    w[2] = rng.integers(1, 256, F)
    w[3] = np.where(rng.random(F) < 0.9, 0, rng.integers(1, 256, F))
    # look-back stress: all-zero ranks at n = N (one zero run across every
    # tile: a look-back that meets only aggregates carries it), one
    # nonzero then a run of N - 1, rows of n = 0, 1 and 2
    lb = np.zeros((5, F), np.int32)
    lb[1, 0] = 7
    lb[2] = rng.integers(1, 256, F)  # n = 0: nothing read
    lb[3, 0], lb[4, :2] = 0, (4, 0)
    return {"edges_8x65536": (r, ns, nu),
            "full_width_4x901120": (w, np.array([F, F - 1, F, F], np.int32),
                                    np.array([1, 256, 256, 40], np.int32)),
            "lookback_5x901120": (lb, np.array([F, F, 0, 1, 2], np.int32),
                                  np.array([1, 30, 7, 2, 5], np.int32)),
            "one_run_1x901120": (np.zeros((1, F), np.int32),
                                 np.array([F], np.int32),
                                 np.array([1], np.int32))}


def pack_edge_args(dev) -> dict:
    """Synthetic group-packing inputs (host arrays made into tensors on
    the card): start bit 31, codes of 20 bits, a dummy symbol with a
    length, ngroups 0 and below G, rows past W."""
    rng = np.random.default_rng(21)
    B, NP, W = 4, 100_001, 40_000
    nm = np.array([NP, 37, 60_000, NP], np.int32)
    ninuse = np.array([256, 3, 120, 255], np.int32)
    mtfv = np.zeros((B, NP), np.int32)
    for b in range(B):
        mtfv[b, :nm[b] - 1] = rng.integers(0, ninuse[b] + 1, nm[b] - 1)
        mtfv[b, nm[b] - 1] = ninuse[b] + 1
    G = -(-NP // 50)
    lens = rng.integers(1, 21, (B, 6, 259)).astype(np.int32)
    lens[0] = 20  # every code 20 bits: row 0 runs past W
    for b in range(B):
        lens[b, :, ninuse[b] + 3:] = 0  # the dummy symbol keeps a length
    codes = rng.integers(0, 1 << 20, lens.shape) & ((1 << lens) - 1)
    ngroups = (nm + 49) // 50
    ngroups[1], ngroups[3] = 0, G // 3
    args = (mtfv, nm, ninuse, ngroups.astype(np.int32),
            rng.integers(-1, 8, (B, G)).astype(np.int32),  # clamped 0..5
            codes.astype(np.int64), lens,
            np.array([31, 0, 17, 31], np.int32))
    cases = {"edges_4x100001": (*(torch.from_numpy(a).to(dev)
                                  for a in args), W)}
    # every row with ngroups 0 (chunk 0 writes start_bit as the total)
    cases["ngroups_0_4x100001"] = (
        *(torch.from_numpy(a).to(dev) for a in
          (mtfv, nm, ninuse, np.zeros(B, np.int32), args[4], args[5],
           lens, args[7])), W)
    # full width, codes of 20 bits: rows 0 and 2 run past W = 80384 (18
    # million bits), row 1 (nm 60,001) and row 3 (ngroups 0) fit
    NP = WIDTH + 1
    G = -(-NP // 50)
    nm = np.array([NP, 60_001, NP - 7, NP], np.int32)
    mtfv = rng.integers(0, 200, (B, NP)).astype(np.int32)
    lens = np.full((B, 6, 259), 20, np.int32)
    codes = rng.integers(0, 1 << 20, lens.shape)
    ngroups = ((nm + 49) // 50).astype(np.int32)
    ngroups[3] = 0
    full = (mtfv, nm, np.full(B, 198, np.int32), ngroups,
            rng.integers(0, 6, (B, G)).astype(np.int32),
            codes.astype(np.int64), lens, np.array([5, 0, 31, 9], np.int32))
    cases["over_W_4x901121"] = (*(torch.from_numpy(a).to(dev)
                                  for a in full), 80384)
    return cases


def flat_ends(wcnt, dev) -> tuple:
    """The rows' inclusive word ends on the card and the F slots of whole
    FLAT_CHUNK chunks that chain_payloads takes for word counts wcnt."""
    from lbzip2_tpu_torch.ops import chain

    ends = np.cumsum(wcnt).astype(np.int32)
    F = -(-int(ends[-1]) // chain.FLAT_CHUNK) * chain.FLAT_CHUNK
    return torch.from_numpy(ends).to(dev), F


def entropy_phase(data: bytes, text: bytes, batch, dev) -> list:
    """20. The RLE2 kernel (csrc/rle2.cu behind ops/rle2.py::
    rle2_hist_rows) and the group-packing kernel (csrc/pack_groups.cu
    behind ops/chain.py::_pack_groups) against their plain versions,
    tolerance 0 on every output: the text batch's MTF ranks at
    (32, 901120), the MTF ranks of the BWT of phase 19's random,
    16-value and runs blocks, deep repeats and (8, 8192) bucket (n = 0,
    1, 2), synthetic edge and look-back stress rows; the packing on the
    arguments chain_payloads gives it on each of those batches and on
    synthetic ones, and its flat mode (ops/chain.py::_pack_flat, what
    chain_payloads runs) against the plain packing then the plain
    compaction on each of them, with the row ends chain_payloads makes
    (rows past W left out) and on the text batch with its first and last
    rows left out and F of three chunks; three calls a case.  The kernels
    a call runs (by torch.profiler), CUDA-event times of each kernel and
    its plain version in turns, and each kernel's device time.  Returns
    the three records (RLE2, packing, flat packing)."""
    from lbzip2_tpu_torch.interop import M32
    from lbzip2_tpu_torch.ops import bwt2, chain, rle2
    from lbzip2_tpu_torch.ops.mtf_pallas import mtf_ranks_rows

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def ranks_of(bwt, ns, cmaps):
        syms = chain._compact_syms(bwt, cmaps).contiguous()
        return (mtf_ranks_rows(syms, ns), ns,
                cmaps.int().sum(1, dtype=torch.int32))

    bwt, ns_h, cmaps_h, primary = batch
    rle_cases = {"text_32x901120": ranks_of(bwt, up(ns_h), up(cmaps_h))}
    flat_cases = {"text_32x901120": flat_args(bwt, ns_h, cmaps_h,
                                              primary.cpu().numpy())}
    for name, host in bwt2_cases(data, text).items():
        if name == "text_32x901120":
            continue
        rows, ns, ms = host[:3]
        kept = np.nonzero(ns > 0)[0]  # the emit reads byte n - 1
        rows_k = bwt2.bwt2_bytes(up(rows[kept]), up(ns[kept]),
                                 up(ms[kept]))
        cm = np.zeros((len(ns), 256), np.uint8)
        for r in range(len(ns)):
            cm[r, np.unique(rows[r, :ns[r]])] = 1
        full = torch.zeros(rows.shape, dtype=torch.uint8, device=dev)
        full[up(kept)] = rows_k[0]
        rle_cases[name] = ranks_of(full, up(ns), up(cm))
        flat_cases[name] = flat_args(rows_k[0], ns[kept], cm[kept],
                                     rows_k[1].cpu().numpy())
    for name, host in entropy_edge_rows().items():
        rle_cases[name] = tuple(up(a) for a in host)
    pack_cases = {name: a[:9] for name, a in flat_cases.items()}
    pack_cases.update(pack_edge_args(dev))
    # the flat pack on every packing case: the word ends chain_payloads
    # makes from the totals (a row past W left out), F in whole chunks;
    # and the text batch with its first and last rows left out, F of
    # three chunks
    for name, a in pack_cases.items():
        if name not in flat_cases:
            total = chain._pack_groups_plain(*a)[1].cpu().numpy()
            wcnt = np.where(total <= 32 * a[8], (total + 31) // 32, 0)
            flat_cases[name] = (*a, *flat_ends(wcnt, dev))
    text = flat_cases["text_32x901120"]
    wcnt = np.diff(text[9].cpu().numpy(), prepend=0)
    wcnt[[0, -1]] = 0
    ends = flat_ends(wcnt, dev)[0]
    flat_cases["text_first_last_out_3_chunks"] = (
        *text[:9], ends, 3 * chain.FLAT_CHUNK)

    # three calls a case, each against the plain version: the per-call
    # state on the card (tickets, descriptors, row counts) resets itself
    errs = {"rle2": 0, "pack": 0}
    for name, a in rle_cases.items():
        want = rle2.rle2_hist_plain(*a)
        got = [rle2.rle2_hist_rows(*a) for _ in range(3)]
        torch.cuda.synchronize()
        e = max(max_err_of(g, want) for g in got)
        errs["rle2"] = max(errs["rle2"], e)
        log(f"rle2 kernel vs plain [{name}, {tuple(a[0].shape)}], 3 calls: "
            f"nm {want[1].min().item()}..{want[1].max().item()}, "
            f"max_abs_err {e}")
        assert e == 0, f"rle2 kernel disagrees with plain on {name}"
        del got, want
    for name, a in pack_cases.items():
        want = chain._pack_groups_plain(*a)
        got = [chain._pack_groups(*a) for _ in range(3)]
        torch.cuda.synchronize()
        e = max(max_err_of(g, want) for g in got)
        errs["pack"] = max(errs["pack"], e)
        past = int((want[1] > 32 * a[-1]).sum())
        log(f"pack_groups kernel vs plain [{name}, {tuple(a[0].shape)}, "
            f"W {a[-1]}], 3 calls: {past} rows past W, total bits "
            f"{want[1].min().item()}..{want[1].max().item()}, "
            f"max_abs_err {e}")
        assert e == 0, f"pack_groups kernel disagrees with plain on {name}"
        del got, want
    errs["flat"] = 0
    for name, a in flat_cases.items():
        want = flat_plain(*a)
        got = [chain._pack_flat(*a) for _ in range(3)]
        torch.cuda.synchronize()
        e = max(max_err_of(g, want) for g in got)
        errs["flat"] = max(errs["flat"], e)
        wcnt = np.diff(a[9].cpu().numpy(), prepend=0)
        log(f"pack_groups flat mode vs plain [{name}, "
            f"{tuple(a[0].shape)}, W {a[8]}, F {a[10]}], 3 calls: rows "
            f"left out {int((wcnt == 0).sum())}, flat words "
            f"{int(a[9][-1])}, max_abs_err {e}")
        assert e == 0, f"the flat pack disagrees with plain on {name}"
        del got, want

    # the text batch: neither wrapper waits for the card (no host read)
    ra, pa = rle_cases["text_32x901120"], pack_cases["text_32x901120"]
    fa = flat_cases["text_32x901120"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rle2.rle2_hist_rows(*ra)
        chain._pack_groups(*pa)
        chain._pack_flat(*fa)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # what a call launches: rle2_scan and the write-only rle2_tail; the
    # output's zero fill and pack_chunks
    ran = {"rle2": launched_kernels(lambda: rle2.rle2_hist_rows(*ra), {
        "rle2_scan": ("rle2_scan",), "rle2_tail": ("rle2_tail",)}),
           "pack": launched_kernels(lambda: chain._pack_groups(*pa), {
               "pack_chunks": ("pack_chunks",),
               "zero fill": ("FillFunctor", "Memset", "memset")}),
           "flat": launched_kernels(lambda: chain._pack_flat(*fa), {
               "pack_chunks": ("pack_chunks",),
               "zero fill": ("FillFunctor", "Memset", "memset")})}
    log(f"entropy kernels, device kernels of 3 calls: {json.dumps(ran)}")
    # in turns: plain, kernel, kernel, plain
    turns = {"rle2": [], "rle2_plain": [], "pack": [], "pack_plain": [],
             "flat": [], "flat_plain": []}
    for kernel in (False, True, True, False):
        if kernel:
            turns["rle2"].append(cuda_ms(lambda: rle2.rle2_hist_rows(*ra),
                                         20))
            turns["pack"].append(cuda_ms(lambda: chain._pack_groups(*pa),
                                         20))
            turns["flat"].append(cuda_ms(lambda: chain._pack_flat(*fa), 20))
        else:
            turns["rle2_plain"].append(cuda_ms(
                lambda: rle2.rle2_hist_plain(*ra), 3))
            turns["pack_plain"].append(cuda_ms(
                lambda: chain._pack_groups_plain(*pa), 3))
            turns["flat_plain"].append(cuda_ms(lambda: flat_plain(*fa), 3))
    us = {"rle2": device_us(lambda: rle2.rle2_hist_rows(*ra)),
          "pack": device_us(lambda: chain._pack_groups(*pa)),
          "flat": device_us(lambda: chain._pack_flat(*fa))}
    log(f"entropy kernels, (32, {WIDTH}) text batch, ms in turns: "
        f"{json.dumps(turns)}; device us {json.dumps(us)}")

    B, N = ra[0].shape
    mtfv, nm, ninuse, ngroups, sel, codes, lens, start_bit, W = pa
    # the ranks below n, ns and ninuse in; values, nm and the histogram
    # out; a lane below n takes at least one operation
    lanes = int(ra[1].clamp(0, N).sum())
    rle_bytes = 4 * (lanes + 2 * B + B * (N + 1) + B + B * rle2.WIDTH)
    # the symbols below nm of the valid groups, their selectors, the row
    # scalars and the tables in; words and totals out; a symbol of a
    # valid group takes at least one operation
    ng = ngroups.clamp(0, sel.shape[1]).long()
    read = int(torch.minimum(50 * ng, nm.long().clamp(0, mtfv.shape[1]))
               .sum())
    pack_bytes = (4 * (read + int(ng.sum()) + 4 * B + lens.numel()) +
                  8 * codes.numel() + 4 * B * W + 8 * B)
    symbols = 50 * int(ng.sum())
    # the flat mode: the same reads and the row ends in; the F slots out
    flat_bytes = pack_bytes - 4 * B * W - 8 * B + 4 * B + 4 * fa[10]
    log(f"entropy kernels' bytes: rle2 {rle_bytes} ({lanes} lanes below "
        f"n), pack_groups {pack_bytes} ({read} symbols read, "
        f"{int(ng.sum())} groups, W {W}), flat mode {flat_bytes} (F "
        f"{fa[10]})")

    def mean(x):
        return sum(x) / len(x)

    return [{"name": "rle2_hist", "route": "cuda",
             "source": "lbzip2_tpu_torch/csrc/rle2.cu",
             "replaces": "lbzip2_tpu/ops/rle2.py:25", "launches": 0,
             "max_abs_err": errs["rle2"], "ms": mean(turns["rle2"]),
             "plain_ms": mean(turns["rle2_plain"]), "turns_ms": turns,
             "device_us": us["rle2"], "kernels_a_call": ran["rle2"],
             **bound(rle_bytes, lanes)},
            {"name": "pack_groups", "route": "cuda",
             "source": "lbzip2_tpu_torch/csrc/pack_groups.cu",
             "replaces": "lbzip2_tpu/ops/chain.py:222", "launches": 0,
             "max_abs_err": errs["pack"], "ms": mean(turns["pack"]),
             "plain_ms": mean(turns["pack_plain"]), "W": W,
             "device_us": us["pack"], "kernels_a_call": ran["pack"],
             **bound(pack_bytes, symbols)},
            {"name": "pack_groups_flat", "route": "cuda",
             "source": "lbzip2_tpu_torch/csrc/pack_groups.cu",
             "replaces": "lbzip2_tpu/ops/chain.py:222, :362", "launches": 0,
             "max_abs_err": errs["flat"], "ms": mean(turns["flat"]),
             "plain_ms": mean(turns["flat_plain"]), "F": fa[10],
             "device_us": us["flat"], "kernels_a_call": ran["flat"],
             **bound(flat_bytes, symbols)}]


def launched_kernels(fn, names: dict, reps: int = 3) -> dict:
    """The device kernels ``reps`` calls of ``fn`` ran, by torch.profiler:
    {label: launches recorded}.  Every kernel (or memset) recorded must
    hold one of the substrings ``names`` gives a label, each label
    recorded at least once and at most ``reps`` times (the profiler may
    miss the last launches, so a count below ``reps`` is no fault)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ran = {e.key: e.count for e in prof.key_averages()
           if e.device_time_total}
    short = {}
    for key, count in ran.items():
        match = [label for label, subs in names.items()
                 if any(sub in key for sub in subs)]
        assert match, f"a call ran {key!r}, not one of {names}"
        short[match[0]] = short.get(match[0], 0) + count
    assert set(short) == set(names) and \
        all(c <= reps for c in short.values()), \
        f"{reps} calls ran {ran}, expected each of {names} once a call"
    return short


def emit_inputs(D, ns, rng):
    """Emit inputs (blocks, ISA, ns, ms) on the host whose BWT rows are
    the designed rows D (B, N) uint8 at the lanes < n: a random
    permutation of [0, n) for each row's ISA, and blocks[j] =
    D[ISA[(j + 1) mod n]], so that the emit's bwt[ISA[p]] = prev[p]
    writes D; random garbage at and past n in the blocks and the ISA,
    m random below n."""
    B, N = D.shape
    blocks = rng.integers(0, 256, (B, N), dtype=np.uint8)
    isa = rng.integers(INT32_MIN, INT32_MAX, (B, N), dtype=np.int32)
    ms = np.zeros(B, np.int32)
    for b in range(B):
        n = int(ns[b])
        if n:
            perm = rng.permutation(n).astype(np.int32)
            isa[b, :n] = perm
            blocks[b, :n] = D[b, perm[(np.arange(n) + 1) % n]]
            ms[b] = rng.integers(0, n)
    return blocks, isa, ns.astype(np.int32), ms


def emit_edge_rows() -> dict:
    """Designed BWT rows for the emits, name -> (D, ns) on the host: runs
    of 254, 255, 256, 510 and 511 bytes across every multiple of 4096
    lanes (the token scan's tile edges, every 8192 lanes, among them) at
    several offsets, a run from a tile's
    first lane, one run of the whole row, a run that touches n, a random
    row whose run count passes N / 4, n = 0, 1 and 4097; at full width a
    row of one run, a random row, a row of runs of exactly 255 and a row
    whose last run touches n = 900,000; and random rows of n at the
    edges of emit_bytes' destination buckets."""
    rng = np.random.default_rng(22)
    N = 65536
    D = rng.integers(0, 256, (8, N), dtype=np.uint8)
    p = 0
    for k in range(1, 15):  # row 0: runs across the edges
        edge, L = 4096 * k, (254, 255, 256, 510, 511, 765, 1)[k % 7]
        lo = edge - (0, 1, 100, 254, 255, 256, 509)[k % 7]
        D[0, lo:lo + L] = D[0, lo - 1] ^ 1
        p = lo + L
    D[0, p] = D[0, p - 1] ^ 2
    D[1] = 7  # one run of the whole row
    D[2, 49000:50000] = 3  # a run that touches n
    D[4, 4096:4096 + 255 * 16 + 1] = 9  # from a tile's first lane
    D[6, 3000:4097] = 5  # n = 4097: a run over the first edge to n
    ns = np.array([N, N, 50000, N, N, 0, 4097, 1], np.int32)
    F = WIDTH
    W = rng.integers(0, 256, (4, F), dtype=np.uint8)
    W[0] = 11
    W[2] = np.repeat(np.arange(F // 255 + 1) % 2 + 40, 255)[:F]
    W[3, 899000:900000] = 12
    # the emit's buckets of S = 16384 destinations: n = 0, 1, 2, S - 1,
    # S, S + 1, 2S + 17 and N, a width that leaves the last bucket
    # partial and puts odd rows off 16-byte alignment
    S = 16384
    K = rng.integers(0, 256, (8, 3 * S + 8), dtype=np.uint8)
    kn = np.array([0, 1, 2, S - 1, S, S + 1, 2 * S + 17, 3 * S + 8],
                  np.int32)
    return {"edges_8x65536": (D, ns),
            "full_width_4x901120": (W, np.array([F, F, F, 900000],
                                                np.int32)),
            "edges_buckets_8x49160": (K, kn)}


def token_stress_rows() -> dict:
    """Designed BWT rows for the token scan's look-back, name -> (D, ns)
    on the host, at the full width and at the (8, 8192) bucket: one run
    of the whole row (n = N); runs of exactly 255 k lanes that end at
    every multiple of 4096 lanes (the tile edges, every 8192 lanes, among
    them), one lane before it and one lane after it; a run longer than 255 over several tiles; alternating bytes,
    whose run count passes N / 4; n = 0, 1 and 2 (n = 0 and 2 in the
    bucket); at the full width also random rows of 2 and 16 values and
    runs, and a row of runs of 255 that ends at n = 900,000."""
    T = 4096
    out = {}
    for B, N in ((ROWS, WIDTH), (8, 8192)):
        rng = np.random.default_rng(N)
        D = np.repeat(rng.integers(0, 16, (B, N // 4 + 1)).astype(np.uint8),
                      4, axis=1)[:, :N]
        D[:, ::3] ^= rng.integers(0, 2, (B, -(-N // 3))).astype(np.uint8)
        ns = np.full(B, N, np.int32)
        D[0] = 7  # one run of the whole row
        for r, shift in ((1, 0), (2, -1), (3, 1)):
            p = 0
            for k, edge in enumerate(range(T, N, T)):
                L = 255 * (k % 3 + 1)
                lo = edge + shift - L
                if lo <= p:
                    continue
                D[r, lo:lo + L] = D[r, lo - 1] ^ 1
                D[r, lo + L] = D[r, lo] ^ 2
                p = lo + L + 1
        D[4, 5:min(5 + 3 * T + 600, N - 7)] = 4  # over several tiles
        D[5] = np.arange(N) % 2 + 30  # run counts past N / 4
        if B == ROWS:
            ns[6:9] = 0, 1, 2
            D[9] = rng.integers(0, 2, N) + 60
            D[10] = np.repeat(np.arange(N // 255 + 1) % 2 + 40, 255)[:N]
            ns[10] = 900_000
        else:
            ns[6:8] = 0, 2
        out[f"tok_stress_{B}x{N}"] = (D, ns)
    return out


def assert_permutation(isa, ns, name: str) -> None:
    """The emit kernel's precondition: on the lanes < n the ISA is a
    permutation of [0, n)."""
    B, N = isa.shape
    valid = torch.arange(N, device=isa.device)[None] < ns.long()[:, None]
    inside = (isa >= 0) & (isa.long() < ns.long()[:, None])
    assert bool((inside | ~valid).all()), f"{name}: ISA out of [0, n)"
    hits = torch.zeros((B, N), dtype=torch.int32, device=isa.device)
    hits.scatter_add_(1, torch.where(valid, isa, 0).long(), valid.int())
    assert torch.equal(hits, valid.int()), f"{name}: ISA no permutation"


def emit_errs(got, want, ns) -> dict:
    """The emits' outputs against their plain versions' on what the
    function defines: (bwt, primary) on the rows' lanes < n and whether
    the kernel wrote 0 past n; (tokens, run_counts) on the counts and the
    tokens below min(count, N / 4) and whether the kernel wrote 0 past
    the count; _emit2's four outputs as both, raw below n."""
    nb = ns.long()[:, None]
    if len(got) == 4:  # (tokens, raw, run_counts, primary)
        e = emit_errs((got[0], got[2]), (want[0], want[2]), ns)
        rk, rp = got[1].view(torch.uint8), want[1].view(torch.uint8)
        keep = torch.arange(rk.shape[1], device=rk.device)[None] < nb
        e["raw"] = max_err_of(torch.where(keep, rk, 0),
                              torch.where(keep, rp, 0))
        e["primary"] = max_err_of(got[3], want[3])
        return e
    if got[0].dtype == torch.uint8:  # (bwt, primary)
        keep = torch.arange(got[0].shape[1], device=ns.device)[None] < nb
        return {"bwt": max_err_of(torch.where(keep, got[0], 0),
                                  torch.where(keep, want[0], 0)),
                "primary": max_err_of(got[1], want[1]),
                "zeros_past_n": int(torch.where(keep, 0, got[0]).max())}
    tk, tp = got[0].view(torch.int16), want[0].view(torch.int16)
    tl = torch.arange(tk.shape[1], device=tk.device)[None]
    upto = want[1].long().clamp(max=tk.shape[1])[:, None]
    return {"tokens": max_err_of(torch.where(tl < upto, tk, 0),
                                 torch.where(tl < upto, tp, 0)),
            "run_counts": max_err_of(got[1], want[1]),
            "zeros_past_count": int(torch.where(
                tl < got[1].long()[:, None], 0, tk).abs().max())}


def flatten_args(bwt, ns, cmaps, idxs) -> tuple:
    """The _flatten_words arguments of the compaction chain_payloads makes
    on a BWT batch (bwt on the card; ns, cmaps, idxs on the host): its
    own call's, or, where the flat pack makes the compaction, the words
    _pack_groups packs from the same arguments with the flat pack's row
    ends and F."""
    from lbzip2_tpu_torch.ops import chain

    got = chain_call_args(bwt, ns, cmaps, idxs)
    if "_pack_flat" not in got:
        return got["_flatten_words"]
    a = got["_pack_flat"]
    return chain._pack_groups(*a[:9])[0], a[9], a[10]


def flat_args(bwt, ns, cmaps, idxs) -> tuple:
    """The arguments chain_payloads gives _pack_flat on a BWT batch."""
    return chain_call_args(bwt, ns, cmaps, idxs)["_pack_flat"]


def flat_plain(*a):
    """The flat pack's plain version: the plain packing, then the plain
    compaction."""
    from lbzip2_tpu_torch.ops import chain

    return chain._flatten_words_plain(chain._pack_groups_plain(*a[:9])[0],
                                      a[9], a[10])


def flatten_edge_args(dev) -> dict:
    """Synthetic _flatten_words inputs: rows of 0 words, base > 0, F past
    the last row's end, one row."""
    rng = np.random.default_rng(23)
    words = torch.from_numpy(rng.integers(INT32_MIN, INT32_MAX, (6, 5000),
                                          dtype=np.int32)).to(dev)
    wc = np.array([5000, 0, 17, 0, 4096, 1], np.int32)
    ends = torch.from_numpy(np.cumsum(wc).astype(np.int32)).to(dev)
    one = torch.from_numpy(np.array([3000], np.int32)).to(dev)
    return {"empty_rows_base_0": (words, ends, 20000, 0),
            "base_700": (words, ends, 512, 700),
            "base_past_end": (words, ends, 4096, 9000),
            "one_row": (words[:1].contiguous(), one, 5000, 1)}


def emits_phase(data: bytes, text: bytes, batch, dev) -> list:
    """21. The BWT's emits (csrc/bwt2_emit.cu behind ops/bwt2.py::
    _emit_bytes, emit_bin then emit_place, and _emit2), the MTF kernel's
    byte entry with its fused
    compaction (csrc/mtf_ranks.cu behind ops/mtf_pallas.py::
    mtf_ranks_bytes_rows) and the flat payload compaction
    (csrc/flatten_words.cu behind ops/chain.py::_flatten_words) against
    their plain versions, tolerance 0: the emits on the ISA of the resolve
    loop of every case of phase 19 (text at (32, 901120), random,
    16-value and runs, deep repeats, the (8, 8192) bucket with n = 0, 1,
    2, N and F8's row) and on designed rows under random permutations
    (emit_edge_rows), each ISA first checked to be a permutation on the
    lanes < n; the MTF byte entry on the text batch, the emitted rows of
    every case, rows of 1 and 256 used values and garbage past n; the
    compaction on the arguments chain_payloads gives it on the text batch
    and phase 19's cases and on synthetic ones.  Every wrapper once
    under torch.cuda.set_sync_debug_mode("error"); CUDA-event times of
    each kernel, its plain version and, where one call computes the
    function, the library call, in turns; each kernel's device time.
    Returns the four records."""
    from lbzip2_tpu_torch.ops import bwt2, chain, mtf_pallas

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    errs = {"emit_bytes": 0, "emit_tokens": 0, "mtf_bytes": 0,
            "flatten": 0}

    def held(kind, name, e):
        errs[kind] = max(errs[kind], max(e.values()) if isinstance(e, dict)
                         else e)
        log(f"{kind} kernel vs plain [{name}]: {json.dumps(e)}")
        assert not (max(e.values()) if isinstance(e, dict) else e), \
            f"{kind} kernel disagrees with plain on {name}"

    emit_cases = {}
    for name, host in bwt2_cases(data, text).items():
        rows, ns, ms = (up(a) for a in host[:3])
        emit_cases[name] = (rows, bwt2._resolve_loop(rows, ns), ns, ms)
    rng = np.random.default_rng(24)
    for name, (D, ns) in {**emit_edge_rows(),
                          **token_stress_rows()}.items():
        emit_cases[name] = tuple(up(a) for a in emit_inputs(D, ns, rng))
    mtf_cases = {"text_32x901120": (batch[0], up(batch[2]), up(batch[1]))}
    flat_cases = {}
    for name, a in emit_cases.items():
        assert_permutation(a[1], a[2], name)
        got, want = bwt2._emit_bytes(*a), bwt2._emit_bytes_plain(*a)
        torch.cuda.synchronize()
        held("emit_bytes", name, emit_errs(got, want, a[2]))
        # three calls: the scan's per-call state resets itself
        want2 = bwt2._emit2_plain(*a)
        for call in range(3):
            got2 = bwt2._emit2(*a)
            torch.cuda.synchronize()
            held("emit_tokens", f"{name}, call {call}",
                 emit_errs(got2, want2, a[2]))
        log(f"  {name}: run counts {got2[2].tolist()[:8]}.., rows over the "
            f"token capacity {int((got2[2] > got2[0].shape[1] * 2).sum())}")
        ns_h = a[2].cpu().numpy()
        cm = np.zeros((len(ns_h), 256), np.uint8)
        bwt_h = got[0].cpu().numpy()
        for r in range(len(ns_h)):
            cm[r, np.unique(bwt_h[r, :ns_h[r]])] = 1
        mtf_cases.setdefault(name, (got[0], up(cm), a[2]))
        if name != "text_32x901120" and not name.startswith(
                ("edges", "full", "tok_stress")):
            kept = np.nonzero(ns_h > 0)[0]
            flat_cases[name] = flatten_args(
                got[0][up(kept)].contiguous(), ns_h[kept], cm[kept],
                got[1].cpu().numpy()[kept])
    # rows of 1 and 256 used values, garbage past n
    g = np.random.default_rng(25)
    B8 = g.integers(0, 256, (6, 65536), dtype=np.uint8)
    B8[0] = 200
    B8[2, :40000] = g.integers(0, 30, 40000) * 7
    ns8 = np.array([65536, 65536, 40000, 0, 1, 33333], np.int32)
    cm8 = np.zeros((6, 256), np.uint8)
    for r in range(6):
        cm8[r, np.unique(B8[r, :ns8[r]])] = 1
    cm8[5] = 1  # every value marked used
    mtf_cases["used_1_256_garbage_6x65536"] = (up(B8), up(cm8), up(ns8))
    for name, a in mtf_cases.items():
        got = mtf_pallas.mtf_ranks_bytes_rows(*a)
        want = mtf_pallas.mtf_ranks_bytes_plain(*a)
        torch.cuda.synchronize()
        held("mtf_bytes", name, max_err_of(got, want))
    bwt, ns_h, cmaps_h, primary = batch
    flat_cases["text_32x901120"] = flatten_args(bwt, ns_h, cmaps_h,
                                                primary.cpu().numpy())
    flat_cases.update(flatten_edge_args(dev))
    for name, a in flat_cases.items():
        got = chain._flatten_words(*a)
        want = chain._flatten_words_plain(*a)
        torch.cuda.synchronize()
        held("flatten", name, max_err_of(got, want))
        log(f"  {name}: B {a[0].shape[0]}, W {a[0].shape[1]}, F {a[2]}, "
            f"base {a[3] if len(a) > 3 else 0}, ends[-1] "
            f"{int(a[1][-1])}")

    # the text batch: no wrapper waits for the card (no host read)
    ea = emit_cases["text_32x901120"]
    ma = mtf_cases["text_32x901120"]
    fa = flat_cases["text_32x901120"]
    sbwt = bwt2._emit_bytes(*ea)[0]
    lib = bwt2._emit_lib()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bwt2._emit_bytes(*ea)
        bwt2._emit2(*ea)
        mtf_pallas.mtf_ranks_bytes_rows(*ma)
        chain._flatten_words(*fa)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the library calls: a scatter of the previous bytes by the ISA (the
    # lanes >= n to themselves), a gather of the symbol table
    blocks, isa, ns, ms = ea
    B, N = blocks.shape
    lane = torch.arange(N, device=dev)[None]
    nb = ns.long()[:, None]
    prev = torch.cat([torch.gather(blocks, 1, (nb - 1).clamp(min=0)),
                      blocks[:, :N - 1]], dim=1)
    dest = torch.where(lane < nb, isa.long(), lane)
    cm = ma[1].int()
    tab = torch.cumsum(cm, dim=1, dtype=torch.int32) - cm
    wide = ma[0].long()
    fns = {
        "emit_bytes": (lambda: bwt2._emit_bytes(*ea),
                       lambda: bwt2._emit_bytes_plain(*ea),
                       lambda: torch.empty_like(prev).scatter_(1, dest,
                                                               prev)),
        "emit_tokens": (lambda: bwt2._tokens_cuda(lib, sbwt, ns),
                        lambda: bwt2._tokens_plain(sbwt, ns), None),
        "mtf_bytes": (lambda: mtf_pallas.mtf_ranks_bytes_rows(*ma),
                      lambda: mtf_pallas.mtf_ranks_bytes_plain(*ma),
                      lambda: torch.gather(tab, 1, wide)),
        "flatten": (lambda: chain._flatten_words(*fa),
                    lambda: chain._flatten_words_plain(*fa), None)}
    turns = {k: {"kernel": [], "plain": [], "library": []} for k in fns}
    for kernel in (False, True, True, False):
        for k, (fk, fp, fl) in fns.items():
            if kernel:
                turns[k]["kernel"].append(cuda_ms(fk, 20))
            else:
                turns[k]["plain"].append(cuda_ms(fp, 1 if k == "mtf_bytes"
                                                 else 3))
                if fl is not None:
                    turns[k]["library"].append(cuda_ms(fl, 20))
    # the path the fused load replaced: the compaction, then the int32
    # entry of the MTF kernel
    unfused = cuda_ms(lambda: mtf_pallas.mtf_ranks_rows(
        mtf_pallas._compact_syms(*ma[:2]).contiguous(), ma[2]), 10)
    us = {k: device_us(f[0]) for k, f in fns.items()}
    log(f"emits and load, (32, {WIDTH}) text batch, ms in turns: "
        f"{json.dumps(turns)}; compaction then the int32 MTF entry "
        f"{unfused:.4f} ms; device us {json.dumps(us)}")

    def mean(x):
        return sum(x) / len(x) if x else None

    lanes = int(ns.clamp(0, N).sum())
    fw, fends, fF = fa[0], fa[1], fa[2]
    fbase = fa[3] if len(fa) > 3 else 0
    copied = max(0, min(int(fends[-1]), fbase + fF) - fbase)
    # bytes once in and once out; a lane (a slot) takes an operation
    nbytes = {
        # the ISA and the blocks below n, ns and ms in; the rows and the
        # primaries out
        "emit_bytes": 4 * lanes + lanes + 8 * B + B * N + 4 * B,
        # the rows below n and ns in; the tokens and the counts out
        "emit_tokens": lanes + 4 * B + 2 * B * (N // 4) + 4 * B,
        # the bytes below n, the maps and ns in; the ranks out
        "mtf_bytes": lanes + 256 * B + 4 * B + 4 * B * N,
        # the words copied and the sums in; the slots out
        "flatten": 4 * copied + 4 * fw.shape[0] + 4 * fF}
    ops = {"emit_bytes": lanes, "emit_tokens": lanes, "mtf_bytes": lanes,
           "flatten": fF}
    log(f"emits and load: bytes {json.dumps(nbytes)}, operations "
        f"{json.dumps(ops)}")
    meta = {"emit_bytes": ("lbzip2_tpu_torch/csrc/bwt2_emit.cu",
                           "lbzip2_tpu/ops/bwt2.py:218"),
            "emit_tokens": ("lbzip2_tpu_torch/csrc/bwt2_emit.cu",
                            "lbzip2_tpu/ops/bwt2.py:166"),
            "mtf_bytes": ("lbzip2_tpu_torch/csrc/mtf_ranks.cu",
                          "lbzip2_tpu/ops/chain.py:48"),
            "flatten": ("lbzip2_tpu_torch/csrc/flatten_words.cu",
                        "lbzip2_tpu/ops/chain.py:362")}
    names = {"emit_bytes": "bwt2_emit_bytes", "emit_tokens":
             "bwt2_emit_tokens", "mtf_bytes": "mtf_ranks_bytes",
             "flatten": "flatten_words"}
    records = []
    for k in fns:
        rec = {"name": names[k], "route": "cuda", "source": meta[k][0],
               "replaces": meta[k][1], "launches": 0,
               "max_abs_err": errs[k], "ms": mean(turns[k]["kernel"]),
               "plain_ms": mean(turns[k]["plain"]), "turns_ms": turns[k],
               "device_us": us[k], **bound(nbytes[k], ops[k])}
        rec["library_ms"] = mean(turns[k]["library"])
        records.append(rec)
    records[2]["unfused_ms"] = unfused
    return records



# ---- 22. the v1 rotation sort ------------------------------------------------

def v1_cases(data: bytes, text: bytes) -> dict:
    """Phase 22's inputs, name -> (rows, ns) on the host, rows zero past
    n: the first 32 text blocks as they stand at (32, 901120), the
    stream's uniform random, 16-value and random-run blocks, the periodic
    stress rows (period 1 at n = 900,000: one class of every lane;
    period 3; period 65,537), and an (8, 8192) bucket with n = 1, 2, 3,
    15, 17 and N, a fully periodic row and a row with one lane of
    sixteen FF bytes (n < N: that lane shares the pads' class in the
    seed and counts as unresolved)."""
    tb = np.frombuffer(text, np.uint8)
    tail = np.frombuffer(data[-3 * BLOCK:], np.uint8)
    rng = np.random.default_rng(22)

    def rows_of(blocks, width):
        rows = np.zeros((len(blocks), width), np.uint8)
        for r, b in enumerate(blocks):
            rows[r, :b.size] = b
        return rows, np.array([b.size for b in blocks], np.int32)

    ff = rng.integers(0, 0xF0, 6000).astype(np.uint8)
    ff[2000:2016] = 0xFF
    return {
        "text_32x901120": rows_of([tb[(r * BLOCK) % tb.size:][:BLOCK]
                                   for r in range(ROWS)], WIDTH),
        "random_uniform_16_runs": rows_of(
            [tail[i * BLOCK:(i + 1) * BLOCK] for i in range(3)], WIDTH),
        "periodic_stress": rows_of(
            [np.full(BLOCK, 0x61, np.uint8),
             np.tile(np.array([7, 1, 7], np.uint8), BLOCK // 3),
             np.tile(rng.integers(0, 256, 65537).astype(np.uint8),
                     BLOCK // 65537 + 1)[:BLOCK]], WIDTH),
        "bucket_8x8192": rows_of(
            [rng.integers(0, 256, n).astype(np.uint8)
             for n in (1, 2, 3, 15, 17, 8192)] +
            [np.tile(np.array([5, 6], np.uint8), 2000), ff], 8192)}


def v1_reference(rows, ns):
    """The BWT rows and primaries of the host: bwt2_bytes (the kernels'
    suffix sort) after native.lyndon_prep for a primitive row, the host C
    BWT (native.bwt) for a periodic one.  (rows list, primaries)."""
    from lbzip2_tpu_torch import native
    from lbzip2_tpu_torch.ops import bwt2

    B, N = rows.shape
    rot = np.zeros_like(rows)
    ms = np.zeros(B, np.int32)
    for r in range(B):
        ms[r] = native.lyndon_prep(rows[r, :ns[r]], out=rot[r, :ns[r]])[1]
    dev = torch.device("cuda", 0)
    prim = bwt2.bwt2_bytes(*(torch.from_numpy(a).to(dev) for a in
                             (rot, ns, np.maximum(ms, 0))))
    out, primary = (t.cpu().numpy() for t in prim)
    want = [out[r, :ns[r]] for r in range(B)]
    primary = primary.copy()
    for r in np.flatnonzero(ms < 0):
        want[r], primary[r] = native.bwt(rows[r, :ns[r]])
    return want, primary, int((ms < 0).sum())


def bwt_v1_phase(data: bytes, text: bytes, dev) -> list:
    """22. The v1 rotation sort (ops/bwt.py) on the cyclic and 4-key
    modes of csrc/bwt2_sort.cu and the emit of csrc/bwt2_emit.cu, against
    the plain twins on the card, tolerance 0, on every case of v1_cases:
    the cyclic seed (ISA's lanes < n and counts against _seed_sparse's),
    every pass of the loop and the tie-break, the whole loop under
    torch.cuda.set_sync_debug_mode("error") (no host read); bwt_batched
    against the doubling twin, SparseBwtTask driven by step against
    JAX's sparse steps, bwt_batched_uniform (uniform-n cases) against
    its shift twin; every row and primary against the host
    (v1_reference).  Then the v1 path, the sharded per-block stage over
    [cuda:0] on the text rows, with its launches counted; pass4, chain_mtf
    and em_estep_batch against their plain twins on the text batch; the
    CUDA-event times of each at (32, 901120) against the plain versions
    and, for the sorts, one torch.sort(stable=True) of a (32, 901120)
    int64 key; each kernel's device time.  Returns the records."""
    from lbzip2_tpu_torch.ops import bwt, bwt2, chain
    from lbzip2_tpu_torch.parallel import sharding

    errs = dict.fromkeys(("seed", "pass", "tie", "loop", "emit", "uniform",
                          "sparse", "pass4", "chain_mtf", "estep"), 0)

    def check(which, got, want, ns=None, name=""):
        if ns is not None:  # an ISA: its lanes < n, and the counts
            got = (valid_lanes(got[0], ns), got[1])
            want = (valid_lanes(want[0], ns), want[1])
        e = max_err_of(got, want)
        errs[which] = max(errs[which], e)
        assert e == 0, f"v1 {which} kernel disagrees with its twin on {name}"

    t_all = time.time()
    for name, (rows_h, ns_h) in v1_cases(data, text).items():
        t0 = time.time()
        rows, ns = (torch.from_numpy(a).to(dev) for a in (rows_h, ns_h))
        isa, cnt = bwt._seed_cyclic(rows, ns)
        check("seed", (isa, cnt), bwt._seed_cyclic_plain(rows, ns), ns, name)
        passes, k = 0, 16
        for _ in range(bwt2.loop_passes(rows.shape[1])):
            if int(cnt.max()) == 0:
                break
            out = bwt._pass_cyclic(isa, k, ns)
            check("pass", out, bwt._pass_cyclic_plain(isa, k, ns), ns, name)
            isa, cnt = out
            passes, k = passes + 1, k * 8
        out = bwt._tie_break(isa, ns)
        check("tie", out, bwt._pass_cyclic_plain(isa, 1, ns, tie=True), ns,
              name)
        ties = int(cnt.max())
        final = out[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop_isa = bwt._cyclic_loop(rows, ns)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check("loop", valid_lanes(loop_isa, ns), valid_lanes(final, ns),
              name=name)
        got = bwt.bwt_batched(rows, ns)
        check("loop", got, bwt._bwt_rows_plain(rows, ns), name=name)
        check("emit", bwt._emit_sparse(rows, final, ns),
              bwt._emit_sparse_plain(rows, final, ns), name=name)
        task = bwt.SparseBwtTask(rows_h, ns_h)
        steps = 0
        while not task.step():
            steps += 1
        packed, prim = task.result()
        check("sparse", (torch.from_numpy(packed), torch.from_numpy(prim)),
              tuple(t.cpu() for t in bwt.bwt_sparse_plain(rows, ns)),
              name=name)
        if (ns_h == ns_h[0]).all():
            check("uniform", bwt.bwt_batched_uniform(rows, int(ns_h[0])),
                  bwt._bwt_uniform_plain(rows, int(ns_h[0])), name=name)
        want, want_prim, periodic = v1_reference(rows_h, ns_h)
        out_h, prim_h = (t.cpu().numpy() for t in got)
        for r in range(len(ns_h)):
            assert np.array_equal(out_h[r, :ns_h[r]], want[r]) and \
                int(prim_h[r]) == int(want_prim[r]), \
                f"v1 BWT of {name} row {r} differs from the host"
        log(f"bwt v1 kernels vs plain [{name}, {tuple(rows.shape)}]: equal "
            f"on the seed, {passes} passes, the tie-break ({ties} tied "
            f"lanes left before it), the loop under sync debug mode, "
            f"bwt_batched, the emit, SparseBwtTask ({steps} steps) and "
            f"bwt_batched_uniform where n is uniform; rows and primaries "
            f"equal to the host's ({periodic} periodic rows); "
            f"{time.time() - t0:.1f} s")

    # the v1 path: the sharded per-block stage on the text rows
    rows_h, ns_h = v1_cases(data, text)["text_32x901120"]
    torch.cuda.synchronize()
    reset_counts()
    plain: dict = {}
    with plain_twins_counted(plain):
        stage = sharding.encode_batch_sharded(rows_h, ns_h, [dev])
    counts = read_counts()
    log(f"bwt v1 path (encode_batch_sharded over [cuda:0], "
        f"{rows_h.shape}): launches {json.dumps(counts)}; plain versions "
        f"{json.dumps(plain)}")
    assert all(counts[k] for k in ("bwt_cyclic_seed", "bwt_cyclic_pass",
                                   "bwt_tie_break", "bwt_emit_v1",
                                   "mtf_ranks")) and \
        not any(plain.values()), "the v1 path missed a kernel"

    # timed at (32, 901120) on the text rows, and the other functions on
    # the text batch
    rows, ns = (torch.from_numpy(a).to(dev) for a in (rows_h, ns_h))
    seed_isa = bwt._seed_cyclic(rows, ns)[0]
    final = bwt._cyclic_loop(rows, ns)
    pre_tie = seed_isa
    k = 16
    for _ in range(bwt2.loop_passes(WIDTH)):
        pre_tie = bwt._pass_cyclic(pre_tie, k, ns)[0]
        k *= 8
    bwt_rows = torch.from_numpy(stage[0]).to(dev)
    assert np.array_equal(stage[1], bwt.bwt_batched(rows, ns)[1].cpu()
                          .numpy()), "the stage's primaries differ"
    cm = np.zeros((ROWS, 256), np.uint8)
    for r in range(ROWS):
        cm[r, np.unique(rows_h[r, :ns_h[r]])] = 1
    cmaps = torch.from_numpy(cm).to(dev)
    check("chain_mtf", chain.chain_mtf(bwt_rows, ns, cmaps),
          chain._chain_mtf_plain(bwt_rows, ns, cmaps), name="text")
    mtfv, nm, _ = chain.chain_mtf(bwt_rows, ns, cmaps)
    ninuse = cmaps.int().sum(1, dtype=torch.int32)
    g = torch.Generator(device=dev).manual_seed(22)
    lengths = torch.randint(1, 21, (ROWS, 6, 259), generator=g, device=dev,
                            dtype=torch.int32)
    nts = (torch.arange(ROWS, device=dev, dtype=torch.int32) % 6) + 1
    est_args = (mtfv, nm, ninuse, nts, lengths)
    check("estep", chain.em_estep_batch(*est_args),
          chain._em_estep_batch_plain(*est_args), name="text")
    lyn, lns, _ = text_rows(text)
    lyn, lns = (torch.from_numpy(a).to(dev) for a in (lyn, lns))
    s16 = bwt2._seed16(lyn, lns)[0]
    check("pass4", bwt2.pass4(s16, 16, lns), bwt2._passx_plain(s16, 16, lns, 4),
          lns, "text")
    lib_ms = sort_library_ms(dev)
    prev = torch.cat([rows[:, -1:], rows[:, :-1]], 1)
    fns = {
        "seed": (lambda: bwt._seed_cyclic(rows, ns),
                 lambda: bwt._seed_cyclic_plain(rows, ns)),
        "pass": (lambda: bwt._pass_cyclic(seed_isa, 16, ns),
                 lambda: bwt._pass_cyclic_plain(seed_isa, 16, ns)),
        "tie": (lambda: bwt._tie_break(pre_tie, ns),
                lambda: bwt._pass_cyclic_plain(pre_tie, 1, ns, tie=True)),
        "loop": (lambda: bwt.bwt_batched(rows, ns),
                 lambda: bwt._bwt_rows_plain(rows, ns)),
        "emit": (lambda: bwt._emit_sparse(rows, final, ns),
                 lambda: bwt._emit_sparse_plain(rows, final, ns)),
        "uniform": (lambda: bwt.bwt_batched_uniform(rows, BLOCK),
                    lambda: bwt._bwt_uniform_plain(rows, BLOCK)),
        "pass4": (lambda: bwt2.pass4(s16, 16, lns),
                  lambda: bwt2._passx_plain(s16, 16, lns, 4)),
        "chain_mtf": (lambda: chain.chain_mtf(bwt_rows, ns, cmaps),
                      lambda: chain._chain_mtf_plain(bwt_rows, ns, cmaps)),
        "estep": (lambda: chain.em_estep_batch(*est_args),
                  lambda: chain._em_estep_batch_plain(*est_args))}
    ms, plain_ms, us = {}, {}, {}
    for which, (kernel, twin) in fns.items():
        ms[which] = cuda_ms(kernel, 5)
        plain_ms[which] = cuda_ms(twin, 1 if which in ("loop", "uniform")
                                  else 2)
        us[which] = device_us(kernel, 2)
    scatter_ms = cuda_ms(lambda: torch.empty_like(rows).scatter_(
        1, final.long(), prev), 10)
    log(f"bwt v1 times at (32, {WIDTH}), ms: kernels {json.dumps(ms)}, "
        f"plain {json.dumps(plain_ms)}; torch.sort(stable=True) {lib_ms:.3f}"
        f", scatter_ {scatter_ms:.3f}; device us {json.dumps(us)}; phase "
        f"{time.time() - t_all:.1f} s")

    lanes = ROWS * WIDTH
    live = int(ns_h.sum())
    syms = int(nm.sum())
    rec = {
        "seed": ("bwt_cyclic_seed", "lbzip2_tpu/ops/bwt.py:157",
                 "bwt2_sort.cu", "bwt_cyclic_seed",
                 bound(lanes + 4 * lanes + 8 * ROWS, live), lib_ms),
        "pass": ("bwt_cyclic_pass", "lbzip2_tpu/ops/bwt.py:218, :26",
                 "bwt2_sort.cu", "bwt_cyclic_pass",
                 bound(8 * lanes + 8 * ROWS, live), lib_ms),
        "tie": ("bwt_tie_break", "lbzip2_tpu/ops/bwt.py:90, :235",
                "bwt2_sort.cu", "bwt_tie_break",
                bound(8 * lanes + 8 * ROWS, live), lib_ms),
        "loop": ("bwt_v1_batched", "lbzip2_tpu/ops/bwt.py:43, :107",
                 "bwt2_sort.cu", "bwt_cyclic_seed",
                 bound(2 * lanes + 8 * ROWS, live),
                 lib_ms),
        "emit": ("bwt_emit_v1", "lbzip2_tpu/ops/bwt.py:289", "bwt2_emit.cu",
                 "bwt_emit_v1", bound(6 * lanes + 8 * ROWS, live),
                 scatter_ms),
        "uniform": ("bwt_batched_uniform", "lbzip2_tpu/ops/bwt.py:412",
                    "bwt2_sort.cu", None, bound(2 * lanes + 4 * ROWS, live),
                    lib_ms),
        "pass4": ("bwt2_pass4", "lbzip2_tpu/ops/bwt2.py:158",
                  "bwt2_sort.cu", None, bound(8 * lanes + 8 * ROWS, live),
                  lib_ms),
        "chain_mtf": ("chain_mtf_hist", "lbzip2_tpu/ops/chain.py:100, :71",
                      "rle2.cu", None,
                      bound(lanes + 256 * ROWS + 4 * (WIDTH + 1) * ROWS +
                            259 * 4 * ROWS, live), None),
        "estep": ("em_estep_batch", "lbzip2_tpu/ops/chain.py:200",
                  "em_chain.cu", None,
                  bound(4 * syms + 2 * 6 * 259 * 4 * ROWS +
                        4 * ROWS * (-(-(WIDTH + 1) // 50)), 6 * syms),
                  None)}
    out = []
    for which, (name, replaces, src, path_key, bnd, library) in rec.items():
        out.append({"name": name, "route": "cuda",
                    "source": f"lbzip2_tpu_torch/csrc/{src}",
                    "replaces": replaces,
                    "launches": counts[path_key] if path_key else 0,
                    "max_abs_err": errs[which], "ms": ms[which],
                    "plain_ms": plain_ms[which], "device_us": us[which],
                    **bnd, "library_ms": library})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--measure", action="store_true",
                    help="also the device time per op of one text batch, "
                    "the whole stream with the plain EM loop, the stream "
                    "runs (shipped default, device-only, both decoders "
                    "with their stage times), and the decode phase under "
                    "the profiler; with --tree only the per-op table, "
                    "one profiled device-only run and the stream runs")
    ap.add_argument("--kernels", action="store_true",
                    help="only hold the kernels against their plain "
                    "versions and time them on the smoke's timed inputs")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --kernels or --measure: take the package "
                    "from the checkout at DIR")
    ap.add_argument("--profile", action="store_true",
                    help="with --kernels: also each CUDA kernel's device "
                    "time by torch.profiler")
    ap.add_argument("--token-run", type=int, metavar="ELIGIBLE",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # device-only block encode, so the run shows the device did the work
    os.environ["LBZ2_HOST_STEAL"] = "0"
    os.environ["LBZ2_STEALBACK"] = "0"
    if args.token_run is not None:
        return token_run(args.token_run)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if args.kernels:
        return kernels_only(args.seed, args.profile, torch.device("cuda", 0))
    if args.tree and args.measure:
        return stream_tree(args.seed, torch.device("cuda", 0))
    if args.tree:
        ap.error("--tree goes with --kernels or --measure")
    from lbzip2_tpu_torch import _build
    from lbzip2_tpu_torch.codec import encoder
    from lbzip2_tpu_torch.core.constants import CLUSTER_FACTOR
    from lbzip2_tpu_torch.ops import (bitpack, bwt2, chain, crc, huffenc,
                                      mtf_pallas, rle2, sort_sweeps)
    from lbzip2_tpu_torch.tools import sort_probe

    dev = torch.device("cuda", 0)
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {nvcc.stdout.strip().splitlines()[-1]}")

    t0 = time.time()
    _build.build()
    log(f"build: {time.time() - t0:.2f} s")
    for name, rec in _build.build_log.items():
        log(f"  {name}: nvcc done at {rec['seconds']:.2f} s\n"
            f"{rec['ptxas']}")
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill",
                                             rec["ptxas"])]
        assert spills and not any(spills), f"{name} spills registers"

    t0 = time.time()
    data, text = make_data(args.seed)
    eligible = encoder.device_eligible(data, 9)
    log(f"data: {len(data)} bytes, {eligible} device-eligible blocks, "
        f"{time.time() - t0:.1f} s to generate")

    record, text_batch = kernel_phase(text, dev)
    text_h = text_symbols(text_batch, dev)
    em_record, text_args = em_phase(text_h, text_batch, dev)
    lengths_record = code_lengths_phase(text_args, dev)
    crc_record = crc_phase(text, dev)
    bitpack_record = bitpack_phase(text_batch, dev)
    crc_record["smoke_launches"] = crc.launches
    bitpack_record["smoke_launches"] = bitpack.launches
    seed_record, pass_record = bwt2_phase(data, text, dev)
    rle2_record, pack_record, flat_record = entropy_phase(
        data, text, text_batch, dev)
    emit_record, tokens_record, mtf_bytes_record, flatten_record = \
        emits_phase(data, text, text_batch, dev)
    v1_records = bwt_v1_phase(data, text, dev)
    for r in v1_records:  # on no path: their launches are phase 22's
        if r["name"] in ("bwt2_pass4", "chain_mtf_hist", "em_estep_batch"):
            r["smoke_launches"] = {
                "bwt2_pass4": bwt2.pass4_launches,
                "chain_mtf_hist": chain.chain_mtf_launches,
                "em_estep_batch": chain.estep_launches}[r["name"]]
    # the standalone compaction is on no path since the flat pack: its
    # launches are phase 21's
    flatten_record["smoke_launches"] = chain.flatten_launches
    if args.measure:
        op_table(text, text_batch, dev)
    del text_batch, text_h, text_args
    sweep_record = sweep_phase(dev)

    sort_sweeps.launches = 0
    probe = sort_probe.run(ROWS, WIDTH, SWEEPS, SUB, device=dev, log=log)
    sweep_record["launches"] = sort_sweeps.launches
    assert sweep_record["launches"] > 0, \
        "the probe never launched the sweep kernel"
    log(f"probe: {json.dumps(probe)}")

    log(f"warm_device: {encoder.warm_device(device=dev):.2f} s")
    t0 = time.time()
    cold = encoder.compress(data, 9, device=dev)
    log(f"compress (first run): {time.time() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    # count what the plain loop would run: on the card every chain batch
    # must go through the EM kernels and none through the plain loop, its
    # E-step or a stand-alone M-step, and through the RLE2 and packing
    # kernels and none of their plain versions
    off_path: dict = {}
    mtf_pallas.launches = huffenc.launches = huffenc.em_launches = 0
    crc.launches = bitpack.launches = 0
    bwt2.launches = bwt2.pass_launches = 0
    rle2.launches = chain.pack_launches = chain.flat_launches = 0
    bwt2.emit_launches = bwt2.token_launches = 0
    mtf_pallas.bytes_launches = chain.flatten_launches = 0
    t0 = time.time()
    with plain_twins_counted(off_path):
        out = encoder.compress(data, 9, device=dev)
    dt = time.time() - t0
    emit_record["launches"] = bwt2.emit_launches
    mtf_bytes_record["launches"] = mtf_pallas.bytes_launches
    flatten_record["launches"] = chain.flatten_launches
    flat_record["launches"] = chain.flat_launches
    chain_token_launches = bwt2.token_launches
    launches, mstep_launches, em_launches = \
        mtf_pallas.launches, huffenc.launches, huffenc.em_launches
    seed_record["launches"] = bwt2.launches - bwt2.pass_launches
    pass_record["launches"] = bwt2.pass_launches
    crc_record["launches"] = crc.launches  # not on the main path: 0
    bitpack_record["launches"] = bitpack.launches
    rle2_record["launches"] = rle2.launches
    pack_record["launches"] = chain.pack_launches
    stats = encoder.last_stats
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"compress (warm run): {dt:.3f} s = {len(data) / dt / 1e6:.3f} "
        f"MB/s, {len(out)} bytes out, peak device memory "
        f"{peak / 2**30:.2f} GiB, mtf launches {launches}, EM loops on the "
        f"card {em_launches} for {len(stats['batch_trace'])} batches, "
        f"{mstep_launches} M-step launches among them, off the kernels "
        f"{json.dumps(off_path)}, BWT seeds {seed_record['launches']} and "
        f"passes {pass_record['launches']} on the kernels, RLE2 "
        f"{rle2_record['launches']} and packing {pack_record['launches']} "
        f"launches, emit {emit_record['launches']}, MTF byte entry "
        f"{mtf_bytes_record['launches']}, flat pack "
        f"{flat_record['launches']}, standalone compaction "
        f"{flatten_record['launches']}, token emit {chain_token_launches}")

    def log_batches(stats):
        for i, tele in enumerate(stats["batch_trace"]):
            log(f"  batch {i}: shape {tele['shape']} claimed at "
                f"{tele['claimed_t']} s, prep {tele['prep_s']} s dispatch "
                f"{tele['dispatch_s']} s ready {tele['ready_s']} s, "
                f"BWT passes {tele.get('bwt2_passes')}, "
                f"claim->deliver {tele['claim_s']} s; chain_stages "
                f"{json.dumps(tele.get('chain_stages'))}")

    log_batches(stats)
    assert em_launches == len(stats["batch_trace"]) > 0 and \
        mstep_launches == (CLUSTER_FACTOR - 1) * em_launches and \
        not any(off_path.values()), \
        f"chain batches off the EM kernels: {em_launches} loops, {off_path}"
    assert all(t.get("bwt2_passes", 0) >= 1
               for t in stats["batch_trace"]), \
        "a batch's trace lacks the BWT's passes"
    assert all(t["shape"][0] == t["rows"] for t in stats["batch_trace"]) and \
        sum(t["rows"] for t in stats["batch_trace"]) == eligible, \
        "a batch shipped rows it did not hold"

    t0 = time.time()
    ref = host_reference(data)
    log(f"bin/lbzip2 -9 (host C pipeline): {time.time() - t0:.2f} s")
    assert cold == ref, "first compress differs from the host pipeline"
    assert out == ref, "compress differs from the host pipeline"
    assert bz2.decompress(out) == data, "bz2 round trip failed"
    assert stats["device_blocks"] == eligible, \
        f"device did {stats['device_blocks']} of {eligible} blocks"
    assert launches > 0, "main path never launched the MTF kernel"
    assert seed_record["launches"] > 0 and pass_record["launches"] > 0, \
        "main path never launched the BWT kernels"
    assert rle2_record["launches"] == pack_record["launches"] == \
        em_launches, "a chain batch missed the RLE2 or packing kernel"
    assert mtf_bytes_record["launches"] == em_launches and \
        emit_record["launches"] >= em_launches and \
        flat_record["launches"] == em_launches and \
        flatten_record["launches"] == 0 and chain_token_launches == 0, \
        "a chain batch missed the emit, the MTF byte entry or the flat " \
        "pack, or ran the standalone compaction or the token emit"
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("lbz2-")]
    assert not alive, f"engine threads outlived compress: {alive}"

    again = idle_share("compress, chain mode", lambda: encoder.compress(
        data, 9, device=dev))
    assert again == ref, "profiled compress differs"
    if args.measure:
        # the same call with the plain loop (its M-steps through the
        # code-length kernel, as before the loop moved to the card) in
        # the EM kernels' place
        wrapper = chain.em_chain_rows
        chain.em_chain_rows = lambda *a: em_plain(a[:5], a[5],
                                                  plain_mstep=False)
        t0 = time.time()
        before = encoder.compress(data, 9, device=dev)
        dt_plain = time.time() - t0
        chain.em_chain_rows = wrapper
        assert before == ref, "compress with the plain EM loop differs"
        log(f"compress with the plain EM loop: {dt_plain:.3f} s = "
            f"{len(data) / dt_plain / 1e6:.3f} MB/s against {dt:.3f} s = "
            f"{len(data) / dt / 1e6:.3f} MB/s with the EM kernels")
        log_batches(encoder.last_stats)
        runs = stream_runs(data, ref, dev)
        for r in runs["compress"] + runs["decompress"]:
            r = {k: v for k, v in r.items() if k != "batches"}
            log(f"stream run: {json.dumps(r)}")
        for i, r in enumerate(runs["compress"]):
            log(f"  compress run {i} ({r['config']}) batches: "
                f"{json.dumps(r['batches'])}")

    tok = token_phase(data, eligible, ref)
    tokens_record["launches"] = tok["calls"]["emit_tokens"]
    tokens_record["emit_bytes_launches"] = tok["calls"]["emit_bytes"]
    log(f"compress warm, {len(data)} bytes: token mode {tok['s']:.3f} s = "
        f"{tok['mbps']:.3f} MB/s vs chain mode {dt:.3f} s = "
        f"{len(data) / dt / 1e6:.3f} MB/s")

    huff_record = huffdec_phase(out, data, dev)
    ibwt_record = ibwt_phase(out, dev)
    decoded = {"chain_stream": decode_phase("chain_stream", out, data, dev,
                                            args.measure)}
    t0 = time.time()
    blob = bz2.compress(data, 9)
    log(f"bz2.compress(data, 9): {len(blob)} bytes, "
        f"{time.time() - t0:.2f} s")
    decoded["bz2_stream"] = decode_phase("bz2_stream", blob, data, dev,
                                         args.measure)
    huff_record["launches"] = decoded["chain_stream"]["huffdec_launches"]
    ibwt_record["launches"] = decoded["chain_stream"]["ibwt_launches"]
    cli_phase(data[:3 * BLOCK])
    sharded = sharded_phase(dev)
    engine_cards_phase(data, ref, dev)
    multihost_phase(data, dev)
    bench_phase()

    record["launches"] = launches
    lengths_record["launches"] = mstep_launches
    em_record["launches"] = em_launches
    ibwt_record["sharded_launches"] = sharded["launches"]["ibwt"]
    print(json.dumps({"kernels": [record, sweep_record, huff_record,
                                  ibwt_record, lengths_record, em_record,
                                  crc_record, bitpack_record, seed_record,
                                  pass_record, rle2_record, pack_record,
                                  flat_record, emit_record, tokens_record,
                                  mtf_bytes_record, flatten_record,
                                  *v1_records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
