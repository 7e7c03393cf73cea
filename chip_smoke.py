"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--seed S]

Phases (any failure exits non-zero before the last line is printed):

  1. card:   nvidia-smi name and power limit, torch and nvcc versions
  2. build:  nvcc builds every CUDA kernel of lbzip2_tpu_torch/csrc into
             build/lbzip2_tpu_torch, one nvcc per source, all at once
  3. mtf:    the MTF-rank kernel against its plain PyTorch version at
             (32, 901120) on real compacted BWT rows, uniform random
             symbols, an alphabet of 1 and rows with n = 0, 1 and N,
             plus the (8, 8192) bucket and a ragged (4, 12289) width;
             tolerance 0 (integer ranks must be equal); CUDA-event times
  4. sweeps: the compare-exchange sweep kernel against its plain
             version at the probe's (32, 7040, 128), sub 4, 210 sweeps,
             and at sweeps 0, 1 and 2, sub 1, int32 extremes and small
             or odd row blocks; tolerance 0; CUDA-event times
  5. probe:  lbzip2_tpu_torch.tools.sort_probe at (32, 901120): torch.sort
             1 key + payload, the BWT's 8-key pass, the sweep kernel at
             210 sweeps, with its launch count
  6. chain:  lbzip2_tpu_torch.codec.encoder.compress(data, 9,
             device="cuda") on ~60 MB generated from the seed, run
             twice; the warm run is timed and its MTF launches read.
             The output must equal the repo's host C pipeline, run
             out of process as `bin/lbzip2 -9 -c`, byte for byte and
             round-trip through bz2; every device-eligible block must
             have gone through the device.
  7. tokens: the same stream in token mode, in a child process of this
             script with LBZ2_DEVICE_CHAIN=0 (the mode is read by the
             inherited scheduler): warm, timed, the same bytes, every
             eligible block on the device, bwt2_tokens dispatched and
             bwt2_bytes never.

This process imports only the port (lbzip2_tpu_torch), never the JAX
package or JAX.

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import bz2
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


def kernel_phase(text: bytes, dev):
    """MTF kernel vs plain version at (32, 901120); returns the record."""
    from lbzip2_tpu_torch.codec.encoder import lyndon_rows
    from lbzip2_tpu_torch.ops import mtf_pallas
    from lbzip2_tpu_torch.ops.bwt2 import bwt2_bytes
    from lbzip2_tpu_torch.ops.chain import _compact_syms

    # real rows: compacted BWT of the first 32 text blocks
    tb = np.frombuffer(text, np.uint8)
    blocks = [tb[(r * BLOCK) % tb.size:][:BLOCK] for r in range(ROWS)]
    batch, ns, ms = lyndon_rows(blocks, WIDTH)
    assert (ms >= 0).all(), "a text block is periodic"
    cmaps = np.stack([np.bincount(b, minlength=256) > 0
                      for b in blocks]).astype(np.uint8)
    t0 = time.time()
    bwt, _ = bwt2_bytes(torch.from_numpy(batch).to(dev),
                        torch.from_numpy(ns).to(dev),
                        torch.from_numpy(ms).to(dev))
    torch.cuda.synchronize()
    log(f"bwt2_bytes (32, 901120) text batch: {time.time() - t0:.3f} s")
    real = _compact_syms(bwt, torch.from_numpy(cmaps).to(dev))

    gen = torch.Generator(device=dev).manual_seed(1)
    uni = torch.randint(0, 256, (ROWS, WIDTH), generator=gen, device=dev,
                        dtype=torch.int32)
    n_full = torch.full((ROWS,), WIDTH, dtype=torch.int32, device=dev)
    n_edge = torch.tensor([(0, 1, WIDTH)[r % 3] for r in range(ROWS)],
                          dtype=torch.int32, device=dev)
    # widths off the kernel's 4096-symbol chunk and 32-lane grid
    ragged = torch.randint(0, 7, (4, 12289), generator=gen, device=dev,
                           dtype=torch.int32)
    n_ragged = torch.tensor([0, 4096, 4097, 12289], dtype=torch.int32,
                            device=dev)
    cases = {
        "real_text_rows": (real, torch.from_numpy(ns).to(dev)),
        "uniform_256": (uni, n_full),
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

    syms, nn = cases["real_text_rows"]
    syms = syms.contiguous()
    ms_k = cuda_ms(lambda: mtf_pallas.mtf_ranks_rows(syms, nn), 10)
    ms_p = cuda_ms(lambda: mtf_pallas.mtf_ranks_plain(syms, nn), 2)
    log(f"mtf_ranks (32, 901120) real rows: kernel {ms_k:.3f} ms, "
        f"plain {ms_p:.3f} ms")
    return {"name": "mtf_ranks", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/mtf_ranks.cu",
            "replaces": "lbzip2_tpu/ops/mtf_pallas.py:81",
            "launches": 0, "max_abs_err": max_err, "ms": ms_k,
            "plain_ms": ms_p}


def sweep_phase(dev):
    """Sweep kernel vs plain version on every case; returns the record."""
    from lbzip2_tpu_torch.ops import sort_sweeps

    rng = np.random.default_rng(2)

    def keys(shape, values=None):
        if values is None:
            k = rng.integers(INT32_MIN, INT32_MAX, shape, dtype=np.int32,
                             endpoint=True)
        else:
            k = rng.choice(np.array(values, np.int32), shape)
        return torch.from_numpy(k).to(dev)

    full = keys((ROWS, WIDTH // 128, 128))
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
    log(f"sort_sweeps (32, 7040, 128) sub {SUB}, {SWEEPS} sweeps: kernel "
        f"{ms_k:.3f} ms, plain {ms_p:.3f} ms")
    return {"name": "sort_sweeps", "route": "cuda",
            "source": "lbzip2_tpu_torch/csrc/sort_sweeps.cu",
            "replaces": "tools/tpu_sort_probe.py:77",
            "launches": 0, "max_abs_err": max_err, "ms": ms_k,
            "plain_ms": ms_p}


def token_run(eligible: int) -> int:
    """Child process of the token phase (LBZ2_DEVICE_CHAIN=0 in its
    environment): compress the stream read from stdin twice, warm, and
    print one JSON line of what the parent checks."""
    from lbzip2_tpu_torch.codec import encoder

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
    t0 = time.time()
    out = encoder.compress(data, 9, device=dev)
    dt = time.time() - t0
    stats = encoder.last_stats
    print(json.dumps({
        "warm_device_s": warm, "first_s": first, "s": dt,
        "mbps": len(data) / dt / 1e6, "bytes": len(out),
        "sha256": hashlib.sha256(out).hexdigest(), "same_as_first":
        out == cold, "roundtrip": bz2.decompress(out) == data,
        "device_blocks": stats["device_blocks"], "eligible": eligible,
        "calls": calls, "batches": [
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
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    from lbzip2_tpu_torch import _build
    from lbzip2_tpu_torch.codec import encoder
    from lbzip2_tpu_torch.ops import mtf_pallas, sort_sweeps
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

    record = kernel_phase(text, dev)
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
    mtf_pallas.launches = 0
    t0 = time.time()
    out = encoder.compress(data, 9, device=dev)
    dt = time.time() - t0
    launches = mtf_pallas.launches
    stats = encoder.last_stats
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"compress (warm run): {dt:.3f} s = {len(data) / dt / 1e6:.3f} "
        f"MB/s, {len(out)} bytes out, peak device memory "
        f"{peak / 2**30:.2f} GiB, mtf launches {launches}")
    for i, tele in enumerate(stats["batch_trace"]):
        log(f"  batch {i}: rows {tele['rows']} prep {tele['prep_s']} s "
            f"dispatch {tele['dispatch_s']} s ready {tele['ready_s']} s "
            f"chain_stages {json.dumps(tele.get('chain_stages'))}")

    t0 = time.time()
    ref = host_reference(data)
    log(f"bin/lbzip2 -9 (host C pipeline): {time.time() - t0:.2f} s")
    assert cold == ref, "first compress differs from the host pipeline"
    assert out == ref, "compress differs from the host pipeline"
    assert bz2.decompress(out) == data, "bz2 round trip failed"
    assert stats["device_blocks"] == eligible, \
        f"device did {stats['device_blocks']} of {eligible} blocks"
    assert launches > 0, "main path never launched the MTF kernel"
    for t in threading.enumerate():
        if t.name.startswith("lbz2-"):
            t.join(timeout=30)
            assert not t.is_alive(), f"thread {t.name} still running"

    tok = token_phase(data, eligible, ref)
    log(f"compress warm, {len(data)} bytes: token mode {tok['s']:.3f} s = "
        f"{tok['mbps']:.3f} MB/s vs chain mode {dt:.3f} s = "
        f"{len(data) / dt / 1e6:.3f} MB/s")

    record["launches"] = launches
    print(json.dumps({"kernels": [record, sweep_record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
