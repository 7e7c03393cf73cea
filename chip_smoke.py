"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--seed S]

Phases (any failure exits non-zero before the last line is printed):

  1. card:   nvidia-smi name and power limit, torch and nvcc versions
  2. build:  nvcc builds every CUDA kernel of the main path from
             lbzip2_tpu_torch/csrc into build/lbzip2_tpu_torch
  3. kernel: the MTF-rank kernel against its plain PyTorch version at
             (32, 901120) on real compacted BWT rows, uniform random
             symbols, an alphabet of 1 and rows with n = 0, 1 and N,
             plus the (8, 8192) bucket and a ragged (4, 12289) width;
             tolerance 0 (integer ranks must be equal); CUDA-event times
  4. end to end: lbzip2_tpu_torch.codec.encoder.compress(data, 9,
             device="cuda") on ~60 MB generated from the seed, run
             twice; the warm run is timed and its launch counts read.
             The output must equal the repo's host C pipeline, run
             out of process as `bin/lbzip2 -9 -c`, byte for byte and
             round-trip through bz2; every device-eligible block must
             have gone through the device.

This process imports only the port (lbzip2_tpu_torch), never the JAX
package or JAX.

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import bz2
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BLOCK = 900_000
ROWS, WIDTH = 32, 901120
TEXT_BLOCKS = 64


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # device-only block encode, so the run shows the device did the work
    os.environ["LBZ2_HOST_STEAL"] = "0"
    os.environ["LBZ2_STEALBACK"] = "0"
    from lbzip2_tpu_torch import _build
    from lbzip2_tpu_torch.codec import encoder
    from lbzip2_tpu_torch.ops import mtf_pallas

    dev = torch.device("cuda", 0)
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {nvcc.stdout.strip().splitlines()[-1]}")

    t0 = time.time()
    _build.load("mtf_ranks")
    log(f"build: {time.time() - t0:.2f} s")
    for name, rec in _build.build_log.items():
        log(f"  {name}: nvcc {rec['seconds']:.2f} s\n{rec['ptxas']}")

    t0 = time.time()
    data, text = make_data(args.seed)
    eligible = encoder.device_eligible(data, 9)
    log(f"data: {len(data)} bytes, {eligible} device-eligible blocks, "
        f"{time.time() - t0:.1f} s to generate")

    record = kernel_phase(text, dev)

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

    record["launches"] = launches
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
