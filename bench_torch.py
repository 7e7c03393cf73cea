"""Benchmark of the PyTorch + CUDA port on one GPU: compress and decompress
throughput on a mixed corpus of about 1 GB.

    python3 bench_torch.py [--size BYTES] [--seed S]

The port's counterpart of bench.py.  Before it times anything it makes
sure that the host C library has a fresh profile for its profile-guided
build (lbzip2_tpu_torch/tools/gen_pgo.py).  Then six legs, in order, each
timed by a host clock around a call that returns bytes, and each output
checked before its number counts:

1. host compress: compress_parallel(data, 9), best of 3 after a one-block
   warm call; the bz2 round trip.
2. host decompress: decompress_parallel with both device stages off, best
   of 2; equal to the data.
3. level parity: data[:24,000,000] at levels 1, 5 and 9 through the
   device engine (codec.encoder.compress, after warm_device, device only:
   a child process with LBZ2_HOST_STEAL=0) and the host C pipeline
   (compress_parallel): byte-identical, both through the bz2 round trip,
   and the device's blocks above 0 at levels 5 and 9 (level 1's 100 kB
   blocks take the host engine by design).  There is no reference lbzip2
   binary: the port's host C pipeline is the reference.
4. device compress in chain mode, the shipped default (host stealing and
   steal-back on): warm_device, a 56-block warm compress, the pool
   drained, then the timed compress(data, 9): equal to leg 1's bytes,
   and on the card the device's blocks above 0.
5. device compress in token mode: leg 4 in a child process with
   LBZ2_DEVICE_CHAIN=0, which builds the corpus from the seed again:
   equal to leg 1's bytes, the device's blocks above 0.
6. decompress with both device stages (LBZ2_DEVICE_DECODE=1,
   LBZ2_DEVICE_HUFF=1) in a child process: decompress_parallel and
   decompress_stream over in-memory chunks of leg 4's output, one call
   each after a warm call: equal to the data.

The last line of stdout is one JSON object under 500 bytes; each leg's
seconds go to stderr and the rest to bench_torch_telemetry.json beside
this file.  Without CUDA, with a variable of the port (LBZ2_*) set, or
when a leg fails, it exits non-zero and prints nothing on stdout.  It
imports torch, numpy, bz2 and lbzip2_tpu_torch only, and so do its child
processes.
"""

from __future__ import annotations

import argparse
import bz2
import glob
import hashlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.device import resolve
from lbzip2_tpu_torch.parallel import decode
from lbzip2_tpu_torch.parallel.encode import compress_parallel
from lbzip2_tpu_torch.tools import gen_pgo

HERE = pathlib.Path(__file__).resolve().parent
TELEMETRY = HERE / "bench_torch_telemetry.json"
BLOCK = 900_000
LEVEL = 9
PARITY_BYTES = 24_000_000
PARITY_LEVELS = (1, 5, 9)
WARM_BLOCKS = 56
# the engine's split of a compress, from encoder.last_stats
SPLIT = ("device_blocks", "host_blocks", "periodic_blocks", "stale_rows")
METRIC = "compress_MBps_level9_chain_default"

# Corpus classes and their shares of the data (bench.py's): text, ELF
# binaries of the system, XML-like records, random bytes.
SHARES = (("text", 0.50), ("elf", 0.25), ("xml", 0.15), ("random", 0.10))
ELF_GLOBS = ("/usr/lib/x86_64-linux-gnu/libc.so*",
             "/usr/lib/x86_64-linux-gnu/libstdc++*",
             "/usr/lib/x86_64-linux-gnu/libm.so*", "/usr/bin/python3*")
ELF_LIMIT = 24 << 20
XML_BYTES = 8 << 20
RANDOM_BYTES = 4 << 20
PAD = 4 << 20  # each class's part is its share of the size plus this
PAGE = 4096

# The text class: the JAX package's Python and C sources, read as bytes
# (nothing is imported), each pattern's matches in sorted order.  That
# package is frozen, so the corpus is the same in every checkout.
TEXT_GLOBS = ("lbzip2_tpu/**/*.py", "lbzip2_tpu/native/*.c")

# Every environment variable of the port starts with this: each one
# changes what a leg measures, and a child process gets only the ones
# its leg sets, so the bench refuses to start with any of them.
SWITCH_PREFIX = "LBZ2_"

NULL_KEYS = {
    "vs_baseline": "bench.py's baseline, 62.5 MB/s a chip, is a target for "
    "a TPU v5e-16 (BASELINE.md); the port has no baseline on the GPU yet",
    "decompress_floor_55_ok": "bench.py's floor of 55 MB/s was set on the "
    "TPU's host; the port's decompress floor is unset until a benchmark "
    "sets one",
    "reference_binary_same_box": "no reference lbzip2 binary: its sources "
    "are not in the checkout; level parity holds the device engine to the "
    "port's host C pipeline (compress_parallel) instead",
}


def log(msg: str) -> None:
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _jsonable(o):
    return o.item() if hasattr(o, "item") else str(o)


def text_class() -> bytes:
    """Every file of TEXT_GLOBS under the checkout, concatenated."""
    out = []
    for pat in TEXT_GLOBS:
        for f in sorted(glob.glob(str(HERE / pat), recursive=True)):
            with open(f, "rb") as fh:
                out.append(fh.read())
    return b"".join(out)


def _read_elf() -> tuple[bytes, list[str]]:
    """Up to ELF_LIMIT bytes of the ELF_GLOBS files, each pattern's
    matches in sorted order; and the files read."""
    out, files, total = [], [], 0
    for pat in ELF_GLOBS:
        for f in sorted(glob.glob(pat)):
            if not os.path.isfile(f):
                continue
            try:
                with open(f, "rb") as fh:
                    b = fh.read()
            except OSError:
                continue
            out.append(b)
            files.append(f)
            total += len(b)
            if total >= ELF_LIMIT:
                return b"".join(out)[:ELF_LIMIT], files
    return b"".join(out), files


def corpus_parts(size: int, rng: np.random.Generator
                 ) -> tuple[dict[str, bytes], dict]:
    """Each class's part before the page shuffle (its share of ``size``
    plus PAD, its source repeated), and what was read."""
    text = text_class()
    elf, elf_files = _read_elf()
    check(bool(text), "corpus: the text class is empty")
    check(bool(elf), f"corpus: the ELF class is empty ({ELF_GLOBS})")
    words = [w for w in text.split(b" ") if 2 < len(w) < 16][:4096]
    check(bool(words), "corpus: the text class has no words for the XML")
    recs, total, i = [], 0, 0
    while total < XML_BYTES:
        w = words[int(rng.integers(len(words)))]
        rec = b"<rec id=\"%d\"><k>%s</k><v>%d</v></rec>\n" % (
            i, w, int(rng.integers(1 << 30)))
        recs.append(rec)
        total += len(rec)
        i += 1
    sources = {"text": text, "elf": elf, "xml": b"".join(recs),
               "random": rng.integers(0, 256, RANDOM_BYTES,
                                      dtype=np.uint8).tobytes()}
    parts = {}
    for name, share in SHARES:
        want = int(size * share) + PAD
        blob = sources[name]
        parts[name] = (blob * (want // len(blob) + 1))[:want]
    return parts, {"source_bytes": {k: len(v) for k, v in sources.items()},
                   "part_bytes": {k: len(v) for k, v in parts.items()},
                   "elf_files": elf_files}


def build_corpus(size: int, seed: int) -> tuple[bytes, dict]:
    """``size`` bytes of the four classes at their shares, shuffled in
    4 KiB pages so that every 900 kB block sees a mix and long-range
    repeats do not dominate; the same bytes for the same seed and
    checkout.  Returns the data and what it was made of (sha256, each
    class's bytes, the ELF files read)."""
    rng = np.random.default_rng(seed)
    parts, info = corpus_parts(size, rng)
    blob = b"".join(parts[name] for name, _ in SHARES)
    del parts
    pages = [blob[i:i + PAGE] for i in range(0, len(blob), PAGE)]
    del blob
    rng.shuffle(pages)
    data = b"".join(pages)[:size]
    info["sha256"] = sha256(data)
    return data, info


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi) and the card count."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_W": None, "count": 0}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = line.rsplit(",", 1)
    watts = limit.strip().removesuffix(" W")
    return {"name": name.strip(),
            "power_limit_W": float(watts) if watts.replace(
                ".", "", 1).isdigit() else None,
            "count": torch.cuda.device_count()}


def _timed(fn, reps: int) -> tuple[bytes, list[float]]:
    """fn()'s result and the seconds of each of ``reps`` calls."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
    return out, secs


def host_compress(data: bytes) -> tuple[bytes, list[float]]:
    """Leg 1 without its check: a one-block warm call, then three timed
    calls of compress_parallel(data, 9)."""
    compress_parallel(data[:BLOCK], LEVEL)
    return _timed(lambda: compress_parallel(data, LEVEL), 3)


def device_took(stats: dict, dev: torch.device) -> None:
    """A compress leg's rate is the card's only if the card took blocks:
    on the card, fail when it took none.  On the CPU, which only the
    tests use, a one-block stream goes to whichever of the host and the
    plain versions delivers first."""
    check(dev.type != "cuda" or stats["device_blocks"] > 0,
          f"device compress: the device took no block ({stats['host_blocks']}"
          f" on the host, {stats['stale_rows']} stale rows)")


def _warm(data: bytes, dev: torch.device) -> float:
    """encoder.warm_device at the bucket the data's blocks take."""
    bucket = min(b for b in encoder._BUCKETS if b >= min(len(data), BLOCK))
    return encoder.warm_device(bucket=bucket, device=dev)


def _device_compress(data: bytes, dev: torch.device) -> tuple[bytes, dict]:
    """Legs 4 and 5: warm the engine at the bucket the data's blocks
    take, a 56-block warm compress, drain the pool, then the timed
    compress.  A warm pass leaves device batches draining, which the
    timed run must not overlap."""
    warm_device_s = _warm(data, dev)
    _, warm_s = _timed(lambda: encoder.compress(
        data[:WARM_BLOCKS * BLOCK], LEVEL, device=dev), 1)
    encoder._GATE.wait_idle(max_inflight=0)
    check(encoder._GATE.inflight == 0,
          "device batches of the warm compress are still in flight")
    out, secs = _timed(lambda: encoder.compress(data, LEVEL, device=dev), 1)
    stats = encoder.last_stats
    device_took(stats, dev)
    return out, {"warm_device_s": warm_device_s, "warm_compress_s": warm_s[0],
                 "s": secs[0], "MBps": len(data) / secs[0] / 1e6,
                 "sha256": sha256(out), "bytes": len(out), "stats": stats}


def _parity_leg(data: bytes, dev: torch.device) -> dict:
    """Leg 3's device side, device only (LBZ2_HOST_STEAL=0), so that
    every block in a device bucket goes through the kernels: each
    level's output bytes, its bz2 round trip and the engine's split."""
    check(not encoder._HOST_STEAL, "parity leg without LBZ2_HOST_STEAL=0")
    out = {"warm_device_s": _warm(data, dev)}
    for lvl in PARITY_LEVELS:
        z = encoder.compress(data, lvl, device=dev)
        out[str(lvl)] = {"sha256": sha256(z), "bytes": len(z),
                         "roundtrip": bz2.decompress(z) == data,
                         **{k: encoder.last_stats[k] for k in SPLIT}}
    return out


def _token_leg(req: dict, dev: torch.device) -> dict:
    check(not encoder._DEVICE_CHAIN, "token leg without LBZ2_DEVICE_CHAIN=0")
    data, corpus = build_corpus(req["size"], req["seed"])
    check(corpus["sha256"] == req["corpus_sha256"],
          "the token leg's corpus differs from the parent's")
    return _device_compress(data, dev)[1]


def _decode_leg(req: dict, blob: bytes, dev: torch.device) -> dict:
    check(decode.DEVICE_HUFF and decode.DEVICE_IBWT,
          "decode leg without LBZ2_DEVICE_HUFF=1 and LBZ2_DEVICE_DECODE=1")
    _, warm_s = _timed(lambda: decode.decompress_parallel(
        bz2.compress(text_class()[:BLOCK]), device=dev), 1)
    out, par_s = _timed(lambda: decode.decompress_parallel(blob, device=dev),
                        1)
    par_ok = len(out) == req["n"] and sha256(out) == req["sha256"]
    par_stats = decode.last_stats
    del out
    chunks: list[bytes] = []
    _, stream_s = _timed(lambda: decode.decompress_stream(
        io.BytesIO(blob).read, chunks.append, device=dev), 1)
    out = b"".join(chunks)
    return {"warm_s": warm_s[0], "parallel_s": par_s[0],
            "parallel_ok": par_ok, "parallel_stats": par_stats,
            "stream_s": stream_s[0], "stream_ok": len(out) == req["n"] and
            sha256(out) == req["sha256"], "stream_stats": decode.last_stats}


def child() -> int:
    """Legs 3, 5 and 6 in a child process: one JSON line of the request on
    stdin, then the leg's input; prints one JSON line of the result."""
    req = json.loads(sys.stdin.buffer.readline())
    payload = sys.stdin.buffer.read()
    dev = resolve(req["device"])
    if req["leg"] == "parity":
        res = _parity_leg(payload, dev)
    elif req["leg"] == "token":
        res = _token_leg(req, dev)
    else:
        res = _decode_leg(req, payload, dev)
    print(json.dumps(res, default=_jsonable), flush=True)
    return 0


def _run_child(req: dict, payload: bytes, env: dict) -> dict:
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(SWITCH_PREFIX)}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, bench_torch; sys.exit(bench_torch.child())"],
        input=json.dumps(req).encode() + b"\n" + payload,
        capture_output=True, env={**base, **env}, cwd=HERE, timeout=3000)
    sys.stderr.write(r.stderr.decode(errors="replace"))
    check(r.returncode == 0, f"{req['leg']} leg exited {r.returncode}")
    return json.loads(r.stdout.decode().strip().splitlines()[-1])


def level_parity(data: bytes, dev: torch.device) -> dict:
    """Leg 3: the device engine, device only in a child process, against
    the host C pipeline at levels 1, 5 and 9.  Level 1's 100 kB blocks
    take the host engine by design; at levels 5 and 9 the device must
    have taken blocks."""
    dev_side = _run_child({"leg": "parity", "device": str(dev)}, data,
                          {"LBZ2_HOST_STEAL": "0"})
    out = {"warm_device_s": dev_side.pop("warm_device_s")}
    for lvl in PARITY_LEVELS:
        ours = dev_side[str(lvl)]
        ref = compress_parallel(data, lvl)
        out[str(lvl)] = {**ours, "host_c": len(ref),
                         "identical": ours["sha256"] == sha256(ref),
                         "roundtrip": ours["roundtrip"] and
                         bz2.decompress(ref) == data}
    return out


def check_defaults() -> None:
    """Raise unless the process runs the shipped defaults: no variable
    of the port set, and the engine's and the decoder's switches as
    shipped."""
    switches = sorted(k for k in os.environ if k.startswith(SWITCH_PREFIX))
    check(not switches and encoder._DEVICE and encoder._DEVICE_CHAIN and
          encoder._HOST_STEAL and encoder._STEALBACK and
          not decode.DEVICE_HUFF and not decode.DEVICE_IBWT,
          "the legs measure the shipped defaults: start without "
          f"{SWITCH_PREFIX}* variables (set: {switches})")


def run(size: int, seed: int, device: str = "cuda") -> tuple[dict, dict]:
    """The six legs on ``size`` bytes of the corpus of ``seed``; returns
    the headline and the telemetry.  Only the tests pass ``"cpu"``."""
    dev = resolve(device)
    check_defaults()
    t0 = time.perf_counter()
    data, corpus = build_corpus(size, seed)
    tele = {"size": size, "seed": seed, "device": str(dev),
            "corpus": corpus, "corpus_s": time.perf_counter() - t0,
            "null_keys": NULL_KEYS}
    log(f"corpus: {size} bytes, sha256 {corpus['sha256']}, "
        f"{tele['corpus_s']:.2f} s")
    mb = size / 1e6

    host_out, secs = host_compress(data)
    check(bz2.decompress(host_out) == data, "host compress: bz2 round trip")
    tele["host_compress_s"] = secs
    log(f"leg 1 host compress: {secs} s")

    rt, secs = _timed(lambda: decode.decompress_parallel(host_out,
                                                         device=dev), 2)
    check(rt == data, "host decompress differs from the data")
    del rt
    tele["host_decompress_s"] = secs
    log(f"leg 2 host decompress: {secs} s")

    t0 = time.perf_counter()
    parity = level_parity(data[:PARITY_BYTES], dev)
    levels = [parity[str(lvl)] for lvl in PARITY_LEVELS]
    check(all(v["roundtrip"] for v in levels),
          f"level parity: a bz2 round trip failed: {parity}")
    check(all(parity[lvl]["device_blocks"] > 0 for lvl in ("5", "9")),
          f"level parity: the device took no block at level 5 or 9: {parity}")
    tele["level_parity"] = parity
    log(f"leg 3 level parity: {time.perf_counter() - t0:.2f} s, "
        f"{json.dumps(parity)}")

    dev_out, chain = _device_compress(data, dev)
    check(dev_out == host_out, "device compress differs from the host's")
    tele["chain"] = chain
    log(f"leg 4 device compress, chain mode: warm_device "
        f"{chain['warm_device_s']:.2f} s, warm {chain['warm_compress_s']:.2f}"
        f" s, timed {chain['s']} s")

    token = _run_child({"leg": "token", "size": size, "seed": seed,
                        "device": str(dev),
                        "corpus_sha256": corpus["sha256"]}, b"",
                       {"LBZ2_DEVICE_CHAIN": "0"})
    check(token["sha256"] == sha256(host_out),
          "token-mode compress differs from the host's")
    tele["token"] = token
    log(f"leg 5 device compress, token mode: timed {token['s']} s")

    dec = _run_child({"leg": "decode", "device": str(dev), "n": size,
                      "sha256": corpus["sha256"]}, dev_out,
                     {"LBZ2_DEVICE_DECODE": "1", "LBZ2_DEVICE_HUFF": "1"})
    check(dec["parallel_ok"] and dec["stream_ok"],
          "decompress with the device stages differs from the data")
    tele["device_decode"] = dec
    log(f"leg 6 decompress with both device stages: parallel "
        f"{dec['parallel_s']} s, stream {dec['stream_s']} s")

    card = card_info(dev)
    head = {
        "metric": METRIC,
        "value": round(chain["MBps"], 2),
        "unit": "MB/s",
        "vs_baseline": None,
        "host_MBps": round(mb / min(tele["host_compress_s"]), 2),
        "device_MBps": round(chain["MBps"], 2),
        "decompress_MBps": round(mb / min(tele["host_decompress_s"]), 2),
        "decompress_floor_55_ok": None,
        "bit_identical_1_5_9": all(v["identical"] for v in levels),
        "reference_binary_same_box": None,
        "token_MBps": round(token["MBps"], 2),
        "decompress_device_MBps": round(mb / dec["parallel_s"], 2),
        "decompress_stream_device_MBps": round(mb / dec["stream_s"], 2),
        "device": card,
    }
    check(len(json.dumps(head)) < 500, "the headline line is too long")
    return head, tele


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1120 * BLOCK,
                    help="corpus bytes (default 1,008,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # both raise before the profile's minutes: without a card, and with
    # a switch set
    resolve("cuda")
    check_defaults()
    t0 = time.perf_counter()
    generated = gen_pgo.ensure(text_class())
    log(f"PGO profile {'generated' if generated else 'fresh'}: "
        f"{time.perf_counter() - t0:.2f} s")
    head, tele = run(args.size, args.seed, "cuda")
    tele["pgo"] = {"generated": generated, "state": native.pgo_flags(
        *native.pgo_inputs(), native._PGO)[1], "build": native.last_build}
    with open(TELEMETRY, "w") as fh:
        json.dump(tele, fh, indent=1, default=_jsonable)
    print(json.dumps(head), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
