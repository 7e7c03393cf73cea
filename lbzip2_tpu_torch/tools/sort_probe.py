"""Sort probe: can a compare-exchange network beat torch.sort on the card?

Counterpart of tools/tpu_sort_probe.py (its ``main``).  The port's BWT
sorts each (32, 901120) batch with ``torch.sort``; a sort network of N =
2^20 keys needs about log2(N)^2 / 2 = 210 compare-exchange sweeps, and
twice the traffic once a payload rides along.  This measures, at the
production shape:

  1. ``torch.sort`` of 1 int32 key with an int32 payload gathered by the
     permutation (checked: sorted, payload follows its key);
  2. the port's own 8-key pass, ``ops/bwt2._lex_sort`` on 8 int32 keys;
  3. the sweep kernel (``ops/sort_sweeps.sweeps``) at 210 sweeps over
     the keys as (B, N / 128, 128) in 4 row blocks;

and prints the per-sweep time and the network projection (210 sweeps x
2 for the payload) against (1).  On a CUDA device the times come from
CUDA events; on the CPU (tests only) from the host clock, and say so.

    python3 -m lbzip2_tpu_torch.tools.sort_probe [--rows B] [--width N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lbzip2_tpu_torch.device import resolve, upload
from lbzip2_tpu_torch.ops import bwt2, sort_sweeps

NETWORK_SWEEPS = 210  # ~log2(N)^2 / 2 compare-exchange sweeps, N = 2^20


def _ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms per call after one warm-up call: CUDA events on a CUDA
    device, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / reps


def run(rows: int = 32, width: int = 901120, sweeps: int = NETWORK_SWEEPS,
        sub: int = 4, reps: int = 3, device: str | torch.device = "cuda",
        log=print) -> dict:
    """Run the probe on keys made from seed 0; returns its numbers (ms
    per call) and logs one line each.  ``width`` must be a multiple of
    128."""
    dev = resolve(device)
    clock = "cuda events" if dev.type == "cuda" else "host clock, cpu"
    rng = np.random.default_rng(0)
    keys = upload(rng.integers(0, 1 << 20, (rows, width), dtype=np.int32),
                  dev)
    payload = torch.arange(width, dtype=torch.int32,
                           device=dev)[None].expand(rows, width)

    def sort1():
        sk, perm = torch.sort(keys, dim=1)
        return sk, torch.gather(payload, 1, perm)

    log(f"sort probe: B={rows} N={width} on {dev} ({clock})")
    t1 = _ms(sort1, reps, dev)
    log(f"torch.sort 1 key + payload: {t1:.3f} ms")
    ks = [upload(rng.integers(0, 1 << 20, (rows, width), dtype=np.int32),
                 dev) for _ in range(8)]
    t8 = _ms(lambda: bwt2._lex_sort(ks), reps, dev)
    log(f"bwt2._lex_sort 8 keys (production pass): {t8:.3f} ms")
    sk, sp = sort1()
    if not bool((sk[:, 1:] >= sk[:, :-1]).all()):
        raise AssertionError("torch.sort 1 key: keys not sorted")
    if not torch.equal(torch.gather(keys, 1, sp.long()), sk):
        raise AssertionError("torch.sort 1 key: payload lost its key")
    k3 = keys.reshape(rows, width // sort_sweeps.LANES, sort_sweeps.LANES)
    ts = _ms(lambda: sort_sweeps.sweeps(k3, sweeps, sub), reps, dev)
    per = ts / sweeps if sweeps else float("nan")
    proj = per * NETWORK_SWEEPS * 2
    log(f"sweep kernel, {sweeps} sweeps, sub {sub}: {ts:.3f} ms")
    log(f"per-sweep: {per:.4f} ms; bitonic ({NETWORK_SWEEPS} sweeps, x2 "
        f"for payload) projection {proj:.3f} ms vs torch.sort {t1:.3f} ms")
    return {"device": str(dev), "clock": clock, "rows": rows,
            "width": width, "sweeps": sweeps, "sub": sub,
            "sort1_ms": t1, "sort8_ms": t8, "sweeps_ms": ts,
            "per_sweep_ms": per, "projection_ms": proj}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--width", type=int, default=901120)
    ap.add_argument("--sweeps", type=int, default=NETWORK_SWEEPS)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.rows, args.width, args.sweeps, reps=args.reps,
        device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
