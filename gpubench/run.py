#!/usr/bin/env python3
"""One run of one cell of the port's benchmark on the GPUs of this machine.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout.  BENCHMARK.json names the cell, its
configuration and its traffic mix; the run sets the configuration's
switches of the port in its own environment, makes the cell's files from
the seed, warms the engine, then calls the port file after file for S
seconds (a closed loop, one client).  Once the window has closed it reads
the peak of device memory, judges every answer against the reference
(``reference.py``) and prints one JSON line last on stdout: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1``, under ``torch.profiler``, its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``, each number
compared beside its limit, which also end stderr.

Without a card, or with fewer cards than the cell takes, it exits 3 and
prints no result; with ``jax``, ``jaxlib``, ``flax`` or ``lbzip2_tpu``
loaded it exits 4; a traced run in which a per-layer metric the cell
lists reads nothing, or a byte count found a layout it does not know,
exits 5.  ``--dry-bytes B`` runs the cell on the CPU with files
of B bytes: the tests' mode, never a measurement (its line says
``"dry_run": true`` and its platform is ``cpu``).

Every build and kernel cache stays inside the checkout: the port builds
into ``build/lbzip2_tpu_torch/``, and ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` are set to fixed directories under
``build/gpubench/``.
"""

from __future__ import annotations

import time

T0 = time.time()  # noqa: E402 — set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lbzip2_tpu")
SWITCH_PREFIX = "LBZ2_"
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4
EXIT_UNREAD = 5


def log(msg: str) -> None:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-bytes", type=int, default=None,
                    help="run on the CPU with files of this many bytes "
                    "(tests only; never a measurement)")
    return ap.parse_args(argv)


def configure_env(config: dict, root: pathlib.Path) -> None:
    """The port's switches from the configuration, and no other LBZ2_
    variable; the build caches at fixed paths inside the checkout."""
    for k in [k for k in os.environ if k.startswith(SWITCH_PREFIX)]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in config["env"].items()})
    cache = root / "build" / "gpubench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def card_info(chips: int) -> dict:
    """The cards a run uses: platform, name, count, and the power limit
    nvidia-smi reads (None where it reads none)."""
    import torch

    watts = None
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
        watts = float(line[0]) if line else None
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_W": watts}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def per_layer(cell: spec.Cell, ctx: dict,
              root: pathlib.Path) -> tuple[dict, list[str]]:
    """Each per-layer metric's reader on ``ctx``, and the names of those
    that found nothing to read (their readers return None)."""
    out, unread = {}, []
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"], root).read(ctx)
        if value is None:
            unread.append(m["name"])
        else:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out, unread


def host_readings(win) -> str:
    """Each call's share of one core's time this process used, and the
    share of the machine the other processes and the hypervisor's steal
    took, as one log line."""
    cores = os.cpu_count() or 1
    rows = []
    for s, (cpu, busy, steal) in zip(win.call_s, win.host):
        if busy is None:
            rows.append(f"{s:.3f}s cpu {cpu / s:.2f}")
            continue
        others = max(0.0, busy - cpu) / (cores * s)
        rows.append(f"{s:.3f}s cpu {cpu / s:.2f} others {others:.3f} "
                    f"steal {steal / (cores * s):.3f}")
    return "; ".join(rows)


def main(argv=None, call_wrapper=None, root: pathlib.Path = ROOT) -> int:
    """One run; returns the exit code.  ``call_wrapper(loop, call)``
    stands a broken call in for the loop's (the tests' faults)."""
    args = parse(argv)
    cell = spec.cell(args.workload, root)
    dry = args.dry_bytes is not None
    configure_env(cell.config, root)

    import torch

    marks = {"torch_s": time.time() - T0}
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not dry and cards < cell.chips:
        log(f"{cell.name} takes {cell.chips} CUDA device(s); this machine "
            f"has {cards}: no result")
        return EXIT_NO_CARD

    from gpubench import corpus, instrument, loops, reference, trace

    kind = cell.traffic["loop"]
    device = "cpu" if dry else ("cuda:0" if cell.chips == 1 else "cuda")
    card = {"platform": "cpu", "kind": "cpu", "count": 0,
            "power_limit_W": None} if dry else card_info(cell.chips)
    log(f"{cell.name} seed {args.seed}: {card}")
    marks["card_s"] = time.time() - T0
    loop = loops.LOOPS[kind](cell.config, cell.traffic, device, dry)
    marks["port_s"] = time.time() - T0
    t0 = time.time()
    files = corpus.make_files(cell.traffic, args.seed, args.dry_bytes, root)
    corpus_s = time.time() - t0
    print(json.dumps({"cell": cell.name, "seed": args.seed, "card": card,
                      "files_sha256": [f.sha256 for f in files],
                      "file_bytes": [len(f.data) for f in files]}),
          flush=True)
    steps = loop.setup(files)
    setup_s = time.time() - T0
    marks = {k: round(v, 3) for k, v in marks.items()}
    log(f"set-up {setup_s:.3f} s (since start: {marks}; corpus "
        f"{corpus_s:.3f} s, {steps})")

    call = call_wrapper(loop, loop.call) if call_wrapper else loop.call
    rec = instrument.Recorder()
    summary = None
    with trace.profiled(bool(args.trace), rec) as prof:
        if prof is not None:
            with loop.spans(rec):
                win = loops.run_window(loop, args.seconds,
                                       instrument.span(rec, "call", call))
        else:
            win = loops.run_window(loop, args.seconds, call)
    if prof is not None:
        summary = trace.summarize(prof, rec)
        del prof
    peak = 0
    if not dry:
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(cell.chips))
    log(f"window {win.wall_s:.3f} s, {len(win.answers)} calls, "
        f"{win.nbytes} bytes, errors {win.errors[:3]}")
    log(f"calls: {host_readings(win)}")

    if args.trace:
        ctx = {"cell": cell, "calls": win.calls, "window": win,
               "trace": summary, "card": card,
               "device_bytes": loop.device_bytes(win, rec)}
        metrics, unread = per_layer(cell, ctx, root)
        if rec.faults or (unread and not dry):
            log(f"metrics that read nothing: {unread}; layout faults: "
                f"{rec.faults[:3]}: no result")
            return EXIT_UNREAD
    else:
        metrics = {loop.metric: {"value": win.nbytes / win.wall_s / 1e6,
                                 "unit": "MB/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    t0 = time.time()
    numbers = loop.judge(win)
    log(f"reference check {time.time() - t0:.3f} s")
    correct, checks = reference.verdict(numbers)
    device = {**card, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": bool(correct), "attempted": len(win.answers),
              "failed": numbers["files_wrong"], "metrics": metrics,
              "device": device}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    if dry:
        result["dry_run"] = True
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}: no result")
        return EXIT_FORBIDDEN
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
