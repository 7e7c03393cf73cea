#!/usr/bin/env python3
"""The controls of a cell's comparison, which ``correct`` must refuse.

- ``effort`` (compress cells): the port's timed path with the least
  effort it offers on its entropy coding, one EM refinement of the
  Huffman tables (``cluster_factor=1``, where the configuration runs
  the port's default of 8): the step that would tempt a later PR, since
  fewer refinements cost less on the card and on the host.  Its streams
  are valid and longer; ``size_excess`` must refuse them.  It runs on
  the card, at the cell's sizes, through the same loop as ``run.py``.
- ``level`` (compress cells): libbzip2 at one level below the
  configuration's, its header rewritten to the configuration's level
  (``BZh8`` data under a ``BZh9`` header): smaller blocks sort faster.
  It breaks the level's guarantee of one block a window of level x
  100,000 input bytes.  It needs no card.
- ``short`` (decompress cells): libbzip2's decoder with the output's
  last page left out, which breaks losslessness.  It needs no card.

    python3 gpubench/control.py --workload CELL --control KIND \\
        --seeds 1 2 3 [--bytes B]

prints, for each seed, the numbers the comparison reads and whether
they pass their limits, one answer a distinct file.  ``--bytes`` makes
the files smaller, and runs ``effort`` on the CPU (the tests' size).
"""

from __future__ import annotations

import argparse
import bz2
import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import corpus, reference, spec  # noqa: E402

KINDS = {"compress": ("effort", "level"), "decompress": ("short",)}


def compress_control(data: bytes, level: int) -> bytes:
    """libbzip2 at ``level - 1`` under a header of ``level``."""
    stream = bz2.compress(data, level - 1)
    return b"BZh" + str(level).encode() + stream[4:]


def decompress_control(stream: bytes, page: int) -> bytes:
    """libbzip2's decode of ``stream`` without its last ``page`` bytes."""
    return bz2.decompress(stream)[:-page]


def effort_loop(cell: spec.Cell, dry: bool):
    """The cell's compress loop as ``run.py`` makes it, set to one EM
    refinement; None where the cell takes more cards than there are."""
    from gpubench import loops, run

    run.configure_env(cell.config, ROOT)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not dry and cards < cell.chips:
        return None
    device = "cpu" if dry else ("cuda:0" if cell.chips == 1 else "cuda")
    loop = loops.LOOPS["compress"](cell.config, cell.traffic, device, dry)
    loop.compress_kwargs = {"cluster_factor": 1}
    return loop


def readings(cell: spec.Cell, kind: str, seed: int,
             nbytes: int | None = None, loop=None) -> dict:
    """The comparison's numbers for control ``kind`` on ``seed``'s files,
    one answer a file; ``loop`` is ``effort_loop``'s, warmed once."""
    files = corpus.make_files(cell.traffic, seed, nbytes)
    level = int(cell.config["level"])
    if kind == "effort":
        if not loop.files:
            loop.setup(files)
        loop.files = files
        numbers = reference.judge_compress(
            [(f.index, loop.call(f.index)) for f in files], files, level)
    elif kind == "level":
        with ThreadPoolExecutor(max_workers=len(files)) as ex:
            streams = list(ex.map(
                lambda f: compress_control(f.data, level), files))
        numbers = reference.judge_compress(
            list(enumerate(streams)), files, level)
    else:
        lvl = int(cell.traffic["encoder_level"])
        page = int(cell.traffic["page_bytes"])
        with ThreadPoolExecutor(max_workers=len(files)) as ex:
            outs = list(ex.map(lambda f: decompress_control(
                bz2.compress(f.data, lvl), page), files))
        numbers = reference.judge_decompress(list(enumerate(outs)), files)
    ok, checks = reference.verdict(numbers)
    return {"cell": cell.name, "control": kind, "seed": seed,
            "correct": ok, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bytes", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.control not in KINDS[cell.traffic["loop"]]:
        ap.error(f"{cell.name} has the controls "
                 f"{KINDS[cell.traffic['loop']]}")
    loop = None
    if args.control == "effort":
        loop = effort_loop(cell, args.bytes is not None)
        if loop is None:
            print(f"control: {cell.name} takes {cell.chips} CUDA device(s)",
                  file=sys.stderr)
            return 3
    for seed in args.seeds:
        print(json.dumps(readings(cell, args.control, seed, args.bytes,
                                  loop)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
