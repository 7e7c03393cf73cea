"""Profile for the profile-guided build of the host C library.

``ensure(text)`` (bench_torch.py calls it before it times anything)
builds ``lbz2_native.so`` instrumented (``LBZ2_PGO_GEN``) in a child
process and runs a representative host workload on it, on ``text`` and
a MiB of random bytes: compress at levels 1, 5 and 9, the
sequential-split (``-u``) mode and parallel decompress.  The counts land
in ``build/lbzip2_tpu_torch/pgo/``; the instrumented library is then
removed, and the next load of the library (``native.get_lib``) rebuilds
it with ``-fprofile-use`` while the profile is newer than every source.
A profile belongs to the machine and the compiler that made it, and is
never committed.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

from lbzip2_tpu_torch import native

ROOT = pathlib.Path(__file__).resolve().parents[2]

# the text comes on stdin
WORKLOAD = r"""
import sys
import numpy as np
from lbzip2_tpu_torch.parallel.decode import decompress_parallel
from lbzip2_tpu_torch.parallel.encode import compress_parallel

rng = np.random.default_rng(0)
text = sys.stdin.buffer.read()
blob = (text * (6 * 900000 // len(text) + 1))[: 6 * 900000]
data = blob + rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
outs = [compress_parallel(data, lvl) for lvl in (1, 5, 9)]
compress_parallel(data[: 3 * 900000], 9, sequential_split=True)
for out in outs:
    assert decompress_parallel(out, device="cpu") == data
print("pgo workload done")
"""


def fresh(pgo: pathlib.Path = native._PGO) -> bool:
    """Whether ``pgo`` holds a profile newer than every source."""
    return native.pgo_flags(*native.pgo_inputs(pgo), pgo)[1] == "use"


def generate(text: bytes, pgo: pathlib.Path = native._PGO,
             workload: str = WORKLOAD, timeout_s: float = 1200) -> None:
    """Run ``workload`` on the instrumented library, ``text`` on its
    stdin, to write a fresh profile into ``pgo``; raises if it fails or
    leaves no profile."""
    pgo.mkdir(parents=True, exist_ok=True)
    for f in pgo.glob("*.gcda"):
        f.unlink()
    instrumented = pgo / native._SO.name
    instrumented.unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("LBZ2_")}
    env["LBZ2_PGO_GEN"] = str(pgo)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-c", workload], input=text,
                       env=env, cwd=ROOT, capture_output=True,
                       timeout=timeout_s)
    # the instrumented library must never be loaded for work
    instrumented.unlink(missing_ok=True)
    if r.returncode != 0 or not list(pgo.glob("*.gcda")):
        raise RuntimeError(f"PGO workload failed (exit {r.returncode}):\n"
                           f"{r.stderr.decode(errors='replace')[-4000:]}")


def ensure(text: bytes, pgo: pathlib.Path = native._PGO) -> bool:
    """Generate a profile on ``text`` unless a fresh one is there; True
    if it did."""
    if fresh(pgo):
        return False
    generate(text, pgo)
    return True
