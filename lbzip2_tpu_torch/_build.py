"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC``
into ``build/lbzip2_tpu_torch/lib<name>.so`` beside the package (rebuilt
when the source or any header ``csrc/*.cuh`` is newer: the sources
include them by name) and loaded with ctypes, at first use or by
``build`` ahead of it, which starts one nvcc per source at once.  A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build" / "lbzip2_tpu_torch"
ARCH = "arch=compute_90a,code=sm_90a"

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
build_log: dict[str, dict] = {}  # name -> {"seconds", "ptxas"}


def nvcc_path() -> str:
    """Path of nvcc (PATH, then CUDA_HOME, then /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    return CSRC / f"{name}.cu", BUILD / f"lib{name}.so"


def build(names=None) -> None:
    """Compile every stale ``csrc/<name>.cu`` of ``names`` (default:
    every source), one nvcc process per source, all started together."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                      default=0.0)
        todo = []
        for name in names:
            src, so = _paths(name)
            if not so.exists() or \
                    so.stat().st_mtime < max(src.stat().st_mtime, headers):
                todo.append((name, src, so))
        if not todo:
            return
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.time()
        running = []
        for name, src, so in todo:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3",
                   "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                   "-o", str(tmp), str(src)]
            running.append((name, src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, src, so, tmp, proc in running:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src.name}:\n{err}")
                continue
            # atomic: a concurrent process never loads half a library
            os.replace(tmp, so)
            build_log[name] = {"seconds": time.time() - t0,
                               "ptxas": err.strip()}
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]
