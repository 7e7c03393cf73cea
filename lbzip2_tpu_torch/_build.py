"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared
-Xcompiler -fPIC`` into ``build/lbzip2_tpu_torch/lib<name>.so`` beside
the package (rebuilt when the source is newer) and loaded with ctypes.
A missing ``nvcc`` or a failed build raises: there is no fallback.
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
_lock = threading.Lock()
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


def _compile(name: str, src: pathlib.Path, so: pathlib.Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(src)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads half
    build_log[name] = {"seconds": time.time() - t0,
                       "ptxas": proc.stderr.strip()}


def load(name: str) -> ctypes.CDLL:
    """ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        so = BUILD / f"lib{name}.so"
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            _compile(name, src, so)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]
