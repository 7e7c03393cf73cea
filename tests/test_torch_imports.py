"""The port is a package of its own: no source file of it (and not
chip_smoke.py or bench_torch.py) imports the JAX package, jax or
jaxlib, and a process that imports every port module and runs its entry
points ends with none of the three loaded.  Its native library is built
from its own sources into build/lbzip2_tpu_torch/.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FOREIGN = {"lbzip2_tpu", "jax", "jaxlib"}
SOURCES = sorted((ROOT / "lbzip2_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_of_the_jax_package(path):
    assert not _imported_roots(path) & FOREIGN


def test_every_module_is_covered():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for must in ("core/constants.py", "core/bits.py", "core/crc32.py",
                 "native/__init__.py", "ref/encoder.py", "ref/decoder.py",
                 "utils/trace.py", "parallel/encode.py",
                 "parallel/scheduler.py", "parallel/decode.py",
                 "codec/decoder.py", "codec/encoder.py", "cli.py",
                 "parallel/sharding.py", "parallel/multihost.py",
                 "entry.py", "ops/crc.py", "ops/bitpack.py", "ops/mtf.py",
                 "ops/rle2.py", "codec/rle2.py"):
        assert f"lbzip2_tpu_torch/{must}" in names


_CHILD = r"""
import importlib, io, os, pkgutil, sys
import numpy as np
import lbzip2_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from lbzip2_tpu_torch import cli, native
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.parallel import decode
rng = np.random.default_rng(4)
data = bytes(rng.integers(97, 105, 7000, dtype=np.uint8))
for chain in (True, False):
    encoder._DEVICE_CHAIN = chain
    blob = encoder.compress(data, 9, device="cpu")
    assert encoder.last_stats["device_blocks"] + \
        encoder.last_stats["host_blocks"] == 1
assert decode.decompress_parallel(blob, device="cpu") == data
out = []
decode.decompress_stream(io.BytesIO(blob).read, out.append, device="cpu")
assert b"".join(out) == data
cli.DEVICE = "cpu"
path = sys.argv[1]
with open(path, "wb") as f:
    f.write(data)
for engine in ("auto", "device"):
    os.environ["LBZIP2_TPU_ENGINE"] = engine
    assert cli.main(["lbzip2", "-k", "-f", path]) == 0
    assert open(path + ".bz2", "rb").read() == blob
    assert cli.main(["lbunzip2", "-k", "-f", path + ".bz2"]) == 0
    assert open(path, "rb").read() == data
so = os.path.realpath(native._SO)
assert so.endswith(os.path.join("build", "lbzip2_tpu_torch",
                                "lbz2_native.so")), so
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("lbzip2_tpu", "jax", "jaxlib"))
assert not loaded, loaded
print("clean")
"""


def test_child_process_ends_without_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("LBZIP2", "BZIP2", "BZIP", "LBZIP2_TPU_ENGINE",
                        "LBZ2_DEVICE_CHAIN")}
    r = subprocess.run([sys.executable, "-c", _CHILD,
                        str(tmp_path / "x.txt")], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "clean"


def test_pool_and_cli_stand_alone():
    """The engine is no subclass of another package's class, and the CLI
    binds no attribute of another package's module."""
    from lbzip2_tpu_torch import cli
    from lbzip2_tpu_torch.codec import encoder
    assert encoder._TorchPool.__mro__ == (encoder._TorchPool, object)
    tree = ast.parse(pathlib.Path(cli.__file__).read_text())
    imported = set()  # every name an import statement binds in cli.py
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0]
                         for a in node.names}
    assert {"os", "sys", "signal"} <= imported
    for node in ast.walk(tree):
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, (ast.AugAssign,
                                               ast.AnnAssign)) else []
        for target in targets:
            for leaf in ast.walk(target):
                if isinstance(leaf, ast.Attribute):
                    base = leaf.value
                    while isinstance(base, ast.Attribute):
                        base = base.value
                    assert not (isinstance(base, ast.Name) and
                                base.id in imported), ast.dump(leaf)
