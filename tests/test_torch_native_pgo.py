"""The profile-guided build of the port's host C library
(lbzip2_tpu_torch/native/__init__.py, lbzip2_tpu_torch/tools/gen_pgo.py):
the flag choice as a pure function, a stale profile skipped with one
message, and one real round trip with gcc into a temporary directory:
the instrumented build under LBZ2_PGO_GEN, a small workload, the
profiled build with no missing profile, and compress_parallel's bytes
equal from the plain and the profiled library (and the shared one).  No
test here builds the shared build/lbzip2_tpu_torch/lbz2_native.so."""

import ast
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import bench_torch
from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.parallel.encode import compress_parallel
from lbzip2_tpu_torch.tools import gen_pgo

ROOT = pathlib.Path(__file__).resolve().parent.parent
PGO = pathlib.Path("/p")
TEXT = bench_torch.text_class()


@pytest.mark.parametrize("newest, profiles, gen, flags, state", [
    (10.0, [], None, [], "none"),
    (10.0, [11.0, 12.0], None,
     ["-fprofile-use=/p", "-Werror=missing-profile"], "use"),
    (10.0, [10.0], None, ["-fprofile-use=/p", "-Werror=missing-profile"],
     "use"),
    (10.0, [12.0, 9.0], None, [], "stale"),
    (10.0, [], "/g", ["-fprofile-generate=/g", "-fprofile-update=atomic"],
     "gen"),
    (10.0, [9.0], "/g", ["-fprofile-generate=/g",
                         "-fprofile-update=atomic"], "gen"),
], ids=["none", "fresh", "fresh_same_second", "stale", "gen",
        "gen_over_stale"])
def test_pgo_flags(newest, profiles, gen, flags, state):
    assert native.pgo_flags(newest, profiles, PGO, gen) == (flags, state)


def test_child_code_imports_only_the_port():
    roots = set()
    for node in ast.walk(ast.parse(gen_pgo.WORKLOAD)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"sys", "numpy", "lbzip2_tpu_torch"}


def test_generate_raises_when_the_workload_fails(tmp_path):
    with pytest.raises(RuntimeError, match="exit 3"):
        gen_pgo.generate(b"", tmp_path / "pgo", "raise SystemExit(3)")


needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None,
                               reason="needs gcc")


@needs_gcc
def test_stale_profile_is_skipped_with_one_message(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.delenv("LBZ2_PGO_GEN", raising=False)
    pgo = tmp_path / "pgo"
    pgo.mkdir()
    old = pgo / "x.gcda"
    old.write_bytes(b"")
    os.utime(old, (0, 0))
    so = native._build(tmp_path / "lib.so", pgo)
    assert so == tmp_path / "lib.so" and so.exists()
    assert native.last_build["state"] == "stale"
    assert not any(f.startswith("-fprofile") for f in
                   native.last_build["cmd"])
    err = capsys.readouterr().err
    assert err.count("stale PGO profile") == 1


SMALL_WORKLOAD = r"""
import sys
import numpy as np
from lbzip2_tpu_torch.parallel.decode import decompress_parallel
from lbzip2_tpu_torch.parallel.encode import compress_parallel
text = sys.stdin.buffer.read()[:250000]
data = text + np.random.default_rng(0).integers(0, 256, 50000,
                                                dtype=np.uint8).tobytes()
out = compress_parallel(data, 1)
assert decompress_parallel(out, device="cpu") == data
"""

# compress_parallel of stdin on the library at argv[1] (its profile
# directory argv[2]): the sha256 of its output, and whether the library
# was built
LOAD = r"""
import hashlib, pathlib, sys
from lbzip2_tpu_torch import native
native._SO, native._PGO = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
from lbzip2_tpu_torch.parallel.encode import compress_parallel
out = compress_parallel(sys.stdin.buffer.read(), 1)
print(hashlib.sha256(out).hexdigest(), bool(native.last_build))
"""


def _load(so, pgo) -> list[str]:
    env = {k: v for k, v in os.environ.items() if not k.startswith("LBZ2_")}
    r = subprocess.run([sys.executable, "-c", LOAD, str(so), str(pgo)],
                       input=TEXT[:400000], capture_output=True, cwd=ROOT,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr.decode(errors="replace")
    return r.stdout.decode().split()


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A profile from the small workload, and the profiled and plain
    libraries built in a temporary directory."""
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc")
    d = tmp_path_factory.mktemp("pgo")
    pgo = d / "pgo"
    gen_pgo.generate(TEXT, pgo, SMALL_WORKLOAD)
    builds = {}
    for name, prof in (("profiled", pgo), ("plain", d / "none")):
        so = native._build(d / f"{name}.so", prof)
        builds[name] = (so, prof, dict(native.last_build))
    return pgo, builds


def test_generate_leaves_a_profile_and_no_instrumented_library(profiled):
    pgo, _ = profiled
    assert [p.name.endswith("#lbz2-lbz2_native.gcda")
            for p in pgo.iterdir()] == [True]
    assert gen_pgo.fresh(pgo)


def test_profiled_build_uses_the_profile(profiled):
    _, builds = profiled
    so, pgo, log = builds["profiled"]
    assert log["state"] == "use" and f"-fprofile-use={pgo}" in log["cmd"]
    assert "-Werror=missing-profile" in log["cmd"]
    assert "missing-profile" not in log["stderr"], log["stderr"]
    assert builds["plain"][2]["state"] == "none"
    assert so.read_bytes() != builds["plain"][0].read_bytes()
    # a library newer than its profile is not rebuilt
    native.last_build.clear()
    assert native._build(so, pgo) == so and not native.last_build


def test_profiled_library_compresses_the_same_bytes(profiled):
    _, builds = profiled
    want = _load(*builds["plain"][:2])
    assert want[1] == "False"  # loaded as built, no rebuild in the child
    assert _load(*builds["profiled"][:2]) == want
    assert hashlib.sha256(compress_parallel(
        TEXT[:400000], 1)).hexdigest() == want[0]
