"""The port's kernel build (lbzip2_tpu_torch/_build.py) off the card: a
stand-in nvcc script shows that every stale source gets its own
compiler process, that up-to-date libraries are not rebuilt and that a
failed or missing compiler raises."""

import os
import stat

import pytest

from lbzip2_tpu_torch import _build

FAKE_NVCC = """#!/bin/sh
# writes the -o target and the ptxas report, or fails for bad.cu
for a in "$@"; do last="$a"; done
case "$last" in *bad.cu) echo "bad.cu: error" >&2; exit 1;; esac
while [ "$1" != "-o" ]; do shift; done
echo "lib" > "$2"
echo "ptxas info    : 0 bytes stack frame, 0 bytes spill stores" >&2
"""


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_log", {})
    return csrc, build


def test_build_compiles_every_stale_source_once(tree):
    csrc, build = tree
    _build.build()
    assert sorted(_build.build_log) == ["one", "two"]
    assert all("0 bytes spill" in r["ptxas"]
               for r in _build.build_log.values())
    assert sorted(os.listdir(build)) == ["libone.so", "libtwo.so"]
    _build.build_log.clear()
    _build.build()  # both libraries are newer than their sources
    assert _build.build_log == {}


def test_newer_header_makes_every_library_stale(tree):
    """A source includes the headers beside it: a header touched after
    the build rebuilds the libraries, an older one does not."""
    csrc, build = tree
    header = csrc / "shared.cuh"
    header.write_text("// device functions\n")
    _build.build()
    _build.build_log.clear()
    _build.build()
    assert _build.build_log == {}
    newest = max(p.stat().st_mtime for p in build.iterdir())
    os.utime(header, (newest + 5, newest + 5))
    _build.build()
    assert sorted(_build.build_log) == ["one", "two"]


def test_build_failure_raises(tree):
    csrc, _ = tree
    (csrc / "bad.cu").write_text("// does not compile\n")
    with pytest.raises(RuntimeError, match="nvcc failed for bad.cu"):
        _build.build()
    assert sorted(_build.build_log) == ["one", "two"]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.pathlib.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


KERNELS = ["bitpack", "bwt2_emit", "bwt2_sort", "code_lengths", "crc32",
           "em_chain", "flatten_words", "huffdec", "ibwt", "mtf_ranks",
           "pack_groups", "rle2", "sort_sweeps"]


def test_every_kernel_source_is_found():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == KERNELS


def test_real_sources_get_one_nvcc_each(tmp_path, monkeypatch):
    """The repository's thirteen sources, the CRC, the bit packer, the
    BWT's suffix sort and emits, the RLE2, the group packing and the flat
    compaction among them, each built by a compiler process of its
    own."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    calls = []
    real_popen = _build.subprocess.Popen

    def popen(cmd, **kw):
        calls.append(os.path.basename(cmd[-1]))
        return real_popen(cmd, **kw)

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_log", {})
    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    _build.build()
    assert sorted(calls) == [f"{k}.cu" for k in KERNELS]
    assert sorted(_build.build_log) == KERNELS


@pytest.mark.parametrize("name", ["crc32", "bitpack", "bwt2_sort",
                                  "rle2", "pack_groups", "bwt2_emit",
                                  "flatten_words"])
def test_missing_toolchain_raises_for_new_kernels(name, tmp_path,
                                                  monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(name)


def _no_nvcc(tmp_path, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})


@pytest.mark.parametrize("fn", ["_seed16", "_pass8"])
def test_bwt2_wrappers_raise_for_a_cuda_tensor_without_nvcc(fn, tmp_path,
                                                           monkeypatch):
    """A CUDA tensor (a fake one: this box has no card) reaches the
    kernels' build and raises; nothing falls back to the plain version,
    and no launch is counted."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lbzip2_tpu_torch.ops import bwt2

    _no_nvcc(tmp_path, monkeypatch)
    with FakeTensorMode():
        src = torch.zeros((2, 64), device="cuda",
                          dtype=torch.uint8 if fn == "_seed16"
                          else torch.int32)
        ns = torch.full((2,), 64, dtype=torch.int32, device="cuda")
    before = bwt2.launches, bwt2.pass_launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if fn == "_seed16":
            bwt2._seed16(src, ns)
        else:
            bwt2._pass8(src, 16, ns)
    assert (bwt2.launches, bwt2.pass_launches) == before
    meta = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(bwt2, fn)(*((meta, ns) if fn == "_seed16"
                            else (meta, 16, ns)))


@pytest.mark.parametrize("fn", ["rle2_hist_rows", "_rle2_batch",
                                "_pack_groups"])
def test_entropy_wrappers_raise_for_a_cuda_tensor_without_nvcc(
        fn, tmp_path, monkeypatch):
    """The RLE2 and group-packing wrappers on a CUDA tensor (a fake one:
    this box has no card) reach their kernels' build and raise; nothing
    falls back to the plain versions, and no launch is counted."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lbzip2_tpu_torch.ops import chain, rle2

    _no_nvcc(tmp_path, monkeypatch)
    calls = []
    for mod, name in ((rle2, "_rle2_plain"), (rle2, "rle2_hist_plain"),
                      (chain, "_pack_groups_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name: calls.append(_n))
    B, N = 2, 64
    with FakeTensorMode():
        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device="cuda")

        if fn == "_pack_groups":
            G = -(-N // 50)
            args = (i32(B, N), i32(B), i32(B), i32(B), i32(B, G),
                    torch.zeros((B, 6, 259), dtype=torch.int64,
                                device="cuda"), i32(B, 6, 259), i32(B), 40)
        else:
            args = (i32(B, N), i32(B), i32(B))
    before = rle2.launches, chain.pack_launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(rle2 if fn != "_pack_groups" else chain, fn)(*args)
    assert (rle2.launches, chain.pack_launches) == before and not calls
