"""bench_torch.py, the port's benchmark, on the CPU: its corpus (the
same bytes for the same seed, its exact size, its classes at their
shares, nothing read but the frozen JAX package's sources and the ELF
files (bench.py read a reference lbzip2 checkout), an empty class
refused), the refusal of a switch, the
gate on the device's share, one whole run on a single block in the 8192
bucket with the plain versions of the kernels (the headline's keys, its
correctness keys, its length, the telemetry), and the script without a
card."""

import builtins
import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from lbzip2_tpu_torch.codec import encoder

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEADLINE = {"metric", "value", "unit", "vs_baseline", "host_MBps",
            "device_MBps", "decompress_MBps", "decompress_floor_55_ok",
            "bit_identical_1_5_9", "reference_binary_same_box",
            "token_MBps", "decompress_device_MBps",
            "decompress_stream_device_MBps", "device"}
RATES = {k for k in HEADLINE if k.endswith("_MBps")}


def test_corpus_same_seed_same_bytes():
    a, ia = bench_torch.build_corpus(20_000, 5)
    b, ib = bench_torch.build_corpus(20_000, 5)
    assert a == b and ia == ib


def test_corpus_other_seed_other_bytes():
    a, ia = bench_torch.build_corpus(20_000, 5)
    b, ib = bench_torch.build_corpus(20_000, 6)
    assert a != b and ia["sha256"] != ib["sha256"]


@pytest.mark.parametrize("size", [1, 4096, 4097, 123_457])
def test_corpus_exact_size(size):
    data, info = bench_torch.build_corpus(size, 0)
    assert len(data) == size
    assert info["sha256"] == bench_torch.sha256(data)


def test_corpus_opens_nothing_under_reference(monkeypatch):
    opened, patterns = [], []
    real_open, real_glob = builtins.open, glob.glob

    def spy_open(f, *a, **kw):
        opened.append(str(f))
        return real_open(f, *a, **kw)

    def spy_glob(pat, *a, **kw):
        patterns.append(str(pat))
        return real_glob(pat, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(glob, "glob", spy_glob)
    _, info = bench_torch.build_corpus(10_000, 0)
    assert opened and patterns
    assert set(patterns) == {str(bench_torch.HERE / p)
                             for p in bench_torch.TEXT_GLOBS} | \
        set(bench_torch.ELF_GLOBS)
    assert set(info["elf_files"]) <= set(opened)
    # the rest only the frozen package: no file a later change may edit
    texts = {str(pathlib.Path(f).resolve().relative_to(ROOT))
             for f in opened if f not in info["elf_files"]}
    assert "lbzip2_tpu/native/lbz2_native.c" in texts
    assert "lbzip2_tpu/parallel/encode.py" in texts
    assert all(t.startswith("lbzip2_tpu/") for t in texts), texts


def test_corpus_parts_at_their_shares():
    size = 1_000_000
    rng = np.random.default_rng(0)
    parts, info = bench_torch.corpus_parts(size, rng)
    text = bench_torch.text_class()
    assert list(parts) == [name for name, _ in bench_torch.SHARES]
    for name, share in bench_torch.SHARES:
        assert len(parts[name]) == int(size * share) + bench_torch.PAD
        assert info["part_bytes"][name] == len(parts[name])
    want = len(parts["text"])
    assert parts["text"] == (text * (want // len(text) + 1))[:want]
    assert info["source_bytes"]["text"] == len(text)
    assert info["source_bytes"]["random"] == bench_torch.RANDOM_BYTES
    assert info["source_bytes"]["xml"] >= bench_torch.XML_BYTES
    assert parts["xml"].startswith(b"<rec id=\"0\"><k>")
    assert 0 < info["source_bytes"]["elf"] <= bench_torch.ELF_LIMIT


@pytest.mark.parametrize("cls, message", [
    ("text", "the text class is empty"), ("elf", "the ELF class is empty")])
def test_an_empty_class_raises(monkeypatch, cls, message):
    if cls == "text":
        monkeypatch.setattr(bench_torch, "text_class", lambda: b"")
    else:
        monkeypatch.setattr(bench_torch, "ELF_GLOBS", ("/nonexistent/*",))
    with pytest.raises(RuntimeError, match=message):
        bench_torch.build_corpus(10_000, 0)


def test_run_refuses_a_switch_off_its_default(monkeypatch):
    monkeypatch.setattr(encoder, "_HOST_STEAL", False)
    with pytest.raises(RuntimeError, match="shipped defaults"):
        bench_torch.run(6000, 0, "cpu")


def test_run_refuses_any_variable_of_the_port(monkeypatch):
    # read at import, it changes the engine's batches under the bench
    monkeypatch.setenv("LBZ2_DEVICE_BATCH", "4")
    with pytest.raises(RuntimeError, match="LBZ2_DEVICE_BATCH"):
        bench_torch.run(6000, 0, "cpu")


@pytest.mark.parametrize("device, blocks, fails", [
    ("cuda", 0, True), ("cuda", 3, False), ("cpu", 0, False)])
def test_a_card_that_took_no_block_fails_the_leg(device, blocks, fails):
    stats = {"device_blocks": blocks, "host_blocks": 5, "stale_rows": 2}
    if fails:
        with pytest.raises(RuntimeError, match="the device took no block"):
            bench_torch.device_took(stats, torch.device(device))
    else:
        bench_torch.device_took(stats, torch.device(device))


@pytest.fixture(scope="module")
def cpu_run():
    """One run of the six legs on 6,000 bytes: one block, in the 8192
    bucket, on the plain versions of the kernels."""
    return bench_torch.run(6000, 1, "cpu")


def test_run_headline_keys(cpu_run):
    head, _ = cpu_run
    assert set(head) == HEADLINE
    assert head["metric"] == "compress_MBps_level9_chain_default"
    assert head["value"] == head["device_MBps"] and head["unit"] == "MB/s"
    assert set(head["device"]) == {"name", "power_limit_W", "count"}


def test_run_correctness_keys(cpu_run):
    head, tele = cpu_run
    assert head["bit_identical_1_5_9"] is True
    for key in ("vs_baseline", "decompress_floor_55_ok",
                "reference_binary_same_box"):
        assert head[key] is None and tele["null_keys"][key]
    parity = tele["level_parity"]
    assert sorted(parity) == ["1", "5", "9", "warm_device_s"]
    for lvl in ("1", "5", "9"):
        assert parity[lvl]["identical"] and parity[lvl]["roundtrip"]
        # device only: the one block in the 8192 bucket is the card's
        assert parity[lvl]["device_blocks"] == 1
        assert parity[lvl]["host_blocks"] == 0
    assert tele["device_decode"]["parallel_ok"]
    assert tele["device_decode"]["stream_ok"]


def test_run_line_under_500_bytes_with_positive_rates(cpu_run):
    head, _ = cpu_run
    assert len(json.dumps(head)) < 500
    assert all(isinstance(head[k], float) and head[k] > 0 for k in RATES)


def test_run_telemetry(cpu_run):
    _, tele = cpu_run
    assert tele["size"] == 6000 and tele["seed"] == 1
    assert tele["corpus"] == bench_torch.build_corpus(6000, 1)[1]
    assert tele["token"]["sha256"] == tele["chain"]["sha256"]
    assert len(tele["host_compress_s"]) == 3
    assert len(tele["host_decompress_s"]) == 2
    stats = tele["chain"]["stats"]
    assert stats["device_blocks"] + stats["host_blocks"] == 1
    assert tele["device_decode"]["parallel_stats"]["device_huff"]
    assert tele["device_decode"]["stream_stats"]["ibwt_rows"] == 1
    json.dumps(tele, default=bench_torch._jsonable)


def test_script_without_a_card_exits_nonzero_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                        "--size", "4096"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA is not available" in r.stderr
