"""The yardstick: the comparison and its control, the roofline's bound
from sizes alone, and the idle share of a synthetic profile."""

import bz2
import types

import numpy as np
import pytest
import torch

from gpubench import control, corpus, instrument, reference, roofline, \
    spec, trace

H100 = "NVIDIA H100 80GB HBM3"
TRAFFIC = spec.load_json(spec.ROOT, "traffic", "files-256m")


@pytest.fixture(scope="module")
def files():
    return corpus.make_files(TRAFFIC, 11, 3_600_000)


def test_sound_streams_pass(files):
    answers = [(f.index, bz2.compress(f.data, 9)) for f in files]
    ok, checks = reference.verdict(
        reference.judge_compress(answers + answers, files, 9))
    assert ok, checks


def test_control_fails_on_blocks(files):
    """libbzip2 at level 8 under a BZh9 header: 5 blocks where 9 gives 4."""
    answers = [(f.index, control.compress_control(f.data, 9)) for f in files]
    numbers = reference.judge_compress(answers, files, 9)
    assert numbers["files_wrong"] == 0 and numbers["headers_wrong"] == 0
    assert numbers["extra_block_share"] == 0.25
    assert not reference.verdict(numbers)[0]


@pytest.mark.parametrize("fault", ["flip", "half", "unchanged", "none",
                                   "level8_header"])
def test_faulty_answers_fail(files, fault):
    f = files[0]
    good = bz2.compress(f.data, 9)
    bad = {"flip": lambda: good[:len(good) // 2] + bytes(
               [good[len(good) // 2] ^ 1]) + good[len(good) // 2 + 1:],
           "half": lambda: bz2.compress(f.data[:len(f.data) // 2], 9),
           "unchanged": lambda: f.data,
           "none": lambda: None,
           "level8_header": lambda: bz2.compress(f.data, 8)}[fault]()
    ok, checks = reference.verdict(
        reference.judge_compress([(0, good), (0, bad)], files, 9))
    assert not ok, checks


def test_decompress_judge(files):
    ok, _ = reference.verdict(reference.judge_decompress(
        [(f.index, f.data) for f in files], files))
    assert ok
    short = control.decompress_control(bz2.compress(files[0].data, 9), 4096)
    numbers = reference.judge_decompress([(0, short)], files)
    assert numbers == {"files_wrong": 1}


def test_count_blocks_at_every_bit_offset(files):
    stream = bz2.compress(files[0].data, 9)   # blocks not byte-aligned
    assert reference.count_blocks(stream) == 4
    assert reference.level_blocks(3_600_000, 9) == 4
    assert reference.level_blocks(3_600_000, 8) == 5


def test_roofline_from_sizes_alone():
    nbytes = 285 * (900_000 + 250_000)
    want = 100 * nbytes / 3.35e12 / 0.5
    assert roofline.share_pct(nbytes, 0.5, H100) == pytest.approx(want)
    assert roofline.share_pct(nbytes, 0.0, H100) is None
    assert roofline.share_pct(0, 0.5, H100) is None
    assert roofline.share_pct(nbytes, 0.5, "another card") is None


def _fake_encoder(build_out, payloads):
    class Pool:
        def _build_batch(self, ids):
            return build_out

        def _fetch_tokens(self, ids, spans, outs, tele):
            return None

    def chain_payloads(bwt_dev, ns, cmaps, idxs, crcs, **kw):
        return payloads

    return Pool, types.SimpleNamespace(
        _TorchPool=Pool, bwt2_bytes=lambda *a: None,
        bwt2_tokens=lambda *a: None, _host_block=lambda *a: b"",
        _entropy_payload=lambda *a: b"", chain_payloads=chain_payloads)


def _spans(*sizes):
    return [types.SimpleNamespace(data=np.zeros(n, np.uint8)) for n in sizes]


def test_recorder_counts_rows_and_outputs():
    """The compress spans count each batch's rows in and its payloads or
    tokens out, whatever the batch holds."""
    spans = _spans(900_000, 7)
    Pool, enc = _fake_encoder(
        ([1, 2], spans, np.zeros((2, 8), np.uint8),
         np.array([900_000, 7], np.int32), None, {}),
        [b"x" * 300, None])
    rec = instrument.Recorder()
    tok = np.zeros((2, 10), np.int32)
    counts = torch.tensor([4, 21])
    with instrument.compress_spans(enc, rec):
        Pool()._build_batch([1, 2])
        enc.chain_payloads(None, [900_000, 7], None, None, None)
        Pool()._fetch_tokens([1, 2], spans, (tok, None, counts), {})
    assert rec.faults == []
    assert rec.in_bytes == 900_007
    assert rec.out_bytes == 300 + 2 * 4 + 7   # 21 > capacity 20: raw n
    assert Pool._build_batch.__name__ == "_build_batch"
    assert not hasattr(Pool._build_batch, "__wrapped__")
    assert {s[0] for s in rec.spans} == {"engine.prep", "engine.chain",
                                         "engine.fetch_tokens"}


@pytest.mark.parametrize("case", ["ns_moved", "payload_rows", "outs"])
def test_recorder_refuses_a_layout_it_does_not_know(case):
    """A batch whose ns no longer sit fourth, a payload list that is not
    a row each, token outputs in another order: each is a fault, the
    byte count is left alone, and the port's call still returns."""
    spans = _spans(900_000, 7)
    ns = np.array([900_000, 7], np.int32)
    build = ([1, 2], spans, np.zeros((2, 8), np.uint8), ns, None, {})
    if case == "ns_moved":
        build = ([1, 2], spans, np.zeros((2, 8), np.uint8), {}, ns, None)
    payloads = [b"x"] if case == "payload_rows" else [b"x", None]
    Pool, enc = _fake_encoder(build, payloads)
    rec = instrument.Recorder()
    outs = (np.zeros((2, 10), np.int32), None, torch.tensor([4, 21]))
    if case == "outs":
        outs = (torch.tensor([4, 21]), None, np.zeros((2, 10), np.int32))
    with instrument.compress_spans(enc, rec):
        assert Pool()._build_batch([1, 2]) is build
        enc.chain_payloads(None, ns, None, None, None)
        Pool()._fetch_tokens([1, 2], spans, outs, {})
    assert len(rec.faults) == 1, rec.faults
    assert "LayoutError" in rec.faults[0]


def test_unread_metric_is_named():
    """A cell's per-layer metric whose reader finds nothing is named, so
    that a traced run prints no result."""
    from gpubench import run

    cell = spec.cell("chain.files-256m")
    ctx = {"cell": cell, "calls": [], "window": None, "trace": None,
           "card": {"kind": H100}, "device_bytes": 0}
    metrics, unread = run.per_layer(cell, ctx, spec.ROOT)
    assert metrics == {}
    assert set(unread) == {m["name"] for m in cell.per_layer}


def _event(name, a, b, cuda):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_idle_share_of_a_synthetic_profile():
    """Device intervals [100, 300), [250, 400) and [1000, 1010) in a
    window [0, 2000) us: 310 us busy; the gap [400, 1000) under an
    engine span."""
    events = [_event(trace.WINDOW_SPAN, 0, 2000, False),
              _event("kernel_a", 100, 300, True),
              _event("kernel_b", 250, 400, True),
              _event("Memcpy HtoD", 1000, 1010, True),
              _event("aten::add", 5, 6, False)]
    prof = types.SimpleNamespace(events=lambda: events)
    rec = instrument.Recorder()
    rec.window = (10.0, 10.002)
    rec.spans = [("engine.prep", 10.0004, 10.0009),
                 ("host.block", 10.0, 10.002)]
    s = trace.summarize(prof, rec)
    assert s["busy_s"] == pytest.approx(310e-6)
    assert s["window_s"] == pytest.approx(2000e-6)
    assert s["kernel_s"] == pytest.approx(350e-6)
    reader = spec.metric_reader("device_idle_share.compress")
    assert reader.read({"trace": s}) == pytest.approx(1 - 310 / 2000)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["engine.prep"] == pytest.approx(600e-6)
    assert gaps["host.block"] == pytest.approx((100 + 990) * 1e-6)
    assert [k for k, _ in s["breakdown"]["device_ops"]][0] == "kernel_a"
