"""The port's tracer (lbzip2_tpu_torch/utils/trace.py) and the spans the
compress engine records with it, on the CPU.

Off, a call leaves ``last_stats["trace"]`` None.  On (``LBZIP2_TPU_TRACE``
or a recording ``torch.profiler``), a multi-block compress in chain and
in token mode leaves every engine span: each inside its thread's life,
each prep's CPU time within its wall, the prep spans' rows and wall equal
to the batches' own accounting.  The dispatch thread's waits are spans.
Under the benchmark's profiler the program's spans land where the
profiler's own events do, once ``gpubench/trace.py``'s window conversion
places them.  The readers of the benchmark's six program metrics give
their defined values on a synthetic window.
"""

import bz2
import collections
import threading
import time

import numpy as np
import pytest
import torch

from gpubench import instrument, spec
from gpubench import trace as gtrace
from lbzip2_tpu import native as jnative
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch import native
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.parallel import decode
from lbzip2_tpu_torch.utils import trace

needs_native = pytest.mark.skipif(not jnative.native_available(),
                                  reason="needs C toolchain")

WIDE = 131072  # holds a level-1 block

# the spans of every traced compress that gives the card a batch; chain
# mode adds its entropy chain, token mode the token fetch and the host
# workers' entropy coding of the card's rows
COMMON = {"compress.call", "compress.collect", "compress.run",
          "compress.assemble", "engine.dispatch_life", "engine.gate_wait",
          "engine.prep", "engine.dispatch", "engine.drain_wait",
          "engine.fetch_life", "engine.ready_wait", "host.life",
          "host.wait", "host.block"}
MODE = {True: {"engine.chain"},
        False: {"engine.fetch_tokens", "host.entropy"}}
LIFE = {"lbz2-device": "engine.dispatch_life",
        "lbz2-fetch": "engine.fetch_life"}


@pytest.fixture()
def small_buckets(monkeypatch):
    """Level-1 blocks on the device, claims of at most 4, the host
    workers on the card's rows and the periodic block alone."""
    for name, value in (("_HOST_STEAL", False), ("_STEALBACK", False),
                        ("_BUCKETS", (8192, WIDE)), ("_MID_CUTOFF", 8192),
                        ("_BATCH", 4)):
        monkeypatch.setattr(encoder, name, value)


def _data():
    """Five level-1 blocks RLE1 leaves alone, then a periodic one (a
    host-convention block the dispatch thread hands to the host)."""
    rng = np.random.default_rng(6)
    body = (rng.integers(0, 13, 500_000) +
            np.tile([97, 110], 250_000)).astype(np.uint8).tobytes()
    return body + b"ab" * 50_000


def _life(spans, sp):
    """The life span of ``sp``'s thread that holds it, or None."""
    t = sp["thread"]
    name = LIFE.get(t) or ("host.life" if t.startswith("lbz2-host")
                           else "compress.call")
    return next((s for s in spans if s["name"] == name and
                 s["thread"] == t and s["t0"] <= sp["t0"] and
                 sp["t1"] <= s["t1"]), None)


@pytest.mark.parametrize("what", ["compress", "decompress"])
def test_off_leaves_no_trace(monkeypatch, what):
    monkeypatch.delenv(trace.ENV, raising=False)
    assert trace.begin() is None
    data = b"lbzip2 " * 3000
    if what == "compress":
        assert bz2.decompress(encoder.compress(data, 1, device="cpu")) == \
            data
        assert encoder.last_stats["trace"] is None
    else:
        assert decode.decompress_parallel(bz2.compress(data, 1),
                                          device="cpu") == data
        assert decode.last_stats["trace"] is None


@needs_native
@pytest.mark.parametrize("chain", [True, False], ids=["chain", "tokens"])
def test_compress_records_the_engine_spans(small_buckets, monkeypatch,
                                           chain):
    monkeypatch.setattr(encoder, "_DEVICE_CHAIN", chain)
    monkeypatch.setenv(trace.ENV, "1")
    data = _data()
    out = encoder.compress(data, 1, entropy_workers=1, device="cpu")
    assert out == compress_parallel(data, 1) and bz2.decompress(out) == data
    s = encoder.last_stats
    tr = s["trace"]
    assert tr["clock"] == "perf_counter_ns" and s["device_blocks"] == 5
    spans = tr["spans"]
    names = collections.Counter(sp["name"] for sp in spans)
    assert COMMON | MODE[chain] <= set(names), names
    assert not MODE[not chain] & set(names)
    for n in ("compress.call", "compress.run", "engine.dispatch_life",
              "engine.fetch_life", "host.life"):
        assert names[n] == 1, names
    for sp in spans:
        assert sp["call"] == tr["call"] and sp["t0"] <= sp["t1"], sp
        assert _life(spans, sp) is not None, sp
    prep = [sp for sp in spans if sp["name"] == "engine.prep"]
    assert all(0 <= sp["cpu_ns"] <= sp["t1"] - sp["t0"] for sp in prep)
    assert [sp["batch"] for sp in prep] == list(range(len(prep)))
    # every row dispatched: the delivered batches' and the skipped ones'
    assert sum(sp["rows"] for sp in prep) == \
        sum(b["rows"] for b in s["batch_trace"]) + \
        tr["counters"].get("engine.skipped_rows", 0)
    assert "engine.skipped_batches" not in tr["counters"]
    built = [sp for sp in prep if sp["rows"]]
    assert len(built) == len(s["batch_trace"])
    wall = sum(sp["t1"] - sp["t0"] for sp in built) / 1e9
    assert wall == pytest.approx(sum(b["prep_s"] for b in s["batch_trace"]),
                                 abs=1e-3 * len(built))
    disp = [sp for sp in spans if sp["name"] == "engine.dispatch"]
    assert [sp["rows"] for sp in disp] == [sp["rows"] for sp in built]
    assert "bwt_device_us" not in disp[0]  # timing events: a card only
    blocks = sorted(sp["block"] for sp in spans
                    if sp["name"] in ("host.block", "host.entropy"))
    assert blocks == ([5] if chain else [0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize("wait", ["cap", "refused"])
def test_dispatch_waits_are_spans(monkeypatch, wait):
    """One batch in flight: at a cap of one the dispatch thread waits on
    the cap; at three its claim is refused and it waits for the batch to
    land.  Either wait ends on the fetch worker's signal."""
    monkeypatch.setattr(encoder, "_WAKE_S", 60.0)
    monkeypatch.setattr(encoder, "_warmed", wait == "refused")
    tr = trace.Tracer()
    pool = encoder._TorchPool(np.zeros(1, np.uint8), [None] * 8, 8, 0,
                              True, torch.device("cpu"), tr)
    pool.fetch_pending = 1
    pool.take_head = lambda k: []
    t = threading.Thread(target=pool._device_pipeline, daemon=True)
    t.start()
    time.sleep(0.05)
    pool._fetched()  # the batch lands
    t.join(timeout=60)
    pool._fetcher.join(timeout=60)
    assert not t.is_alive() and not pool._fetcher.is_alive()
    names = [sp["name"] for sp in tr.spans]
    assert sorted(names) == sorted([
        "engine.gate_wait", f"engine.{wait}_wait", "engine.drain_wait",
        "engine.dispatch_life", "engine.fetch_life"])
    sp = tr.spans[names.index(f"engine.{wait}_wait")]
    assert sp["t1"] - sp["t0"] >= 0.04e9 and sp["thread"] == t.name


@needs_native
def test_profiler_turns_tracing_on_and_shares_its_timeline(monkeypatch):
    """Under the benchmark's profiler, with the switch unset, a compress
    is traced, and a ``record_function`` opened inside the call's
    ``compress.collect`` span sits inside that span on the profiler's
    timeline once the span is placed by the window's start (as
    ``gpubench/trace.py::summarize`` places host spans), within 1 ms."""
    monkeypatch.delenv(trace.ENV, raising=False)
    collect = native.rle1_collect

    def probed(*a, **kw):
        with torch.profiler.record_function("lbz2-probe"):
            return collect(*a, **kw)
    monkeypatch.setattr(native, "rle1_collect", probed)
    data = b"lbzip2 " * 30_000
    with gtrace.profiled(True, instrument.Recorder()):  # warm the profiler
        encoder.compress(data, 1, device="cpu")
    rec = instrument.Recorder()
    with gtrace.profiled(True, rec) as prof:
        encoder.compress(data, 1, device="cpu")
    tr = encoder.last_stats["trace"]
    assert tr is not None
    assert encoder.compress(data, 1, device="cpu") and \
        encoder.last_stats["trace"] is None  # the profiler stopped
    events = list(prof.events())
    w0 = next(e for e in events if e.name == gtrace.WINDOW_SPAN
              ).time_range.start
    probe = next(e for e in events if e.name == "lbz2-probe").time_range
    sp = next(s for s in tr["spans"] if s["name"] == "compress.collect")
    a, b = (w0 + (t / 1e9 - rec.window[0]) * 1e6 for t in (sp["t0"],
                                                          sp["t1"]))
    assert a - 1000 <= probe.start <= probe.end <= b + 1000, \
        (a, b, probe.start, probe.end)


@needs_native
def test_collect_runs_on_as_many_threads_as_the_pool_has_workers(
        monkeypatch):
    """A twelve-window compress with four workers collects its windows in
    runs on four threads (the span's ``chunks`` and ``threads``), with
    one worker in one walk, and both give the same stream; no ``lbz2-``
    thread outlives either call."""
    monkeypatch.setenv(trace.ENV, "1")
    rng = np.random.default_rng(12)
    data = (rng.integers(0, 4, 12 * 100_000 - 999) + 97).astype(
        np.uint8).tobytes()
    outs, spans = [], []
    for workers in (4, 1):
        outs.append(encoder.compress(data, 1, entropy_workers=workers,
                                     device="cpu"))
        spans.append(next(sp for sp in encoder.last_stats["trace"]["spans"]
                          if sp["name"] == "compress.collect"))
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("lbz2-")]
    assert outs[0] == outs[1] and bz2.decompress(outs[0]) == data
    assert spans[0]["chunks"] > 1 and spans[0]["threads"] == 4
    assert spans[1]["chunks"] == 1 and spans[1]["threads"] == 1
    assert spans[0]["blocks"] == spans[1]["blocks"] >= 12


def _span(name, t0, t1, **kw):
    return {"name": name, "thread": "t", "call": 1, "t0": t0, "t1": t1,
            **kw}


def _window():
    """Two traced calls, one untraced call of this port (trace None), one
    of a port without the tracer (no key) and a call that left no
    statistics."""
    first = [_span("compress.call", 0, 1000), _span("compress.run", 200, 900),
             _span("engine.dispatch_life", 200, 900),
             _span("engine.prep", 300, 400, cpu_ns=80, rows=4),
             _span("engine.prep", 500, 700, cpu_ns=100, rows=0),
             _span("engine.dispatch", 400, 450, rows=4, bwt_device_us=2000),
             _span("host.life", 200, 900), _span("host.wait", 300, 370),
             _span("host.life", 210, 890), _span("host.wait", 400, 410)]
    second = [_span("compress.call", 0, 3000), _span("compress.run", 0, 2000),
              _span("engine.dispatch_life", 0, 1900),
              _span("engine.prep", 100, 400, cpu_ns=300, rows=8),
              _span("engine.dispatch", 400, 450, rows=8),
              _span("engine.dispatch", 500, 550, rows=2, bwt_device_us=900),
              _span("host.life", 0, 2000), _span("host.wait", 0, 500)]
    return {"calls": [{"stale_rows": 1, "trace": {"spans": first}},
                      {"stale_rows": 2, "trace": {"spans": second}},
                      {"stale_rows": 50, "trace": None},
                      {"stale_rows": 70}, None],
            "trace": None, "device_bytes": 0, "card": {"kind": "cpu"}}


READINGS = {
    "call_serial_share": (300 + 1000) / 4000,
    "dispatch_prep_share": (100 + 200 + 300) / (700 + 1900),
    "prep_cpu_share": (80 + 100 + 300) / (100 + 200 + 300),
    "host_wait_share": (70 + 10 + 500) / (700 + 680 + 2000),
    "stale_row_share": (1 + 2) / (4 + 0 + 8),
    "bwt_device_ms_per_row": (2000 + 900) / 1000 / (4 + 2),
}


@pytest.mark.parametrize("name", list(READINGS))
def test_reader_of_the_program_spans(name):
    reader = spec.metric_reader(name)
    assert reader.read(_window()) == pytest.approx(READINGS[name])
    untraced = _window()
    untraced["calls"] = untraced["calls"][2:]
    assert reader.read(untraced) is None
