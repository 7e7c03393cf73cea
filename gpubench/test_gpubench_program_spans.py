"""The readers of the port's own spans (``last_stats["trace"]``, filled
while a ``torch.profiler`` records, so in every traced run) and the
entries that would name them in BENCHMARK.json.

The entries are not in BENCHMARK.json: ``run.py`` ends a traced run
with exit 5 when a per-layer metric of the cell reads nothing, and a
port without the tracer (every commit before it) reads nothing for
them, so each of its traced runs would fail.  Once ``run.py`` leaves a
metric the program does not record out of the line, a change that
edits the benchmark appends ``SPAN_ENTRIES["per_layer"]``.  Until then
the CPU tests run each compress cell dry with the entries laid over a
copy of the harness, and a chip run does the same on the card.
"""

import json

import pytest

from gpubench import spec
from gpubench.test_gpubench_runs import copy_root, dry

COMPRESS = ["chain.files-256m", "token.files-256m"]
TOKEN = ["token.files-256m"]


def _entry(name, unit, better, source, layer, cells=COMPRESS):
    return {"name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "compress_MBps", "workloads": cells}


SPAN_ENTRIES = {"per_layer": [
    _entry("call_serial_share", "share", "lower", "program_span", "engine"),
    _entry("dispatch_prep_share", "share", "lower", "program_span",
           "engine"),
    _entry("prep_cpu_share", "share", "higher", "program_span", "host C"),
    _entry("host_wait_share", "share", "lower", "program_span", "engine"),
    _entry("stale_row_share", "share", "lower", "program_counter",
           "engine"),
    _entry("bwt_device_ms_per_row", "ms", "lower", "program_span",
           "kernels", TOKEN),
]}
# read only on a card: the BWT's timing events are CUDA events
CARD_ONLY = {"bwt_device_ms_per_row"}


def spans_root(tmp_path):
    """A checkout whose BENCHMARK.json names the span metrics too."""
    root = copy_root(tmp_path)
    bench = spec.bench_file()
    for group, entries in SPAN_ENTRIES.items():
        bench[group] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("entry", SPAN_ENTRIES["per_layer"],
                         ids=lambda e: e["name"])
def test_span_reader_matches_its_entry(entry):
    reader = spec.metric_reader(entry["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES,
            reader.BETTER) == (entry["layer"], entry["unit"],
                               entry["source"], entry["moves"],
                               entry["better"])
    empty = {"calls": [], "trace": None, "device_bytes": 0,
             "card": {"kind": "cpu"}}
    assert reader.read(empty) is None
    # a port without the tracer: statistics without a "trace" key
    assert reader.read({**empty, "calls": [{"stale_rows": 3}]}) is None


@pytest.mark.parametrize("cell", COMPRESS)
def test_dry_run_reads_the_span_metrics(cell, tmp_path):
    root = spans_root(tmp_path)
    rc, out, err = dry(cell, 2**31 + 23, trace=1, root=root)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert line["correct"], line
    want = {e["name"] for e in SPAN_ENTRIES["per_layer"]
            if cell in e["workloads"]} - CARD_ONLY
    assert want <= set(line["metrics"]), line["metrics"]
    for name in want - {"stale_row_share"}:
        assert 0 < line["metrics"][name]["value"] <= 1, (name, line)
