"""Whole runs of the harness in child processes: each cell in its dry
mode (the CPU, tiny files), each fault planted under the timed path, a
run without a card, a run without the port, a cell added as files only,
the decompress cell (whose files the harness keeps, and which
BENCHMARK.json does not name: its rate is too unsteady for a bound)
added as entries only, and, on the chip, each cell for real."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gpubench import spec

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.bench_file()["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DRY = {"compress": 8000, "decompress": 2_000_000}
UNBZ2 = "chain.unbz2-files-64m"
# The entries that name the decompress cell, its end-to-end metric and
# its per-layer metrics: what a later change adds back to BENCHMARK.json
# once the cell's rate holds a bound.
UNBZ2_ENTRIES = {
    "workloads": [{"name": UNBZ2, "config": "lbzip2-9-chain",
                   "traffic": "bz2-files-64m", "chips": 1,
                   "why": "64 MB libbzip2 streams, closed loop: decompress "
                   "with the card's Huffman and IBWT stages"}],
    "end_to_end": [{"name": "decompress_MBps", "unit": "MB/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": [UNBZ2]}],
    "per_layer": [
        {"name": "ibwt_rows_per_flush", "unit": "rows", "better": "higher",
         "source": "program_counter", "layer": "decode batcher",
         "moves": "decompress_MBps", "workloads": [UNBZ2]},
        {"name": "kernels_roofline.decompress", "unit": "%",
         "better": "higher", "source": "device_trace", "layer": "kernels",
         "moves": "decompress_MBps", "workloads": [UNBZ2]},
        {"name": "device_idle_share.decompress", "unit": "share",
         "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "decompress_MBps", "workloads": [UNBZ2]}],
}


def run(args, root=ROOT, fault=None, timeout=600):
    """``run.main(args)`` in a child process under ``root``; returns
    (exit code, stdout lines, stderr)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from gpubench import run, faults; "
            "w = faults.FAULTS[sys.argv[2]] if sys.argv[2] else None; "
            "sys.exit(run.main(sys.argv[3:], call_wrapper=w, "
            "root=__import__('pathlib').Path(sys.argv[1])))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("LBZ2_")}
    r = subprocess.run([sys.executable, "-c", code, str(root), fault or "",
                        *args], capture_output=True, text=True, cwd=root,
                       env=env, timeout=timeout)
    return r.returncode, r.stdout.splitlines(), r.stderr


def dry(cell, seed, trace=0, root=ROOT, **kw):
    kind = spec.cell(cell, root).traffic["loop"]
    return run(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                "--trace", str(trace), "--dry-bytes", str(DRY[kind])],
               root=root, **kw)


def copy_root(tmp_path):
    """A checkout under ``tmp_path``: the harness copied, the packages
    and the build linked."""
    for name in ("lbzip2_tpu", "lbzip2_tpu_torch", "build"):
        if (ROOT / name).exists():
            (tmp_path / name).symlink_to(ROOT / name)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def unbz2_root(tmp_path):
    """A checkout whose BENCHMARK.json names the decompress cell again,
    by ``UNBZ2_ENTRIES`` alone."""
    root = copy_root(tmp_path)
    bench = spec.bench_file()
    for group, entries in UNBZ2_ENTRIES.items():
        bench[group] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cell_root(cell, tmp_path):
    return ROOT if cell in CELLS else unbz2_root(tmp_path)


@pytest.mark.parametrize("cell", CELLS + [UNBZ2])
def test_dry_run_is_correct(cell, tmp_path):
    root = cell_root(cell, tmp_path)
    rc, out, err = dry(cell, 2**31 + 5, trace=1, root=root)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert set(line) <= set(RESULT_KEYS) | {"breakdown", "dry_run",
                                            "checks"}
    assert line["correct"] and line["dry_run"], line
    assert line["device"]["platform"] == "cpu"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert err.rstrip().splitlines()[-1].startswith("check ")
    wanted = {m["name"] for m in spec.cell(cell, root).per_layer}
    assert set(line["metrics"]) <= wanted
    shas = json.loads(out[0])["files_sha256"]
    assert len(shas) == spec.cell(cell, root).traffic["distinct_files"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["chain.files-256m", UNBZ2])
def test_fault_is_not_correct(cell, fault, tmp_path):
    rc, out, err = dry(cell, 77, fault=fault, root=cell_root(cell, tmp_path))
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert not line["correct"], line
    assert line["failed"] == line["attempted"] > 0


def test_untraced_line_holds_the_end_to_end_metrics():
    rc, out, err = dry("token.files-256m", 3)
    assert rc == 0, err[-3000:]
    m = json.loads(out[-1])["metrics"]
    assert set(m) == {"compress_MBps", "setup_s"}
    assert m["compress_MBps"]["unit"] == "MB/s" and m["setup_s"]["value"] > 0


def test_no_card_no_result():
    rc, out, err = run(["--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"])
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert rc == 3 and out == [], (rc, out, err[-2000:])


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--dry-bytes", "8000"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0 and "correct" not in r.stdout, \
        (r.returncode, r.stdout[-500:])


def test_a_cell_added_as_files_runs(tmp_path):
    """A new configuration, traffic mix and per-layer metric, and a cell
    that names them, added as files alone."""
    copy_root(tmp_path)
    bench = spec.bench_file()
    conf = spec.load_json(ROOT, "configs", "lbzip2-9-token")
    conf["name"] = "lbzip2-9-token-nosteal"
    conf["env"]["LBZ2_HOST_STEAL"] = "0"
    mix = spec.load_json(ROOT, "traffic", "files-256m")
    mix["distinct_files"] = 2
    g = tmp_path / "gpubench"
    (g / "configs" / "lbzip2-9-token-nosteal.json").write_text(
        json.dumps(conf))
    (g / "traffic" / "files-2.json").write_text(json.dumps(mix))
    (g / "metrics" / "calls_seen.py").write_text(
        'LAYER = "engine"\nUNIT = "calls"\nSOURCE = "program_counter"\n'
        'MOVES = "compress_MBps"\nBETTER = "higher"\n\n\n'
        'def read(ctx):\n    return len(ctx["calls"]) or None\n')
    bench["configs"].append({"name": conf["name"], "source": conf["source"],
                             "file": "gpubench/configs/"
                             "lbzip2-9-token-nosteal.json", "reduced": [],
                             "why": "a test cell"})
    bench["workloads"].append({"name": "token-nosteal.files-2",
                               "config": conf["name"], "traffic": "files-2",
                               "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("token-nosteal.files-2")
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine", "moves": "compress_MBps",
                               "workloads": ["token-nosteal.files-2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run(["--workload", "token-nosteal.files-2", "--seed",
                        "4", "--seconds", "1", "--trace", "1",
                        "--dry-bytes", "8000"], root=tmp_path)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert line["correct"]
    assert line["metrics"]["calls_seen"]["value"] >= 1
    assert len(json.loads(out[0])["files_sha256"]) == 2


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    rc, out, err = run(["--workload", cell, "--seed", "123456789",
                        "--seconds", "5", "--trace", "1"], timeout=1200)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert line["correct"], line
    assert line["device"]["kind"] == card and line["device"]["count"] == 1
    assert line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == {m["name"]
                                    for m in spec.cell(cell).per_layer}


def test_effort_control_is_not_correct():
    """The port with one EM refinement of its Huffman tables writes valid
    streams that ``size_excess`` refuses (at a size a test holds; the
    readings at the cells' sizes come from the card)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("LBZ2_")}
    r = subprocess.run([sys.executable, "gpubench/control.py", "--workload",
                        "chain.files-256m", "--control", "effort", "--seeds",
                        "1", "--bytes", "2000000"], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.splitlines()[-1])
    checks = line["checks"]
    assert not line["correct"]
    assert checks["files_wrong"]["value"] == 0
    assert checks["size_excess"]["value"] > checks["size_excess"]["limit"]


@pytest.mark.parametrize("entry", UNBZ2_ENTRIES["per_layer"],
                         ids=lambda e: e["name"])
def test_unnamed_reader_matches_its_entry(entry):
    """The readers of the decompress cell's metrics, which BENCHMARK.json
    does not name now, still match the entries that would name them."""
    reader = spec.metric_reader(entry["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES,
            reader.BETTER) == (entry["layer"], entry["unit"],
                               entry["source"], entry["moves"],
                               entry["better"])
    empty = {"calls": [], "trace": None, "device_bytes": 0,
             "card": {"kind": "cpu"}}
    assert reader.read(empty) is None
