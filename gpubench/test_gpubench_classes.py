"""Data classes found by name (``classes/<name>.py``), files whose classes
keep their order (``"page_bytes": null``), the versions class, and the
existing traffics' files pinned to the bytes they had before classes
could be added as files."""

import _io
import builtins
import json
import pathlib

import numpy as np
import pytest

from gpubench import corpus, spec
from gpubench.test_gpubench_runs import DRY, copy_root, run

SMALL = 300_000
SEED = 2**31 + 2601
VERSIONS = spec.load_json(spec.ROOT, "traffic", "srcversions-256m")
TEXT = corpus.text_class()
BASE = np.frombuffer(TEXT, np.uint8)
N = BASE.size
RATE = VERSIONS["versions"]["mutation_rate"]


def _versions(seed, nversions):
    """File 0 of ``seed`` on the versions traffic, cut into its first
    ``nversions`` versions of the base's length."""
    f = corpus.make_file(VERSIONS, seed, 0, TEXT, nversions * N)
    return np.frombuffer(f.data, np.uint8).reshape(nversions, N)


# sha256 of file ``index`` of ``seed`` at ``nbytes``, as the harness made
# it before data classes came in as files.  The two mixes have the same
# ``shares`` and ``sources``, so at one seed and size they draw the same
# bytes: each is pinned at seeds and indices of its own.
PINNED = [
    ("files-256m", SEED, 0, SMALL,
     "7101f45bda57a068e3fd750e689a3fdf910ba8c7b19d5d2ab1df25c8e87bba17"),
    ("files-256m", SEED, 1, 5_000_000,
     "dc62f8487759cebff5c1a02bb43a43aff71b50b0c976f41464e93e94a7c0157a"),
    ("bz2-files-64m", SEED + 1, 1, SMALL,
     "7a4e453ede8e8c69c673e92a98c9ac61a3c040bd1f6f3b2d3384dd7c5c092135"),
    ("bz2-files-64m", SEED + 2, 0, 5_000_000,
     "25a4263ce31e8f648c946a74343b6c59b36995e10f522509bf3525645092acda"),
]


@pytest.mark.parametrize("traffic,seed,index,nbytes,sha", PINNED)
def test_existing_traffic_files_are_pinned(traffic, seed, index, nbytes, sha):
    mix = spec.load_json(spec.ROOT, "traffic", traffic)
    assert corpus.make_file(mix, seed, index, TEXT, nbytes).sha256 == sha


def test_class_found_by_path(tmp_path):
    root = copy_root(tmp_path)
    (root / "gpubench" / "classes" / "counting.py").write_text(
        "import numpy as np\n\n\n"
        "def make(traffic, rng, text, nbytes):\n"
        "    start = int(rng.integers(0, 256))\n"
        "    step = traffic['counting']['step']\n"
        "    return ((start + step * np.arange(nbytes)) % 256)"
        ".astype(np.uint8).tobytes()\n")
    mix = {"file_bytes": 5000, "distinct_files": 2, "page_bytes": None,
           "shares": {"counting": 1.0}, "sources": {"pad_bytes": 0},
           "counting": {"step": 3}}
    files = corpus.make_files(mix, 8, root=root)
    for f in files:
        a = np.frombuffer(f.data, np.uint8).astype(int)
        assert a.size == 5000 and set(np.diff(a) % 256) == {3}
    assert files[0].data != files[1].data


def test_missing_class_names_its_path(tmp_path):
    mix = {"page_bytes": None, "shares": {"nosuch": 1.0},
           "sources": {"pad_bytes": 0}}
    with pytest.raises(FileNotFoundError) as e:
        corpus.make_file(mix, 1, 0, TEXT, 1000, root=tmp_path)
    assert str(tmp_path / "gpubench" / "classes" / "nosuch.py") in str(e.value)


@pytest.mark.parametrize("order", [("random", "text"), ("text", "random")])
def test_classes_keep_the_order_of_shares(order):
    mix = {"page_bytes": None, "shares": {name: 0.5 for name in order},
           "sources": {"random_bytes": 50_000, "pad_bytes": 0}}
    data = corpus.make_file(mix, 4, 0, TEXT, 100_000).data
    halves = {name: data[k * 50_000:(k + 1) * 50_000]
              for k, name in enumerate(order)}
    assert halves["text"] == TEXT[:50_000]
    assert halves["random"] not in TEXT and len(set(halves["random"])) == 256


def test_versions_same_seed_same_bytes_other_seeds_other_bytes():
    a = corpus.make_files(VERSIONS, 2**33 + 1, SMALL)
    b = corpus.make_files(VERSIONS, 2**33 + 1, SMALL)
    c = corpus.make_files(VERSIONS, 2**33 + 2, SMALL)
    assert [f.sha256 for f in a] == [f.sha256 for f in b]
    assert len({f.sha256 for f in a + c}) == 2 * VERSIONS["distinct_files"]


def test_every_version_is_as_long_as_the_base():
    """Cut at the base's length, each version lines up with the next:
    they differ in a few positions, where one byte of shift would differ
    in most."""
    v = _versions(6, 4)
    for a, b in zip(v[:-1], v[1:]):
        assert (a != b).sum() < 200
        assert (a[1:] != b[:-1]).mean() > 0.5


def test_consecutive_versions_differ_by_a_binomial_count():
    """Each version changes a Binomial(n, rate) count of the bytes of the
    one before (the base for the first)."""
    v = _versions(7, 12)
    counts = [(a != b).sum() for a, b in zip(np.vstack([BASE, v[:-1]]), v)]
    mean, sd = N * RATE, (N * RATE * (1 - RATE)) ** 0.5
    assert all(abs(c - mean) < 6 * sd for c in counts), counts
    assert abs(np.mean(counts) - mean) < 6 * sd / len(counts) ** 0.5
    assert len(set(counts)) > 1


def test_every_byte_is_in_the_base_alphabet():
    v = _versions(8, 3)
    assert set(np.unique(v)) <= set(np.unique(BASE))


def test_dry_bytes_sized_files():
    files = corpus.make_files(VERSIONS, 9, DRY["compress"])
    for f in files:
        a = np.frombuffer(f.data, np.uint8)
        assert a.size == DRY["compress"]
        assert (a != BASE[:a.size]).sum() < 20


def test_versions_read_nothing_outside_the_checkout(monkeypatch):
    """Neither the corpus nor the class module's loading opens a file
    outside the checkout."""
    root = spec.ROOT.resolve()
    seen = []
    real_open, real_open_code = builtins.open, _io.open_code

    def spy(opener):
        def opened(file, *args, **kwargs):
            seen.append(pathlib.Path(file).resolve())
            return opener(file, *args, **kwargs)
        return opened

    spec.data_class.cache_clear()
    monkeypatch.setattr(builtins, "open", spy(real_open))
    monkeypatch.setattr(_io, "open_code", spy(real_open_code))
    corpus.make_files(VERSIONS, 5, SMALL)
    assert root / "gpubench" / "classes" / "versions.py" in seen
    assert all(p.is_relative_to(root / "lbzip2_tpu") or
               p.is_relative_to(root / "gpubench" / "classes")
               for p in seen), [p for p in seen
                                if not p.is_relative_to(root)]


def test_a_cell_on_the_versions_traffic_runs(tmp_path):
    """A cell that names srcversions-256m, added to a copy of
    BENCHMARK.json, runs through ``run.py --dry-bytes``."""
    root = copy_root(tmp_path)
    bench = spec.bench_file()
    name = "chain.srcversions-256m"
    bench["workloads"].append({"name": name, "config": "lbzip2-9-chain",
                               "traffic": "srcversions-256m", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.cell(name, root).traffic == VERSIONS
    rc, out, err = run(["--workload", name, "--seed", str(2**31 + 26),
                        "--seconds", "1", "--trace", "0", "--dry-bytes",
                        str(DRY["compress"])], root=root)
    assert rc == 0, err[-3000:]
    line = json.loads(out[-1])
    assert line["correct"] and line["dry_run"], line
    assert set(line["metrics"]) == {"compress_MBps", "setup_s"}
    first = json.loads(out[0])
    want = corpus.make_files(VERSIONS, 2**31 + 26, DRY["compress"])
    assert first["files_sha256"] == [f.sha256 for f in want]
