"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``classes/<name>.py`` (a kind of data a
traffic mix names under ``shares``) under this folder.

Only the standard library is imported here, so the tests and a run that
fails early load it cheaply.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with its configuration, its traffic
    mix, its end-to-end metrics and the per-layer metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def bench_file(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(root: pathlib.Path, kind: str, name: str) -> dict:
    """``gpubench/<kind>/<name>.json`` under ``root``."""
    path = root / "gpubench" / kind / f"{name}.json"
    with open(path) as fh:
        return json.load(fh)


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    """The metrics a cell reports: those that list it under
    ``workloads``, and those without the key."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; KeyError if there
    is none."""
    bench = bench_file(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root, "configs", conf["name"])
    traffic = load_json(root, "traffic", w["traffic"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def _load_by_path(kind: str, name: str, root: pathlib.Path) -> ModuleType:
    """The module ``gpubench/<kind>/<name>.py`` under ``root``, loaded by
    path (a name may hold dots); FileNotFoundError naming the path where
    there is none."""
    path = root / "gpubench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r}: {path}")
    mod_name = f"gpubench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: pathlib.Path = ROOT) -> ModuleType:
    """The reader module ``gpubench/metrics/<name>.py``."""
    return _load_by_path("metrics", name, root)


@functools.cache
def data_class(name: str, root: pathlib.Path = ROOT) -> ModuleType:
    """The data class ``gpubench/classes/<name>.py``, loaded once for each
    ``root``: its ``make(traffic, rng, text, nbytes)`` returns exactly
    ``nbytes`` bytes drawn from the file's generator ``rng``."""
    return _load_by_path("classes", name, root)
