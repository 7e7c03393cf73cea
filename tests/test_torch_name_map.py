"""The README's map from the JAX package's public op names to the port's
(section "JAX → port name map"): the JAX modules are read with ``ast``
(nothing of them is imported), and every public name of
lbzip2_tpu/ops/*.py must have a same-named definition in the port's
module of the same file name or a row in the map; every port name a row
gives must be defined where it says."""

import ast
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_OPS = ROOT / "lbzip2_tpu" / "ops"
PORT_OPS = ROOT / "lbzip2_tpu_torch" / "ops"


def defined(path: pathlib.Path) -> set:
    """Top-level names a module binds: functions, classes, assignments
    and imported names."""
    if not path.exists():
        return set()
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return out


def public(path: pathlib.Path) -> list:
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def name_map() -> dict:
    """{"ops/x.py::name": port cell} of the README's table."""
    text = (ROOT / "README.md").read_text()
    part = text[text.index("### JAX → port name map"):]
    part = part[:part.index("\n## ")]
    rows = re.findall(r"^\| `(ops/\w+\.py::\w+)` \| (.+?) \|$", part, re.M)
    return dict(rows)


def test_every_public_jax_name_has_a_counterpart():
    table = name_map()
    missing = []
    for path in sorted(JAX_OPS.glob("*.py")):
        port = defined(PORT_OPS / path.name)
        for name in public(path):
            key = f"ops/{path.name}::{name}"
            if name not in port and key not in table:
                missing.append(key)
    assert not missing, f"no counterpart in the port or the map: {missing}"


def test_every_mapped_port_name_exists():
    """A cell lists `ops/y.py::name` then further names of the same
    module (`other`), or says there is none and why."""
    table = name_map()
    assert len(table) >= 40
    for key, cell in table.items():
        if cell.startswith("none:"):
            continue
        refs = re.findall(r"`([^`]+)`", cell)
        module, first = refs[0].split("::")
        names = defined(ROOT / "lbzip2_tpu_torch" / module)
        for ref in [first] + refs[1:]:
            assert "::" not in ref and ref in names, (key, ref)
        jax_module, jax_name = key.split("::")
        assert jax_name in public(ROOT / "lbzip2_tpu" / jax_module), key
