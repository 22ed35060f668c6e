"""``BENCHMARK.json`` against the files it names, and the imports of the
benchmark's sources."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = sorted(HERE.rglob("*.py"))


def test_every_named_file_exists():
    assert BENCH["command"][1] == "portbench/run.py" and (ROOT / BENCH["command"][1]).exists()
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.exists() and path.parts[len(ROOT.parts)] == "portbench"
        config = json.loads(path.read_text())
        assert config["name"] == c["name"]
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        assert (HERE / "datasets" / f"{config['dataset']}.py").exists()
        assert (HERE / "reference" / f"{config.get('reference', 'natural_join')}.py").exists()
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "loops" / f"{traffic['loop']}.py").exists()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_names_units_and_links():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w[k]) for w in BENCH["workloads"] for k in ("config", "traffic"))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert {w["chips"] for w in BENCH["workloads"]} == {1}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_imports(path):
    """No JAX and no JAX package anywhere (whole top-level names: the port's
    name begins with the JAX package's); the reference takes nothing of the
    program either."""
    found = set(top_level_imports(path))
    assert not found & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in found and found <= {"__future__", "numpy", "torch"}
