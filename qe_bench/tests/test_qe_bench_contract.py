"""BENCHMARK.json against the benchmark's contract, and the imports of
every file under qe_bench/."""

import ast
import json
import os
import re

import pytest

from qe_bench.common import harness

ROOT, BENCH = harness.ROOT, harness.BENCH
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "qe_bench/run.py"]
    assert SPEC["paths"] == ["qe_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_units_and_texts():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and TEXT.fullmatch(c["source"])
        assert TEXT.fullmatch(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith("qe_bench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.fullmatch(w[k])
        assert TEXT.fullmatch(w["why"]) and w["chips"] in (1, 4)
        assert w["config"] in names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in SPEC[k]]
    assert len(all_names) == len(set(all_names))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_every_cell_finds_its_files():
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"], SPEC)
        assert cell.end_to_end and cell.per_layer
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in SPEC["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def _python_files():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(_python_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_a_plain_reference(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "tpu_qe"}
    if os.path.relpath(path, BENCH).startswith("reference"):
        assert "tpu_qe_torch" not in tops
