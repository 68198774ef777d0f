"""Each cell end to end at a tiny size on the CPU, and the command's
refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from qe_bench.common import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end(tiny_cell, workload, traced):
    cell = tiny_cell(workload)
    r = harness.run(cell, 2 ** 31 + 17, 0.5, traced, "cpu",
                    time.perf_counter())
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True, r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["mismatched_values"] == {"value": 0, "limit": 0}
    assert r["device"]["count"] == 1
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    assert set(r["metrics"]) <= names
    if traced:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    json.dumps(r)


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "qe_bench/run.py", "--workload", "tpch-sf10.q6",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    r = _command(ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "qe_bench"), tmp_path / "qe_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_modules_are_seen(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_qe.fake", object())
    assert "tpu_qe.fake" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_qe_torch_like", object())
    assert "tpu_qe_torch_like" not in harness.forbidden_modules()


def test_traced_slice_is_bounded(tiny_cell, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SLICE_REQUESTS", 3)
    cell = tiny_cell("tpch-sf10.q6")
    monkeypatch.setattr(harness, "HOST_SLICE_REQUESTS", 2)
    r = harness.run(cell, 5, 4.0, True, "cpu", time.perf_counter())
    assert r["correct"] and r["attempted"] >= 3 + 2
    assert r["metrics"]["sort.hostpaced.passes"]["value"] > 0
    assert os.path.exists(os.path.join(harness.OUT_DIR,
                                       "tpch-sf10.q6.host.json.gz"))
