"""The per-layer metrics read from the program's own spans and counts
(common/spans.py, the metrics sql.syncs, sql.hostpaced.*, sql.expr_ms,
ops.group_ms, ops.hostpaced.compact_yield).

On the CPU at tiny sizes: the counts against what the queries must do,
and silence, not failure, where the program keeps no records. On the card
(marked `cuda`): each query's sql.sync spans against the synchronisations
torch's sync debug mode reports, and no span or event among the kernels of
a device-only profile.

    python3 -m pytest -p no:cacheprovider qe_bench/tests -m cuda
"""

import os
import time
import warnings

import pytest
import torch

from qe_bench.common import harness, spans, trace, traffic
from tpu_qe_torch.utils import profiling

SQL = ["tpch-sf10.q1", "tpch-sf10.q6", "tpch-sf10.q12"]
SYNCS = {"tpch-sf10.q1": 18, "tpch-sf10.q6": 6, "tpch-sf10.q12": 10}
READERS = ["sql.syncs", "sql.hostpaced.syncs", "sql.hostpaced.host_ms",
           "sql.expr_ms", "ops.group_ms", "ops.hostpaced.compact_yield"]


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH, "metrics",
                                            name + ".py")).read


def _kept(li, traffic_name, p):
    """The lineitem rows each query's WHERE keeps, by torch on the data."""
    if traffic_name == "q1":
        m = li["l_shipdate"] <= 10561 - p["delta"]
    elif traffic_name == "q6":
        m = ((li["l_shipdate"] >= p["d0"]) & (li["l_shipdate"] < p["d1"])
             & (li["l_discount"] >= p["disc_lo"])
             & (li["l_discount"] <= p["disc_hi"])
             & (li["l_quantity"] < p["quantity"]))
    else:
        rd = li["l_receiptdate"]
        m = (((li["l_shipmode"] == p["modes"][0])
              | (li["l_shipmode"] == p["modes"][1]))
             & (li["l_commitdate"] < rd)
             & (li["l_shipdate"] < li["l_commitdate"])
             & (rd >= p["d0"]) & (rd < p["d1"]))
    return int(m.sum())


@pytest.mark.parametrize("workload", SQL)
def test_counts_against_the_queries(tiny_cell, workload):
    cell = tiny_cell(workload)
    data = cell.kind.make_data(cell.cfg, 2 ** 31 + 5, "cpu")
    db = cell.kind.setup(data, "cpu")
    reqs = traffic.requests(cell.mix, 2 ** 31 + 5)
    served = [next(reqs) for _ in range(3)]
    with profiling.tracing():
        for p in served:
            cell.kind.serve(db, cell.mix, p)
    assert len(spans.requests("sql.query")) == 3
    n = data["lineitem"]["l_orderkey"].shape[0]
    kept = sum(_kept(data["lineitem"], workload.split(".")[1], p)
               for p in served)
    assert _reader("sql.syncs")(None) == SYNCS[workload]
    assert _reader("ops.hostpaced.compact_yield")(None) == pytest.approx(
        100.0 * kept / (3 * n))
    assert _reader("sql.hostpaced.host_ms")(None) > 0
    # event-timed: no device time on the CPU
    assert _reader("sql.expr_ms")(None) is None
    assert _reader("ops.group_ms")(None) is None


def test_readers_are_silent_without_records(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    for name in READERS:
        assert _reader(name)(None) is None


@pytest.mark.parametrize("workload", SQL)
def test_a_traced_run_reports_the_counts(tiny_cell, workload, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SLICE_REQUESTS", 3)
    monkeypatch.setattr(harness, "HOST_SLICE_REQUESTS", 2)
    cell = tiny_cell(workload)
    with profiling.tracing():       # empties the ring, as a fresh process
        pass
    r = harness.run(cell, 2 ** 31 + 9, 0.5, True, "cpu", time.perf_counter())
    assert r["correct"], r
    got = {k: v["value"] for k, v in r["metrics"].items()}
    syncs = "sql.syncs" if workload.endswith("q1") else "sql.hostpaced.syncs"
    assert got[syncs] == SYNCS[workload]
    if not workload.endswith("q1"):
        assert 0 < got["ops.hostpaced.compact_yield"] < 100
        assert got["sql.hostpaced.host_ms"] > 0
    assert "sql.expr_ms" not in got and "ops.group_ms" not in got


def _card_db(workload, seed):
    cell = harness.load_cell(workload)
    cell.cfg["scale_factor"] = 0.1
    data = cell.kind.make_data(cell.cfg, seed, "cuda")
    return cell, cell.kind.setup(data, "cuda")


def _syncs_reported(fn):
    """(fn's result, where each synchronisation torch's sync debug mode
    reported came from)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [(os.path.basename(w.filename), w.lineno) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SQL)
def test_sync_spans_are_the_syncs_on_the_card(cuda_card, workload):
    cell, db = _card_db(workload, 2 ** 31 + 11)
    reqs = traffic.requests(cell.mix, 2 ** 31 + 11)
    for _ in range(3):
        query = cell.mix["sql"].format(**next(reqs))
        db.sql(query)                                   # warm
        _, untraced = _syncs_reported(lambda: db.sql(query))

        def traced():
            with profiling.tracing():
                db.sql(query)
        _, reported = _syncs_reported(traced)
        rec = profiling.records()[-1]
        assert rec["name"] == "sql.query"
        assert len(spans.named(rec, "sql.sync")) == len(reported), reported
        assert reported == untraced
        assert len(reported) == SYNCS[workload], reported
        expr = [s["device_ms"] for s in spans.named(rec, "sql.expr")]
        assert expr and all(t >= 0 for t in expr)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SQL + ["morton-lbvh-2e26.frame"])
def test_no_span_among_the_device_kernels(cuda_card, workload):
    cell = harness.load_cell(workload)
    cell.cfg.update({"tpch": {"scale_factor": 0.1},
                     "morton": {"num_vertices": 1 << 16,
                                "num_triangles": 1 << 18}}[cell.cfg["kind"]])
    data = cell.kind.make_data(cell.cfg, 2 ** 31 + 13, "cuda")
    state = cell.kind.setup(data, "cuda")
    reqs = traffic.requests(cell.mix, 2 ** 31 + 13)
    cell.kind.serve(state, cell.mix, next(reqs))
    before = {r["id"] for r in profiling.records()}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        assert profiling.enabled()
        for _ in range(2):
            cell.kind.serve(state, cell.mix, next(reqs))
        torch.cuda.synchronize()
    finally:
        prof.stop()
    traced = [r for r in profiling.records() if r["id"] not in before]
    names = {s["name"] for r in traced for s in r["spans"]}
    assert len(traced) == 2 and "sort.radix" in names
    kernels, _, _ = trace.device_ops(prof)
    assert kernels
    assert not names & set(kernels), names & set(kernels)
    assert not [k for k in kernels if "event" in k.lower()]
