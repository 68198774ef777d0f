"""The plain references against the program, and the comparison failing
what it must: the control (the reference in lower precision), a wrapped
32-bit charge, and the program broken underneath the timed path."""

import time

import numpy as np
import pytest
import torch

from qe_bench.common import compare, harness, traffic

TPCH = ["tpch-sf10.q1", "tpch-sf10.q6", "tpch-sf10.q12"]
ALL = TPCH + ["morton-lbvh-2e26.frame"]


@pytest.mark.parametrize("seed", [1, 77, 2 ** 31 + 3])
@pytest.mark.parametrize("workload", ALL)
def test_reference_matches_program(tiny_cell, workload, seed):
    cell = tiny_cell(workload)
    data = cell.kind.make_data(cell.cfg, seed, "cpu")
    state = cell.kind.setup(data, "cpu")
    reqs = traffic.requests(cell.mix, seed)
    for _ in range(3):
        params = next(reqs)
        got = cell.kind.answer_of(cell.kind.serve(state, cell.mix, params))
        want = cell.reference.answer(data, params)
        assert compare.mismatches(got, want) == 0, params


@pytest.mark.parametrize("workload", ["tpch-sf10.q1", "tpch-sf10.q6",
                                      "morton-lbvh-2e26.frame"])
def test_control_is_not_correct(tiny_cell, workload):
    # Q12's control (keys searched as float32) departs only past 2^24
    # order keys, at the cell's own size: tests/test_qe_bench_card.py
    cell = tiny_cell(workload)
    r = harness.run(cell, 9, 0.3, False, "cpu", time.perf_counter(),
                    control=True)
    assert r["correct"] is False
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_wrapped_charge_is_not_correct(tiny_cell):
    # the spec's charge in one 32-bit row expression wraps
    cell = tiny_cell("tpch-sf10.q1")
    cell.mix = dict(cell.mix, sql=cell.mix["sql"].replace(
        "(l_extendedprice / 1024) * (100 - l_discount)",
        "l_extendedprice * (100 - l_discount)"))
    r = harness.run(cell, 4, 0.3, False, "cpu", time.perf_counter())
    assert r["correct"] is False


def _alter_sum(monkeypatch):
    from tpu_qe_torch.ops import aggregate
    real = aggregate.group_aggregate_multi

    def altered(*a, **k):
        res = real(*a, **k)
        for name, v in res.aggs.items():
            if name.endswith("_sum"):
                v.lo[0] += 1
                break
        return res
    monkeypatch.setattr(aggregate, "group_aggregate_multi", altered)


def _half_rows(monkeypatch):
    from tpu_qe_torch.ops import filter as F
    real = F.compact

    def half(table, mask):
        t, cnt = real(table, mask)
        return t, cnt // 2
    monkeypatch.setattr(F, "compact", half)


def _stale_sql(monkeypatch):
    from tpu_qe_torch.sql import executor
    real, first = executor.Database.sql, {}

    def stale(self, query, **k):
        if "r" not in first:
            first["r"] = real(self, query, **k)
        return first["r"]
    monkeypatch.setattr(executor.Database, "sql", stale)


def _alter_order(monkeypatch):
    from tpu_qe_torch import pipeline
    real = pipeline.sort_u64

    def swapped(*a, **k):
        key, (idx,) = real(*a, **k)
        idx = idx.clone()
        idx[[0, 1]] = idx[[1, 0]]
        return key, (idx,)
    monkeypatch.setattr(pipeline, "sort_u64", swapped)


def _half_frame(monkeypatch):
    from tpu_qe_torch import pipeline
    real = pipeline.sort_u64

    def half(key, idx, **k):
        h = key.lo.shape[0] // 2
        (lo, hi), (sidx,) = real(type(key)(key.lo[:h], key.hi[:h]),
                                 idx[:h], **k)
        return (type(key)(torch.cat([lo, key.lo[h:]]),
                          torch.cat([hi, key.hi[h:]])),
                (torch.cat([sidx, idx[h:]]),))
    monkeypatch.setattr(pipeline, "sort_u64", half)


def _stale_frame(monkeypatch):
    from tpu_qe_torch import pipeline
    real, first = pipeline.sorted_morton_index, {}

    def stale(*a, **k):
        if "r" not in first:
            first["r"] = real(*a, **k)
        return first["r"]
    monkeypatch.setattr(pipeline, "sorted_morton_index", stale)


FAULTS = [(w, f) for w in TPCH for f in (_alter_sum, _half_rows, _stale_sql)]
FAULTS += [("morton-lbvh-2e26.frame", f)
           for f in (_alter_order, _half_frame, _stale_frame)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_broken_program_is_not_correct(tiny_cell, monkeypatch, workload,
                                       fault):
    cell = tiny_cell(workload)
    fault(monkeypatch)
    r = harness.run(cell, 21, 0.5, False, "cpu", time.perf_counter())
    assert r["correct"] is False
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_comparison_counts_what_differs():
    a = {"x": np.array([1, 2, 3], np.uint64), "y": np.array([0.5, 1.0])}
    assert compare.mismatches(a, dict(a)) == 0
    assert compare.mismatches(a, {"x": np.array([1, 2, 4]),
                                  "y": a["y"]}) == 1
    assert compare.mismatches(a, {"x": a["x"][:2], "y": a["y"]}) == 1
    assert compare.mismatches(a, {"y": a["y"], "x": a["x"]}) == 1
    assert compare.mismatches({"x": a["x"]}, a) == 2
    t = {"c": torch.arange(4)}
    assert compare.mismatches(t, {"c": torch.tensor([0, 1, 2, 2])}) == 1
