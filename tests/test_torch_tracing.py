"""The port's span API (tpu_qe_torch/utils/profiling.py) and the spans at
the SQL, ops, sort and morton boundaries, on the CPU.

Spans are off unless a torch.profiler session runs or profiling.tracing()
is held; then each query is one request record whose span tree, counts
and Chrome-trace ranges are checked here against numpy on tiny tables.
"""

import gc
import json
from collections import Counter

import numpy as np
import pytest
import torch

from tpu_qe_torch.sql.executor import Database
from tpu_qe_torch.utils import profiling

N_ORDERS = 400

Q1 = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
      "SUM(l_extendedprice) AS sum_base_price, "
      "SUM(l_extendedprice * (100 - l_discount)) AS sum_disc_price, "
      "SUM((l_extendedprice / 1024) * (100 - l_discount) * (100 + l_tax)) "
      "AS sum_charge_hi, "
      "SUM((l_extendedprice % 1024) * (100 - l_discount) * (100 + l_tax)) "
      "AS sum_charge_lo, AVG(l_quantity) AS avg_qty, "
      "AVG(l_extendedprice) AS avg_price, AVG(l_discount) AS avg_disc, "
      "COUNT(*) AS count_order FROM lineitem WHERE l_shipdate <= 10471 "
      "GROUP BY l_returnflag, l_linestatus "
      "ORDER BY l_returnflag, l_linestatus")
Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
      "WHERE l_shipdate >= 8766 AND l_shipdate < 9131 "
      "AND l_discount BETWEEN 5 AND 7 AND l_quantity < 24")
Q12 = ("SELECT l_shipmode, SUM(CASE WHEN o_orderpriority = 0 OR "
       "o_orderpriority = 1 THEN 1 ELSE 0 END) AS high_line_count, "
       "SUM(CASE WHEN o_orderpriority <> 0 AND o_orderpriority <> 1 "
       "THEN 1 ELSE 0 END) AS low_line_count FROM orders JOIN lineitem "
       "ON o_orderkey = l_orderkey WHERE l_shipmode IN (2, 5) "
       "AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate "
       "AND l_receiptdate >= 8766 AND l_receiptdate < 9131 "
       "GROUP BY l_shipmode ORDER BY l_shipmode")

# the spans of each query, without the radix passes' own: one sql.sync per
# read of a device value (the kept count, the group count, each column of
# the group frame: a u64 sum is two planes); sql.grouped holds the grouped
# answer's reads, every group read to the host frame here
SUM_COLS = {"q1": 7, "q6": 2, "q12": 3}
SPANS = {
    "q1": {"sql.query": 1, "sql.parse": 1, "sql.from": 1, "sql.expr": 4,
           "ops.compact": 1, "ops.group": 1, "sort.radix": 1,
           "sql.sync": 18, "sql.finish": 4, "sql.grouped": 1},
    "q6": {"sql.query": 1, "sql.parse": 1, "sql.from": 1, "sql.expr": 2,
           "ops.compact": 1, "ops.group": 1, "sort.radix": 1,
           "sql.sync": 6, "sql.finish": 4, "sql.grouped": 1},
    "q12": {"sql.query": 1, "sql.parse": 1, "sql.from": 1, "ops.join": 1,
            "sort.radix": 2, "sql.expr": 3, "ops.compact": 1,
            "ops.group": 1, "sql.sync": 10, "sql.finish": 4,
            "sql.grouped": 1},
}
PARENTS = {"sql.parse": "sql.query", "sql.from": "sql.query",
           "sql.expr": "sql.query", "ops.compact": "sql.query",
           "ops.group": "sql.query", "ops.join": "sql.from",
           "sql.grouped": "sql.query"}


@pytest.fixture(scope="module")
def tpch():
    """(Database on the CPU, numpy columns) of a tiny lineitem and
    orders."""
    rng = np.random.default_rng(19)
    lines = rng.integers(1, 8, N_ORDERS)
    n = int(lines.sum())
    okey = np.arange(N_ORDERS, dtype=np.uint32) * 4 + 1
    ship = rng.integers(8035, 10440, n)
    commit = ship + rng.integers(-30, 30, n)
    li = {"l_orderkey": np.repeat(okey, lines),
          "l_returnflag": rng.integers(0, 3, n),
          "l_linestatus": rng.integers(0, 2, n),
          "l_quantity": rng.integers(1, 51, n),
          "l_extendedprice": rng.integers(90000, 10000000, n),
          "l_discount": rng.integers(0, 11, n),
          "l_tax": rng.integers(0, 9, n),
          "l_shipdate": ship, "l_commitdate": commit,
          "l_receiptdate": ship + rng.integers(1, 31, n),
          "l_shipmode": rng.integers(0, 7, n)}
    li = {k: v.astype(np.uint32) for k, v in li.items()}
    orders = {"o_orderkey": okey,
              "o_orderpriority": rng.integers(0, 5, N_ORDERS).astype(
                  np.uint32)}
    db = Database("cpu")
    db.register("lineitem", li)
    db.register("orders", orders)
    return db, li


def _kept(li, name):
    """numpy's count of the rows each query's WHERE keeps."""
    if name == "q1":
        return int((li["l_shipdate"] <= 10471).sum())
    if name == "q6":
        return int(((li["l_shipdate"] >= 8766) & (li["l_shipdate"] < 9131)
                    & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
                    & (li["l_quantity"] < 24)).sum())
    return int((np.isin(li["l_shipmode"], (2, 5))
                & (li["l_commitdate"] < li["l_receiptdate"])
                & (li["l_shipdate"] < li["l_commitdate"])
                & (li["l_receiptdate"] >= 8766)
                & (li["l_receiptdate"] < 9131)).sum())


def _groups(li, name):
    """numpy's count of the groups each query's GROUP BY makes."""
    if name == "q6":
        return 1                    # a global aggregate: one group
    keep = li["l_shipdate"] <= 10471 if name == "q1" else (
        np.isin(li["l_shipmode"], (2, 5))
        & (li["l_commitdate"] < li["l_receiptdate"])
        & (li["l_shipdate"] < li["l_commitdate"])
        & (li["l_receiptdate"] >= 8766) & (li["l_receiptdate"] < 9131))
    keys = (li["l_returnflag"] * 2 + li["l_linestatus"] if name == "q1"
            else li["l_shipmode"])
    return len(np.unique(keys[keep]))


def _traced(db, query, how):
    """The records filed while `query` ran traced `how`."""
    before = {r["id"] for r in profiling.records()}
    if how == "profiler":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert profiling.enabled()
            db.sql(query)
    else:
        with profiling.tracing():
            assert profiling.enabled()
            db.sql(query)
    assert not profiling.enabled()
    return [r for r in profiling.records() if r["id"] not in before]


def test_tracing_off_keeps_nothing_and_enters_no_range(tpch, monkeypatch):
    db, _ = tpch

    def refuse(*a, **k):
        raise AssertionError("a range was entered with tracing off")
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    before = [r["id"] for r in profiling.records()]
    assert not profiling.enabled()
    assert profiling.span("sql.query") is profiling.span("x", rows=1)
    db.sql(Q6)
    assert [r["id"] for r in profiling.records()] == before


@pytest.mark.parametrize("how", ["profiler", "tracing"])
@pytest.mark.parametrize("name,query", [("q1", Q1), ("q6", Q6),
                                        ("q12", Q12)],
                         ids=["q1", "q6", "q12"])
def test_a_query_is_one_request_with_its_span_tree(tpch, name, query, how):
    db, li = tpch
    (rec,) = _traced(db, query, how)
    spans = rec["spans"]
    assert rec["name"] == "sql.query" and spans[0]["parent"] is None
    assert [s["parent"] for s in spans[1:]].count(None) == 0
    assert {s["request"] for s in spans} == {rec["id"]}
    names = Counter(s["name"] for s in spans if " pass " not in s["name"])
    assert names == SPANS[name]
    for s in spans:
        parent = spans[s["parent"]]["name"] if s["parent"] is not None \
            else None
        if s["name"] in PARENTS:
            assert parent == PARENTS[s["name"]], s
        if s["name"] == "sort.radix":
            assert parent in ("ops.group", "ops.join")
        if " pass " in s["name"]:
            assert parent == "sort.radix"
        if s["name"] == "sql.sync":
            assert parent in ("sql.query", "sql.from", "sql.finish",
                              "ops.compact", "ops.join", "sql.grouped")
        if s["name"] not in ("ops.compact", "ops.join", "ops.group",
                             "sql.grouped"):
            assert s["counts"] == {}, s
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
    (compact,) = [s["counts"] for s in spans if s["name"] == "ops.compact"]
    n = len(li["l_orderkey"])
    assert compact == {"rows_in": n, "rows_kept": _kept(li, name)}
    # the count and integer-sum aggregates, each query's COUNT(*) among
    # them; CPU tensors take the reduce-by-key kernel's plain twin
    (group,) = [s["counts"] for s in spans if s["name"] == "ops.group"]
    assert group == {"sum_cols": SUM_COLS[name], "sum_cols_kernel": 0}
    (grouped,) = [s["counts"] for s in spans if s["name"] == "sql.grouped"]
    assert grouped == {"groups_read": _groups(li, name)}
    joins = [s["counts"] for s in spans if s["name"] == "ops.join"]
    if name == "q12":       # every line finds its order, 1-7 to an order
        assert joins == [{"rows_left": N_ORDERS, "rows_right": n,
                          "rows_out": n, "passthrough": 0}]


def test_span_names_nest_in_the_chrome_trace(tpch, tmp_path):
    db, _ = tpch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        db.sql(Q12)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e["name"] in ("sql.query", "sql.from",
                                                "ops.join", "ops.compact",
                                                "ops.group", "sort.radix"):
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))

    def inside(inner, outer):
        return all(any(a >= c and b <= d for c, d in spans[outer])
                   for a, b in spans[inner])
    assert len(spans["sql.query"]) == 1 and len(spans["sort.radix"]) == 2
    for inner, outer in [("sql.from", "sql.query"), ("ops.join", "sql.from"),
                         ("ops.compact", "sql.query"),
                         ("ops.group", "sql.query"),
                         ("sort.radix", "sql.query")]:
        assert inside(inner, outer), (inner, outer)


def test_a_frame_is_one_request_with_its_encode_and_sort():
    from tpu_qe_torch.config import SceneConfig
    from tpu_qe_torch.pipeline import scene_tensors, sorted_morton_index
    verts, tris, params = scene_tensors(
        SceneConfig(num_vertices=300, num_triangles=1000), "cpu")
    with profiling.tracing():
        sorted_morton_index(verts, tris, params)
    rec = profiling.records()[-1]
    top = [(s["name"], s["parent"]) for s in rec["spans"]
           if " pass " not in s["name"]]
    assert top == [("morton.frame", None), ("morton.encode", 0),
                   ("sort.radix", 0)]
    passes = [s for s in rec["spans"] if " pass " in s["name"]]
    assert len(passes) == 3 * 8 and {s["parent"] for s in passes} == {2}


def test_the_ring_is_bounded_and_restarts_with_tracing():
    with profiling.tracing():
        for _ in range(profiling.RING + 20):
            with profiling.span("t", k=1) as s:
                s.count(k=2)
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert [r["id"] for r in recs] == list(range(recs[0]["id"],
                                                 recs[0]["id"]
                                                 + profiling.RING))
    assert recs[-1]["spans"][0]["counts"] == {"k": 3}
    with profiling.span("untraced"):
        pass
    assert len(profiling.records()) == profiling.RING
    # two profiler sessions in a row add to the ring, as a traced run's
    # device and host slices do
    for name in ("device slice", "host slice"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
    assert [r["name"] for r in profiling.records()[-2:]] == [
        "device slice", "host slice"]
    assert len(profiling.records()) == profiling.RING
    with profiling.tracing():
        with profiling.tracing():
            with profiling.span("t"):
                pass
        assert [r["name"] for r in profiling.records()] == ["t"]


def test_records_reference_no_tensor(tpch):
    db, _ = tpch
    _traced(db, Q1, "tracing")
    _traced(db, Q12, "profiler")
    seen, todo = set(), [profiling.records(), list(profiling._TRACER.ring)]
    while todo:
        obj = todo.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        assert not isinstance(obj, torch.Tensor)
        if isinstance(obj, type):
            continue
        assert not callable(obj), type(obj)
        todo.extend(gc.get_referents(obj))


Q_SUB = ("SELECT o_orderkey, COUNT(*) AS c FROM orders JOIN lineitem ON "
         "o_orderkey = l_orderkey WHERE o_orderkey IN (SELECT l_orderkey "
         "FROM lineitem GROUP BY l_orderkey HAVING SUM(l_quantity) > 150) "
         "GROUP BY o_orderkey ORDER BY c DESC, o_orderkey LIMIT 3")


def test_a_subquery_is_one_span_and_its_groups_are_not_read(tpch):
    db, li = tpch
    sums = np.bincount(np.unique(li["l_orderkey"], return_inverse=True)[1],
                       weights=li["l_quantity"])
    assert (sums > 150).sum() > 3       # the outer answer: a LIMIT below G
    (rec,) = _traced(db, Q_SUB, "tracing")
    spans = rec["spans"]

    def under(i, j):
        while spans[i]["parent"] is not None:
            i = spans[i]["parent"]
            if i == j:
                return True
        return False
    (sub,) = [i for i, s in enumerate(spans) if s["name"] == "sql.subquery"]
    assert spans[sub]["parent"] == 0 and spans[sub]["counts"] == {}
    assert spans[sub]["device_ms"] is None          # events on the card only
    grouped = [i for i, s in enumerate(spans) if s["name"] == "sql.grouped"]
    assert [spans[i]["counts"] for i in grouped if under(i, sub)] == [
        {"groups_read": 0}]                         # the IN reads none
    assert [spans[i]["counts"] for i in grouped if not under(i, sub)] == [
        {"groups_read": 3}]                         # the LIMIT's rows
