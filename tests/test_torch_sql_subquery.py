"""IN (SELECT ...) and the grouped answer kept on the device, on the CPU.

- The parser's InSelect node and the refusals: NOT IN (SELECT ...), a
  subquery of more than one item, a correlated subquery, and the mesh=
  and out-of-core tiers.
- Uncorrelated subqueries against sqlite3: plain and grouped (HAVING),
  duplicates, an empty answer, i32 / u32 / u64 / f32 keys and mixed ones.
- The device group frame (HAVING, a LIMIT below the groups) against the
  host frame on the same queries: the same columns, dtypes and values.
- TPC-H Q18 and Q3 at SF 0.002 through the benchmark's `tpch_cust` kind,
  against its plain reference (Q18) and sqlite.
"""

import json
import os

import numpy as np
import pytest

from sql_battery import agrees, battery_tables, sqlite_connection, sqlite_rows
from tpu_qe_torch.sql import parser as P
from tpu_qe_torch.sql.executor import Database
from tpu_qe_torch.sql.parser import SqlError


def _big_table() -> dict:
    """u32 values near 2^32 and i32 values near -2^31, so that a group's
    sums pass 2^32 in both directions."""
    rng = np.random.default_rng(5)
    n = 600
    return {"k": rng.integers(0, 6, n).astype(np.uint32),
            "u": rng.integers(4_000_000_000, 1 << 32, n, dtype=np.uint64)
            .astype(np.uint32),
            "v": rng.integers(-(1 << 31), -2_000_000_000, n).astype(np.int32)}


@pytest.fixture(scope="module")
def dbs():
    tabs = battery_tables()
    tabs["big"] = _big_table()
    db = Database("cpu")
    for name, cols in tabs.items():
        db.register(name, cols)
    return db, sqlite_connection(tabs)


# --- the parser --------------------------------------------------------------

def test_in_select_parses_to_a_node_holding_the_subquery():
    q = P.parse("SELECT id FROM t WHERE v > 0 AND k IN (SELECT k FROM r "
                "WHERE w < 9 GROUP BY k HAVING COUNT(*) > 2) ORDER BY id")
    where = q.selects[0].where
    (node,) = P.in_selects(q)
    assert where.right is node and node.operand == P.Col("k")
    sub = node.select
    assert sub.table.name == "r" and sub.group_by == (P.Col("k"),)
    assert sub.where == P.Binary("<", P.Col("w"), P.Lit(9))
    assert isinstance(sub.having, P.Binary)
    # a list after IN is still a list
    (lst,) = [P.parse("SELECT id FROM t WHERE k IN (1, 2)").selects[0]
              .where]
    assert isinstance(lst, P.InList) and not P.in_selects(lst)


@pytest.mark.parametrize("query,words", [
    ("SELECT id FROM t WHERE k NOT IN (SELECT k FROM r)", "NOT IN"),
    ("SELECT id FROM t WHERE k IN (SELECT k, w FROM r)", "one select item"),
    ("SELECT id FROM t WHERE k IN (SELECT * FROM r)", "one select item"),
], ids=["not_in", "two_items", "star"])
def test_the_parser_refuses_what_it_does_not_run(query, words):
    with pytest.raises(SqlError, match=words):
        P.parse(query)


@pytest.mark.parametrize("query", [
    "SELECT id FROM t WHERE k IN (SELECT k FROM r WHERE w = t.v)",
    "SELECT id FROM t WHERE k IN (SELECT k FROM r WHERE w = id)",
], ids=["qualified", "bare"])
def test_a_correlated_subquery_is_refused(dbs, query):
    db, _ = dbs
    with pytest.raises(SqlError, match="correlated subquery"):
        db.sql(query)


def test_the_mesh_and_out_of_core_tiers_refuse_subqueries(dbs):
    from tpu_qe_torch.exchange.mesh import LocalMesh
    db, _ = dbs
    q = "SELECT id FROM t WHERE k IN (SELECT k FROM r WHERE w < 5)"
    with pytest.raises(SqlError, match="mesh="):
        db.sql(q, mesh=LocalMesh(2, device="cpu"))
    vdb = Database("cpu")
    vdb.register("r", battery_tables()["r"])
    vdb.register_virtual("vt", 64, {"k": lambda i: i % 7})
    with pytest.raises(SqlError, match="out-of-core"):
        vdb.sql("SELECT k FROM vt WHERE k IN (SELECT k FROM r)")
    with pytest.raises(SqlError, match="out-of-core"):
        vdb.sql("SELECT k FROM r WHERE k IN (SELECT k FROM vt)")


# --- IN (SELECT ...) against sqlite ------------------------------------------

SUBQUERIES = {
    "u32_plain": "SELECT id, v FROM t WHERE k IN (SELECT k FROM r WHERE "
                 "w < 9) ORDER BY id",
    "u32_having": "SELECT id FROM t WHERE g IN (SELECT g FROM t GROUP BY g "
                  "HAVING SUM(v) > 0) AND v < 0 ORDER BY id",
    "duplicates": "SELECT k, COUNT(*) AS c FROM t WHERE k IN (SELECT k "
                  "FROM r) GROUP BY k ORDER BY k",
    "empty": "SELECT id FROM t WHERE k IN (SELECT k FROM r WHERE w > 1000) "
             "ORDER BY id",
    "i32": "SELECT id, v FROM t WHERE v IN (SELECT w FROM r WHERE rid < 200) "
           "ORDER BY id",
    "i32_having": "SELECT id FROM t WHERE v IN (SELECT v FROM t GROUP BY v "
                  "HAVING COUNT(*) > 2) ORDER BY id",
    "u32_against_i32": "SELECT id FROM t WHERE u IN (SELECT v FROM t WHERE "
                       "k = 3) ORDER BY id",
    "u32_against_counts": "SELECT id FROM t WHERE u IN (SELECT COUNT(*) FROM "
                          "t GROUP BY v) ORDER BY id",
    "f32": "SELECT id FROM t WHERE f IN (SELECT f FROM t WHERE id < 40) "
           "ORDER BY id",
    "u64": "SELECT u, k FROM x WHERE h IN (SELECT h FROM x WHERE v > 45) "
           "ORDER BY u",
    "u64_having": "SELECT u FROM x WHERE h IN (SELECT h FROM x GROUP BY h "
                  "HAVING COUNT(*) > 110) ORDER BY u",
    "nested_and_distinct": "SELECT id FROM t WHERE k IN (SELECT DISTINCT k "
                           "FROM r WHERE w IN (SELECT v FROM t WHERE g = 2)) "
                           "ORDER BY id",
    "comma_join_outer": "SELECT t.id, r.rid FROM t, r WHERE t.k = r.k AND "
                        "r.w IN (SELECT w FROM r GROUP BY w HAVING COUNT(*) "
                        "> 7) AND t.id < 300 ORDER BY t.id, r.rid",
    "limit_below_groups": "SELECT g, COUNT(*) AS c FROM t WHERE k IN (SELECT "
                          "k FROM r WHERE w < 50) GROUP BY g ORDER BY c DESC "
                          "LIMIT 2",
}


@pytest.mark.parametrize("name", sorted(SUBQUERIES))
def test_in_select_against_sqlite(dbs, name):
    db, con = dbs
    q = SUBQUERIES[name]
    got = db.sql(q)
    want = sqlite_rows(con, q)
    assert agrees(got, want, True) is None
    if name == "empty":
        assert len(got["id"]) == 0
    elif name != "u32_against_counts":
        assert len(next(iter(got.values()))) > 0


# --- the device group frame against the host frame ---------------------------

GROUPED = {
    "having_order": "SELECT k, SUM(v) AS s, AVG(u) AS a, COUNT(*) AS c FROM t "
                    "GROUP BY k HAVING COUNT(*) > 150 ORDER BY s DESC, k",
    "limit_offset": "SELECT k, g, SUM(u) AS s, MIN(v) AS lo, MAX(f) AS hi "
                    "FROM t GROUP BY k, g ORDER BY s DESC LIMIT 7 OFFSET 3",
    "case_div_mod": "SELECT g, CASE WHEN SUM(v) > 0 THEN SUM(v) ELSE 0 - "
                    "SUM(v) END AS m, SUM(u) / COUNT(*) AS q, SUM(u) % 7 AS r,"
                    " -AVG(f) AS na FROM t GROUP BY g HAVING NOT SUM(u) < 1000"
                    " ORDER BY m LIMIT 3",
    "sums_past_2_32": "SELECT k, SUM(u) AS su, SUM(v) AS sv, AVG(u) AS au, "
                      "SUM(u) - SUM(v) AS d FROM big GROUP BY k HAVING "
                      "SUM(u) > 4294967296 AND SUM(v) < -4294967296 "
                      "ORDER BY su DESC LIMIT 4",
    "mixed_signs": "SELECT k, SUM(u) AS s FROM t GROUP BY k HAVING SUM(u) > "
                   "-5 AND SUM(u) <> 12 OR k = 3 ORDER BY k LIMIT 4",
    "u64_key": "SELECT h, COUNT(*) AS c, SUM(v) AS s FROM x GROUP BY h "
               "HAVING COUNT(*) > 50 ORDER BY h DESC",
    "three_keys": "SELECT k, v, f, COUNT(*) AS c FROM t GROUP BY k, v, f "
                  "ORDER BY c DESC, v, f LIMIT 5",
    "distinct_median": "SELECT g, COUNT(DISTINCT k) AS d, MEDIAN(v) AS m "
                       "FROM t GROUP BY g HAVING COUNT(DISTINCT k) > 3 "
                       "ORDER BY m LIMIT 3",
    "order_by_bool": "SELECT k, SUM(v) > 0 AS pos, COUNT(*) AS c FROM t "
                     "GROUP BY k ORDER BY pos DESC, c LIMIT 4",
}
SQLITE_TOO = {"having_order", "limit_offset", "sums_past_2_32", "u64_key",
              "mixed_signs"}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_device_frame_equals_the_host_frame(dbs, name, monkeypatch):
    db, con = dbs
    q = GROUPED[name]
    got = db.sql(q)                    # HAVING or LIMIT < G: on the device
    with monkeypatch.context() as m:
        m.setattr(Database, "_partial", staticmethod(lambda *a: False))
        want = db.sql(q)               # the host frame, read whole
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c])
    assert len(want[next(iter(want))]) > 0
    if name in SQLITE_TOO:
        assert agrees(got, sqlite_rows(con, q), True) is None


def test_sums_past_2_32_stay_exact(dbs):
    db, _ = dbs
    big = _big_table()
    got = db.sql(GROUPED["sums_past_2_32"])
    for k, su, sv in zip(got["k"], got["su"], got["sv"]):
        m = big["k"] == k
        assert int(su) == int(big["u"][m].astype(np.int64).sum())
        assert int(sv) == int(big["v"][m].astype(np.int64).sum())
    assert got["su"].dtype == np.uint64 and got["sv"].dtype == np.int64


# --- TPC-H Q18 and Q3 at SF 0.002 -------------------------------------------

Q3 = ("SELECT l_orderkey, SUM(l_extendedprice * (100 - l_discount)) AS "
      "revenue, o_orderdate, o_shippriority FROM customer, orders, lineitem "
      "WHERE c_mktsegment = {segment} AND c_custkey = o_custkey AND "
      "l_orderkey = o_orderkey AND o_orderdate < {date} AND l_shipdate > "
      "{date} GROUP BY l_orderkey, o_orderdate, o_shippriority ORDER BY "
      "revenue DESC, o_orderdate LIMIT 10")


@pytest.fixture(scope="module")
def tpch_cust():
    from qe_bench.common import harness
    kind = harness.load_module(os.path.join(harness.BENCH, "kinds",
                                            "tpch_cust.py"))
    reference = harness.load_module(os.path.join(harness.BENCH, "reference",
                                                 "q18.py"))
    with open(os.path.join(harness.BENCH, "traffic", "q18.json")) as f:
        mix = json.load(f)
    data = kind.make_data({"scale_factor": 0.002}, 2 ** 31 + 9, "cpu")
    con = sqlite_connection({t: {c: v.numpy() for c, v in cols.items()}
                             for t, cols in data.items()})
    return kind, reference, mix, data, kind.setup(data, "cpu"), con


def test_tpch_cust_keeps_tpch_orders_and_lineitem():
    from qe_bench.common import harness
    load = harness.load_module
    tpch = load(os.path.join(harness.BENCH, "kinds", "tpch.py"))
    cust = load(os.path.join(harness.BENCH, "kinds", "tpch_cust.py"))
    a = tpch.make_data({"scale_factor": 0.002}, 77, "cpu")
    b = cust.make_data({"scale_factor": 0.002}, 77, "cpu")
    for t in a:
        for c in a[t]:
            assert np.array_equal(a[t][c].numpy(), b[t][c].numpy()), (t, c)
    c = b["customer"]
    assert len(c["c_custkey"]) == 300
    assert int(b["orders"]["o_custkey"].max()) <= 300
    assert set(c["c_mktsegment"].tolist()) <= set(range(5))


@pytest.mark.parametrize("quantity", [150, 250, 312])
def test_q18_against_the_reference_and_sqlite(tpch_cust, quantity):
    from qe_bench.common import compare
    kind, reference, mix, data, db, con = tpch_cust
    params = {"quantity": quantity}
    got = kind.answer_of(kind.serve(db, mix, params))
    want = reference.answer(data, params)
    assert compare.mismatches(got, want) == 0
    # sqlite names the unaliased SUM by its text; the program sum_5
    text = mix["sql"].format(**params).replace(
        "SUM(l_quantity) FROM", "SUM(l_quantity) AS sum_5 FROM")
    assert agrees(got, sqlite_rows(con, text), True) is None
    assert len(got["o_orderkey"]) == {150: 100, 250: 16, 312: 0}[quantity]
    if quantity == 150:         # the control: prices past 2^24 in float32
        lower = reference.answer(data, params, lower=True)
        assert compare.mismatches(lower, want) > 0


@pytest.mark.parametrize("segment,date", [(1, 9204), (3, 9190)])
def test_q3_against_sqlite(tpch_cust, segment, date):
    *_, db, con = tpch_cust
    q = Q3.format(segment=segment, date=date)
    got = db.sql(q)
    assert len(got["l_orderkey"]) == 10
    assert agrees(got, sqlite_rows(con, q), True) is None
