"""Implicit joins (`FROM a, b, c WHERE a.x = b.y AND ...`): the parser's
comma FROM, the join planner (tpu_qe_torch/sql/planner.py) and the
executor's answers, against sqlite3 and against the same query written
with JOIN ... ON; SSB Q4.1 at a tiny scale through the benchmark's `ssb`
kind against its plain reference."""

import json
import os

import numpy as np
import pytest

from sql_battery import agrees, battery_tables, sqlite_connection, sqlite_rows
from tpu_qe_torch.sql import parser as P
from tpu_qe_torch.sql.executor import Database
from tpu_qe_torch.sql.parser import SqlError
from tpu_qe_torch.sql.planner import conjuncts, plan_select


def _tables():
    """The battery's `t` (2000 rows) and `r` (500), and `s`, 5 rows keyed
    by t.g."""
    tabs = battery_tables()
    tabs = {"t": tabs["t"], "r": tabs["r"]}
    tabs["s"] = {"sg": np.arange(5, dtype=np.uint32),
                 "z": np.array([3, 9, 1, 7, 4], dtype=np.int32)}
    return tabs


@pytest.fixture(scope="module")
def dbs():
    tabs = _tables()
    db = Database("cpu")
    for name, cols in tabs.items():
        db.register(name, cols)
    return db, sqlite_connection(tabs)


# (comma form, the same query with JOIN ... ON, rows ordered)
QUERIES = {
    "two_tables": (
        "SELECT t.id, r.rid, t.v, r.w FROM t, r WHERE t.k = r.k "
        "ORDER BY t.id, r.rid",
        "SELECT t.id, r.rid, t.v, r.w FROM t JOIN r ON t.k = r.k "
        "ORDER BY t.id, r.rid", True),
    "three_tables_group": (
        "SELECT sg, COUNT(*) AS c, SUM(w) AS s FROM s, r, t "
        "WHERE t.k = r.k AND v > 0 AND t.g = sg GROUP BY sg ORDER BY sg",
        "SELECT sg, COUNT(*) AS c, SUM(w) AS s FROM t JOIN s ON t.g = sg "
        "JOIN r ON t.k = r.k WHERE v > 0 GROUP BY sg ORDER BY sg", True),
    "aliases_residual": (
        "SELECT a.id, b.rid, c.z FROM t AS a, r b, s c WHERE a.k = b.k "
        "AND c.sg = a.g AND c.z > 3 AND b.w < 50 ORDER BY a.id, b.rid",
        "SELECT a.id, b.rid, c.z FROM t AS a JOIN s c ON a.g = c.sg "
        "JOIN r b ON a.k = b.k WHERE c.z > 3 AND b.w < 50 "
        "ORDER BY a.id, b.rid", True),
    "second_edge_is_a_filter": (
        "SELECT t.id, r.rid FROM t, r WHERE t.k = r.k AND t.g = r.k "
        "ORDER BY t.id, r.rid",
        "SELECT t.id, r.rid FROM t JOIN r ON t.k = r.k WHERE t.g = r.k "
        "ORDER BY t.id, r.rid", True),
    "select_star": (
        "SELECT * FROM s, t WHERE sg = g AND id < 300",
        "SELECT * FROM s JOIN t ON sg = g WHERE id < 300", False),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_comma_form_against_sqlite_and_join_on(dbs, name):
    db, con = dbs
    comma, explicit, ordered = QUERIES[name]
    got = db.sql(comma)
    assert agrees(got, sqlite_rows(con, comma), ordered) is None
    want = db.sql(explicit)
    assert list(got) == list(want)
    if not ordered:     # rows in the join order the plan picked
        order = np.lexsort([got[c] for c in reversed(list(got))])
        worder = np.lexsort([want[c] for c in reversed(list(want))])
        got = {c: v[order] for c, v in got.items()}
        want = {c: v[worder] for c, v in want.items()}
    for c in want:
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])
    assert len(next(iter(got.values()))) > 0


def test_select_star_lists_the_columns_of_join_on(dbs):
    db, _ = dbs
    # the plan starts from t, the larger, whichever is written first
    assert list(db.sql("SELECT * FROM s, t WHERE sg = g AND id < 3")) \
        == list(db.sql("SELECT * FROM s JOIN t ON sg = g WHERE id < 3")) \
        == list(db.sql("SELECT * FROM t, s WHERE g = sg AND id < 3")) \
        == ["f", "g", "id", "k", "sg", "u", "v", "z"]


def _star():
    """A fact table and four dimensions: (tables for plan_select, FROM)."""
    tables = {"fact": (1000, ["fa", "fb", "fc", "fd", "m"]),
              "da": (50, ["ka", "xa"]), "db": (5, ["kb", "xb"]),
              "dc": (20, ["kc", "xc"]), "dd": (20, ["kd", "xd"])}
    return tables, "da, dd, db, dc, fact"


def _plan(sql, tables):
    (sel,) = P.parse(sql).selects
    return plan_select(sel, tables)


def test_star_order_largest_then_fewest_connected():
    tables, frm = _star()
    sel, plan = _plan(
        f"SELECT m FROM {frm} WHERE fa = ka AND xa > 2 AND fb = kb "
        "AND kc = fc AND fd = kd", tables)
    # fact first; then db (5 rows); dd and dc tie at 20: FROM order; da
    assert plan.order == ("fact", "db", "dd", "dc", "da")
    assert plan.start_rows == 1000 and plan.joins == 4
    assert sel.table.name == "fact"
    assert [(j.how, j.left_col.name, j.right_col.name) for j in sel.joins] \
        == [("inner", "fb", "kb"), ("inner", "fd", "kd"),
            ("inner", "fc", "kc"), ("inner", "fa", "ka")]
    assert conjuncts(sel.where) == [P.Binary(">", P.Col("xa"), P.Lit(2))]
    # the joins carry the columns the query names
    assert plan.keep == {"da": {"ka", "xa"}, "dd": {"kd"}, "db": {"kb"},
                         "dc": {"kc"}, "fact": {"fa", "fb", "fc", "fd", "m"}}


def test_keep_reads_every_clause_and_star_keeps_all():
    tables = {"a": (10, ["k", "p", "w", "o", "unused"]),
              "b": (3, ["k2", "h", "g", "q", "part", "spare"])}
    q = P.parse("SELECT a.p, SUM(q) OVER (PARTITION BY part ORDER BY w) "
                "AS s FROM a, b WHERE k = k2 AND h > 0 GROUP BY g "
                "HAVING MAX(b.q) > 1 ORDER BY o")
    (sel,) = q.selects
    _, plan = plan_select(sel, tables, q.order_by)
    assert plan.keep == {"a": {"k", "p", "w", "o"},
                         "b": {"k2", "h", "g", "q", "part"}}
    _, plan = _plan("SELECT * FROM a, b WHERE k = k2", tables)
    assert plan.keep is None


def test_snowflake_joins_a_table_only_once_it_is_connected():
    tables = {"f": (100, ["fk"]), "d": (10, ["dk", "sk"]),
              "sub": (2, ["sk2", "y"])}
    sel, plan = _plan("SELECT y FROM sub, d, f WHERE sk = sk2 AND fk = dk",
                      tables)
    assert plan.order == ("f", "d", "sub") and sel.where is None
    assert (sel.joins[1].left_col, sel.joins[1].right_col) == (
        P.Col("sk"), P.Col("sk2"))


def test_residual_keeps_order_and_unused_edges():
    tables = {"a": (10, ["x", "y", "p"]), "b": (3, ["x2", "y2", "q"])}
    sel, plan = _plan(
        "SELECT p FROM a, b WHERE p > 1 AND a.y = b.y2 AND q < 5 "
        "AND x = x2 AND (p = 2 OR q = 3)", tables)
    (join,) = sel.joins
    assert (join.left_col, join.right_col) == (P.Col("y", "a"),
                                               P.Col("y2", "b"))
    assert [type(t).__name__ for t in conjuncts(sel.where)] == [
        "Binary"] * 4
    assert [t.op for t in conjuncts(sel.where)] == [">", "<", "=", "or"]
    assert conjuncts(sel.where)[2] == P.Binary("=", P.Col("x"),
                                               P.Col("x2"))
    assert plan.joins == 1


def test_ambiguous_or_unknown_columns_are_no_edges():
    tables = {"a": (10, ["k", "p"]), "b": (3, ["k", "q"]),
              "c": (2, ["r"])}
    with pytest.raises(SqlError, match="no join condition connects b"):
        _plan("SELECT p FROM a, b WHERE k = k", tables)
    with pytest.raises(SqlError, match="no join condition connects c"):
        _plan("SELECT p FROM a, b, c WHERE a.k = b.k AND r = nope",
              tables)


def test_errors(dbs):
    db, _ = dbs
    with pytest.raises(SqlError, match="no join condition connects s"):
        db.sql("SELECT id FROM t, s, r WHERE t.k = r.k")
    with pytest.raises(SqlError, match="no join condition connects r"):
        db.sql("SELECT id FROM r, t")
    for q in ("SELECT id FROM t, s JOIN r ON t.k = r.k WHERE g = sg",
              "SELECT id FROM t JOIN r ON t.k = r.k, s WHERE g = sg"):
        with pytest.raises(SqlError, match="comma-separated tables with "
                                           "JOIN ... ON"):
            db.sql(q)
    with pytest.raises(SqlError, match="appears twice"):
        db.sql("SELECT id FROM t, t WHERE k = k")


def test_explain_prints_the_planned_order(dbs):
    db, _ = dbs
    text = db.explain("SELECT sg, SUM(w) AS s FROM s, r, t WHERE "
                      "t.k = r.k AND t.g = sg GROUP BY sg")
    assert "join order: t -> s -> r" in text
    assert "join order" not in db.explain(
        "SELECT sg FROM t JOIN s ON g = sg")


def test_a_set_operation_plans_each_side(dbs):
    db, con = dbs
    q = ("SELECT t.id FROM t, s WHERE g = sg AND z > 5 UNION "
         "SELECT r.rid FROM r, t WHERE t.k = r.k AND t.id < 40 ORDER BY id")
    assert agrees(db.sql(q), sqlite_rows(con, q), True) is None


def test_plan_and_join_spans(dbs):
    from tpu_qe_torch.utils import profiling
    db, _ = dbs
    with profiling.tracing():
        got = db.sql("SELECT sg, COUNT(*) AS c FROM s, r, t WHERE "
                     "t.k = r.k AND t.g = sg GROUP BY sg")
    (rec,) = profiling.records()
    spans = {}
    for sp in rec["spans"]:
        spans.setdefault(sp["name"], []).append(sp)
    (plan,) = spans["sql.plan"]
    assert rec["spans"][plan["parent"]]["name"] == "sql.query"
    assert plan["counts"] == {"joins": 2, "start_rows": 2000}
    t_then_s, then_r = (sp["counts"] for sp in spans["ops.join"])
    assert t_then_s == {"rows_left": 2000, "rows_right": 5,
                        "rows_out": 2000, "passthrough": 1}
    assert then_r["rows_left"] == 2000 and then_r["rows_right"] == 500
    assert then_r["rows_out"] == int(got["c"].sum())
    assert then_r["passthrough"] == 0       # r's keys repeat


def test_star_join_passes_the_fact_columns_through_unchanged(dbs):
    # t.g matches one s row each: the join passes t's columns through
    from tpu_qe_torch.utils import profiling
    db, con = dbs
    before = {(nm, c): db._tables[nm][c].clone()
              for nm in ("t", "s") for c in db._tables[nm].column_names}
    q = ("SELECT t.id, t.v, z FROM t, s WHERE t.g = sg AND z > 3 "
         "ORDER BY t.id")
    with profiling.tracing():
        got = db.sql(q)
    (rec,) = profiling.records()
    (join,) = [sp for sp in rec["spans"] if sp["name"] == "ops.join"]
    assert join["counts"]["passthrough"] == 1
    assert agrees(got, sqlite_rows(con, q), True) is None
    want = db.sql("SELECT t.id, t.v, z FROM t JOIN s ON t.g = sg "
                  "WHERE z > 3 ORDER BY t.id")
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    for (nm, c), col in before.items():
        assert np.array_equal(db._tables[nm][c].numpy(), col.numpy()), c


# SSB Q4.1 through the benchmark's kind at a tiny scale
SSB_POINTS = [{"c_region": 1, "s_region": 1, "mfgr": [0, 1]},
              {"c_region": 0, "s_region": 4, "mfgr": [2, 4]},
              {"c_region": 3, "s_region": 2, "mfgr": [1, 3]}]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 2 ** 33 + 1])
def test_ssb_q41_against_the_plain_reference(seed):
    from qe_bench.common import compare, harness
    bench = os.path.join(harness.BENCH)
    kind = harness.load_module(os.path.join(bench, "kinds", "ssb.py"))
    reference = harness.load_module(os.path.join(bench, "reference",
                                                 "ssb-q4.1.py"))
    with open(os.path.join(bench, "traffic", "ssb-q4.1.json")) as f:
        mix = json.load(f)
    data = kind.make_data({"scale_factor": 0.02}, seed, "cpu")
    db = kind.setup(data, "cpu")
    for params in SSB_POINTS:
        want = reference.answer(data, params)
        assert len(want["profit"]) > 0
        got = kind.answer_of(kind.serve(db, mix, params))
        assert compare.mismatches(got, want) == 0
