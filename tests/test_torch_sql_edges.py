"""The port's SQL executor at its edges, against the JAX package's
Database.sql on the same tables (device="cpu" for the port):

- empty inputs: a WHERE that keeps no row under GROUP BY and under a
  global aggregate (both packages give zero rows: SQL gives one row with
  COUNT 0 and SUM NULL, a gap both share, ROADMAP Queue C), set
  operations over empty sides, DISTINCT, windows and ORDER BY of empty
  tables;
- where the port follows SQL and the JAX package raises (each pinned on
  both sides): joins with an empty side, percentiles over zero rows;
- division: / 0, % 0, INT_MIN / -1, u32 values of 2^31 or more, mixed
  u32 / i32 operands; the mixed u32 / i32 compares; u64 literals;
- the SqlError messages of the error tests of tests/test_sql.py and of
  the executor's other rejections, equal to the reference's;
- `explain` text equal to the reference's for in-core queries;
- on the battery tables of tests/sql_battery.py, the six set
  operations and the families sqlite lacks (percentiles, float sums, u64
  DISTINCT), and tests/test_query_integration.py's join + GROUP BY as SQL
  (also against numpy);
- a shape the mesh= path does not take raising the reference's SqlError,
  virtual tables registering and colliding with in-core names as in the
  reference, and the Database's device.

Tolerance: exact (integers bit for bit; floats by value, NaNs in the same
places; the battery families bit for bit), but GROUP BY SUM and AVG of a
float column at tests/test_sql.py's `check` rule (rtol 1e-5, atol 1e-4):
they difference a float32 running sum, whose rounding follows the row
order inside a group, which the JAX package's unstable sort leaves open.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.sql import Database as JDatabase  # noqa: E402
from tpu_qe.sql import SqlError as JSqlError  # noqa: E402
import sql_battery as bsql  # noqa: E402
from tpu_qe_torch.sql import Database, SqlError, parse  # noqa: E402
from tpu_qe_torch.table import Table  # noqa: E402

INT_MIN = -(1 << 31)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables():
    rng = np.random.default_rng(0)
    n = 64
    t = {"k": rng.integers(0, 5, n).astype(np.uint32),
         "v": rng.integers(-50, 50, n).astype(np.int32),
         "d": rng.integers(-3, 3, n).astype(np.int32),
         "u": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
         "w": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
         "f": (rng.random(n) * 10 - 5).astype(np.float32),
         "id": np.arange(n, dtype=np.uint32)}
    t["v"][:6] = [INT_MIN, INT_MIN, (1 << 31) - 1, -1, 0, 7]
    t["d"][:6] = [-1, 0, -1, 0, 0, -2]
    t["u"][:4] = [0x80000000, 0xFFFFFFFF, 5, 0]
    t["w"][:4] = [0, 7, 0x80000001, 0xFFFFFFFF]
    e = {"k": np.zeros(0, np.uint32), "w": np.zeros(0, np.int32)}
    x = {"h": np.array([5, 5 | (1 << 32), (1 << 40) + 1, (1 << 63) + 9,
                        (1 << 64) - 1], np.uint64),
         "v": np.arange(5, dtype=np.int32)}
    return {"t": t, "e": e, "x": x}


TABLES = _tables()


def _register(db):
    for name, cols in TABLES.items():
        db.register(name, cols)
    return db


@functools.lru_cache(maxsize=None)
def _dbs():
    return _register(Database("cpu")), _register(JDatabase())


def _answer(db, q):
    try:
        return {k: np.asarray(v) for k, v in db.sql(q).items()}
    except (SqlError, JSqlError) as e:
        return ("SqlError", str(e))


def _same(got, want):
    if isinstance(want, tuple):
        assert got == want
        return
    assert list(got) == list(want)
    for nm in want:
        g, w = got[nm], want[nm]
        assert g.dtype == w.dtype and g.shape == w.shape, (nm, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=nm)


SAME_AS_JAX = [
    # a WHERE that keeps no row
    "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM t WHERE v > 2147483647 "
    "GROUP BY k",
    "SELECT k, v, f, COUNT(*) AS c, AVG(f) AS a, MIN(u) AS mn FROM t "
    "WHERE v > 2147483647 GROUP BY k, v, f",
    "SELECT COUNT(*) AS c, SUM(v) AS s, MAX(f) AS m FROM t "
    "WHERE v > 2147483647",
    "SELECT k, COUNT(DISTINCT u) AS d FROM t WHERE v > 2147483647 "
    "GROUP BY k",
    "SELECT id, v / 3 AS q FROM t WHERE v > 2147483647 ORDER BY id",
    # empty tables
    "SELECT k FROM e UNION SELECT k FROM e",
    "SELECT k FROM e INTERSECT SELECT k FROM e",
    "SELECT k FROM e EXCEPT SELECT k FROM e",
    "SELECT k FROM e UNION ALL SELECT k FROM e",
    "SELECT k FROM t EXCEPT SELECT k FROM e ORDER BY k",
    "SELECT k FROM e UNION SELECT k FROM t ORDER BY k",
    "SELECT DISTINCT k FROM e",
    "SELECT DISTINCT k, w FROM e",
    "SELECT * FROM e",
    "SELECT k, COUNT(*) AS c FROM e GROUP BY k",
    "SELECT k, ROW_NUMBER() OVER (PARTITION BY k ORDER BY w) AS rn, "
    "SUM(w) OVER (PARTITION BY k ORDER BY w) AS s FROM e",
    "SELECT k FROM e ORDER BY k DESC LIMIT 3",
    # division
    "SELECT id, v / 0 AS a, v % 0 AS b, v / -1 AS c, v % -1 AS e2, "
    "v / d AS q, v % d AS r, v / 7 AS q7, v % 7 AS r7, -v AS n "
    "FROM t ORDER BY id",
    "SELECT id, u / 3 AS a, u % 3 AS b, u / w AS c, u % w AS e2, "
    "u / 0 AS q0, u % 0 AS r0, u * w AS m, u + w AS s, u - w AS df "
    "FROM t ORDER BY id",
    "SELECT id, u / v AS q, u % v AS r, u + v AS s, u * v AS m, "
    "v - u AS df, u / 2147483648 AS q2 FROM t ORDER BY id",
    "SELECT id, f / 0.0 AS a, f % 0.0 AS b, f % 0.7 AS c, f / d AS q, "
    "f % d AS r, u / 2.0 AS h FROM t ORDER BY id",
    # mixed u32 / i32 compares
    "SELECT id, u > v AS a, u <= v AS b, v < u AS c, u = v AS d2, "
    "u <> v AS e2, u >= -5 AS f2, u < 2147483648 AS g, "
    "v > 3000000000 AS h, v < 3000000000 AS i, u > 2147483647 AS j "
    "FROM t ORDER BY id",
    "SELECT id FROM t WHERE u > v AND w >= u ORDER BY id",
    # u64 literals
    "SELECT v, h > 4294967296 AS a, h = 5 AS b, "
    "h <= 18446744073709551615 AS c, 1099511627781 < h AS d2, "
    "h >= 9223372036854775817 AS e2 FROM x ORDER BY v",
    "SELECT v FROM x WHERE h = 4294967301 OR h = 18446744073709551615 "
    "ORDER BY v",
    "SELECT h, COUNT(*) AS c FROM x WHERE h > 7 GROUP BY h ORDER BY h",
]


@pytest.mark.parametrize("query", SAME_AS_JAX)
def test_edges_match_jax(query):
    db, jdb = _dbs()
    _same(_answer(db, query), _answer(jdb, query))


def test_zero_row_answers_and_dtypes():
    db, _ = _dbs()
    out = db.sql("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM t "
                 "WHERE v > 2147483647 GROUP BY k")
    assert [(k, v.dtype, len(v)) for k, v in out.items()] == [
        ("k", np.uint32, 0), ("c", np.int64, 0), ("s", np.int64, 0)]
    # SQL would give one row (COUNT 0, SUM NULL); both packages give none
    out = db.sql("SELECT COUNT(*) AS c, SUM(v) AS s FROM t "
                 "WHERE v > 2147483647")
    assert {k: len(v) for k, v in out.items()} == {"c": 0, "s": 0}
    out = db.sql("SELECT k FROM e UNION SELECT k FROM e")
    assert out["k"].dtype == np.uint32 and len(out["k"]) == 0


@pytest.mark.parametrize("how", ["JOIN", "LEFT JOIN", "FULL JOIN"])
def test_joins_with_an_empty_side_follow_sql(how):
    # inner: no row; left: each left row once, right columns 0, __matched
    # 0; full: the non-empty side's rows. The JAX package raises.
    db, jdb = _dbs()
    t = TABLES["t"]
    q = f"SELECT t.v, t.id, e.w FROM t {how} e ON t.k = e.k"
    out = db.sql(q)
    n = 0 if how == "JOIN" else len(t["v"])
    assert [(k, v.dtype, len(v)) for k, v in out.items()] == [
        ("v", np.int32, n), ("id", np.uint32, n), ("w", np.int32, n)]
    np.testing.assert_array_equal(out["v"], t["v"][:n])
    assert not out["w"].any()
    if how != "JOIN":
        assert not db.sql(f"SELECT e__matched FROM t {how} e "
                          "ON t.k = e.k")["e__matched"].any()
    with pytest.raises(IndexError):
        jdb.sql(q)
    # the empty side on the left
    q = f"SELECT e.w, t.id FROM e {how} t ON e.k = t.k"
    out = db.sql(q)
    n = len(t["id"]) if how == "FULL JOIN" else 0
    np.testing.assert_array_equal(np.sort(out["id"]), t["id"][:n])
    assert len(out["w"]) == n and not out["w"].any()
    if how == "FULL JOIN":
        assert not db.sql(f"SELECT __left_matched FROM e {how} t "
                          "ON e.k = t.k")["__left_matched"].any()
    with pytest.raises(IndexError):
        jdb.sql(q)


def test_percentiles_over_zero_rows_follow_sql():
    # no row, no group: the port answers with empty columns; the JAX
    # package's group quantile asserts on the empty stream
    db, jdb = _dbs()
    q = ("SELECT k, MEDIAN(v) AS m, PERCENTILE_CONT(0.5) WITHIN GROUP "
         "(ORDER BY f) AS p FROM t WHERE v > 2147483647 GROUP BY k")
    out = db.sql(q)
    assert [(k, v.dtype, len(v)) for k, v in out.items()] == [
        ("k", np.uint32, 0), ("m", np.int32, 0), ("p", np.float32, 0)]
    with pytest.raises(AssertionError):
        jdb.sql(q)


def test_int_min_over_minus_one_and_zero_divisors():
    db, _ = _dbs()
    out = db.sql("SELECT id, v / d AS q, v % d AS r, v / 0 AS q0, "
                 "v % 0 AS r0, v / -1 AS q1, v % -1 AS r1 FROM t "
                 "ORDER BY id LIMIT 6")
    np.testing.assert_array_equal(out["q"][:2], [INT_MIN, INT_MIN])
    np.testing.assert_array_equal(out["r"][:2], [0, 0])
    np.testing.assert_array_equal(out["q0"][:4],
                                  [INT_MIN, INT_MIN, (1 << 31) - 1, -1])
    assert not out["r0"].any() and not out["r1"].any()
    np.testing.assert_array_equal(out["q1"][:4],
                                  [INT_MIN, INT_MIN, -(1 << 31) + 1, 1])


ERRORS = [
    ({}, "SELECT x FROM nope"),
    ({"t": {"a": np.zeros(4, np.uint32)}}, "SELECT b FROM t"),
    ({"a": {"k": np.arange(4, dtype=np.uint32),
            "v": np.arange(4, dtype=np.uint32)},
      "b": {"k": np.arange(4, dtype=np.uint32),
            "v": np.arange(4, dtype=np.uint32)}},
     "SELECT v FROM a JOIN b ON a.k = b.k"),
    ({"t": {"h": np.arange(4, dtype=np.uint64),
            "v": np.arange(4, dtype=np.uint32)}},
     "SELECT h + 1 AS x FROM t"),
    ({"t": {"h": np.arange(4, dtype=np.uint64)}},
     "SELECT h FROM t WHERE h > -1"),
    ({"t": {"h": np.arange(4, dtype=np.uint64)}},
     "SELECT h FROM t WHERE h > 2.5 + h"),
    ({"t": {"v": np.arange(8, dtype=np.uint32)}},
     "SELECT PERCENTILE_DISC(0.5) FROM t"),
    ({"t": {"v": np.arange(8, dtype=np.uint32)}},
     "SELECT SUM(0.5) WITHIN GROUP (ORDER BY v) FROM t"),
    ({"t": {"k": np.zeros(4, np.uint32), "v": np.arange(4, dtype=np.int32)}},
     "SELECT k, SUM(v + COUNT(*)) AS s FROM t GROUP BY k"),
    ({"t": {"g": np.zeros(4, np.uint32),
            "v": np.arange(4, dtype=np.uint32)}},
     "SELECT SUM(v) OVER (PARTITION BY g ROWS BETWEEN 2 PRECEDING AND "
     "CURRENT ROW) AS s FROM t"),
    ({"t": {"g": np.zeros(4, np.uint32),
            "o": np.arange(4, dtype=np.uint32)}},
     "SELECT RANK() OVER (PARTITION BY g ORDER BY o ROWS BETWEEN 2 "
     "PRECEDING AND CURRENT ROW) AS r FROM t"),
    ({"t": {"g": np.zeros(4, np.uint32),
            "id": np.arange(4, dtype=np.uint32)}},
     "SELECT ROW_NUMBER() OVER (PARTITION BY g ORDER BY id ROWS BETWEEN "
     "1 PRECEDING AND 2 FOLLOWING) AS r FROM t"),
    ({"t": {"g": np.zeros(4, np.uint32), "v": np.arange(4, dtype=np.uint32),
            "id": np.arange(4, dtype=np.uint32)}},
     "SELECT LAG(v, 0) OVER (PARTITION BY g ORDER BY id) AS l FROM t"),
    ({"t": {"g": np.zeros(4, np.uint32), "v": np.arange(4, dtype=np.uint32),
            "id": np.arange(4, dtype=np.uint32)}},
     "SELECT LAG(v, 1.5) OVER (PARTITION BY g ORDER BY id) AS l FROM t"),
    ({"t": {"g": np.zeros(4, np.uint32), "v": np.arange(4, dtype=np.uint32),
            "id": np.arange(4, dtype=np.uint32)}},
     "SELECT NTILE(v) OVER (PARTITION BY g ORDER BY id) AS l FROM t"),
    ({"t": {"g": np.zeros(4, np.uint32), "v": np.arange(4, dtype=np.uint32)}},
     "SELECT SUM(v) OVER (PARTITION BY g RANGE BETWEEN 2 PRECEDING AND "
     "CURRENT ROW) AS l FROM t"),
    ({"t": {"a": np.array([(1 << 60) + 1], np.uint64)},
      "r": {"b": np.array([1.5], np.float32)}},
     "SELECT a FROM t UNION ALL SELECT b FROM r"),
    ({"t": {"a": np.arange(4, dtype=np.uint32),
            "f": np.ones(4, np.float32)}},
     "SELECT a FROM t INTERSECT SELECT f FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a FROM t UNION SELECT a, a AS b FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a, a AS b FROM t EXCEPT SELECT a, a AS b FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT * FROM t GROUP BY a"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT SUM(DISTINCT a) AS s FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a, COUNT(*) AS c FROM t GROUP BY a HAVING b > 1"),
    ({"t": {"a": np.arange(4, dtype=np.uint32),
            "b": np.arange(4, dtype=np.uint32)}},
     "SELECT a, b FROM t GROUP BY a"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT NOT a AS x FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a FROM t WHERE a + 1"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a FROM t WHERE a = 'x'"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a FROM t ORDER BY zz"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT STDDEV(a) AS s FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT MEDIAN(a, a) AS m FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a FROM t WHERE a > 99999999999999999999999"),
    ({"t": {"h": np.arange(4, dtype=np.uint64)}},
     "SELECT MEDIAN(h) AS m FROM t"),
    ({"t": {"h": np.arange(4, dtype=np.uint64)}},
     "SELECT SUM(h) AS m FROM t"),
    ({"t": {"h": np.arange(4, dtype=np.uint64),
            "a": np.arange(4, dtype=np.uint32)}},
     "SELECT ROW_NUMBER() OVER (PARTITION BY a ORDER BY h) AS r FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT ROW_NUMBER() OVER (PARTITION BY a, a, a ORDER BY a) AS r "
     "FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT a + ROW_NUMBER() OVER (PARTITION BY a ORDER BY a) AS r "
     "FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}},
     "SELECT FOO(a) OVER (PARTITION BY a ORDER BY a) AS r FROM t"),
    ({"t": {"a": np.arange(4, dtype=np.uint32)}}, "SELECT FROM t"),
]


@pytest.mark.parametrize("tables,query", ERRORS,
                         ids=[q for _, q in ERRORS])
def test_errors_match_jax(tables, query):
    msgs = []
    for db, err in ((Database("cpu"), SqlError), (JDatabase(), JSqlError)):
        for name, cols in tables.items():
            db.register(name, cols)
        with pytest.raises(err) as e:
            db.sql(query)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_error_class_is_the_parsers():
    from tpu_qe_torch.sql import parser
    assert SqlError is parser.SqlError and issubclass(SqlError, ValueError)
    with pytest.raises(SqlError, match="expected"):
        parse("SELECT FROM t")


def test_explain_in_core_matches_jax():
    db, jdb = _dbs()
    for q in ("SELECT k, v, u % 2 AS m, COUNT(*) AS c FROM t WHERE v > 0 "
              "GROUP BY k, v, m ORDER BY k",
              "SELECT SUM(v) OVER (PARTITION BY k ORDER BY id) AS s FROM t",
              "SELECT t.id, w FROM t JOIN e ON t.k = e.k",
              "SELECT id FROM t",
              "SELECT id, v FROM t WHERE v > 0 ORDER BY v LIMIT 5 OFFSET 2",
              "SELECT DISTINCT k FROM t",
              "SELECT k, COUNT(*) AS c FROM t GROUP BY k HAVING COUNT(*) > 3 "
              "ORDER BY c DESC LIMIT 4",
              "SELECT k FROM t UNION SELECT k FROM e ORDER BY k",
              "SELECT COUNT(*) AS c FROM t",
              "SELECT DISTINCT k, MEDIAN(v) AS m FROM t LEFT JOIN e "
              "ON t.k = e.k WHERE v < 0 GROUP BY k ORDER BY k LIMIT 2"):
        assert db.explain(q) == jdb.explain(q), q
    p = db.explain("SELECT k, v, u % 2 AS m, COUNT(*) AS c FROM t WHERE "
                   "v > 0 GROUP BY k, v, m ORDER BY k")
    assert "in-core" in p and "dense group ids" in p


def test_what_is_not_ported_raises_with_its_item():
    # the distributed mesh= path is ported: a shape it does not take
    # raises the reference's own text (its `unsup`), no one-device
    # fallback; mesh= over a virtual table keeps its error
    from tpu_qe.exchange.dsort import make_mesh
    from tpu_qe_torch.exchange import LocalMesh
    cols = {"k": np.arange(8, dtype=np.uint32)}
    db, jdb = Database("cpu"), JDatabase()
    db.register("t", cols)
    jdb.register("t", cols)
    q = "SELECT DISTINCT k, COUNT(*) AS c FROM t GROUP BY k"
    with pytest.raises(SqlError, match="is not supported with mesh=") as got:
        db.sql(q, mesh=LocalMesh(2, "cpu"))
    with pytest.raises(JSqlError) as want:
        jdb.sql(q, mesh=make_mesh(2))
    assert str(got.value) == str(want.value)
    db.register_virtual("big", 1 << 10, {
        "k": lambda i: (i & 3).view(torch.uint32)})
    with pytest.raises(SqlError, match="mesh= with a virtual table"):
        db.sql("SELECT k, COUNT(*) AS c FROM big GROUP BY k",
               mesh=LocalMesh(2, "cpu"))


def test_register_virtual_runs_and_names_collide():
    # virtual tables are ported (sql/bigexec.py): registration succeeds,
    # a query runs, and names collide with the reference's messages
    # either way; mesh= over a virtual table raises the reference's own
    db = Database("cpu")
    db.register("t", {"k": np.arange(8, dtype=np.uint32)})
    db.register_virtual("big", 1 << 12, {
        "k": lambda i: (i & 3).view(torch.uint32)})
    out = db.sql("SELECT k, COUNT(*) AS c FROM big GROUP BY k ORDER BY k",
                 run_size=1 << 10)
    np.testing.assert_array_equal(out["k"], np.arange(4, dtype=np.uint32))
    np.testing.assert_array_equal(out["c"], [1 << 10] * 4)
    with pytest.raises(SqlError, match="'T' is already a registered table"):
        db.register_virtual("T", 16, {"k": lambda i: i})
    with pytest.raises(SqlError, match="'big' is already a virtual table"):
        db.register("big", {"k": np.arange(8, dtype=np.uint32)})
    jdb = JDatabase()
    jdb.register("t", {"k": np.arange(8, dtype=np.uint32)})
    with pytest.raises(JSqlError, match="'T' is already a registered table"):
        jdb.register_virtual("T", 16, {"k": lambda i: i})
    with pytest.raises(SqlError, match="mesh= with a virtual table"):
        db.sql("SELECT k, COUNT(*) AS c FROM big GROUP BY k", mesh=object())


def test_database_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Database()
    db = Database("cpu")
    assert db.device == torch.device("cpu")
    t = Table.from_numpy({"k": np.arange(4, dtype=np.uint32)}, device="cpu")
    db.register("t", t)
    np.testing.assert_array_equal(db.sql("SELECT k FROM t ORDER BY k")["k"],
                                  np.arange(4, dtype=np.uint32))
    other = Table.from_numpy({"k": np.arange(4, dtype=np.uint32)},
                             device="meta")
    with pytest.raises(SqlError, match="lies on meta"):
        db.register("m", other)


@functools.lru_cache(maxsize=None)
def _battery_dbs():
    dbs = Database("cpu"), JDatabase()
    for db in dbs:
        for name, cols in bsql.battery_tables().items():
            db.register(name, cols)
    return dbs


# family -> (query, rows ordered by the query)
BATTERY_PARITY = {fam: bsql.FAMILIES[fam][::2] for fam in (
    "union", "union_all", "intersect", "except")}
BATTERY_PARITY.update({
    "intersect_all": ("SELECT g FROM t WHERE v > 0 INTERSECT ALL "
                      "SELECT k FROM r", False),
    "except_all": ("SELECT g FROM t WHERE v > 0 EXCEPT ALL "
                   "SELECT k FROM r", False),
    "percentiles": (bsql.PERCENTILE_FAMILY, True),
    "float_sum": ("SELECT k, SUM(f) AS s, AVG(f) AS a FROM t GROUP BY k "
                  "ORDER BY k", True),
    "distinct_u64": ("SELECT DISTINCT h FROM x WHERE v > 0", False),
})


@pytest.mark.parametrize("family", sorted(BATTERY_PARITY))
def test_battery_families_match_jax(family):
    query, ordered = BATTERY_PARITY[family]
    db, jdb = _battery_dbs()
    got = db.sql(query)
    want = {k: np.asarray(v) for k, v in jdb.sql(query).items()}
    assert list(got) == list(want)
    assert len(next(iter(want.values()))) > 0
    if not ordered:
        got, want = bsql.canon(got), bsql.canon(want)
    for nm in want:
        g, w = got[nm], want[nm]
        assert g.dtype == w.dtype and g.shape == w.shape, (nm, g.dtype,
                                                           w.dtype)
        if family == "float_sum":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=nm)
        else:
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=nm)


def test_tpch_flavored_join_group_matches_numpy_and_jax():
    # tests/test_query_integration.py's query (u64 order keys, the FK side
    # unique), written in SQL
    rng = np.random.default_rng(99)
    n_orders, n_items = 1 << 10, 1 << 13
    order_keys = np.unique(
        rng.integers(0, 1 << 48, 2 * n_orders, dtype=np.uint64))[:n_orders]
    regions = rng.integers(0, 5, n_orders, dtype=np.uint32)
    item_order = order_keys[rng.integers(0, n_orders, n_items)]
    quantity = rng.integers(0, 100, n_items, dtype=np.uint32)
    amount = rng.integers(1, 10_000, n_items, dtype=np.uint32)
    query = ("SELECT o.region, COUNT(*) AS c, SUM(l.amount) AS s, "
             "MAX(l.amount) AS mx FROM lineitem l JOIN orders o "
             "ON l.key = o.key WHERE quantity < 42 GROUP BY o.region "
             "ORDER BY o.region")
    outs = []
    for db in (Database("cpu"), JDatabase()):
        db.register("orders", {"key": order_keys, "region": regions})
        db.register("lineitem", {"key": item_order, "quantity": quantity,
                                 "amount": amount})
        outs.append({k: np.asarray(v) for k, v in db.sql(query).items()})
    got, want = outs
    assert list(got) == list(want) == ["region", "c", "s", "mx"]
    for nm in want:
        assert got[nm].dtype == want[nm].dtype
        np.testing.assert_array_equal(got[nm], want[nm])
    sel = quantity < 42
    reg = regions[np.searchsorted(order_keys, item_order[sel])]
    np.testing.assert_array_equal(got["region"], np.unique(reg))
    np.testing.assert_array_equal(got["c"], np.bincount(reg)[np.unique(reg)])
    np.testing.assert_array_equal(
        got["s"], np.bincount(reg, weights=amount[sel])[np.unique(reg)])
    for i, r in enumerate(got["region"]):
        assert got["mx"][i] == amount[sel][reg == r].max()
