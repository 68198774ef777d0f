"""The port's SQL executor (tpu_qe_torch.sql.Database, device="cpu")
against sqlite3 and against the JAX package's Database.sql.

- sqlite3: every query that tests/test_sql.py hands to its `check` rule
  (read from that file's syntax tree), on its data (`_mk_data`, n = 2000
  and m = 500), by that rule (integers exact, floats at rtol 1e-5 / atol
  1e-4 unless the case says otherwise); the battery of
  tests/sql_battery.py; the three fuzz seeds of `test_sql_fuzz`.
- tpu_qe.sql: one query per family of sql_battery.FAMILIES (the set
  operations and the families sqlite lacks are in
  test_torch_sql_edges.py): the same column names and dtypes, every
  column bit for bit (float expression and window columns included),
  join rows as multisets unless an ORDER BY fixes them. One JAX answer
  per query (lru_cache).
- the other tests of tests/test_sql.py that build their own Database,
  with their numpy oracles.

Torch runs on one thread here (several test processes share the cores).
"""

import ast
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_sql import TEMPLATES, _disc_oracle, _mk_data, check  # noqa: E402
from tpu_qe.sql import Database as JDatabase  # noqa: E402
import sql_battery as bsql  # noqa: E402
from tpu_qe_torch.sql import Database  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = bsql.battery_tables()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(db):
    for name, cols in TABLES.items():
        db.register(name, cols)
    return db


@pytest.fixture(scope="module")
def engines():
    return _register(Database("cpu")), bsql.sqlite_connection(TABLES)


@functools.lru_cache(maxsize=None)
def _jax_db():
    return _register(JDatabase())


@functools.lru_cache(maxsize=None)
def _jax(query):
    return {k: np.asarray(v) for k, v in _jax_db().sql(query).items()}


def _check_calls():
    """(test name, query, sqlite query or None, keyword args) of every
    check(...) call with literal queries in tests/test_sql.py."""
    with open(os.path.join(REPO, "tests", "test_sql.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "check"):
                continue
            strs = [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str)]
            if not strs:
                continue        # the fuzz: templates, run below
            kw = {k.arg: k.value.value for k in node.keywords
                  if isinstance(k.value, ast.Constant)}
            out.append((fn.name, strs[0], strs[1] if len(strs) > 1
                        else None, kw))
    return out


CHECKS = _check_calls()


def test_data_and_rule_are_the_reference_tests():
    t, r = _mk_data()
    for name, cols in (("t", t), ("r", r)):
        assert sorted(cols) == sorted(TABLES[name])
        for c in cols:
            assert cols[c].dtype == TABLES[name][c].dtype
            np.testing.assert_array_equal(cols[c], TABLES[name][c])
    assert len(CHECKS) >= 60


@pytest.mark.parametrize("case", CHECKS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CHECKS)])
def test_reference_check_queries_match_sqlite(engines, case):
    _, query, sqlite_query, kw = case
    check(*engines, query, sqlite_query, **kw)


@pytest.mark.parametrize("family", sorted(bsql.FAMILIES))
def test_battery_matches_sqlite(engines, family):
    db, con = engines
    query, sqlite_query, ordered = bsql.FAMILIES[family]
    got = db.sql(query)
    bad = bsql.agrees(got, bsql.sqlite_rows(con, sqlite_query or query),
                      ordered)
    assert bad is None, (family, bad)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_templates_match_sqlite(seed):
    rng = np.random.default_rng(seed)
    t, r = _mk_data(seed=seed + 100, n=1500, m=300)
    db = Database("cpu")
    db.register("t", t)
    db.register("r", r)
    con = bsql.sqlite_connection({"t": t, "r": r})
    for tmpl, oracle_tmpl in TEMPLATES:
        p = int(rng.integers(2, 9))
        q = int(rng.integers(-50, 400))
        rr = q + int(rng.integers(10, 500))
        check(db, con, tmpl.format(p=p, q=q, r=rr),
              (oracle_tmpl or tmpl).format(p=p, q=q, r=rr), ordered=True)


# -- the JAX package's answer ------------------------------------------------

# one query per family; the set operations, the families sqlite lacks,
# the arithmetic rules, the u64 compares and the division edges are held
# to the JAX answer in test_torch_sql_edges.py
PARITY_FAMILIES = (
    "projection_where", "group_1col", "group_2col", "group_3col",
    "count_distinct_u32", "count_distinct_u64", "inner_join", "left_join",
    "full_join", "distinct", "window_rank_lag", "window_sums",
    "order_limit_device", "order_limit_host")


@pytest.mark.parametrize("family", PARITY_FAMILIES)
def test_family_matches_jax(engines, family):
    query, _, ordered = bsql.FAMILIES[family]
    got, want = engines[0].sql(query), _jax(query)
    assert list(got) == list(want)
    assert len(next(iter(want.values()))) > 0
    if not ordered:
        got, want = bsql.canon(got), bsql.canon(want)
    for nm in want:
        g, w = got[nm], want[nm]
        assert g.dtype == w.dtype and g.shape == w.shape, (nm, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=nm)


# -- the other tests of tests/test_sql.py, on the port ----------------------

def test_signed_sums_and_full_outer_counts(engines):
    db, con = engines
    got = db.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    want = bsql.sqlite_rows(con, "SELECT k, SUM(v) AS s FROM t GROUP BY k "
                                 "ORDER BY k")
    assert (want["s"] < 0).any()
    np.testing.assert_array_equal(got["s"].astype(np.int64), want["s"])
    got = db.sql("SELECT id, rid, r__matched, __left_matched "
                 "FROM t FULL JOIN r ON t.k = r.k")
    want = bsql.sqlite_rows(
        con, "SELECT id, rid, (rid IS NOT NULL) AS m, (id IS NOT NULL) "
             "AS lm FROM t FULL OUTER JOIN r ON t.k = r.k")
    assert len(got["id"]) == len(want["id"])
    assert int(got["r__matched"].sum()) == int(want["m"].sum())
    assert int(got["__left_matched"].sum()) == int(want["lm"].sum())


def test_set_op_multisets_and_positional_union_all():
    db = Database("cpu")
    db.register("a", {"x": np.array([1, 1, 1, 2, 3], np.uint32)})
    db.register("b", {"x": np.array([1, 3, 3], np.uint32)})
    out = db.sql("SELECT x FROM a EXCEPT ALL SELECT x FROM b")
    assert sorted(out["x"].tolist()) == [1, 1, 2]
    out = db.sql("SELECT x FROM a INTERSECT ALL SELECT x FROM b")
    assert sorted(out["x"].tolist()) == [1, 3]
    db.register("t", {"a": np.array([1], np.uint32),
                      "b": np.array([2], np.uint32)})
    db.register("r", {"c": np.array([3], np.uint32),
                      "a2": np.array([4], np.uint32)})
    out = db.sql("SELECT a, b FROM t UNION ALL SELECT c, a2 FROM r "
                 "ORDER BY a")
    np.testing.assert_array_equal(out["a"], [1, 3])
    np.testing.assert_array_equal(out["b"], [2, 4])
    db.register("u", {"a": np.array([(1 << 60) + 1], np.uint64)})
    db.register("w", {"b": np.array([(1 << 61) + 3], np.uint64)})
    out = db.sql("SELECT a FROM u UNION ALL SELECT b FROM w ORDER BY a")
    np.testing.assert_array_equal(
        out["a"], np.array([(1 << 60) + 1, (1 << 61) + 3], np.uint64))


def test_percentiles_match_numpy():
    rng = np.random.default_rng(3)
    v = rng.integers(-500, 500, 1001).astype(np.int32)
    db = Database("cpu")
    db.register("t", {"v": v})
    out = db.sql("SELECT MEDIAN(v) AS m, PERCENTILE_DISC(0.25) WITHIN "
                 "GROUP (ORDER BY v) AS p25 FROM t")
    assert out["m"][0] == _disc_oracle(v, 0.5)
    assert out["p25"][0] == _disc_oracle(v, 0.25)
    rng = np.random.default_rng(4)
    k = rng.integers(0, 7, 3000).astype(np.uint32)
    u = rng.integers(0, 10000, 3000).astype(np.uint32)
    db.register("g", {"k": k, "v": u})
    out = db.sql("SELECT k, PERCENTILE_DISC(0.9) WITHIN GROUP "
                 "(ORDER BY v) AS p90, COUNT(*) AS c, PERCENTILE_CONT(0.75) "
                 "WITHIN GROUP (ORDER BY v) AS p FROM g GROUP BY k "
                 "ORDER BY k")
    for i, kk in enumerate(out["k"]):
        grp = u[k == kk]
        assert out["p90"][i] == _disc_oracle(grp, 0.9)
        assert out["c"][i] == len(grp)
        np.testing.assert_allclose(out["p"][i], np.percentile(
            grp, 75, method="linear"), rtol=1e-5)
    kk = np.repeat(np.arange(4, dtype=np.uint32), 5)
    db.register("h", {"k": kk, "v": np.arange(20, dtype=np.int32)})
    out = db.sql("SELECT k FROM h GROUP BY k HAVING MEDIAN(v) > 7 "
                 "ORDER BY k")
    np.testing.assert_array_equal(out["k"], [2, 3])
    out = db.sql("SELECT k, MEDIAN(v * 2) AS m FROM h GROUP BY k "
                 "ORDER BY k")
    np.testing.assert_array_equal(out["m"], [4, 14, 24, 34])
    rng = np.random.default_rng(6)
    k = rng.integers(0, 3, 999).astype(np.uint32)
    v = rng.integers(-50, 50, 999).astype(np.int32)
    db.register("s", {"k": k, "v": v})
    out = db.sql("SELECT k, SUM(v) AS s, MEDIAN(v) AS m FROM s "
                 "WHERE v <> 0 GROUP BY k ORDER BY k")
    for i, kk in enumerate(out["k"]):
        grp = v[(v != 0) & (k == kk)]
        assert out["s"][i] == grp.sum()
        assert out["m"][i] == _disc_oracle(grp, 0.5)


@pytest.mark.parametrize("seed", range(3))
def test_percentile_fuzz_matches_numpy(seed):
    from tpu_qe_torch.ops.quantile import canon_qs, disc_rank
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(500, 3000))
    k = rng.integers(0, rng.integers(2, 9), n).astype(np.uint32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    db = Database("cpu")
    db.register("t", {"k": k, "v": v})
    q = round(float(rng.uniform(0.05, 0.95)), 3)
    out = db.sql(f"SELECT k, PERCENTILE_DISC({q}) WITHIN GROUP "
                 f"(ORDER BY v) AS p, PERCENTILE_CONT({q}) WITHIN "
                 f"GROUP (ORDER BY v) AS pc FROM t GROUP BY k ORDER BY k")
    (num, sh) = canon_qs([q])[0]
    for i, kk in enumerate(out["k"]):
        grp = np.sort(v[k == kk])
        assert out["p"][i] == grp[disc_rank(num, sh, len(grp))], (kk, q)
        t = num * (len(grp) - 1)
        fl, frac = t >> sh, (t - ((t >> sh) << sh)) / (1 << sh)
        want = grp[fl] + (grp[min(fl + 1, len(grp) - 1)] - grp[fl]) * frac
        np.testing.assert_allclose(out["pc"][i], want, rtol=1e-5,
                                   atol=1e-3)


def test_order_limit_paths(engines):
    db, _ = engines
    np.testing.assert_array_equal(db.sql("SELECT id FROM t LIMIT 5")["id"],
                                  np.arange(5))
    assert len(db.sql("SELECT k FROM t GROUP BY k ORDER BY k LIMIT 5 "
                      "OFFSET 100")["k"]) == 0
    d2 = Database("cpu")
    d2.register("t", {"v": np.array([3, 1, 2, 4], np.int32)})
    out = d2.sql("SELECT v, v > 2 AS big FROM t ORDER BY big, v")
    np.testing.assert_array_equal(out["v"], [1, 2, 3, 4])
    assert out["big"].dtype == bool
    np.testing.assert_array_equal(out["big"], [False, False, True, True])
    v = np.array([5, -3, 10, -20, 1, 2], np.int32)
    d2.register("w", {"k": np.zeros(6, np.uint32), "v": v,
                      "o": np.arange(6, dtype=np.uint32)})
    out = d2.sql("SELECT o, SUM(v) OVER (PARTITION BY k ORDER BY o) AS s "
                 "FROM w ORDER BY s LIMIT 3")
    assert out["s"].dtype == np.int64
    np.testing.assert_array_equal(out["s"], np.sort(np.cumsum(v))[:3])
    d2.register("c", {"current": np.arange(4, dtype=np.uint32),
                      "rows": np.arange(4, dtype=np.uint32),
                      "within": np.arange(4, dtype=np.uint32)})
    out = d2.sql("SELECT current, rows, within FROM c "
                 "ORDER BY current DESC LIMIT 2")
    np.testing.assert_array_equal(out["current"], [3, 2])
    np.testing.assert_array_equal(out["rows"], [3, 2])


def test_u64_group_compare_and_count_distinct():
    db = Database("cpu")
    h = np.array([5, 5, (1 << 40) + 1, (1 << 40) + 1, 7], np.uint64)
    db.register("t", {"h": h, "v": np.arange(1, 6, dtype=np.uint32)})
    out = db.sql("SELECT h, COUNT(*) AS c, SUM(v) AS s FROM t GROUP BY h "
                 "ORDER BY h")
    np.testing.assert_array_equal(out["h"], np.array(
        [5, 7, (1 << 40) + 1], np.uint64))
    np.testing.assert_array_equal(out["c"], [2, 1, 2])
    np.testing.assert_array_equal(out["s"], [3, 5, 7])
    out = db.sql(f"SELECT v FROM t WHERE h > {1 << 39} ORDER BY v")
    np.testing.assert_array_equal(out["v"], [3, 4])
    db.register("d", {"k": np.zeros(4, np.uint32),
                      "h": np.array([5, 5 | (1 << 32), 5, 7], np.uint64)})
    out = db.sql("SELECT k, COUNT(DISTINCT h) AS d FROM d GROUP BY k")
    assert len(out["k"]) == 1 and int(out["d"][0]) == 3
    rng = np.random.default_rng(7)
    n = 512
    h = (rng.integers(0, 6, n).astype(np.uint64) << np.uint64(40)
         | rng.integers(0, 3, n).astype(np.uint64))
    k = rng.integers(0, 4, n).astype(np.uint32)
    v = rng.integers(0, 100, n).astype(np.uint32)
    db.register("m", {"h": h, "k": k, "v": v})
    out = db.sql("SELECT h, k, COUNT(*) AS c, SUM(v) AS s FROM m "
                 "GROUP BY h, k ORDER BY h, k")
    packed = [(int(a), int(b)) for a, b in zip(h, k)]
    keys = sorted(set(packed))
    assert [(int(a), int(b)) for a, b in zip(out["h"], out["k"])] == keys
    for i, kk in enumerate(keys):
        mask = np.array([p == kk for p in packed])
        assert int(out["c"][i]) == int(mask.sum())
        assert int(out["s"][i]) == int(v[mask].sum())


def test_review_regressions():
    db = Database("cpu")
    db.register("t", {"u": np.array([3000000000, 5], np.uint32),
                      "s": np.array([-2, 10], np.int32)})
    np.testing.assert_array_equal(
        db.sql("SELECT u FROM t WHERE u > 5")["u"], [3000000000])
    np.testing.assert_array_equal(
        db.sql("SELECT u FROM t WHERE u > -1 ORDER BY u")["u"],
        [5, 3000000000])
    np.testing.assert_array_equal(
        db.sql("SELECT u FROM t WHERE u > s ORDER BY u")["u"], [3000000000])
    db.register("s", {"g": np.array([0, 0, 1], np.uint32),
                      "x": np.array([8, 9, 4], np.uint32)})
    out = db.sql("SELECT g AS gg, SUM(x) AS g FROM s GROUP BY g "
                 "ORDER BY gg")
    np.testing.assert_array_equal(out["gg"], [0, 1])
    np.testing.assert_array_equal(out["g"], [17, 4])
    db.register("p", {"g": np.zeros(4, np.uint32),
                      "x": np.array([5, 3, 9, 4], np.uint32)})
    np.testing.assert_array_equal(
        db.sql("SELECT MIN(x) OVER (PARTITION BY g) AS m FROM p")["m"],
        [3, 3, 3, 3])
    db.register("a", {"id": np.arange(3, dtype=np.uint32),
                      "v": np.arange(3, dtype=np.uint32) * 10})
    db.register("b", {"id": np.arange(3, dtype=np.uint32),
                      "w": np.arange(3, dtype=np.uint32) * 100})
    out = db.sql("SELECT * FROM a JOIN b ON id = id ORDER BY v")
    assert sorted(out) == ["a.id", "b.id", "v", "w"]
    np.testing.assert_array_equal(out["a.id"], [0, 1, 2])
    np.testing.assert_array_equal(out["b.id"], [0, 1, 2])
    db.register("l", {"k": np.arange(4, dtype=np.uint32),
                      "v": np.arange(4, dtype=np.uint32)})
    db.register("e", {"k": np.arange(0, 8, 2, dtype=np.uint32),
                      "w": np.arange(4, dtype=np.uint32)})
    x = db.sql("SELECT v, w FROM l JOIN e ON l.k = e.k ORDER BY v")
    y = db.sql("SELECT v, w FROM l JOIN e ON e.k = l.k ORDER BY v")
    np.testing.assert_array_equal(x["v"], y["v"])
    np.testing.assert_array_equal(x["w"], y["w"])
    np.testing.assert_array_equal(x["v"], [0, 2])

