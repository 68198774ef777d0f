"""The SQL tier's query battery: one query for each family of the port's
SQL executor at the size of the JAX package's SQL tests (tests/test_sql.py:
2000 rows of `t`, 500 of `r`, the same generator), with sqlite3 as the
oracle (`sqlite_rows`, `agrees`: integers exact, floats at rtol 1e-5 /
atol 1e-4, the JAX tests' rule).

The CPU parity tests import it as `sql_battery`; chip_smoke.py loads it
from this file to run the same battery on the card.
"""

from __future__ import annotations

import sqlite3

import numpy as np


def battery_tables(seed: int = 0, n: int = 2000, m: int = 500) -> dict:
    """`t` and `r` as the JAX package's SQL tests make them
    (tests/test_sql.py::_mk_data), and `x`, a u64 table (values below 2^63,
    which sqlite stores exactly) for the u64 families."""
    rng = np.random.default_rng(seed)
    t = {
        "k": rng.integers(0, 12, n).astype(np.uint32),
        "g": rng.integers(0, 5, n).astype(np.uint32),
        "v": rng.integers(-1000, 1000, n).astype(np.int32),
        "u": rng.integers(0, 1000, n).astype(np.uint32),
        "f": (rng.random(n).astype(np.float32) * 10 - 5),
        "id": np.arange(n, dtype=np.uint32),
    }
    r = {
        "k": rng.integers(0, 16, m).astype(np.uint32),
        "w": rng.integers(0, 100, m).astype(np.int32),
        "rid": np.arange(m, dtype=np.uint32),
    }
    rng = np.random.default_rng(seed + 1)
    h = (rng.integers(0, 6, n).astype(np.uint64) << np.uint64(40)
         | rng.integers(0, 3, n).astype(np.uint64))
    h[::7] |= np.uint64(5)        # values that share their low word
    x = {"h": h, "k": rng.integers(0, 4, n).astype(np.uint32),
         "u": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
         "v": rng.integers(-50, 50, n).astype(np.int32)}
    return {"t": t, "r": r, "x": x}


# family -> (query, sqlite's form of it or None, rows ordered by the query)
FAMILIES = {
    "projection_where": (
        "SELECT id, v + 2 * u AS a, v - u AS b FROM t WHERE k < 4 "
        "ORDER BY id", None, True),
    "case_between_in": (
        "SELECT id, CASE WHEN v < 0 THEN 0 - v WHEN v < 100 THEN v "
        "ELSE 100 END AS c FROM t WHERE v BETWEEN -10 AND 25 "
        "AND k IN (1, 2, 9) ORDER BY id", None, True),
    "i32_div_mod": (
        "SELECT id, v / 7 AS q, v % 7 AS r, v / (k - 3) AS q0, "
        "v % (k - 3) AS r0 FROM t ORDER BY id",
        "SELECT id, v / 7 AS q, v % 7 AS r, CASE WHEN k = 3 THEN v "
        "ELSE v / (k - 3) END AS q0, CASE WHEN k = 3 THEN 0 "
        "ELSE v % (k - 3) END AS r0 FROM t ORDER BY id", True),
    "u32_arith": (
        "SELECT id, u / 7 AS q, u % 7 AS r, u * 3 + 1 AS m, u / k AS d "
        "FROM t WHERE u > 500 ORDER BY id",
        "SELECT id, u / 7 AS q, u % 7 AS r, u * 3 + 1 AS m, CASE WHEN "
        "k = 0 THEN u ELSE u / k END AS d FROM t WHERE u > 500 "
        "ORDER BY id", True),
    "mixed_u32_i32_compare": (
        "SELECT id FROM t WHERE u > v AND u <= v + 600 ORDER BY id",
        None, True),
    "f32_arith": (
        "SELECT id, f * 2.0 + 1.0 AS x, f / 3.0 AS y, -f AS z FROM t "
        "WHERE f > 0.5 ORDER BY id", None, True),
    "group_1col": (
        "SELECT k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx, "
        "AVG(u) AS a FROM t GROUP BY k HAVING COUNT(*) > 150 ORDER BY k",
        None, True),
    "group_2col": (
        "SELECT k, g, COUNT(*) AS c, SUM(u) AS s, MAX(f) AS mf FROM t "
        "GROUP BY k, g ORDER BY k, g", None, True),
    "group_3col": (
        "SELECT k, g, u % 3 AS m, COUNT(*) AS c, SUM(u) AS s, "
        "MIN(v) AS mn FROM t GROUP BY k, g, m ORDER BY k, g, m", None, True),
    "group_expr_args": (
        "SELECT g, SUM(v * 2) AS s, SUM(CASE WHEN v > 0 THEN v ELSE 0 END) "
        "AS p, MAX(v % 13) AS mx FROM t GROUP BY g ORDER BY g", None, True),
    "count_distinct_u32": (
        "SELECT k, COUNT(DISTINCT g) AS d, COUNT(DISTINCT v % 7) AS dv "
        "FROM t GROUP BY k ORDER BY k", None, True),
    "count_distinct_u64": (
        "SELECT k, COUNT(DISTINCT h) AS d, COUNT(*) AS c FROM x "
        "GROUP BY k ORDER BY k", None, True),
    "u64_group_compare": (
        "SELECT h, COUNT(*) AS c, SUM(u) AS s FROM x "
        f"WHERE h > {1 << 40} GROUP BY h ORDER BY h", None, True),
    "inner_join": (
        "SELECT t.id, r.rid, t.v, r.w FROM t JOIN r ON t.k = r.k "
        "ORDER BY t.id, r.rid", None, True),
    "left_join": (
        "SELECT id, w, r__matched FROM t LEFT JOIN r ON t.k = r.k",
        "SELECT id, COALESCE(w, 0) AS w, (w IS NOT NULL) AS r__matched "
        "FROM t LEFT JOIN r ON t.k = r.k", False),
    "full_join": (
        "SELECT id, rid, r__matched, __left_matched FROM t "
        "FULL JOIN r ON t.k = r.k",
        "SELECT COALESCE(id, 0) AS id, COALESCE(rid, 0) AS rid, "
        "(rid IS NOT NULL) AS r__matched, (id IS NOT NULL) AS "
        "__left_matched FROM t FULL OUTER JOIN r ON t.k = r.k", False),
    "join_group": (
        "SELECT g, COUNT(*) AS c, SUM(w) AS s FROM t JOIN r "
        "ON t.k = r.k WHERE v > 0 GROUP BY g ORDER BY g", None, True),
    "distinct": (
        "SELECT DISTINCT k, g FROM t ORDER BY k, g", None, True),
    "union": ("SELECT k FROM t UNION SELECT k FROM r ORDER BY k",
              None, True),
    "union_all": (
        "SELECT v FROM t WHERE k = 1 UNION ALL SELECT w FROM r "
        "WHERE k = 1 ORDER BY v",
        "SELECT v FROM t WHERE k = 1 UNION ALL SELECT w AS v FROM r "
        "WHERE k = 1 ORDER BY v", True),
    "intersect": ("SELECT v FROM t INTERSECT SELECT w FROM r ORDER BY v",
                  None, True),
    "except": ("SELECT v FROM t EXCEPT SELECT w FROM r ORDER BY v",
               None, True),
    "window_rank_lag": (
        "SELECT id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY id) AS rn, "
        "DENSE_RANK() OVER (PARTITION BY k ORDER BY g) AS dr, "
        "LAG(v, 2, -7) OVER (PARTITION BY k ORDER BY id) AS l "
        "FROM t ORDER BY id", None, True),
    "window_sums": (
        "SELECT id, SUM(v) OVER (PARTITION BY g ORDER BY id) AS s, "
        "SUM(u) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN 3 PRECEDING "
        "AND CURRENT ROW) AS ms, AVG(f) OVER (PARTITION BY g) AS a "
        "FROM t ORDER BY id LIMIT 400",
        "SELECT id, SUM(v) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN "
        "UNBOUNDED PRECEDING AND CURRENT ROW) AS s, SUM(u) OVER "
        "(PARTITION BY g ORDER BY id ROWS BETWEEN 3 PRECEDING AND "
        "CURRENT ROW) AS ms, AVG(f) OVER (PARTITION BY g) AS a FROM t "
        "ORDER BY id LIMIT 400", True),
    "window_range": (
        "SELECT id, SUM(v) OVER (PARTITION BY g ORDER BY u RANGE BETWEEN "
        "100 PRECEDING AND CURRENT ROW) AS rx, MIN(v) OVER (PARTITION BY "
        "g ORDER BY k RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) "
        "AS rm FROM t ORDER BY id LIMIT 300", None, True),
    "order_limit_device": (
        "SELECT id, v, f FROM t WHERE v > 0 ORDER BY v DESC, id "
        "LIMIT 17 OFFSET 5", None, True),
    "order_limit_host": (
        "SELECT k, COUNT(*) AS c FROM t GROUP BY k ORDER BY c DESC, k "
        "LIMIT 5 OFFSET 2", None, True),
}
# percentiles: sqlite has none (numpy oracles in the tests)
PERCENTILE_FAMILY = (
    "SELECT k, PERCENTILE_DISC(0.9) WITHIN GROUP (ORDER BY v) AS p90, "
    "PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY v) AS pc, MEDIAN(u) AS md "
    "FROM t GROUP BY k ORDER BY k")


def battery(device) -> dict:
    """Every family's answer (and the percentile family's) on `device`:
    {family: {column: numpy array}}."""
    from tpu_qe_torch.sql import Database
    db = Database(device)
    for name, cols in battery_tables().items():
        db.register(name, cols)
    queries = {fam: q for fam, (q, _, _) in FAMILIES.items()}
    queries["percentiles"] = PERCENTILE_FAMILY
    return {fam: db.sql(q) for fam, q in queries.items()}


def differs(got: dict, want: dict, rtol: float = 1e-5,
            atol: float = 1e-4) -> str | None:
    """None when two answers of the port have the same columns, dtypes
    and rows in the same order, integers bit for bit and floats within
    rtol / atol (a float32 running sum rounds by the device's scan
    order), else what differs."""
    if list(got) != list(want):
        return f"columns {list(got)} != {list(want)}"
    for nm, w in want.items():
        g = got[nm]
        if g.dtype != w.dtype or g.shape != w.shape:
            return f"{nm}: {g.dtype}{g.shape} != {w.dtype}{w.shape}"
        if g.dtype.kind == "f":
            if not np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
                return f"{nm}: floats differ"
        elif not np.array_equal(g, w):
            return f"{nm}: values differ"
    return None


def sqlite_connection(tables: dict) -> sqlite3.Connection:
    """An in-memory sqlite3 database holding `tables` (numpy columns)."""
    con = sqlite3.connect(":memory:")
    for name, cols in tables.items():
        names = sorted(cols)
        con.execute(f"CREATE TABLE {name} ({', '.join(names)})")
        rows = zip(*[cols[c].astype(np.float64).tolist()
                     if cols[c].dtype.kind == "f"
                     else cols[c].astype(np.int64).tolist() for c in names])
        con.executemany(
            f"INSERT INTO {name} VALUES ({','.join('?' * len(names))})",
            rows)
    return con


def sqlite_rows(con: sqlite3.Connection, query: str) -> dict:
    cur = con.execute(query)
    names = [d[0] for d in cur.description]
    rows = cur.fetchall()
    return {nm: np.array([row[i] for row in rows])
            for i, nm in enumerate(names)}


def canon(cols: dict) -> dict:
    """Rows in one canonical order: a stable lexsort over every column
    (floats rounded to 1e-4, so rounding cannot reorder them)."""
    names = sorted(cols)
    n = len(cols[names[0]]) if names else 0
    keys = [np.round(np.asarray(cols[nm]).astype(np.float64), 4)
            if np.asarray(cols[nm]).dtype.kind == "f"
            else np.asarray(cols[nm]) for nm in reversed(names)]
    perm = np.lexsort(keys) if keys and n else np.arange(n)
    return {nm: np.asarray(cols[nm])[perm] for nm in names}


def agrees(got: dict, want: dict, ordered: bool, rtol: float = 1e-5,
           atol: float = 1e-4) -> str | None:
    """None when `got` matches sqlite's `want` by the JAX tests' rule
    (integers exact, floats within rtol / atol), else what differs."""
    if sorted(got) != sorted(want):
        return f"columns {sorted(got)} != {sorted(want)}"
    if not ordered:
        got, want = canon(got), canon(want)
    for nm in want:
        g, w = np.asarray(got[nm]), want[nm]
        if len(g) != len(w):
            return f"{nm}: {len(g)} rows, sqlite {len(w)}"
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            if not np.allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=rtol, atol=atol):
                return f"{nm}: floats differ"
        elif not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
            return f"{nm}: integers differ"
    return None
