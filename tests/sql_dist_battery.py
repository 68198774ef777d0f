"""The query families of tests/test_sql_distributed.py as data, for the
port's `Database.sql(q, mesh=)` tests and chip_smoke.py's phase 20.

`tables(seed, n, m)` makes the reference test's two tables (its `_db`,
the same draws in the same order, so a seed gives the same data) as numpy
column dicts: t of n rows (k in [0, 12), v, sv signed, f float, id, g2,
h64 a u64 column with shared low bits) and r of m UNIQUE even keys with a
value w. `FAMILIES` holds one query for each comparing test of that file
(name -> Family); `OWN_TABLES` the tests that register tables of their
own; `ERRORS` the queries that must raise, with the text they raise with.
`case(name, d)` gives one of them at mesh size d; `compare` is the
reference's `_cmp` (rows canonicalised by the full row
tuple unless the family is fully ordered; integers bit for bit, floats at
the family's rtol and atol 1e-3).

This module imports no JAX (chip_smoke.py loads it on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def tables(seed: int = 0, n: int = 2048, m: int = 1024) -> dict:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, n).astype(np.uint32)
    v = rng.integers(0, 1000, n).astype(np.uint32)
    t = {
        "k": k,
        "v": v,
        "sv": rng.integers(-500, 500, n).astype(np.int32),
        "f": rng.random(n).astype(np.float32),
        "id": np.arange(n, dtype=np.uint32),
        "g2": (np.arange(n, dtype=np.uint32) % 7),
        "h64": ((v % 5).astype(np.uint64) << np.uint64(33))
        | (k % 3).astype(np.uint64),
    }
    r = {
        "k": (rng.permutation(m).astype(np.uint32) * 2),
        "w": rng.integers(0, 100, m).astype(np.uint32),
    }
    return {"t": t, "r": r}


class Family(NamedTuple):
    """One query of the reference file: its seed (`seed + d` when
    per_device, as the reference's `_db(n_dev + c)`), the SQL, the rtol of
    its float columns and whether its rows are fully ordered (compared in
    place)."""
    seed: int
    sql: str
    rtol: float = 1e-5
    ordered: bool = False
    per_device: bool = False
    window: bool = False          # windows and ORDER BY (the second file)

    def seed_for(self, d: int) -> int:
        return self.seed + d if self.per_device else self.seed


_RANGE = "RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW"

FAMILIES = {
    "group_by_aggregates": Family(
        0, "SELECT k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(v) AS mx, AVG(v) AS a FROM t GROUP BY k ORDER BY k",
        per_device=True),
    "count_distinct": Family(
        10, "SELECT k, COUNT(DISTINCT sv) AS d FROM t GROUP BY k "
            "ORDER BY k", per_device=True),
    "float_aggregate": Family(
        20, "SELECT k, SUM(f) AS s, MAX(f) AS mx FROM t GROUP BY k "
            "ORDER BY k", rtol=1e-4, per_device=True),
    "fused_join_group_by": Family(
        30, "SELECT t.k, COUNT(*) AS c, SUM(w) AS s FROM t "
            "JOIN r ON t.k = r.k GROUP BY t.k ORDER BY t.k",
        per_device=True),
    "set_op_union": Family(
        60, "SELECT v FROM t UNION SELECT w AS v FROM r ORDER BY v"),
    "set_op_intersect": Family(
        60, "SELECT v FROM t INTERSECT SELECT w AS v FROM r ORDER BY v"),
    "set_op_except": Family(
        60, "SELECT v FROM t EXCEPT SELECT w AS v FROM r ORDER BY v"),
    "percentiles": Family(
        7, "SELECT k, MEDIAN(v) AS m, PERCENTILE_DISC(0.9) WITHIN "
           "GROUP (ORDER BY v) AS p90, COUNT(*) AS c FROM t "
           "GROUP BY k ORDER BY k"),
    "percentile_cont": Family(
        8, "SELECT k, PERCENTILE_CONT(0.75) WITHIN GROUP "
           "(ORDER BY v) AS p FROM t GROUP BY k ORDER BY k"),
    "where_group_by": Family(
        9, "SELECT k, COUNT(*) AS c, SUM(v) AS s, MEDIAN(v) AS m "
           "FROM t WHERE v % 3 = 1 AND k < 9 GROUP BY k ORDER BY k"),
    "where_count_distinct": Family(
        10, "SELECT k, COUNT(DISTINCT v) AS d FROM t WHERE v > 100 "
            "GROUP BY k ORDER BY k"),
    "where_empty_result": Family(
        11, "SELECT k, COUNT(*) AS c FROM t WHERE v > 100000 "
            "GROUP BY k"),
    "having": Family(
        14, "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM t GROUP BY k "
            "HAVING COUNT(*) > 150 AND MIN(v) < 100 ORDER BY k"),
    "having_with_where_and_median": Family(
        15, "SELECT k, MEDIAN(v) AS m FROM t WHERE v % 2 = 0 GROUP BY k "
            "HAVING MEDIAN(v) > 400 ORDER BY k"),
    "group_by_three_columns": Family(
        90, "SELECT k, g2, sv % 3 = 0 AS e, COUNT(*) AS c, SUM(v) AS s "
            "FROM t GROUP BY k, g2, e ORDER BY k, g2, e"),
    "group_by_two_columns_where": Family(
        91, "SELECT k, g2, COUNT(*) AS c, MAX(v) AS mx FROM t "
            "WHERE v > 200 GROUP BY k, g2 ORDER BY k, g2"),
    "select_distinct": Family(92, "SELECT DISTINCT k FROM t ORDER BY k"),
    "select_distinct_two_columns_where": Family(
        93, "SELECT DISTINCT k, g2 FROM t WHERE v > 600 "
            "ORDER BY k, g2"),
    "count_distinct_u64": Family(
        94, "SELECT k, COUNT(DISTINCT h64) AS d FROM t GROUP BY k "
            "ORDER BY k"),
    "where_with_join_left": Family(
        95, "SELECT t.k, COUNT(*) AS c, SUM(w) AS s FROM t "
            "JOIN r ON t.k = r.k WHERE v > 300 GROUP BY t.k "
            "ORDER BY t.k"),
    "where_with_join_right_side": Family(
        96, "SELECT t.k, COUNT(*) AS c, SUM(w) AS s FROM t "
            "JOIN r ON t.k = r.k WHERE w < 50 GROUP BY t.k "
            "ORDER BY t.k"),
    "set_op_union_all": Family(
        27, "SELECT k FROM t UNION ALL SELECT k FROM r"),
    "set_op_intersect_all": Family(
        27, "SELECT k FROM t INTERSECT ALL SELECT k FROM r"),
    "set_op_except_all": Family(
        27, "SELECT k FROM t EXCEPT ALL SELECT k FROM r"),
    # windows and ORDER BY
    "window": Family(
        40, "SELECT id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY id) "
            "AS rn, SUM(v) OVER (PARTITION BY k ORDER BY id) AS s "
            "FROM t ORDER BY id", per_device=True, window=True),
    "order_by_limit": Family(
        50, "SELECT id, sv, k FROM t ORDER BY sv DESC, k, id LIMIT 64",
        ordered=True, per_device=True, window=True),
    "window_rows_frame": Family(
        13, "SELECT id, SUM(v) OVER (PARTITION BY k ORDER BY id ROWS "
            "BETWEEN 4 PRECEDING AND CURRENT ROW) AS ms, "
            "AVG(v) OVER (PARTITION BY k ORDER BY id ROWS "
            "BETWEEN 4 PRECEDING AND CURRENT ROW) AS ma FROM t",
        window=True),
    "where_order_by": Family(
        16, "SELECT id, v, f FROM t WHERE v % 3 = 1 "
            "ORDER BY v DESC, f, id", ordered=True, window=True),
    "where_order_by_float_key_desc": Family(
        17, "SELECT id, f FROM t WHERE f > 0.5 ORDER BY f DESC, id",
        ordered=True, window=True),
    "where_window": Family(
        19, "SELECT id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY id) "
            "AS rn, SUM(v) OVER (PARTITION BY k ORDER BY id) AS s "
            "FROM t WHERE v % 2 = 0", window=True),
    "where_window_rows_frame": Family(
        21, "SELECT id, SUM(v) OVER (PARTITION BY k ORDER BY id ROWS "
            "BETWEEN 3 PRECEDING AND CURRENT ROW) AS ms FROM t "
            "WHERE v % 3 <> 2", window=True),
    "lag_lead_offset_k": Family(
        22, "SELECT id, LAG(v, 3, 777) OVER (PARTITION BY k ORDER BY "
            "id) AS l3, LEAD(v, 2, 888) OVER (PARTITION BY k ORDER BY "
            "id) AS d2 FROM t ORDER BY id", window=True),
    "whole_partition_frames": Family(
        23, "SELECT id, SUM(v) OVER (PARTITION BY k) AS ts, "
            "SUM(sv) OVER (PARTITION BY k) AS tsi, "
            "MIN(sv) OVER (PARTITION BY k) AS tmn, "
            "MAX(f) OVER (PARTITION BY k) AS tmx, "
            "COUNT(v) OVER (PARTITION BY k) AS pc, "
            "AVG(v) OVER (PARTITION BY k) AS ta FROM t ORDER BY id",
        rtol=2e-4, window=True),
    "running_avg_and_signed_sums": Family(
        24, "SELECT id, AVG(v) OVER (PARTITION BY k ORDER BY id) AS ra, "
            "SUM(sv) OVER (PARTITION BY k ORDER BY id) AS rs "
            "FROM t WHERE v > 100 ORDER BY id", rtol=2e-4, window=True),
    "whole_partition_rides_ordered_spec": Family(
        25, "SELECT id, SUM(v) OVER (PARTITION BY k) AS ts, "
            "SUM(v) OVER (PARTITION BY k ORDER BY id) AS rs "
            "FROM t ORDER BY id", window=True),
    "order_by_limit_offset": Family(
        26, "SELECT id, v FROM t ORDER BY v DESC, id LIMIT 16 OFFSET 8",
        ordered=True, window=True),
    "range_unbounded_frames": Family(
        25, f"SELECT id, SUM(v) OVER (PARTITION BY k ORDER BY g2 {_RANGE}) "
            f"AS rs, SUM(sv) OVER (PARTITION BY k ORDER BY g2 {_RANGE}) "
            f"AS ri, MIN(sv) OVER (PARTITION BY k ORDER BY g2 {_RANGE}) "
            f"AS rm, MAX(f) OVER (PARTITION BY k ORDER BY g2 {_RANGE}) "
            f"AS rx, AVG(v) OVER (PARTITION BY k ORDER BY g2 {_RANGE}) "
            "AS ra FROM t ORDER BY id", rtol=2e-4, window=True),
    "count_frames": Family(
        29, "SELECT id, COUNT(*) OVER (PARTITION BY k ORDER BY id ROWS "
            "BETWEEN 4 PRECEDING AND CURRENT ROW) AS c1, "
            "COUNT(v) OVER (PARTITION BY k ORDER BY id ROWS BETWEEN "
            "2 PRECEDING AND 3 FOLLOWING) AS c2, "
            "COUNT(*) OVER (PARTITION BY k ORDER BY id ROWS BETWEEN "
            "UNBOUNDED PRECEDING AND 2 FOLLOWING) AS c3 "
            "FROM t ORDER BY id", window=True),
}


def _own_non_dividing():
    rng = np.random.default_rng(12)
    return {"t": {"k": rng.integers(0, 9, 2049).astype(np.uint32),
                  "v": rng.integers(0, 99, 2049).astype(np.uint32)}}


def _own_order_by_non_dividing():
    rng = np.random.default_rng(18)
    return {"t": {"v": rng.integers(0, 50, 1027).astype(np.uint32),
                  "id": np.arange(1027, dtype=np.uint32)}}


def _own_window_non_dividing():
    rng = np.random.default_rng(20)
    return {"t": {"k": rng.integers(0, 5, 1027).astype(np.uint32),
                  "o": np.arange(1027, dtype=np.uint32),
                  "v": rng.integers(0, 9, 1027).astype(np.uint32)}}


def _own_u64_reserved_filtered():
    return {"t": {"k": np.array([1, 1, (1 << 64) - 1, 2], np.uint64),
                  "v": np.array([10, 20, 30, 40], np.uint32)}}


# name -> (tables(), sql, fully ordered, window family)
OWN_TABLES = {
    "non_dividing_rows": (
        _own_non_dividing,
        "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k ORDER BY k",
        False, False),
    "order_by_non_dividing_rows": (
        _own_order_by_non_dividing, "SELECT id, v FROM t ORDER BY v, id",
        True, True),
    "window_non_dividing_rows": (
        _own_window_non_dividing,
        "SELECT o, RANK() OVER (PARTITION BY k ORDER BY o) AS r FROM t",
        False, True),
    "u64_reserved_key_filtered_out_by_where_ok": (
        _own_u64_reserved_filtered,
        "SELECT k, COUNT(*) AS c FROM t WHERE v < 30 GROUP BY k ORDER BY k",
        True, False),
}


def _own_duplicate_right_keys():
    rng = np.random.default_rng(3)
    return {"t": {"k": rng.integers(0, 8, 256).astype(np.uint32)},
            "r": {"k": rng.integers(0, 8, 128).astype(np.uint32),
                  "w": rng.integers(0, 9, 128).astype(np.uint32)}}


def _own_u64_reserved():
    return {"t": {"k": np.array([1, 1, (1 << 64) - 1, (1 << 64) - 1],
                                np.uint64),
                  "v": np.arange(4, dtype=np.uint32)}}


# name -> (tables(), sql, a piece of the SqlError's text); every query
# raises at D = 2
ERRORS = {
    "join_where_mixes_sides": (
        lambda: tables(70),
        "SELECT t.k, COUNT(*) AS c, SUM(w) AS s FROM t "
        "JOIN r ON t.k = r.k WHERE v > 3 AND w < 50 GROUP BY t.k",
        "one side"),
    "int32_sum_with_negatives": (
        lambda: tables(70), "SELECT k, SUM(sv) AS s FROM t GROUP BY k",
        "int32 with negatives"),
    "join_having": (
        lambda: tables(70),
        "SELECT t.k, COUNT(*) AS c FROM t JOIN r ON t.k = r.k "
        "GROUP BY t.k HAVING COUNT(*) > 2", "HAVING"),
    "join_duplicate_right_keys": (
        _own_duplicate_right_keys,
        "SELECT t.k, COUNT(*) AS c, SUM(w) AS s FROM t "
        "JOIN r ON t.k = r.k GROUP BY t.k", "unique right join keys"),
    "u64_reserved_max_group_key": (
        _own_u64_reserved, "SELECT k, COUNT(*) AS c FROM t GROUP BY k",
        "reserved"),
    "range_bounded": (
        lambda: tables(26),
        "SELECT SUM(v) OVER (PARTITION BY k ORDER BY g2 RANGE "
        "BETWEEN 5 PRECEDING AND CURRENT ROW) AS rs FROM t", "in-core only"),
    "set_op_dtype_mismatch": (
        lambda: tables(28), "SELECT k FROM t UNION ALL SELECT f FROM t",
        "dtypes differ"),
    "distinct_with_aggregates": (
        lambda: tables(70), "SELECT DISTINCT k, COUNT(*) AS c FROM t "
                            "GROUP BY k", "is not supported with mesh="),
    "left_join": (
        lambda: tables(70),
        "SELECT t.k, COUNT(*) AS c FROM t LEFT JOIN r ON t.k = r.k "
        "GROUP BY t.k", "exactly one INNER JOIN"),
    "plain_select_without_order_by": (
        lambda: tables(70), "SELECT id, v FROM t", "needs ORDER BY"),
    "u64_sum": (lambda: tables(70), "SELECT k, SUM(h64) AS s FROM t "
                                    "GROUP BY k", "u64 columns"),
}


def case(name: str, d: int):
    """(tables, sql, rtol, ordered) of a family at mesh size d, or of an
    own-table test."""
    if name in FAMILIES:
        f = FAMILIES[name]
        return tables(f.seed_for(d)), f.sql, f.rtol, f.ordered
    make, sql, ordered, _ = OWN_TABLES[name]
    return make(), sql, 1e-5, ordered


def compare(local: dict, dist: dict, rtol: float = 1e-5,
            ordered: bool = False) -> None:
    """The reference's _cmp: same column names, the same rows (in place
    when ordered, else after a lexsort by the full row tuple), integers
    bit for bit (through int64), floats at rtol and atol 1e-3."""
    assert sorted(local) == sorted(dist), (sorted(local), sorted(dist))
    names = sorted(local)

    def perm(cols):
        n = len(np.asarray(cols[names[0]])) if names else 0
        if ordered or not names:
            return np.arange(n)
        return np.lexsort([np.asarray(cols[nm]).astype(np.float64)
                           for nm in reversed(names)])
    pl, pd = perm(local), perm(dist)
    for nm in names:
        a, b = np.asarray(local[nm])[pl], np.asarray(dist[nm])[pd]
        assert len(a) == len(b), (nm, len(a), len(b))
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=rtol,
                                       atol=1e-3, err_msg=nm)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=nm)
