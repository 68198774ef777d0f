"""The port's out-of-core SQL (tpu_qe_torch/sql/bigexec.py): every test of
tests/test_sql_big.py on the port, and one query per verb family against
the JAX package's tpu_qe.sql.bigexec.

Each query of tests/test_sql_big.py runs through the port's
register_virtual and through the port's in-core Database("cpu") over the
same columns, materialized: that file's own oracle (the in-core executor
is held to tpu_qe.sql by tests/test_torch_sql.py). The virtual tables'
generators (tests/sql_big_battery.py) take the int32 plane of the u32 row
indices and return u32 (torch.uint32), i32 or f32 columns; each generator
dict is held equal to its JAX twin at index windows around 0, 2^31 and
2^32 - 8 (a bare `lambda i: i` would be an i32 column there).

Tolerance, stated in tests/test_sql_big.py's `_cmp` and kept here:
integers exact; floats at rtol 1e-5 and atol 1e-3 (1e-4 where that file
says so): a float SUM / AVG's float32 rounding follows the row order
inside a group, which the reference's unstable sorts leave open. The JAX
family answers are computed once per query (lru_cache); integers must
match them bit for bit and `explain` must print the same text.

Also pinned on both packages: the tie-aware RANGE sum of the big tier
(the reference composes it in int64, the port in u64 mod 2^64, the
in-core semantics) and a bare column name present on both sides of a
virtual x virtual join (the reference resolves it to the fact side, the
port raises). Both are ROADMAP Queue C entries. The CLI
(`python -m tpu_qe_torch bench-bigsql --device cpu`) runs every verb at a
small size.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from tpu_qe.hashing import murmur_fmix32 as jfmix  # noqa: E402
from tpu_qe.sql import Database as JDatabase  # noqa: E402

import sql_big_battery as B  # noqa: E402
from tpu_qe_torch.sql import Database, SqlError  # noqa: E402
from tpu_qe_torch.sql.bigexec import _range_sum_compose  # noqa: E402
from tpu_qe_torch.table import from_plane  # noqa: E402

N, RUN = B.N, B.RUN


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(p):
    return from_plane(p, torch.uint32)


@pytest.fixture(scope="module")
def dbs():
    big = Database("cpu")
    big.register_virtual("t", N, B.fact_gens())
    big.register("d", B.dim_np())
    ref = Database("cpu")
    ref.register("t", B.materialize(B.fact_gens(), N))
    ref.register("d", B.dim_np())
    return big, ref


def _cmp(got: dict, want: dict, float_cols=(), rtol=1e-5, atol=1e-3):
    assert sorted(got) == sorted(want)
    names = sorted(want)
    pg = np.lexsort([np.asarray(got[n]).astype(np.float64)
                     for n in reversed(names)])
    pw = np.lexsort([np.asarray(want[n]).astype(np.float64)
                     for n in reversed(names)])
    for n in names:
        a, b = np.asarray(got[n])[pg], np.asarray(want[n])[pw]
        assert len(a) == len(b), (n, len(a), len(b))
        if n in float_cols or a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64),
                                       rtol=rtol, atol=atol, err_msg=n)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=n)


def _exact(got: dict, want: dict):
    for nm in want:
        np.testing.assert_array_equal(
            np.asarray(got[nm]).astype(np.int64),
            np.asarray(want[nm]).astype(np.int64), err_msg=nm)


def test_group_aggregates(dbs):
    big, ref = dbs
    sql = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(v) AS mx, AVG(u) AS a FROM t GROUP BY k ORDER BY k")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql), float_cols=("a",))


def test_where_having_limit(dbs):
    big, ref = dbs
    sql = ("SELECT k, SUM(u) AS s, COUNT(*) AS c FROM t "
           "WHERE v > 0 AND u % 3 <> 1 GROUP BY k "
           "HAVING COUNT(*) > 40 ORDER BY s DESC LIMIT 11")
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_aggregate_expressions(dbs):
    big, ref = dbs
    sql = ("SELECT k, SUM(u * 2) AS s2, "
           "SUM(CASE WHEN v > 0 THEN u ELSE 0 END) AS cs "
           "FROM t GROUP BY k ORDER BY k")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_float_aggregates(dbs):
    big, ref = dbs
    sql = "SELECT k, SUM(f) AS s, MAX(f) AS mx FROM t GROUP BY k"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql),
         float_cols=("s", "mx"), rtol=1e-4)


def test_percentiles(dbs):
    big, ref = dbs
    sql = ("SELECT k, MEDIAN(v) AS m, PERCENTILE_DISC(0.9) WITHIN "
           "GROUP (ORDER BY u) AS p90, PERCENTILE_CONT(0.25) WITHIN "
           "GROUP (ORDER BY v) AS pc FROM t GROUP BY k ORDER BY k")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql), float_cols=("pc",),
         rtol=1e-5)


def test_percentile_with_where(dbs):
    big, ref = dbs
    sql = ("SELECT k, MEDIAN(u) AS m, COUNT(*) AS c FROM t "
           "WHERE v % 2 = 0 GROUP BY k ORDER BY k")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_overflow_detected(dbs):
    big, _ = dbs
    with pytest.raises(SqlError, match="max_groups"):
        big.sql("SELECT u, COUNT(*) AS c FROM t GROUP BY u",
                run_size=RUN, max_groups=16)


def test_count_only(dbs):
    big, ref = dbs
    sql = "SELECT k, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_unsupported_shapes(dbs):
    big, _ = dbs
    # row-scale results still demand a LIMIT (readback boundary)
    with pytest.raises(SqlError, match="LIMIT"):
        big.sql("SELECT v FROM t ORDER BY v", run_size=RUN)
    with pytest.raises(SqlError, match="LIMIT"):
        big.sql("SELECT v FROM t", run_size=RUN)


def test_virtual_name_collision():
    db = Database("cpu")
    db.register("x", {"a": np.zeros(4, np.uint32)})
    with pytest.raises(SqlError, match="already"):
        db.register_virtual("x", 16, {"a": _u32})
    db2 = Database("cpu")
    db2.register_virtual("y", 16, {"a": _u32})
    with pytest.raises(SqlError, match="already"):
        db2.register("y", {"a": np.zeros(4, np.uint32)})


# -- review-finding regressions ---------------------------------------------

def test_median_expression_without_other_aggs():
    from tpu_qe_torch.hashing import murmur_fmix32, murmur_fmix32_numpy
    db = Database("cpu")
    db.register_virtual("t", 4096, {
        "k": lambda i: _u32(i & 7),
        "v": lambda i: _u32(murmur_fmix32(i) & 999)})
    got = db.sql("SELECT k, MEDIAN(v * 2) AS m FROM t GROUP BY k "
                 "ORDER BY k", run_size=1024)
    idx = np.arange(4096, dtype=np.uint32)
    k = idx & np.uint32(7)
    v2 = (murmur_fmix32_numpy(idx) & np.uint32(999)) * 2
    for i, kk in enumerate(got["k"]):
        s = np.sort(v2[k == kk])
        assert got["m"][i] == s[(len(s) + 1) // 2 - 1], kk
    got2 = db.sql("SELECT k, COUNT(*) AS c, MEDIAN(v * 2) AS m FROM t "
                  "GROUP BY k", run_size=1024)
    assert (got2["c"] == 512).all()


def test_unaliased_duplicate_aggs_do_not_collide(dbs):
    big, ref = dbs
    sql = "SELECT k, SUM(u), SUM(v) FROM t GROUP BY k ORDER BY k"
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    assert sorted(got) == sorted(want) and len(got) == 3
    _exact(got, want)


def test_run_size_u32_wrap_rejected():
    db = Database("cpu")
    db.register_virtual("t", (1 << 32) - 1, {"k": _u32})
    with pytest.raises(SqlError, match="u32 index space"):
        db.sql("SELECT k, COUNT(*) AS c FROM t GROUP BY k",
               run_size=3 << 24)


# -- heads, ORDER BY/LIMIT, DISTINCT, global/2-col GROUP BY ------------------

def test_head_limit_no_where(dbs):
    big, ref = dbs
    sql = "SELECT k, v, u FROM t LIMIT 37"
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_select_star_limit(dbs):
    big, ref = dbs
    sql = "SELECT * FROM t LIMIT 21"
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    assert sorted(got) == sorted(want)
    for nm in want:
        np.testing.assert_allclose(
            np.asarray(got[nm]).astype(np.float64),
            np.asarray(want[nm]).astype(np.float64), err_msg=nm)


def test_head_limit_where_spans_runs(dbs):
    # the predicate is sparse enough that the head spans several runs
    big, ref = dbs
    sql = "SELECT k, u, v % 7 AS m FROM t WHERE u % 97 = 3 LIMIT 60"
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_orderby_limit(dbs):
    big, ref = dbs
    sql = ("SELECT k, v, u, id FROM t WHERE u % 3 = 1 "
           "ORDER BY v DESC, u, id LIMIT 25")
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_orderby_limit_float_and_alias(dbs):
    big, ref = dbs
    sql = "SELECT id, f * 2 AS d FROM t ORDER BY d DESC, id LIMIT 13"
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    np.testing.assert_array_equal(got["id"], want["id"])
    np.testing.assert_allclose(got["d"], want["d"], rtol=1e-6)


def test_orderby_limit_exceeds_matches(dbs):
    big, ref = dbs
    sql = ("SELECT id FROM t WHERE u = 17 AND k = 3 "
           "ORDER BY id LIMIT 1000")
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    np.testing.assert_array_equal(got["id"], want["id"])


def test_select_distinct(dbs):
    big, ref = dbs
    sql = "SELECT DISTINCT k FROM t WHERE v > 0 ORDER BY k"
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    np.testing.assert_array_equal(got["k"], want["k"])


def test_select_distinct_two_cols(dbs):
    big, ref = dbs
    sql = ("SELECT DISTINCT k, u % 5 AS m FROM t "
           "ORDER BY k, m LIMIT 100")
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_array_equal(got["m"], want["m"])


def test_global_aggregates(dbs):
    big, ref = dbs
    sql = ("SELECT COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(u) AS mx, AVG(u) AS a FROM t WHERE u % 2 = 0")
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    _exact({k: got[k] for k in ("c", "s", "mn", "mx")},
           {k: want[k] for k in ("c", "s", "mn", "mx")})
    np.testing.assert_allclose(got["a"], want["a"], rtol=1e-6)


def test_global_median(dbs):
    big, ref = dbs
    sql = "SELECT MEDIAN(v) AS md, COUNT(*) AS c FROM t"
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    np.testing.assert_array_equal(got["md"], want["md"])
    np.testing.assert_array_equal(got["c"], want["c"])


def test_group_by_two_columns(dbs):
    big, ref = dbs
    sql = ("SELECT k, u % 3 AS m, COUNT(*) AS c, SUM(v) AS s, "
           "MIN(u) AS mn FROM t GROUP BY k, m ORDER BY k, m")
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_group_by_two_columns_signed_and_median(dbs):
    big, ref = dbs
    sql = ("SELECT v % 5 AS m, k % 2 AS b, COUNT(*) AS c, "
           "MEDIAN(u) AS md FROM t GROUP BY m, b ORDER BY m, b")
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_group_by_alias_expression(dbs):
    big, ref = dbs
    sql = ("SELECT u % 10 AS m, COUNT(*) AS c, SUM(v) AS s FROM t "
           "GROUP BY m ORDER BY m")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


# -- JOIN over a virtual fact table x in-core dimension ----------------------

def test_join_group_by_dim_col(dbs):
    big, ref = dbs
    sql = ("SELECT d.r AS r, COUNT(*) AS c, SUM(v) AS s, MAX(w) AS mw "
           "FROM t JOIN d ON t.k = d.dk GROUP BY d.r ORDER BY r")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_left_join_matched_counts(dbs):
    big, ref = dbs
    sql = ("SELECT d__matched AS m, COUNT(*) AS c, SUM(u) AS s "
           "FROM t LEFT JOIN d ON k = dk GROUP BY m ORDER BY m")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_join_where_on_dim(dbs):
    big, ref = dbs
    sql = ("SELECT k, COUNT(*) AS c, SUM(w) AS sw FROM t "
           "JOIN d ON k = dk WHERE w > 500 AND v < 0 "
           "GROUP BY k ORDER BY k")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_join_orderby_limit(dbs):
    big, ref = dbs
    # unique global tiebreak (id) makes the top-20 deterministic
    sql = ("SELECT id, k, w FROM t JOIN d ON k = dk "
           "ORDER BY w DESC, id LIMIT 20")
    _exact(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_join_head_star(dbs):
    big, ref = dbs
    # WHERE narrows to fewer rows than LIMIT: both engines return the
    # full (order-free) match set — compare as sets of rows
    sql = "SELECT * FROM t JOIN d ON k = dk WHERE id < 50 LIMIT 100"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_left_join_head_null_fill(dbs):
    big, ref = dbs
    sql = ("SELECT id, k, dk, w, d__matched FROM t LEFT JOIN d "
           "ON k = dk WHERE id < 40 LIMIT 100")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_join_distinct(dbs):
    big, ref = dbs
    sql = "SELECT DISTINCT r FROM t JOIN d ON k = dk ORDER BY r"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_join_median_by_dim_group(dbs):
    big, ref = dbs
    sql = ("SELECT r, MEDIAN(v) AS md, COUNT(*) AS c FROM t "
           "JOIN d ON k = dk GROUP BY r ORDER BY r")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_join_unsupported_shapes(dbs):
    big, _ = dbs
    # virtual x virtual joins are supported (test_torch_sql_vvjoin.py)
    # but a self-join without aliases has ambiguous bindings
    with pytest.raises(SqlError, match="distinct table aliases"):
        big.sql("SELECT COUNT(*) AS c FROM t JOIN t ON k = k")
    with pytest.raises(SqlError, match="FULL OUTER"):
        big.sql("SELECT COUNT(*) AS c FROM t FULL JOIN d ON k = dk")


def test_join_duplicate_dim_keys_rejected():
    big = Database("cpu")
    big.register_virtual("t", 1 << 10, B.fact_gens())
    big.register("dup", {"dk": np.array([1, 1, 2], np.uint32),
                         "w": np.arange(3, dtype=np.uint32)})
    with pytest.raises(SqlError, match="not unique"):
        big.sql("SELECT COUNT(*) AS c FROM t JOIN dup ON k = dk")


# -- COUNT(DISTINCT) over big tables -----------------------------------------

def test_count_distinct_by_group(dbs):
    big, ref = dbs
    sql = ("SELECT k, COUNT(DISTINCT u) AS cd, COUNT(*) AS c FROM t "
           "GROUP BY k ORDER BY k")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_count_distinct_global_where(dbs):
    big, ref = dbs
    sql = "SELECT COUNT(DISTINCT k) AS cd FROM t WHERE v > 0"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_count_distinct_expression(dbs):
    big, ref = dbs
    sql = ("SELECT k % 4 AS m, COUNT(DISTINCT u % 50) AS cd, "
           "SUM(v) AS s FROM t GROUP BY m ORDER BY m")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_count_distinct_join(dbs):
    big, ref = dbs
    sql = ("SELECT r, COUNT(DISTINCT k) AS cd FROM t "
           "JOIN d ON k = dk GROUP BY r ORDER BY r")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_sum_distinct_rejected(dbs):
    big, _ = dbs
    with pytest.raises(SqlError, match="DISTINCT"):
        big.sql("SELECT k, SUM(DISTINCT u) AS s FROM t GROUP BY k",
                run_size=RUN)


# -- set operations over big tables ------------------------------------------

def test_union_distinct(dbs):
    big, ref = dbs
    sql = ("SELECT u FROM t WHERE u < 300 UNION "
           "SELECT u FROM t WHERE u >= 250 ORDER BY u")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_intersect_and_except(dbs):
    big, ref = dbs
    for op in ("INTERSECT", "EXCEPT"):
        sql = (f"SELECT u FROM t WHERE u < 400 {op} "
               "SELECT u FROM t WHERE u % 3 = 0 ORDER BY u")
        _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_union_all_multiset(dbs):
    big, ref = dbs
    # single-column UNION ALL: multiset equality (both engines repeat
    # keys by exact multiplicity; _cmp sorts)
    sql = ("SELECT k FROM t WHERE v > 0 UNION ALL "
           "SELECT k FROM t WHERE v > 16000")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_setop_virtual_x_incore(dbs):
    big, ref = dbs
    sql = "SELECT u FROM t WHERE u < 60 INTERSECT SELECT dk FROM d"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_setop_incore_first_side(dbs):
    big, ref = dbs
    # in-core side FIRST: routing still lands out-of-core
    sql = "SELECT dk FROM d EXCEPT SELECT u FROM t WHERE u < 30"
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_setop_signed_and_expression(dbs):
    big, ref = dbs
    sql = ("SELECT v % 7 AS m FROM t WHERE v > 0 UNION "
           "SELECT v % 5 AS m FROM t WHERE v < 0 ORDER BY m LIMIT 9")
    got, want = big.sql(sql, run_size=RUN), ref.sql(sql)
    np.testing.assert_array_equal(
        np.asarray(got["m"]).astype(np.int64),
        np.asarray(want["m"]).astype(np.int64))


def test_setop_dtype_mismatch_rejected(dbs):
    big, _ = dbs
    with pytest.raises(SqlError, match="dtype"):
        big.sql("SELECT u FROM t UNION SELECT f FROM t",
                run_size=RUN)


# -- window functions over big tables (LIMIT-bounded prefix exactness) -------

def _cmp_ordered(got: dict, want: dict, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for nm in want:
        a, b = np.asarray(got[nm]), np.asarray(want[nm])
        assert len(a) == len(b), (nm, len(a), len(b))
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64),
                                       rtol=rtol, atol=1e-4, err_msg=nm)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=nm)


def test_window_prefix_family(dbs):
    big, ref = dbs
    body = ("SELECT k, u, id, "
            "ROW_NUMBER() OVER (PARTITION BY k ORDER BY u) AS rn, "
            "RANK() OVER (PARTITION BY k ORDER BY u) AS rk, "
            "SUM(v) OVER (PARTITION BY k ORDER BY u) AS rs, "
            "LAG(u) OVER (PARTITION BY k ORDER BY u) AS lg "
            "FROM t")
    got = big.sql(body + " LIMIT 50", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 50")
    _cmp_ordered(got, want)


def test_window_whole_partition(dbs):
    big, ref = dbs
    body = ("SELECT k, id, COUNT(*) OVER (PARTITION BY k) AS pc, "
            "SUM(u) OVER (PARTITION BY k) AS ts, "
            "MIN(v) OVER (PARTITION BY k) AS mn, "
            "AVG(f) OVER (PARTITION BY k) AS av FROM t WHERE u < 700")
    got = big.sql(body + " LIMIT 64", run_size=RUN)
    want = ref.sql(body + " ORDER BY id LIMIT 64")
    _cmp_ordered(got, want, rtol=1e-4)


def test_window_mixed_specs(dbs):
    big, ref = dbs
    body = ("SELECT k, u, id, "
            "ROW_NUMBER() OVER (PARTITION BY k ORDER BY u) AS rn, "
            "COUNT(*) OVER (PARTITION BY u) AS pc2 "
            "FROM t WHERE v > 0")
    got = big.sql(body + " LIMIT 40", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 40")
    _cmp_ordered(got, want)


def test_window_lead_offset(dbs):
    big, ref = dbs
    body = ("SELECT k, u, id, "
            "LEAD(u, 3) OVER (PARTITION BY k ORDER BY u) AS ld, "
            "FIRST_VALUE(u) OVER (PARTITION BY k ORDER BY u) AS fv "
            "FROM t")
    got = big.sql(body + " LIMIT 30", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 30")
    _cmp_ordered(got, want)


def test_window_percent_rank_ntile(dbs):
    big, ref = dbs
    body = ("SELECT k, u, id, "
            "PERCENT_RANK() OVER (PARTITION BY k ORDER BY u) AS pr, "
            "NTILE(4) OVER (PARTITION BY k ORDER BY u) AS nt "
            "FROM t")
    got = big.sql(body + " LIMIT 50", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 50")
    _cmp_ordered(got, want)


def test_window_moving_frame(dbs):
    big, ref = dbs
    body = ("SELECT k, u, id, SUM(u) OVER (PARTITION BY k ORDER BY u "
            "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ms FROM t")
    got = big.sql(body + " LIMIT 30", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 30")
    _cmp_ordered(got, want)


def test_window_unsupported_shapes(dbs):
    big, _ = dbs
    rn = "ROW_NUMBER() OVER (PARTITION BY k ORDER BY u) AS rn"
    with pytest.raises(SqlError, match="LIMIT"):
        big.sql(f"SELECT k, {rn} FROM t", run_size=RUN)
    with pytest.raises(SqlError, match="composite"):
        big.sql(f"SELECT k, {rn} FROM t ORDER BY k LIMIT 5",
                run_size=RUN)
    with pytest.raises(SqlError, match="last_value"):
        big.sql("SELECT LAST_VALUE(u) OVER (PARTITION BY k ORDER BY u)"
                " AS lv FROM t LIMIT 5", run_size=RUN)
    with pytest.raises(SqlError, match="share one"):
        big.sql(f"SELECT {rn}, RANK() OVER (PARTITION BY u ORDER BY v)"
                " AS r2 FROM t LIMIT 5", run_size=RUN)


def test_limit_offset_over_virtual_table():
    db = Database("cpu")
    db.register_virtual("big", 1 << 14,
                        {"k": lambda i: _u32(i & 63), "v": _u32})
    out = db.sql("SELECT v FROM big ORDER BY v DESC LIMIT 5 OFFSET 3",
                 run_size=1 << 12)
    np.testing.assert_array_equal(
        out["v"], (1 << 14) - 1 - 3 - np.arange(5))
    out2 = db.sql("SELECT v FROM big LIMIT 4 OFFSET 10",
                  run_size=1 << 12)
    np.testing.assert_array_equal(out2["v"], 10 + np.arange(4))
    out3 = db.sql("SELECT k, v, ROW_NUMBER() OVER (PARTITION BY k "
                  "ORDER BY v) AS rn FROM big LIMIT 4 OFFSET 2",
                  run_size=1 << 12)
    np.testing.assert_array_equal(out3["v"], 64 * (2 + np.arange(4)))
    np.testing.assert_array_equal(out3["rn"], 3 + np.arange(4))


def test_window_range_unbounded(dbs):
    # SQL's tie-aware default RANGE frame over a big table: the frame
    # runs through the row's last order peer, which extends past the
    # candidate prefix (u has only 1000 values, so runs straddle the
    # LIMIT boundary by construction)
    big, ref = dbs
    body = ("SELECT k, u, id, "
            "SUM(v) OVER (PARTITION BY k ORDER BY u RANGE BETWEEN "
            "UNBOUNDED PRECEDING AND CURRENT ROW) AS rs, "
            "MIN(v) OVER (PARTITION BY k ORDER BY u RANGE BETWEEN "
            "UNBOUNDED PRECEDING AND CURRENT ROW) AS rm, "
            "MAX(f) OVER (PARTITION BY k ORDER BY u RANGE BETWEEN "
            "UNBOUNDED PRECEDING AND CURRENT ROW) AS rx, "
            "AVG(v) OVER (PARTITION BY k ORDER BY u RANGE BETWEEN "
            "UNBOUNDED PRECEDING AND CURRENT ROW) AS ra FROM t")
    got = big.sql(body + " LIMIT 40", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 40")
    _cmp_ordered(got, want)


def test_window_range_where_offset(dbs):
    big, ref = dbs
    body = ("SELECT k, u, id, SUM(u) OVER (PARTITION BY k ORDER BY u "
            "RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs "
            "FROM t WHERE u % 3 <> 1")
    got = big.sql(body + " LIMIT 25 OFFSET 7", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 25 OFFSET 7")
    _cmp_ordered(got, want)


def test_window_range_bounded_rejected(dbs):
    big, _ = dbs
    with pytest.raises(SqlError, match="bounded RANGE"):
        big.sql("SELECT SUM(v) OVER (PARTITION BY k ORDER BY u RANGE "
                "BETWEEN 5 PRECEDING AND CURRENT ROW) AS rs FROM t "
                "LIMIT 10", run_size=RUN)


def test_window_select_star(dbs):
    # SELECT * expands to the virtual table's columns (sorted name
    # order) alongside the window calls
    big, ref = dbs
    got = big.sql("SELECT *, ROW_NUMBER() OVER (PARTITION BY k ORDER "
                  "BY u) AS rn FROM t LIMIT 30", run_size=RUN)
    want = ref.sql("SELECT f, id, k, u, v, ROW_NUMBER() OVER "
                   "(PARTITION BY k ORDER BY u) AS rn FROM t "
                   "ORDER BY k, u, id LIMIT 30")
    _cmp_ordered(got, want)


def test_window_count_frames(dbs):
    # moving_count over a big table: backward clamp prefix-exact;
    # FOLLOWING clamp composes hidden row_number with the partition
    # count side channel
    big, ref = dbs
    body = ("SELECT k, u, id, "
            "COUNT(*) OVER (PARTITION BY k ORDER BY u ROWS BETWEEN "
            "4 PRECEDING AND CURRENT ROW) AS c1, "
            "COUNT(*) OVER (PARTITION BY k ORDER BY u ROWS BETWEEN "
            "2 PRECEDING AND 3 FOLLOWING) AS c2, "
            "COUNT(*) OVER (PARTITION BY k ORDER BY u ROWS BETWEEN "
            "UNBOUNDED PRECEDING AND 5 FOLLOWING) AS c3 FROM t")
    got = big.sql(body + " LIMIT 30", run_size=RUN)
    want = ref.sql(body + " ORDER BY k, u, id LIMIT 30")
    _cmp_ordered(got, want)


# -- the port against tpu_qe.sql.bigexec: one query per verb family ----------

def _jax_fact_gens():
    """tests/test_sql_big.py's _gens."""
    return {
        "k": lambda i: jfmix(i) & jnp.uint32(63),
        "v": lambda i: ((jfmix(i ^ jnp.uint32(0xA5A5))
                         & jnp.uint32(0xFFFF)).astype(jnp.int32)
                        - jnp.int32(0x8000)),
        "u": lambda i: jfmix(i ^ jnp.uint32(7)) & jnp.uint32(999),
        "f": lambda i: (jfmix(i ^ jnp.uint32(3)) >> 8
                        ).astype(jnp.float32) * jnp.float32(2.0 ** -24),
        "id": lambda i: i,
    }


def _jax_vv_fact_gens():
    """tests/test_sql_vvjoin.py's _fact_gens."""
    g = _jax_fact_gens()
    return {"fk": lambda i: jfmix(i) % jnp.uint32(768),
            "v": g["v"], "u": g["u"], "id": g["id"]}


def _jax_vv_dim_gens():
    """tests/test_sql_vvjoin.py's _dim_gens."""
    return {
        "dk": lambda i: i,
        "w": lambda i: (i * jnp.uint32(2654435761)) >> jnp.uint32(22),
        "grp": lambda i: i & jnp.uint32(15),
        "fw": lambda i: i.astype(jnp.float32) * jnp.float32(0.25),
    }


def _jax_cli_gens(n, G):
    """The JAX CLI's tables (tpu_qe/__main__.py, bench-bigsql)."""
    shift = G.bit_length() - 1
    nf = min(n, 1 << 29)
    nd = min(nf >> 2, 1 << 27)
    return {
        "big": {"k": lambda i: jfmix(i) & jnp.uint32(G - 1),
                "v": lambda i: i},
        "bigdet": {"k": lambda i: i & jnp.uint32(G - 1),
                   "v": lambda i: i,
                   "d": lambda i: (i >> jnp.uint32(shift)) & jnp.uint32(15)},
        "bigfact": {"fk": lambda i: i & jnp.uint32(nd - 1),
                    "v": lambda i: i},
        "bigdim": {"dk": lambda i: i, "w": lambda i: 2 * i + jnp.uint32(1),
                   "grp": lambda i: i & jnp.uint32(15)},
        "seta": {"k": lambda i: i & jnp.uint32(G - 1)},
        "setb": {"k": lambda i: (i & jnp.uint32(G // 2 - 1))
                 + jnp.uint32(G // 2)},
    }


def _gen_pairs():
    from tpu_qe_torch.bench.bigsql import generators
    pairs = [("t", B.fact_gens(), _jax_fact_gens()),
             ("f", B.vv_fact_gens(), _jax_vv_fact_gens()),
             ("vd", B.vv_dim_gens(), _jax_vv_dim_gens())]
    for n, G in ((1 << 30, 1 << 16), (1 << 16, 16)):
        port, ref = generators(n, G), _jax_cli_gens(n, G)
        pairs += [(f"cli {name} n={n} G={G}", port[name], ref[name])
                  for name in port]
    return pairs


@pytest.mark.parametrize("start", [0, (1 << 31) - 32, (1 << 32) - 64])
def test_generator_dicts_equal_their_jax_twins(start):
    # indices 0.., around 2^31, and up to 2^32 - 8: a u32 generator that
    # returned the bare int32 plane would be i32, negative past 2^31
    idx = np.arange(start, start + 64, dtype=np.uint64).astype(np.uint32)
    pidx = torch.from_numpy(idx.view(np.int32))
    jidx = jnp.asarray(idx)
    for name, port, ref in _gen_pairs():
        assert sorted(port) == sorted(ref), name
        for col in ref:
            want = np.asarray(ref[col](jidx))
            got = port[col](pidx)
            from tpu_qe_torch.table import column_to_numpy
            got = column_to_numpy(got)
            assert got.dtype == want.dtype, (name, col, got.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}.{col}")


@functools.lru_cache(maxsize=None)
def _jax_db():
    db = JDatabase()
    db.register_virtual("t", N, _jax_fact_gens())
    db.register("d", B.dim_np())
    db.register_virtual("f", B.NF, _jax_vv_fact_gens())
    db.register_virtual("vd", B.ND, _jax_vv_dim_gens())
    return db


@functools.lru_cache(maxsize=None)
def _port_db():
    return B.database("cpu")


@functools.lru_cache(maxsize=None)
def _jax_answer(fam):
    return _jax_db().sql(B.FAMILIES[fam][0], run_size=RUN)


@pytest.mark.parametrize("fam", sorted(B.FAMILIES))
def test_family_matches_jax(fam):
    q, ordered = B.FAMILIES[fam]
    got = _port_db().sql(q, run_size=RUN)
    bad = B.differs(got, _jax_answer(fam), ordered)
    assert bad is None, bad


@pytest.mark.parametrize("fam", sorted(B.FAMILIES))
def test_family_explain_matches_jax(fam):
    q = B.FAMILIES[fam][0]
    assert _port_db().explain(q) == _jax_db().explain(q)


def test_explain_other_shapes_match_jax():
    for q in ("SELECT k, v FROM t WHERE u > 5 LIMIT 10",
              "SELECT v FROM t ORDER BY v DESC LIMIT 5 OFFSET 2",
              "SELECT DISTINCT k FROM t",
              "SELECT id, w FROM t JOIN d ON k = dk ORDER BY w LIMIT 3",
              "SELECT k, COUNT(*) AS c FROM t WHERE v > 0 GROUP BY k "
              "ORDER BY c LIMIT 4",
              "SELECT dk FROM d EXCEPT SELECT u FROM t",
              "SELECT k FROM d"):
        assert _port_db().explain(q) == _jax_db().explain(q), q


# -- the two reference quirks, pinned on both packages ----------------------

def test_range_sum_compose_is_u64_mod_2_64():
    # the host compose of the tie-aware RANGE sum: the sum before the
    # row's (partition, order) run from the candidates, plus the run's
    # total from the side channel. A u32 column's run total can pass 2^63
    # (2^32 rows of values near 2^32); the port keeps the u64 word mod
    # 2^64, the in-core tier's SUM semantics, where the reference casts
    # the total to int64 and reports a negative sum (the same bits).
    v = np.array([5, 7, 7, 9], np.uint32)
    rs_row = np.array([0, 1, 1, 3])
    ps_row = np.zeros(4, np.int64)
    run_tot = np.array([5, (1 << 63) + 14, (1 << 63) + 14, 9], np.uint64)
    pre, tot = _range_sum_compose(v, rs_row, ps_row, run_tot, "u32")
    assert tot.dtype == np.uint64
    assert [int(x) for x in pre] == [0, 5, 5, 19]
    assert [int(x) for x in tot] == [5, (1 << 63) + 19, (1 << 63) + 19, 28]
    # tpu_qe/sql/bigexec.py composes in int64: the reference's arithmetic
    # on the same inputs reads 2^63 + 19 as a negative int64
    cv = np.cumsum(v.astype(np.int64))
    before_all = cv - v.astype(np.int64)
    ref = ((before_all[rs_row] - before_all[ps_row])
           + run_tot.astype(np.int64)).astype(np.int64)
    assert int(ref[1]) == (1 << 63) + 19 - (1 << 64) < 0
    np.testing.assert_array_equal(ref.view(np.uint64), tot)
    # i32 values: sign-extended words, read back as int64
    w = np.array([-5, 3, 3], np.int32)
    _, t32 = _range_sum_compose(w, np.array([0, 1, 1]), np.zeros(3, np.int64),
                                np.array([-5, 6, 6], np.int64), "i32")
    assert t32.view(np.int64).tolist() == [-5, 1, 1]


def test_range_sum_below_2_63_equals_jax():
    # below 2^63 both packages give the same values; the dtypes differ
    # for u32 columns (the reference int64, the port uint64 as in-core)
    q = ("SELECT k, u, id, SUM(u) OVER (PARTITION BY k ORDER BY u RANGE "
         "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs, "
         "SUM(v) OVER (PARTITION BY k ORDER BY u RANGE BETWEEN UNBOUNDED "
         "PRECEDING AND CURRENT ROW) AS rv FROM t LIMIT 40")
    got, want = _port_db().sql(q, run_size=RUN), _jax_db().sql(q,
                                                               run_size=RUN)
    assert want["rs"].dtype == np.int64 and got["rs"].dtype == np.uint64
    assert got["rv"].dtype == want["rv"].dtype == np.int64
    assert B.differs(got, want, True) is None
    # the port's big tier gives the in-core tier's dtypes
    inc = Database("cpu")
    inc.register("t", B.materialize(B.fact_gens(), N))
    loc = inc.sql(q.replace("LIMIT 40", "ORDER BY k, u, id LIMIT 40"))
    assert {c: got[c].dtype for c in got} == {c: loc[c].dtype for c in loc}
    assert B.differs(got, loc, True) is None


def _ambiguous_dbs():
    # fact f and dimension g both have a column v
    gf = {"k": lambda i: _u32(i & 7), "v": lambda i: _u32(i & 3)}
    gg = {"k2": _u32, "v": lambda i: _u32(i + 100)}
    port = Database("cpu")
    port.register_virtual("f", 64, gf)
    port.register_virtual("g", 8, gg)
    jax_db = JDatabase()
    jax_db.register_virtual("f", 64, {"k": lambda i: i & jnp.uint32(7),
                                      "v": lambda i: i & jnp.uint32(3)})
    jax_db.register_virtual("g", 8, {"k2": lambda i: i,
                                     "v": lambda i: i + jnp.uint32(100)})
    return port, jax_db


def test_vv_bare_name_on_both_sides_is_ambiguous():
    port, jax_db = _ambiguous_dbs()
    bare = "SELECT COUNT(*) AS c, SUM(v) AS s FROM f JOIN g ON k = k2"
    # tpu_qe/sql/bigexec.py resolves the bare v to the fact side silently
    got = jax_db.sql(bare, run_size=32)
    assert int(got["s"][0]) == int(sum(i & 3 for i in range(64)))
    # the port asks to qualify it
    with pytest.raises(SqlError, match="ambiguous.*qualify"):
        port.sql(bare, run_size=32)
    # qualified, both packages agree: the dimension's v of every match
    q = "SELECT COUNT(*) AS c, SUM(g.v) AS s FROM f JOIN g ON k = k2"
    a, b = port.sql(q, run_size=32), jax_db.sql(q, run_size=32)
    assert int(a["s"][0]) == int(b["s"][0]) == sum((i & 7) + 100
                                                   for i in range(64))
    q = "SELECT COUNT(*) AS c, SUM(f.v) AS s FROM f JOIN g ON k = k2"
    assert B.differs(port.sql(q, run_size=32), jax_db.sql(q, run_size=32),
                     True) is None


# -- the virtual-column contract ---------------------------------------------

@pytest.mark.parametrize("fn, what", [
    (lambda i: i.to(torch.int64), "torch.int64"),
    (lambda i: i > 0, "torch.bool"),
    (lambda i: i[:4], "shape"),
    (lambda i: np.asarray(i), "ndarray"),
])
def test_register_virtual_rejects_other_columns(fn, what):
    db = Database("cpu")
    with pytest.raises(SqlError, match=what if what == "shape" else
                       "takes the int32 plane"):
        db.register_virtual("t", 16, {"x": fn})


def test_register_virtual_rejects_u64():
    from tpu_qe_torch.bits import U64
    db = Database("cpu")
    with pytest.raises(SqlError, match="u64 generators"):
        db.register_virtual("t", 16, {"x": lambda i: U64(i, i)})


def test_virtual_column_tags_follow_the_dtype():
    db = Database("cpu")
    db.register_virtual("t", 16, {"a": _u32, "b": lambda i: i,
                                  "c": lambda i: i.to(torch.float32)})
    assert db._virtual["t"].tags == {"a": "u32", "b": "i32", "c": "f32"}


def test_stats_keep_the_reference_keys(dbs):
    big, _ = dbs
    stats = {}
    big.sql("SELECT k, COUNT(*) AS c, MEDIAN(v) AS m FROM t GROUP BY k",
            run_size=RUN, stats=stats)
    assert {"compile_s", "runs_s", "combine_s", "pct_s"} <= set(stats)
    assert stats["compile_s"] == 0.0 and stats["n_runs"] == 4
    assert stats["groups"] == 64


# -- the CLI -----------------------------------------------------------------

def _cli(capsys, argv):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(argv + ["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return rc, [json.loads(ln) for ln in lines]


@pytest.mark.parametrize("argv", [
    ["--verb", v] for v in ("groupby", "orderby", "head", "distinct",
                            "countdistinct", "join", "window", "setops",
                            "range", "vvjoin")] + [["--median"], ["--where"]])
def test_bench_bigsql_cli_rehearses_on_the_cpu(argv, capsys):
    rc, rows = _cli(capsys, ["bench-bigsql", "--n", str(1 << 16),
                             "--run-size", str(1 << 12), "--groups", "16"]
                    + argv)
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] is True
    assert row["time_s"] == "not measured" and row["device"] == "cpu"
    assert row["sort_passes"] >= (0 if "head" in argv else 1)
