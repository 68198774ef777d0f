"""The port's distributed SQL path, `Database.sql(q, mesh=)` and
`Database.explain(q, mesh=)` (tpu_qe_torch/sql/executor.py), on a
LocalMesh of the CPU: the GROUP BY, COUNT(DISTINCT), percentile, HAVING,
DISTINCT, fused JOIN and set-op families of tests/test_sql_distributed.py
(tests/sql_dist_battery.py holds its queries and tables; the window and
ORDER BY families are in test_torch_sql_distributed_window.py).

Each family is held three ways: to the port's own in-core
`Database.sql(q)` at the reference's mesh sizes D = 1, 2, 4 and 8; to the
JAX `Database().sql(q, mesh=make_mesh(D))` at D = 2 and 8 (one cached JAX
answer per family and D; integers bit for bit and the same dtypes, floats
at the family's rtol and atol 1e-3); and `explain(q, mesh=)` word for word
against the JAX text. Every SqlError of the reference's raising tests
carries the JAX text. Two pins: the all-ones u64 key, which the JAX set op
drops and the port keeps (ROADMAP Queue C 15), and which the GROUP BY
rejects in both packages (so the group quantile's difference, Queue C 17,
never reaches SQL)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sql_dist_battery as B  # noqa: E402

tsql = importlib.import_module("tpu_qe_torch.sql")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

FAMS = [nm for nm, f in B.FAMILIES.items() if not f.window]
OWN = [nm for nm, o in B.OWN_TABLES.items() if not o[3]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_db(tbls):
    db = tsql.Database("cpu")
    for nm, cols in tbls.items():
        db.register(nm, cols)
    return db


def _jax_db(tbls):
    from tpu_qe.sql import Database
    db = Database()
    for nm, cols in tbls.items():
        db.register(nm, cols)
    return db


def _jmesh(d):
    from tpu_qe.exchange.dsort import make_mesh
    return make_mesh(d)


@functools.lru_cache(maxsize=None)
def _jax_answer(name, d):
    tbls, sql, _, _ = B.case(name, d)
    return _jax_db(tbls).sql(sql, mesh=_jmesh(d))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("name", FAMS + OWN)
def test_mesh_equals_in_core(name, d):
    tbls, sql, rtol, ordered = B.case(name, d)
    db = _port_db(tbls)
    B.compare(db.sql(sql), db.sql(sql, mesh=tm.LocalMesh(d, "cpu")),
              rtol=rtol, ordered=ordered)


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("name", FAMS + OWN)
def test_mesh_equals_jax(name, d):
    tbls, sql, rtol, ordered = B.case(name, d)
    got = _port_db(tbls).sql(sql, mesh=tm.LocalMesh(d, "cpu"))
    want = _jax_answer(name, d)
    assert list(got) == list(want)
    for nm in want:
        assert np.asarray(got[nm]).dtype == np.asarray(want[nm]).dtype, nm
    B.compare(want, got, rtol=rtol, ordered=ordered)


def test_where_empty_result_has_no_rows():
    tbls, sql, _, _ = B.case("where_empty_result", 4)
    out = _port_db(tbls).sql(sql, mesh=tm.LocalMesh(4, "cpu"))
    assert len(out["k"]) == 0 and len(out["c"]) == 0


@pytest.mark.parametrize("d", [2, 8])
def test_explain_equals_jax(d):
    # every family's plan (window and ORDER BY families too) and the
    # in-core text beside it
    jmesh = _jmesh(d)
    for name, f in B.FAMILIES.items():
        tbls = B.tables(f.seed_for(d))
        db, jdb = _port_db(tbls), _jax_db(tbls)
        got = db.explain(f.sql, mesh=tm.LocalMesh(d, "cpu"))
        assert got == jdb.explain(f.sql, mesh=jmesh), name
        assert got.startswith(f"tier: distributed ({d} devices)"), name
        assert db.explain(f.sql) == jdb.explain(f.sql), name


@pytest.mark.parametrize("name", list(B.ERRORS))
def test_sql_error_texts_equal_jax(name):
    make, sql, piece = B.ERRORS[name]
    tbls = make()
    with pytest.raises(tsql.SqlError, match=piece) as got:
        _port_db(tbls).sql(sql, mesh=tm.LocalMesh(2, "cpu"))
    from tpu_qe.sql import SqlError
    with pytest.raises(SqlError) as want:
        _jax_db(tbls).sql(sql, mesh=_jmesh(2))
    assert str(got.value) == str(want.value)


def test_distributed_group_quantile_overflow_type():
    # the retry loop catches ONLY the dedicated overflow type; both
    # packages raise it with one text
    from tpu_qe.exchange.dquantile import QuantileOverflow as JOverflow
    from tpu_qe.exchange.dquantile import (
        distributed_group_quantile_numpy as jgq)
    from tpu_qe_torch.exchange.dquantile import (
        QuantileOverflow, distributed_group_quantile_numpy)
    keys = np.arange(256, dtype=np.uint64)
    vals = np.zeros(256, np.uint32)
    with pytest.raises(QuantileOverflow) as got:
        distributed_group_quantile_numpy(keys, vals, [(1, 1)],
                                         tm.LocalMesh(2, "cpu"),
                                         max_groups=16)
    with pytest.raises(JOverflow) as want:
        jgq(keys, vals, [(1, 1)], _jmesh(2), max_groups=16)
    assert str(got.value) == str(want.value)


def test_virtual_table_with_mesh_keeps_its_error():
    db = tsql.Database("cpu")
    db.register_virtual("big", 1 << 10, {
        "k": lambda i: (i & 3).view(torch.uint32)})
    with pytest.raises(tsql.SqlError, match="mesh= with a virtual table"):
        db.sql("SELECT k, COUNT(*) AS c FROM big GROUP BY k",
               mesh=tm.LocalMesh(2, "cpu"))


def _all_ones_sides():
    top = (1 << 64) - 1
    # the set ops do not pad: each side's rows split over D = 2
    a = np.array([5, top, 7, 7, top, 9, 11, 3], np.uint64)
    b = np.array([top, 7, 12, 13, 5, 12], np.uint64)
    return {"a": {"h": a}, "b": {"h": b}}


@pytest.mark.parametrize("op", ["UNION", "INTERSECT", "EXCEPT"])
def test_all_ones_key_set_op_pinned(op):
    # Queue C 15 through SQL: the port keeps a real 2^64-1 key, as its
    # in-core set op and numpy do; the JAX distributed set op reads it
    # as padding and drops it
    tbls = _all_ones_sides()
    sql = f"SELECT h FROM a {op} SELECT h FROM b ORDER BY h"
    db = _port_db(tbls)
    got = db.sql(sql, mesh=tm.LocalMesh(2, "cpu"))["h"]
    a, b = tbls["a"]["h"], tbls["b"]["h"]
    want = {"UNION": np.union1d(a, b), "INTERSECT": np.intersect1d(a, b),
            "EXCEPT": np.setdiff1d(a, b)}[op]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(db.sql(sql)["h"], want)
    jgot = _jax_db(tbls).sql(sql, mesh=_jmesh(2))["h"]
    np.testing.assert_array_equal(jgot, want[want != np.uint64((1 << 64)
                                                               - 1)])


def test_all_ones_key_group_quantile_unreachable_from_sql():
    # Queue C 17 (the JAX group quantile drops an all-ones key, the port
    # keeps it) cannot reach SQL: a real 2^64-1 group key raises in both
    # packages, and the pad group both use is popped before the answer
    tbls = {"t": {"k": np.array([1, 1, (1 << 64) - 1], np.uint64),
                  "v": np.arange(3, dtype=np.uint32)}}
    sql = "SELECT k, MEDIAN(v) AS m FROM t GROUP BY k"
    with pytest.raises(tsql.SqlError, match="reserved") as got:
        _port_db(tbls).sql(sql, mesh=tm.LocalMesh(2, "cpu"))
    from tpu_qe.sql import SqlError
    with pytest.raises(SqlError) as want:
        _jax_db(tbls).sql(sql, mesh=_jmesh(2))
    assert str(got.value) == str(want.value)
    tbls["t"]["k"][2] = 2                     # 3 rows: one pad row at D=2
    port = _port_db(tbls).sql(sql, mesh=tm.LocalMesh(2, "cpu"))
    jax = _jax_db(tbls).sql(sql, mesh=_jmesh(2))
    B.compare(jax, port, ordered=True)


@pytest.mark.parametrize("mesh", [0, 4])
def test_bench_sql_runs_in_core_and_over_a_mesh(mesh):
    # python -m tpu_qe_torch.bench.sql [--mesh D] on the CPU: the SQL run
    # (over LocalMesh(D) when D) agrees with the hand-composed operators;
    # no time is measured here
    from tpu_qe_torch.bench import sql as bsql
    row, got, _ = bsql.run(1 << 16, 64, torch.device("cpu"), mesh=mesh)
    assert row["verified"] and row["groups_out"] == len(got["k"]) == 64
    assert row["time_s"] == "not measured"
    assert ("mesh" in row) == bool(mesh)
    if mesh:
        assert row["read_back_share"] == "not measured"
        assert row["metric"].endswith(f", mesh=LocalMesh({mesh})")
