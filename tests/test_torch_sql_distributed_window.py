"""The port's distributed SQL path (`Database.sql(q, mesh=)`) on a
LocalMesh of the CPU: the window and ORDER BY families of
tests/test_sql_distributed.py (the rest are in
test_torch_sql_distributed.py, which says how they are held). Each family
against the port's in-core `Database.sql(q)` at D = 1, 2, 4 and 8, and
against the JAX `Database().sql(q, mesh=make_mesh(D))` at D = 2 and 8
(one cached JAX answer per family and D; integers bit for bit and the same
dtypes, floats at the family's rtol and atol 1e-3)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sql_dist_battery as B  # noqa: E402

tsql = importlib.import_module("tpu_qe_torch.sql")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

FAMS = [nm for nm, f in B.FAMILIES.items() if f.window]
OWN = [nm for nm, o in B.OWN_TABLES.items() if o[3]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(db, tbls):
    for nm, cols in tbls.items():
        db.register(nm, cols)
    return db


@functools.lru_cache(maxsize=None)
def _jax_answer(name, d):
    from tpu_qe.exchange.dsort import make_mesh
    from tpu_qe.sql import Database
    tbls, sql, _, _ = B.case(name, d)
    return _register(Database(), tbls).sql(sql, mesh=make_mesh(d))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("name", FAMS + OWN)
def test_mesh_equals_in_core(name, d):
    tbls, sql, rtol, ordered = B.case(name, d)
    db = _register(tsql.Database("cpu"), tbls)
    B.compare(db.sql(sql), db.sql(sql, mesh=tm.LocalMesh(d, "cpu")),
              rtol=rtol, ordered=ordered)


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("name", FAMS + OWN)
def test_mesh_equals_jax(name, d):
    tbls, sql, rtol, ordered = B.case(name, d)
    got = _register(tsql.Database("cpu"), tbls).sql(
        sql, mesh=tm.LocalMesh(d, "cpu"))
    want = _jax_answer(name, d)
    assert list(got) == list(want)
    for nm in want:
        assert np.asarray(got[nm]).dtype == np.asarray(want[nm]).dtype, nm
    B.compare(want, got, rtol=rtol, ordered=ordered)


def test_float_order_pads_keep_their_nan_bits():
    # the direction-extreme pads of a float ORDER BY key are NaN bit
    # patterns: 5 rows over D = 4 take 3 pads that must sort last, also
    # beside real NaNs and infinities
    f = np.array([0.5, np.inf, -np.inf, -0.0, 0.25], np.float32)
    db = _register(tsql.Database("cpu"), {"t": {
        "f": f, "id": np.arange(5, dtype=np.uint32)}})
    for direction in ("", " DESC"):
        sql = f"SELECT id, f FROM t ORDER BY f{direction}, id"
        got = db.sql(sql, mesh=tm.LocalMesh(4, "cpu"))
        want = db.sql(sql)
        np.testing.assert_array_equal(got["id"], want["id"])
        np.testing.assert_array_equal(got["f"].view(np.uint32),
                                      want["f"].view(np.uint32))
