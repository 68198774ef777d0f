"""tpu_qe_torch.ops.dbigorderby on a LocalMesh of the CPU: every test of
tests/test_dbigorderby.py at the reference's mesh sizes and inputs,
against the numpy oracle (lexsort) and the port's single-device
order_by_big; then order_by_big_distributed against tpu_qe.ops.dbigorderby
on the same configuration at D = 2 and 8 (every column and check, bit for
bit)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigorderby")
td = importlib.import_module("tpu_qe_torch.ops.dbigorderby")
tb = importlib.import_module("tpu_qe_torch.ops.bigorderby")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

CHECKS = ("n", "a_card", "sorted_ok", "hash_ok", "boundary_ok",
          "count_ok", "perm_ok")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return tm.LocalMesh(n, "cpu")


def _jmesh(n):
    from tpu_qe.exchange import make_mesh
    return make_mesh(n)


def _oracle(n, a_card):
    a, b, pay = tb.rows_numpy(np.arange(n, dtype=np.uint32), a_card)
    perm = np.lexsort((np.arange(n), b, ~a))
    return a[perm], b[perm], perm.astype(np.uint32), pay[perm]


# --------------------------------------------- tests/test_dbigorderby.py

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_matches_oracle_and_singlechip(n_dev):
    n, rs = 1 << 13, 1 << 10
    res, got = td.order_by_big_distributed(n, _mesh(n_dev), a_card=19,
                                           run_size=rs, buckets_per_dev=2,
                                           collect=True)
    assert res.all_ok, res
    wa, wb, widx, wpay = _oracle(n, 19)
    np.testing.assert_array_equal(got["a"], wa)
    np.testing.assert_array_equal(got["b"], wb)
    np.testing.assert_array_equal(got["idx"], widx)
    np.testing.assert_array_equal(got["pay"], wpay)
    _, single = tb.order_by_big(n, a_card=19, run_size=rs, n_buckets=4,
                                collect=True, device="cpu")
    for nm in got:
        np.testing.assert_array_equal(got[nm], single[nm], err_msg=nm)


def test_one_hot_key_spans_mesh_and_buckets():
    n, rs = 1 << 13, 1 << 10
    res, got = td.order_by_big_distributed(n, _mesh(8), a_card=1,
                                           run_size=rs, buckets_per_dev=2,
                                           collect=True)
    assert res.all_ok, res
    _, _, widx, _ = _oracle(n, 1)
    np.testing.assert_array_equal(got["idx"], widx)


def test_d1_delegates_and_force_composed_agrees():
    n, rs = 1 << 12, 1 << 10
    res_d = td.order_by_big_distributed(n, _mesh(1), a_card=11, run_size=rs,
                                        buckets_per_dev=3)
    assert isinstance(res_d, tb.BigOrderByResult) and res_d.all_ok
    res_f, got_f = td.order_by_big_distributed(n, _mesh(1), a_card=11,
                                               run_size=rs,
                                               buckets_per_dev=3,
                                               collect=True,
                                               force_composed=True)
    assert res_f.all_ok
    _, _, widx, _ = _oracle(n, 11)
    np.testing.assert_array_equal(got_f["idx"], widx)


# ------------------------------------------------------------ the port

def test_dry_run_size_and_stats():
    n, rs = 8 * 2 * 2048, 2048
    st = {}
    res, got = td.order_by_big_distributed(n, _mesh(8), run_size=rs,
                                           collect=True, stats=st)
    assert res.all_ok and res.a_card == n // 256
    wa, wb, widx, _ = _oracle(n, n // 256)
    np.testing.assert_array_equal(got["idx"], widx)
    assert sum(st["shard_rows"]) == n and len(st["shard_rows"]) == 8


# ----------------------------------------- against tpu_qe's dbigorderby

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n, rs, a_card, b):
    return jd.order_by_big_distributed(n, _jmesh(n_dev), a_card=a_card,
                                       run_size=rs, buckets_per_dev=b,
                                       collect=True)


@pytest.mark.parametrize("n_dev,n,rs,a_card,b", [
    (2, 1 << 13, 1 << 10, 19, 2),
    (8, 1 << 13, 1 << 9, 3, 3),
])
def test_matches_jax(n_dev, n, rs, a_card, b):
    jres, jgot = _jax(n_dev, n, rs, a_card, b)
    res, got = td.order_by_big_distributed(n, _mesh(n_dev), a_card=a_card,
                                           run_size=rs, buckets_per_dev=b,
                                           collect=True)
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    for nm in jgot:
        np.testing.assert_array_equal(got[nm], jgot[nm], err_msg=nm)
        assert got[nm].dtype == jgot[nm].dtype, nm


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.order_by_big_distributed).parameters
    tp = inspect.signature(td.order_by_big_distributed).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
    assert td.N_CHECK == jd.N_CHECK
