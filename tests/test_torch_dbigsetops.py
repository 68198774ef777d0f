"""tpu_qe_torch.ops.dbigsetops on a LocalMesh of the CPU: every test of
tests/test_dbigsetops.py at the reference's mesh sizes and inputs, against
the raw-keys numpy oracle and the port's single-device set_op_big; then
set_op_big_distributed against tpu_qe.ops.dbigsetops on the same
configuration at D = 2 and 8 (the collect=True tables, every check and the
overflow flag, bit for bit)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigsetops")
td = importlib.import_module("tpu_qe_torch.ops.dbigsetops")
tb = importlib.import_module("tpu_qe_torch.ops.bigsetops")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

FIELDS = ("op", "n_a", "n_b", "g_a", "g_b", "offset", "n_dev", "n_runs_a",
          "n_runs_b", "num", "expected_num", "counts_ok", "keys_ok",
          "overflow")


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


def _oracle(op, n_a, g_a, n_b, g_b, offset):
    ka = np.arange(n_a, dtype=np.uint64) % g_a
    kb = np.arange(n_b, dtype=np.uint64) % g_b + offset
    ua, ub = np.unique(ka), np.unique(kb)
    if op == "union":
        keys = np.union1d(ua, ub)
    elif op == "intersect":
        keys = np.intersect1d(ua, ub)
    else:
        keys = np.setdiff1d(ua, ub)
    ca = np.array([(ka == k).sum() for k in keys], dtype=np.uint32)
    cb = np.array([(kb == k).sum() for k in keys], dtype=np.uint32)
    return keys.astype(np.uint32), ca, cb


# ---------------------------------------------- tests/test_dbigsetops.py

@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("op", ["union", "intersect", "except"])
def test_matches_oracle(n_dev, op):
    n_a, n_b, rs = 1 << 13, 1 << 13, 1 << 10
    g_a, g_b, offset = 300, 200, 150
    res = td.set_op_big_distributed(op, n_a, n_b, _mesh(n_dev), g_a=g_a,
                                    g_b=g_b, offset=offset, run_size=rs,
                                    collect=True,
                                    capacity_factor=float(n_dev))
    assert res.all_ok, res
    keys, ca, cb = _oracle(op, n_a, g_a, n_b, g_b, offset)
    np.testing.assert_array_equal(res.table["key"], keys)
    np.testing.assert_array_equal(res.table["count_a"], ca)
    np.testing.assert_array_equal(res.table["count_b"], cb)


def test_d1_delegates_and_force_composed_agrees():
    n_a, n_b, rs = 1 << 12, 1 << 12, 1 << 10
    kw = dict(g_a=96, g_b=160, offset=32, run_size=rs, collect=True)
    dele = td.set_op_big_distributed("intersect", n_a, n_b, _mesh(1), **kw)
    single = tb.set_op_big("intersect", n_a, n_b, device="cpu", **kw)
    forced = td.set_op_big_distributed("intersect", n_a, n_b, _mesh(1),
                                       force_composed=True, **kw)
    assert dele.all_ok and single.all_ok and forced.all_ok
    assert forced.n_dev == 1 and forced.route_s > 0
    for k in ("key", "count_a", "count_b"):
        np.testing.assert_array_equal(dele.table[k], single.table[k])
        np.testing.assert_array_equal(forced.table[k], single.table[k])


def test_one_hot_key_all_devices():
    # g_a = 1: every A row is the same key, generated on every shard
    n, rs = 1 << 13, 1 << 10
    res = td.set_op_big_distributed("except", n, n, _mesh(8), g_a=1,
                                    g_b=64, offset=1, run_size=rs,
                                    collect=True, capacity_factor=8.0)
    assert res.all_ok
    np.testing.assert_array_equal(res.table["key"], [0])
    np.testing.assert_array_equal(res.table["count_a"], [n])


def test_exchange_overflow_detected():
    n, rs = 1 << 12, 1 << 10
    res = td.set_op_big_distributed("union", n, n, _mesh(4), g_a=1 << 10,
                                    g_b=1 << 10, offset=0, run_size=rs,
                                    capacity_factor=0.05)
    assert res.overflow and not res.all_ok


# ------------------------------------------------------------ the port

def test_dry_run_step_and_the_pad_bound():
    # __graft_entry__'s step: INTERSECT of 8 x 2 x 2048 rows a side
    ns = 8 * 2 * 2048
    st = {}
    res = td.set_op_big_distributed("intersect", ns, ns, _mesh(8), g_a=96,
                                    g_b=160, offset=32, run_size=2048,
                                    collect=True, capacity_factor=8.0,
                                    stats=st)
    assert res.all_ok
    keys, ca, cb = _oracle("intersect", ns, 96, ns, 160, 32)
    np.testing.assert_array_equal(res.table["key"], keys)
    np.testing.assert_array_equal(res.table["count_a"], ca)
    assert len(st["shard_pairs"]) == 8 and min(st["shard_pairs"]) > 0
    # a real key may never reach the all-ones pad of the exchange
    with pytest.raises(AssertionError):
        td.set_op_big_distributed("union", 4096, 4096, _mesh(2),
                                  g_a=16, g_b=16, offset=(1 << 32) - 17,
                                  run_size=1024)


# ---------------------------------------- against tpu_qe's dbigsetops

@functools.lru_cache(maxsize=None)
def _jax(op, n_dev, n, g_a, g_b, offset, cf):
    return jd.set_op_big_distributed(op, n, n, _jmesh(n_dev), g_a=g_a,
                                     g_b=g_b, offset=offset,
                                     run_size=1 << 10, collect=True,
                                     capacity_factor=cf)


@pytest.mark.parametrize("op,n_dev,n,g_a,g_b,offset,cf", [
    ("union", 2, 1 << 13, 300, 200, 150, 2.0),
    ("intersect", 8, 1 << 13, 300, 200, 150, 8.0),
    ("except", 8, 1 << 14, 1 << 10, 1 << 9, 1 << 8, 2.0),
    ("union", 2, 1 << 12, 1 << 10, 1 << 10, 0, 0.05),   # overflows
])
def test_matches_jax(op, n_dev, n, g_a, g_b, offset, cf):
    want = _jax(op, n_dev, n, g_a, g_b, offset, cf)
    got = td.set_op_big_distributed(op, n, n, _mesh(n_dev), g_a=g_a,
                                    g_b=g_b, offset=offset,
                                    run_size=1 << 10, collect=True,
                                    capacity_factor=cf)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.overflow == (cf < 1)
    for k in want.table:
        np.testing.assert_array_equal(got.table[k], want.table[k], err_msg=k)


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.set_op_big_distributed).parameters
    tp = inspect.signature(td.set_op_big_distributed).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
    assert list(td.DistBigSetOpResult.__dataclass_fields__) == list(
        jd.DistBigSetOpResult.__dataclass_fields__)
