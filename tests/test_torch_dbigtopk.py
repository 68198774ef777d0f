"""tpu_qe_torch.ops.dbigtopk on a LocalMesh of the CPU: every test of
tests/test_dbigtopk.py at the reference's mesh sizes and inputs, against
the port's single-device top_k_big (bit for bit) and numpy's stable sort;
then top_k_big_distributed against tpu_qe.ops.dbigtopk on the same
configuration at D = 2 and 8 (winners and checks, bit for bit)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigtopk")
td = importlib.import_module("tpu_qe_torch.ops.dbigtopk")
tb = importlib.import_module("tpu_qe_torch.ops.bigtopk")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.hashing import keygen_hash_numpy  # noqa: E402

CHECKS = ("n", "k", "hash_ok", "order_ok", "distinct_ok")


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


# ------------------------------------------------ tests/test_dbigtopk.py

@pytest.mark.parametrize("n_dev,n,k,run_size,largest", [
    (1, 1 << 14, 16, 1 << 12, False),     # D = 1 delegates to top_k_big
    (2, 1 << 14, 16, 1 << 12, False),
    (2, 1 << 14, 16, 1 << 12, True),
    (4, 1 << 15, 100, 1 << 12, False),    # 2 runs a shard, odd k
    (8, 1 << 15, 1 << 12, 1 << 12, True),  # k == run_size
])
def test_matches_single_chip_bit_exact(n_dev, n, k, run_size, largest):
    res, (keys, pay) = td.top_k_big_distributed(
        n, k, _mesh(n_dev), run_size=run_size, largest=largest,
        collect=True)
    assert res.all_ok, res
    res1, (k1, p1) = tb.top_k_big(n, k, run_size=run_size, largest=largest,
                                  collect=True, device="cpu")
    assert res1.all_ok
    np.testing.assert_array_equal(keys, k1)
    np.testing.assert_array_equal(pay, p1)


def test_matches_numpy_oracle():
    n, k = 1 << 14, 37
    _, (keys, pay) = td.top_k_big_distributed(n, k, _mesh(4),
                                              run_size=1 << 12, collect=True)
    okeys = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(okeys, kind="stable")[:k]
    np.testing.assert_array_equal(keys, okeys[order])
    np.testing.assert_array_equal(pay, order.astype(np.uint32))


def test_1dev_forced_composed_matches(monkeypatch):
    monkeypatch.setattr(tb, "top_k_big", None)
    res, (keys, pay) = td.top_k_big_distributed(
        1 << 14, 16, _mesh(1), run_size=1 << 12, collect=True,
        force_composed=True)
    assert res.all_ok, res
    monkeypatch.undo()
    _, (k1, p1) = tb.top_k_big(1 << 14, 16, run_size=1 << 12, collect=True,
                               device="cpu")
    np.testing.assert_array_equal(keys, k1)
    np.testing.assert_array_equal(pay, p1)


def test_indivisible_n_asserts():
    with pytest.raises(AssertionError):
        td.top_k_big_distributed(1 << 14, 16, _mesh(8), run_size=3000)


# ------------------------------------------------------------ the port

def test_dry_run_step():
    # __graft_entry__'s step: top-64 of 8 x 2 x 2048 rows
    n, k = 8 * 2 * 2048, 64
    res, (keys, pay) = td.top_k_big_distributed(n, k, _mesh(8),
                                                run_size=2048, collect=True)
    assert res.all_ok
    okeys = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(okeys, kind="stable")[:k]
    np.testing.assert_array_equal(keys, okeys[order])
    np.testing.assert_array_equal(pay, order.astype(np.uint32))


# ------------------------------------------- against tpu_qe's dbigtopk

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n, k, rs, largest):
    return jd.top_k_big_distributed(n, k, _jmesh(n_dev), run_size=rs,
                                    largest=largest, collect=True)


@pytest.mark.parametrize("n_dev,n,k,rs,largest", [
    (2, 1 << 14, 16, 1 << 12, True),
    (8, 1 << 15, 100, 1 << 11, False),
])
def test_matches_jax(n_dev, n, k, rs, largest):
    jres, (jk, jp) = _jax(n_dev, n, k, rs, largest)
    res, (keys, pay) = td.top_k_big_distributed(n, k, _mesh(n_dev),
                                                run_size=rs, largest=largest,
                                                collect=True)
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    np.testing.assert_array_equal(keys, jk)
    np.testing.assert_array_equal(pay, jp)
    assert keys.dtype == jk.dtype and pay.dtype == jp.dtype


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.top_k_big_distributed).parameters
    tp = inspect.signature(td.top_k_big_distributed).parameters
    assert list(tp) == list(jp)
    for name, p in jp.items():
        assert tp[name].default == p.default, name
