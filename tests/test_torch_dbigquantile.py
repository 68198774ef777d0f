"""tpu_qe_torch.ops.dbigquantile on a LocalMesh of the CPU: every test of
tests/test_dbigquantile.py at the reference's mesh sizes and inputs,
against the regenerated-key numpy oracle and the port's single-device
quantile_big; then quantile_big_distributed and the CONT driver against
tpu_qe.ops.dbigquantile on the same configuration at D = 2 and 8 (values,
ranks and certificates, bit for bit)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigquantile")
td = importlib.import_module("tpu_qe_torch.ops.dbigquantile")
tq = importlib.import_module("tpu_qe_torch.ops.bigquantile")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.hashing import keygen_hash_numpy  # noqa: E402
from tpu_qe_torch.ops.quantile import canon_qs, disc_rank  # noqa: E402

QS = [0.0, 0.1, (1, 1), 0.99, 1.0]


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


def _oracle(n, key_bits, qs=QS):
    k = keygen_hash_numpy(np.arange(n, dtype=np.uint32), 7)
    if key_bits < 64:
        k = k & np.uint64((1 << key_bits) - 1)
    s = np.sort(k)
    return np.array([s[disc_rank(num, sh, n)] for num, sh in canon_qs(qs)],
                    dtype=np.uint64)


# -------------------------------------------- tests/test_dbigquantile.py

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_matches_oracle_and_singlechip(n_dev):
    n, rs = 1 << 13, 1 << 10
    res = td.quantile_big_distributed(n, QS, _mesh(n_dev), run_size=rs)
    assert res.all_ok and res.n_runs == n // rs
    np.testing.assert_array_equal(res.values, _oracle(n, 64))
    # the union of the shards' index ranges is [0, n): the single-device
    # operator's data
    single = tq.quantile_big(n, QS, run_size=rs, device="cpu")
    np.testing.assert_array_equal(res.values, single.values)


def test_duplicate_heavy_key_space():
    n, rs = 1 << 13, 1 << 10
    res = td.quantile_big_distributed(n, QS, _mesh(8), run_size=rs,
                                      key_bits=6)
    assert res.all_ok
    np.testing.assert_array_equal(res.values, _oracle(n, 6))


def test_shape_contract():
    with pytest.raises(AssertionError, match="multiple of devices"):
        td.quantile_big_distributed(1 << 12, [0.5], _mesh(8),
                                    run_size=1 << 10)


# ------------------------------------------------------------ the port

def test_dry_run_step():
    # __graft_entry__'s step: the median and p99 of 8 x 2 x 2048 keys
    n = 8 * 2 * 2048
    res = td.quantile_big_distributed(n, [(1, 1), 0.99], _mesh(8),
                                      run_size=2048)
    assert res.all_ok and res.n_runs == 16 and res.n_dev == 8
    s = np.sort(keygen_hash_numpy(np.arange(n, dtype=np.uint32), 7))
    assert res.values[0] == s[(n + 1) // 2 - 1]
    np.testing.assert_array_equal(res.values,
                                  _oracle(n, 64, [(1, 1), 0.99]))


def test_cont_matches_single_device():
    n, rs = 1 << 13, 1 << 10
    got = td.quantile_cont_big_distributed(n, [0.5, (3, 2), 0.99],
                                           _mesh(4), run_size=rs)
    want = tq.quantile_cont_big(n, [0.5, (3, 2), 0.99], run_size=rs,
                                device="cpu")
    assert got.all_ok and want.all_ok
    np.testing.assert_array_equal(got.lower, want.lower)
    np.testing.assert_array_equal(got.upper, want.upper)
    assert got.frac_num == want.frac_num and got.shifts == want.shifts


def test_a_wrong_rank_fails_the_certificate():
    # the certificate holds only for the value at the rank: a count that
    # no bit round can reach (rank n) must fail it
    res = td.quantile_big_distributed(1 << 12, None, _mesh(4),
                                      run_size=1 << 10, ranks=(0, 1 << 12))
    assert not res.cert_ok


# ---------------------------------------- against tpu_qe's dbigquantile

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n, rs, key_bits, cont):
    if cont:
        return jd.quantile_cont_big_distributed(n, QS, _jmesh(n_dev),
                                                run_size=rs,
                                                key_bits=key_bits)
    return jd.quantile_big_distributed(n, QS, _jmesh(n_dev), run_size=rs,
                                       key_bits=key_bits)


@pytest.mark.parametrize("n_dev,n,rs,key_bits,cont", [
    (2, 1 << 13, 1 << 10, 64, False),
    (8, 1 << 13, 1 << 10, 8, False),
    (8, 1 << 14, 1 << 10, 64, True),
])
def test_matches_jax(n_dev, n, rs, key_bits, cont):
    want = _jax(n_dev, n, rs, key_bits, cont)
    if cont:
        got = td.quantile_cont_big_distributed(n, QS, _mesh(n_dev),
                                               run_size=rs,
                                               key_bits=key_bits)
        np.testing.assert_array_equal(got.lower, want.lower)
        np.testing.assert_array_equal(got.upper, want.upper)
        assert got.frac_num == want.frac_num and got.shifts == want.shifts
    else:
        got = td.quantile_big_distributed(n, QS, _mesh(n_dev), run_size=rs,
                                          key_bits=key_bits)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.values.dtype == want.values.dtype
        assert got.ranks == want.ranks and got.n_dev == want.n_dev
    assert got.cert_ok == want.cert_ok and got.n_runs == want.n_runs


def test_defaults_are_the_reference_defaults():
    import inspect
    for name in ("quantile_big_distributed",
                 "quantile_cont_big_distributed"):
        jp = inspect.signature(getattr(jd, name)).parameters
        tp = inspect.signature(getattr(td, name)).parameters
        assert list(tp) == list(jp), name
        for p, q in jp.items():
            assert tp[p].default == q.default, (name, p)
