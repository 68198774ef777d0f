"""tpu_qe_torch.ops.dbigpipe on a LocalMesh of the CPU: every test of
tests/test_dbigpipe.py at the reference's mesh sizes and inputs, against
bigjoin's data-model oracle in numpy and the port's single-device fused
pipeline; then join_aggregate_big_distributed against tpu_qe.ops.dbigpipe
on the same configuration at D = 2 and 8 (the collect=True table and every
check, bit for bit)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the JAX bucket partial's module constants must exist before the first
# shard_map trace that imports the module
importlib.import_module("tpu_qe.ops.bigpipe")
jd = importlib.import_module("tpu_qe.ops.dbigpipe")
td = importlib.import_module("tpu_qe_torch.ops.dbigpipe")
tp = importlib.import_module("tpu_qe_torch.ops.bigpipe")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.hashing import (keygen_hash_numpy,  # noqa: E402
                                  murmur_fmix32_numpy)

FIELDS = ("n_l", "n_r", "n_dev", "matched", "n_groups", "join_ok",
          "count_ok", "keys_ok")


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


def _oracle(n_l, n_r, n_groups):
    j = np.arange(n_l, dtype=np.uint32)
    i = (j * np.uint32(2654435761)) % np.uint32(n_r)
    lkeys = keygen_hash_numpy(i) & ~np.uint64(1)
    matched = (j % 2) == 0
    vals = murmur_fmix32_numpy(
        (lkeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ^ (lkeys >> np.uint64(32)).astype(np.uint32)
        ^ np.uint32(0xABCD1234)).astype(np.uint64)
    g = tp.group_of_join_key_numpy(lkeys, n_groups)
    cnt = np.zeros(n_groups, np.int64)
    np.add.at(cnt, g[matched], 1)
    sums = np.zeros(n_groups, np.uint64)
    np.add.at(sums, g[matched], vals[matched])
    keep = cnt > 0
    return (np.nonzero(keep)[0].astype(np.uint32),
            cnt[keep].astype(np.uint32), sums[keep])


# ------------------------------------------------ tests/test_dbigpipe.py

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_matches_oracle(n_dev):
    n, rs, g = 1 << 13, 1 << 10, 1 << 7
    res, table = td.join_aggregate_big_distributed(
        n, n, _mesh(n_dev), n_groups=g, run_size=rs, collect=True)
    assert res.all_ok, res
    wk, wc, ws = _oracle(n, n, g)
    np.testing.assert_array_equal(table["key"], wk)
    np.testing.assert_array_equal(table["count"], wc)
    np.testing.assert_array_equal(table["sum"], ws)     # exact u64


def test_matches_singlechip_fused():
    n, rs, g = 1 << 12, 1 << 10, 1 << 6
    res_d, t_d = td.join_aggregate_big_distributed(
        n, n, _mesh(4), n_groups=g, run_size=rs, collect=True)
    res_s, t_s = tp.join_aggregate_big(n, n, n_groups=g, n_buckets=4,
                                       collect=True, device="cpu")
    assert res_d.all_ok and res_s.all_ok
    for nm in ("key", "count", "sum"):
        np.testing.assert_array_equal(t_d[nm], t_s[nm], err_msg=nm)


def test_d1_delegates():
    n, rs = 1 << 12, 1 << 10
    res = td.join_aggregate_big_distributed(n, n, _mesh(1), n_groups=64,
                                            run_size=rs)
    assert isinstance(res, tp.BigPipeResult) and res.all_ok


def test_asymmetric_sides():
    rs = 1 << 10
    res, table = td.join_aggregate_big_distributed(
        1 << 13, 1 << 12, _mesh(4), n_groups=32, run_size=rs, collect=True)
    assert res.all_ok
    wk, wc, ws = _oracle(1 << 13, 1 << 12, 32)
    np.testing.assert_array_equal(table["key"], wk)
    np.testing.assert_array_equal(table["sum"], ws)


# ------------------------------------------------------------ the port

def test_1dev_forced_composed(monkeypatch):
    monkeypatch.setattr(tp, "join_aggregate_big", None)
    n, rs, g = 1 << 12, 1 << 10, 1 << 6
    st = {}
    res, table = td.join_aggregate_big_distributed(
        n, n, _mesh(1), n_groups=g, run_size=rs, collect=True,
        force_composed=True, stats=st)
    assert res.all_ok and res.n_dev == 1
    wk, wc, ws = _oracle(n, n, g)
    np.testing.assert_array_equal(table["sum"], ws)
    assert st["shard_rows"] == [2 * n]


# -------------------------------------------- against tpu_qe's dbigpipe

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n_l, n_r, g, rs):
    return jd.join_aggregate_big_distributed(n_l, n_r, _jmesh(n_dev),
                                             n_groups=g, run_size=rs,
                                             collect=True)


@pytest.mark.parametrize("n_dev,n_l,n_r,g,rs", [
    (2, 1 << 13, 1 << 13, 1 << 7, 1 << 10),
    (8, 1 << 13, 1 << 12, 1 << 14, 1 << 9),
])
def test_matches_jax(n_dev, n_l, n_r, g, rs):
    jres, jtab = _jax(n_dev, n_l, n_r, g, rs)
    res, tab = td.join_aggregate_big_distributed(
        n_l, n_r, _mesh(n_dev), n_groups=g, run_size=rs, collect=True)
    for f in FIELDS:
        assert getattr(res, f) == getattr(jres, f), f
    for k in jtab:
        np.testing.assert_array_equal(tab[k], jtab[k], err_msg=k)
        assert tab[k].dtype == jtab[k].dtype, k


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.join_aggregate_big_distributed).parameters
    tq = inspect.signature(td.join_aggregate_big_distributed).parameters
    for name, p in jp.items():
        assert tq[name].default == p.default, name
    assert list(td.DBigPipeResult.__dataclass_fields__) == list(
        jd.DBigPipeResult.__dataclass_fields__)
