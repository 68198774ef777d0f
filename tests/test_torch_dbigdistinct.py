"""tpu_qe_torch.ops.dbigdistinct on a LocalMesh of the CPU: every test of
tests/test_dbigdistinct.py at the reference's mesh sizes and inputs,
against the numpy data-model oracle and the port's single-device
count_distinct_big; then count_distinct_big_distributed against
tpu_qe.ops.dbigdistinct on the same configuration at D = 2 and 8 (the
collect=True tables, every check and the overflow flag, bit for bit)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigdistinct")
td = importlib.import_module("tpu_qe_torch.ops.dbigdistinct")
tb = importlib.import_module("tpu_qe_torch.ops.bigdistinct")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

FIELDS = ("n", "n_groups", "n_values", "n_dev", "n_runs", "num_groups",
          "groups_ok", "cd_ok", "cnt_ok", "keys_ok", "overflow")


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


def _oracle(n, g, v):
    keys, vals = tb.rows_of_index_numpy(np.arange(n, dtype=np.uint32), g, v)
    out = {}
    for k in np.unique(keys):
        sel = keys == k
        out[int(k)] = (len(np.unique(vals[sel])), int(sel.sum()))
    return out


def _table_dict(table):
    return {int(k): (int(cd), int(c))
            for k, cd, c in zip(table["key"], table["count_distinct"],
                                table["count"])}


# --------------------------------------------- tests/test_dbigdistinct.py

@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("g,v", [(16, 4), (64, 1000)])
def test_matches_oracle(n_dev, g, v):
    n, rs = 1 << 13, 1 << 10
    res = td.count_distinct_big_distributed(
        n, _mesh(n_dev), n_groups=g, n_values=v, run_size=rs, collect=True,
        capacity_factor=float(n_dev))
    assert res.all_ok, res
    assert _table_dict(res.table) == _oracle(n, g, v)


def test_matches_singlechip_and_d1_delegates():
    n, rs = 1 << 12, 1 << 10
    res1 = td.count_distinct_big_distributed(n, _mesh(1), n_groups=32,
                                             n_values=8, run_size=rs,
                                             collect=True)
    single = tb.count_distinct_big(n, n_groups=32, n_values=8, run_size=rs,
                                   collect=True, device="cpu")
    assert res1.all_ok and single.all_ok
    assert _table_dict(res1.table) == _table_dict(single.table)
    res8 = td.count_distinct_big_distributed(n * 2, _mesh(8), n_groups=32,
                                             n_values=8, run_size=rs // 4,
                                             collect=True,
                                             capacity_factor=8.0)
    assert res8.all_ok
    assert _table_dict(res8.table) == _oracle(n * 2, 32, 8)


def test_one_group_all_devices():
    n, rs = 1 << 13, 1 << 10
    res = td.count_distinct_big_distributed(n, _mesh(8), n_groups=1,
                                            n_values=100, run_size=rs,
                                            collect=True,
                                            capacity_factor=8.0)
    assert res.all_ok
    assert _table_dict(res.table) == {0: (100, n)}


def test_non_dividing_groups_exact():
    n, rs = 1 << 12, 1 << 10
    res = td.count_distinct_big_distributed(n, _mesh(4), n_groups=7,
                                            n_values=3, run_size=rs,
                                            collect=True,
                                            capacity_factor=4.0)
    assert res.all_ok
    assert _table_dict(res.table) == _oracle(n, 7, 3)


# ------------------------------------------------------------ the port

def test_1dev_forced_composed_and_stats(monkeypatch):
    monkeypatch.setattr(tb, "count_distinct_big", None)
    st = {}
    res = td.count_distinct_big_distributed(
        1 << 12, _mesh(1), n_groups=7, n_values=3, run_size=1 << 10,
        collect=True, force_composed=True, stats=st)
    assert res.all_ok and res.n_dev == 1
    assert _table_dict(res.table) == _oracle(1 << 12, 7, 3)
    assert st == {"shard_pairs": [21]}


def test_dedup_sorted_is_a_compaction():
    # a sorted stream with pads behind: each distinct pair once, in order,
    # with its occurrences; pads (key all ones) contribute nothing
    g = torch.tensor([1, 1, 1, 2, 5, 5, -1, -1], dtype=torch.int32)
    v = torch.tensor([0, 0, 3, 3, 1, 1, 0, 0], dtype=torch.int32)
    occ = torch.tensor([2, 1, 4, 1, 1, 7, 0, 0], dtype=torch.int32)
    klo, val, o, m = td._dedup_sorted(g, v, occ)
    assert int(m) == 4
    assert klo.tolist() == [1, 1, 2, 5, -1, -1, -1, -1]
    assert val.tolist() == [0, 3, 3, 1, 0, 0, 0, 0]
    assert o.tolist() == [3, 4, 1, 8, 0, 0, 0, 0]
    klo, _, o, m = td._dedup_sorted(g, v)
    assert int(m) == 4 and o.tolist()[:4] == [2, 1, 1, 2]


# ------------------------------------- against tpu_qe's dbigdistinct

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n, g, v, rs, cf):
    return jd.count_distinct_big_distributed(
        n, _jmesh(n_dev), n_groups=g, n_values=v, run_size=rs, collect=True,
        capacity_factor=cf)


@pytest.mark.parametrize("n_dev,n,g,v,rs,cf", [
    (2, 1 << 13, 16, 4, 1 << 10, 2.0),
    (8, 1 << 13, 64, 1000, 1 << 10, 8.0),
    (8, 1 << 14, 1 << 10, 4, 1 << 10, 2.0),
    (4, 1 << 12, 1 << 10, 4, 1 << 10, 0.05),     # the exchange overflows
])
def test_matches_jax(n_dev, n, g, v, rs, cf):
    want = _jax(n_dev, n, g, v, rs, cf)
    got = td.count_distinct_big_distributed(
        n, _mesh(n_dev), n_groups=g, n_values=v, run_size=rs, collect=True,
        capacity_factor=cf)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.overflow == (cf < 1)
    for k in want.table:
        np.testing.assert_array_equal(got.table[k], want.table[k], err_msg=k)


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.count_distinct_big_distributed).parameters
    tp = inspect.signature(td.count_distinct_big_distributed).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
    assert list(td.DistBigDistinctResult.__dataclass_fields__) == list(
        jd.DistBigDistinctResult.__dataclass_fields__)
