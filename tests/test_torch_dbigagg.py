"""tpu_qe_torch.ops.dbigagg on a LocalMesh of the CPU: every test of
tests/test_dbigagg.py at the reference's mesh sizes and inputs, against
the port's single-device aggregate_big (bit for bit) and numpy; then
aggregate_big_distributed against tpu_qe.ops.dbigagg on the same
configuration at D = 2 and 8 (the collect=True tables and every check, bit
for bit), and per-run checkpoints that cross between the packages."""

import functools
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigagg")
td = importlib.import_module("tpu_qe_torch.ops.dbigagg")
tb = importlib.import_module("tpu_qe_torch.ops.bigagg")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

CHECKS = ("n", "n_groups", "count_ok", "sum_ok", "keys_ok", "groups_ok",
          "minmax_ok")


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


def _single(n, **kw):
    return tb.aggregate_big(n, collect=True, device="cpu", **kw)


def _same_tables(a, b):
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


# ------------------------------------------------- tests/test_dbigagg.py

@pytest.mark.parametrize("n_dev,n,n_groups,run_size", [
    (1, 1 << 14, 1 << 9, 1 << 12),     # D = 1 delegates to aggregate_big
    (2, 1 << 14, 1 << 9, 1 << 12),
    (4, 1 << 15, 1 << 10, 1 << 12),    # 8 runs across 4 shards
    (8, 1 << 15, 1 << 16, 1 << 12),    # more groups than rows per run
])
def test_matches_single_chip_bit_exact(n_dev, n, n_groups, run_size):
    res, table = td.aggregate_big_distributed(
        n, _mesh(n_dev), n_groups=n_groups, run_size=run_size, collect=True)
    assert res.all_ok, res
    res1, t1 = _single(n, n_groups=n_groups, run_size=run_size)
    assert res1.all_ok
    _same_tables(table, t1)
    assert res.n_groups == res1.n_groups


def test_minmax_matches_single_chip():
    res, table = td.aggregate_big_distributed(
        1 << 14, _mesh(4), n_groups=1 << 8, run_size=1 << 12, collect=True,
        minmax=True)
    assert res.all_ok and res.minmax_ok
    _, t1 = _single(1 << 14, n_groups=1 << 8, run_size=1 << 12, minmax=True)
    _same_tables(table, t1)


def test_1dev_forced_composed_matches(monkeypatch):
    # the composed machinery at D = 1 (an identity all_gather); the
    # single-device operator must not be reached
    monkeypatch.setattr(tb, "aggregate_big", None)
    res, table = td.aggregate_big_distributed(
        1 << 14, _mesh(1), n_groups=1 << 9, run_size=1 << 12, collect=True,
        force_composed=True)
    assert res.all_ok, res
    monkeypatch.undo()
    _, t1 = _single(1 << 14, n_groups=1 << 9, run_size=1 << 12)
    _same_tables(table, t1)


def test_single_group_adversarial():
    # every row in one group: each local table holds one valid row, and
    # the combine tree still gives the exact global count and sum
    n = 1 << 15
    res, table = td.aggregate_big_distributed(
        n, _mesh(8), n_groups=1, run_size=1 << 12, collect=True)
    assert res.all_ok, res
    assert res.n_groups == 1
    assert table["count"][0] == n
    assert int(table["sum"][0]) == n * (n - 1) // 2


def test_divisibility_asserts():
    with pytest.raises(AssertionError):
        td.aggregate_big_distributed(1 << 14, _mesh(8), run_size=1 << 12)


def test_checkpoint_resume_distributed(tmp_path, monkeypatch):
    """Killed between rounds: the round tables persist, and a restart
    loads them, computes only the missing rounds and gives the same
    table."""
    mesh = _mesh(4)
    n, g, rs = 1 << 14, 1 << 8, 1 << 11   # 2 rounds of 4-shard runs
    ckdir = str(tmp_path)
    want, wtab = td.aggregate_big_distributed(
        n, mesh, n_groups=g, run_size=rs, collect=True, force_composed=True)
    assert want.all_ok
    real_save = tb._run_ck_save
    calls = {"n": 0}

    def crashing_save(directory, r, meta, part):
        real_save(directory, r, meta, part)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(tb, "_run_ck_save", crashing_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        td.aggregate_big_distributed(n, mesh, n_groups=g, run_size=rs,
                                     checkpoint_dir=ckdir,
                                     force_composed=True)
    monkeypatch.setattr(tb, "_run_ck_save", real_save)
    assert os.listdir(ckdir) == ["bigagg_rund0.npz"]
    res, table = td.aggregate_big_distributed(
        n, mesh, n_groups=g, run_size=rs, collect=True,
        checkpoint_dir=ckdir, force_composed=True)
    assert res.all_ok
    _same_tables(table, wtab)


# ---------------------------------------------------- numpy's GROUP BY

def test_dry_run_step_against_numpy():
    # __graft_entry__'s step: 8 shards x 2 runs x 2048 rows, 512 groups,
    # min and max
    n, g = 8 * 2 * 2048, 512
    res, tbl = td.aggregate_big_distributed(n, _mesh(8), n_groups=g,
                                            run_size=2048, collect=True,
                                            minmax=True)
    assert res.all_ok, res
    idx = np.arange(n, dtype=np.uint32)
    gid = tb.group_of_index_numpy(idx, g)
    cnt = np.bincount(gid, minlength=g)
    sums = np.zeros(g, np.uint64)
    np.add.at(sums, gid, idx.astype(np.uint64))
    mn = np.full(g, 0xFFFFFFFF, np.uint32)
    mx = np.zeros(g, np.uint32)
    np.minimum.at(mn, gid, idx)
    np.maximum.at(mx, gid, idx)
    keep = cnt > 0
    np.testing.assert_array_equal(tbl["key"], np.flatnonzero(keep))
    np.testing.assert_array_equal(tbl["count"], cnt[keep])
    np.testing.assert_array_equal(tbl["sum"], sums[keep])
    np.testing.assert_array_equal(tbl["min"], mn[keep])
    np.testing.assert_array_equal(tbl["max"], mx[keep])


# ------------------------------------------- against tpu_qe's dbigagg

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n, g, run_size, minmax):
    return jd.aggregate_big_distributed(n, _jmesh(n_dev), n_groups=g,
                                        run_size=run_size, collect=True,
                                        minmax=minmax)


@pytest.mark.parametrize("n_dev,n,g,run_size,minmax", [
    (2, 1 << 14, 1 << 9, 1 << 12, True),
    (8, 1 << 15, 1 << 16, 1 << 12, False),
    (8, 1 << 15, 7, 1 << 11, True),
])
def test_matches_jax(n_dev, n, g, run_size, minmax):
    jres, jtab = _jax(n_dev, n, g, run_size, minmax)
    res, tab = td.aggregate_big_distributed(
        n, _mesh(n_dev), n_groups=g, run_size=run_size, collect=True,
        minmax=minmax)
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    _same_tables(tab, jtab)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    # run tables written by one package at D = 2 (one of two rounds, as a
    # stopped run leaves them) resume in the other, bit for bit
    n, g, rs = 1 << 14, 1 << 8, 1 << 12
    d = str(tmp_path)
    if writer == "jax":
        jd.aggregate_big_distributed(n, _jmesh(2), n_groups=g, run_size=rs,
                                     checkpoint_dir=d)
    else:
        td.aggregate_big_distributed(n, _mesh(2), n_groups=g, run_size=rs,
                                     checkpoint_dir=d)
    os.remove(os.path.join(d, "bigagg_rund1.npz"))
    if writer == "jax":
        res, tab = td.aggregate_big_distributed(
            n, _mesh(2), n_groups=g, run_size=rs, checkpoint_dir=d,
            collect=True)
    else:
        res, tab = jd.aggregate_big_distributed(
            n, _jmesh(2), n_groups=g, run_size=rs, checkpoint_dir=d,
            collect=True)
    assert res.all_ok
    _, want = _single(n, n_groups=g, run_size=rs)
    _same_tables(tab, want)
    assert sorted(os.listdir(d)) == ["bigagg_rund0.npz", "bigagg_rund1.npz"]
