"""tpu_qe_torch.ops.dbigjoin on a LocalMesh of the CPU: every test of
tests/test_dbigjoin.py at the reference's mesh sizes and inputs (every
construction check on the device, the exact match count); then
join_big_distributed against tpu_qe.ops.dbigjoin on the same configuration
at D = 2 and 8 (every result field, the checkpointed plan and per-bucket
scalars of every shard, bit for bit), and checkpoints that cross between
the packages."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigjoin")
td = importlib.import_module("tpu_qe_torch.ops.dbigjoin")
tbj = importlib.import_module("tpu_qe_torch.ops.bigjoin")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

FIELDS = ("n_l", "n_r", "n_dev", "matched", "match_ok", "val_ok",
          "count_ok")


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


def _meta(n_l, n_r, n_dev, run_size, b):
    return np.asarray([n_l, n_r, n_dev, run_size, b, 7,
                       min(4096, run_size)], np.int64)


# ------------------------------------------------ tests/test_dbigjoin.py

@pytest.mark.parametrize("n_dev,n_l,n_r,b", [
    (1, 1 << 13, 1 << 13, 2),     # D = 1 delegates to join_big
    (2, 1 << 13, 1 << 13, 2),
    (4, 1 << 14, 1 << 12, 2),     # left-heavy (4 vs 1 runs a shard)
    (4, 1 << 12, 1 << 14, 3),     # right-heavy, odd bucket count
    (8, 1 << 14, 1 << 14, 2),
])
def test_join_big_distributed_all_checks(n_dev, n_l, n_r, b):
    res = td.join_big_distributed(n_l, n_r, _mesh(n_dev),
                                  run_size=min(n_l, n_r) // n_dev,
                                  buckets_per_dev=b)
    assert res.all_ok, res
    assert res.matched == (n_l + 1) // 2


def test_1dev_forced_composed_path(monkeypatch):
    monkeypatch.setattr(tbj, "join_big", None)
    res = td.join_big_distributed(1 << 13, 1 << 13, _mesh(1),
                                  run_size=1 << 11, buckets_per_dev=2,
                                  force_composed=True)
    assert res.all_ok, res
    assert res.matched == 1 << 12


def test_multiple_runs_per_device():
    # out of core per shard: 4 runs a shard a side
    res = td.join_big_distributed(1 << 14, 1 << 14, _mesh(2),
                                  run_size=1 << 11, buckets_per_dev=2)
    assert res.all_ok, res
    assert res.matched == 1 << 13


def test_divisibility_asserts():
    with pytest.raises(AssertionError):
        td.join_big_distributed(1 << 12, 1 << 13, _mesh(8),
                                run_size=1 << 11)


def test_checkpoint_resume(tmp_path, monkeypatch):
    mesh = _mesh(4)
    kw = dict(run_size=1 << 10, buckets_per_dev=3)
    n = 4 * 2 * (1 << 10)
    ckdir = str(tmp_path)
    want = td.join_big_distributed(n, n, mesh, **kw)
    assert want.all_ok
    real_record = td._DJoinState.record
    calls = {"n": 0}

    def crashing_record(self, b, vals):
        real_record(self, b, vals)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(td._DJoinState, "record", crashing_record)
    with pytest.raises(RuntimeError, match="simulated kill"):
        td.join_big_distributed(n, n, mesh, checkpoint_dir=ckdir, **kw)
    monkeypatch.setattr(td._DJoinState, "record", real_record)
    meta = _meta(n, n, 4, 1 << 10, 3)
    st = td._DJoinState.load(ckdir, meta)
    assert st is not None and int(st.done.sum()) == 1
    res = td.join_big_distributed(n, n, mesh, checkpoint_dir=ckdir, **kw)
    assert res.all_ok
    assert res.matched == want.matched
    st = td._DJoinState.load(ckdir, meta)
    assert int(st.done.sum()) == 3


# ------------------------------------------------------------ the port

def test_dry_run_step_and_stats():
    # __graft_entry__'s step: 8 shards x 2 runs x 2048 rows a side
    n = 8 * 2 * 2048
    st = {}
    res = td.join_big_distributed(n, n, _mesh(8), run_size=2048,
                                  buckets_per_dev=2, stats=st)
    assert res.all_ok and res.matched == (n + 1) // 2
    assert sum(st["shard_rows"]) == 2 * n and len(st["shard_rows"]) == 8


def test_aggregate_groups_tables():
    # one (S, partial_cap) 5-plane table per bucket round, padded as
    # bigagg pads (all-ones keys, zero counts and sums)
    res, tables = td.join_big_distributed(1 << 13, 1 << 13, _mesh(4),
                                          run_size=1 << 10,
                                          buckets_per_dev=2,
                                          aggregate_groups=64)
    assert res.all_ok and len(tables) == 2
    total = 0
    for t in tables:
        assert len(t) == 5 and all(p.shape == (4, 128) for p in t)
        pad = t[2] == 0
        assert (t[0][pad] == -1).all() and (t[3][pad] == 0).all()
        total += int(t[2].sum())
    assert total == res.matched
    with pytest.raises(AssertionError, match="checkpoint_dir"):
        td.join_big_distributed(1 << 13, 1 << 13, _mesh(4),
                                run_size=1 << 10, aggregate_groups=64,
                                checkpoint_dir="unused")


# -------------------------------------------- against tpu_qe's dbigjoin

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n_l, n_r, rs, b, ckdir):
    res = jd.join_big_distributed(n_l, n_r, _jmesh(n_dev), run_size=rs,
                                  buckets_per_dev=b, checkpoint_dir=ckdir)
    return res, jd._DJoinState.load(ckdir, _meta(n_l, n_r, n_dev, rs, b))


@pytest.mark.parametrize("n_dev,n_l,n_r,rs,b", [
    (2, 1 << 13, 1 << 13, 1 << 11, 2),
    (8, 1 << 14, 1 << 13, 1 << 10, 3),
])
def test_matches_jax(n_dev, n_l, n_r, rs, b, tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp(f"j{n_dev}"))
    tdir = str(tmp_path_factory.mktemp(f"t{n_dev}"))
    jres, jst = _jax(n_dev, n_l, n_r, rs, b, jdir)
    res = td.join_big_distributed(n_l, n_r, _mesh(n_dev), run_size=rs,
                                  buckets_per_dev=b, checkpoint_dir=tdir)
    for f in FIELDS:
        assert getattr(res, f) == getattr(jres, f), f
    st = td._DJoinState.load(tdir, _meta(n_l, n_r, n_dev, rs, b))
    np.testing.assert_array_equal(st.bounds, jst.bounds)
    np.testing.assert_array_equal(st.done, jst.done)
    np.testing.assert_array_equal(st.scalars, jst.scalars)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(writer, tmp_path, monkeypatch):
    # a run stopped after one of two bucket rounds at D = 2 resumes in the
    # other package with the same per-shard scalars as a whole run
    n, rs, b = 1 << 13, 1 << 11, 2
    meta = _meta(n, n, 2, rs, b)
    pkg, mesh = (jd, _jmesh(2)) if writer == "jax" else (td, _mesh(2))
    real = pkg._DJoinState.record

    def stop(self, bb, vals):
        real(self, bb, vals)
        raise RuntimeError("stopped")
    monkeypatch.setattr(pkg._DJoinState, "record", stop)
    with pytest.raises(RuntimeError, match="stopped"):
        pkg.join_big_distributed(n, n, mesh, run_size=rs, buckets_per_dev=b,
                                 checkpoint_dir=str(tmp_path))
    monkeypatch.setattr(pkg._DJoinState, "record", real)
    assert int(td._DJoinState.load(str(tmp_path), meta).done.sum()) == 1
    other, omesh = (td, _mesh(2)) if writer == "jax" else (jd, _jmesh(2))
    res = other.join_big_distributed(n, n, omesh, run_size=rs,
                                     buckets_per_dev=b,
                                     checkpoint_dir=str(tmp_path))
    assert res.all_ok and res.matched == n // 2
    (tmp_path / "whole").mkdir()
    td.join_big_distributed(n, n, _mesh(2), run_size=rs, buckets_per_dev=b,
                            checkpoint_dir=str(tmp_path / "whole"))
    a = td._DJoinState.load(str(tmp_path), meta)
    w = td._DJoinState.load(str(tmp_path / "whole"), meta)
    assert a.done.all()
    np.testing.assert_array_equal(a.scalars, w.scalars)
    np.testing.assert_array_equal(a.bounds, w.bounds)


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.join_big_distributed).parameters
    tp = inspect.signature(td.join_big_distributed).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
    assert list(td.DBigJoinResult.__dataclass_fields__) == list(
        jd.DBigJoinResult.__dataclass_fields__)
