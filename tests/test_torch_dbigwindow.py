"""tpu_qe_torch.ops.dbigwindow on a LocalMesh of the CPU: every test of
tests/test_dbigwindow.py at the reference's mesh sizes and inputs, against
the single-device operator's numpy oracle (tests/test_bigwindow.py's);
then window_big_distributed against tpu_qe.ops.dbigwindow on the same
configuration at D = 2 and 8 (every row and window column and every check,
bit for bit), the shard carries of the pre-pass against the carries a
sequential sweep gives, and the summary's edge rows."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.dbigwindow")
td = importlib.import_module("tpu_qe_torch.ops.dbigwindow")
tw = importlib.import_module("tpu_qe_torch.ops.bigwindow")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.sort.dbigsort import (bucket_cols,  # noqa: E402
                                        exchange_runs, segment_plan)

from test_bigwindow import _oracle  # noqa: E402  (same data model)

COLS = ("key", "order", "idx", "value", "rn", "rk", "cum", "lg")
CHECKS = ("n", "partitions", "sorted_ok", "hash_ok", "window_ok",
          "count_ok", "boundary_ok")


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


@functools.lru_cache(maxsize=None)
def _want(n, parts):
    return _oracle(n, parts)


# ---------------------------------------------- tests/test_dbigwindow.py

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_matches_oracle(n_dev):
    n, run_size, parts = 1 << 14, 1 << 11, 64
    res, got = td.window_big_distributed(
        n, _mesh(n_dev), partitions=parts, run_size=run_size,
        buckets_per_dev=2, collect=True, force_composed=(n_dev == 1))
    assert res.all_ok, res
    want = _want(n, parts)
    for nm in COLS:
        np.testing.assert_array_equal(got[nm], want[nm], err_msg=nm)


def test_one_partition_spans_every_device_and_bucket():
    # one partition split over every shard and bucket by the composite
    # splitters: both carry levels (the shards' chain and the rounds')
    # must compose it
    n = 1 << 13
    res, got = td.window_big_distributed(
        n, _mesh(8), partitions=1, run_size=1 << 10, buckets_per_dev=2,
        collect=True)
    assert res.all_ok, res
    want = _want(n, 1)
    for nm in ("rn", "rk", "cum", "lg"):
        np.testing.assert_array_equal(got[nm], want[nm], err_msg=nm)
    # the exact u64 running sum passes 2^32 within the partition
    assert got["cum"][-1] == got["value"].astype(np.uint64).sum()
    assert got["cum"][-1] > (1 << 32)


def test_device_checks_without_collect():
    res = td.window_big_distributed(1 << 14, _mesh(4), partitions=256,
                                    run_size=1 << 11, buckets_per_dev=2)
    assert res.all_ok, res


def test_d1_delegates_and_composed_path_agrees():
    n, parts = 1 << 13, 32
    res_d, got_d = td.window_big_distributed(
        n, _mesh(1), partitions=parts, run_size=1 << 11, buckets_per_dev=4,
        collect=True)
    res_c, got_c = td.window_big_distributed(
        n, _mesh(1), partitions=parts, run_size=1 << 11, buckets_per_dev=4,
        collect=True, force_composed=True)
    assert res_d.all_ok and res_c.all_ok
    for nm in COLS:
        np.testing.assert_array_equal(got_c[nm], got_d[nm], err_msg=nm)


# ------------------------------------------------------------ the port

def test_dry_run_step():
    # __graft_entry__'s step: 8 x 2 x 2048 rows, 16 hot partitions that
    # span every shard; rn and the exact running sum against numpy
    n, parts = 8 * 2 * 2048, 16
    st = {}
    res, got = td.window_big_distributed(n, _mesh(8), partitions=parts,
                                         run_size=2048, buckets_per_dev=2,
                                         collect=True, stats=st)
    assert res.all_ok, res
    key, order, val = tw.rows_numpy(np.arange(n, dtype=np.uint32), parts)
    perm = np.lexsort((np.arange(n), order, key))
    sk, sv = key[perm], val[perm].astype(np.uint64)
    new = np.r_[True, sk[1:] != sk[:-1]]
    i = np.arange(n)
    ps = np.maximum.accumulate(np.where(new, i, 0))
    np.testing.assert_array_equal(got["rn"], (i - ps + 1).astype(np.uint32))
    cs = np.cumsum(sv)
    np.testing.assert_array_equal(got["cum"], cs - np.r_[0, cs[:-1]][ps])
    assert sum(st["shard_rows"]) == n and len(st["shard_rows"]) == 8


@pytest.mark.parametrize("parts", [1, 3, 64])
def test_shard_carries_equal_a_sweep(parts):
    # the pre-pass chain gives shard t the carry that a window over the
    # sorted rows of shards 0..t-1 leaves: run the whole chain through
    # window_core and compare
    n, n_dev = 1 << 13, 4
    mesh = _mesh(n_dev)
    runs = td._runs(mesh, n // n_dev, 2, 1024, parts, 7)
    bounds = td._plan(mesh, runs, n_dev, 1024)
    pos, bs, bz, seg, cb, co = segment_plan(bounds, 1024, 1)
    blocks = exchange_runs(mesh, runs, bs, bz, cb, co, td._FILLS)
    sizes = torch.from_numpy(np.ascontiguousarray(
        bz.transpose(2, 1, 0)))
    chain = td._carry_chain(mesh.all_gather(td._summaries(blocks, sizes))[
        0].reshape(n_dev, -1))
    carry = torch.zeros(tw.N_CARRY, dtype=torch.int64)
    for t in range(n_dev):
        np.testing.assert_array_equal(chain[t].numpy(), carry.numpy(),
                                      err_msg=f"shard {t}")
        cols, count = bucket_cols(blocks, t, pos[:, :, t] - bs[:, :, t],
                                  seg[:, :, t], td._FILLS)
        lo, hi, o, idx, v = cols
        srt = tw.sort_planes([hi, lo, o, idx, v], 3)
        _, carry, _ = tw.window_core(*srt, count, carry, parts, 7)


# ------------------------------------------ against tpu_qe's dbigwindow

@functools.lru_cache(maxsize=None)
def _jax(n_dev, n, rs, parts, b):
    return jd.window_big_distributed(n, _jmesh(n_dev), partitions=parts,
                                     run_size=rs, buckets_per_dev=b,
                                     collect=True)


@pytest.mark.parametrize("n_dev,n,rs,parts,b", [
    (2, 1 << 13, 1 << 10, 16, 2),
    (8, 1 << 13, 1 << 9, 1, 3),
])
def test_matches_jax(n_dev, n, rs, parts, b):
    jres, jgot = _jax(n_dev, n, rs, parts, b)
    res, got = td.window_big_distributed(n, _mesh(n_dev), partitions=parts,
                                         run_size=rs, buckets_per_dev=b,
                                         collect=True)
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    for nm in COLS:
        np.testing.assert_array_equal(got[nm], jgot[nm], err_msg=nm)
        assert got[nm].dtype == jgot[nm].dtype, nm


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.window_big_distributed).parameters
    tp = inspect.signature(td.window_big_distributed).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
