"""tpu_qe_torch.exchange.dorderby on a LocalMesh of the CPU: every test of
tests/test_dorderby.py and
tests/test_fuzz_ops.py::test_fuzz_distributed_orderby_quantile, each
against the port's in-core sort_by_multi (and numpy's sort for the
quantiles), at the reference's inputs and mesh sizes (bit for bit). Then
distributed_order_by_numpy against tpu_qe.exchange.dorderby on the same
inputs at D = 2 and 8 (bit for bit, the position witness too), with keys
and values that straddle 2^31 and an all-ones key, the capacity plan
against the reference's, and positions moved across 2^31."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jo = importlib.import_module("tpu_qe.exchange.dorderby")
to = importlib.import_module("tpu_qe_torch.exchange.dorderby")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.ops.orderby import sort_by_multi  # noqa: E402
from tpu_qe_torch.table import Table  # noqa: E402


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


def _cols(rng, n):
    return {
        "a": rng.integers(0, 12, n).astype(np.uint64) << np.uint64(35),
        "b": rng.integers(-40, 40, n, dtype=np.int64).astype(np.int32),
        "f": rng.standard_normal(n).astype(np.float32),
        "pay": np.arange(n, dtype=np.uint32),
    }


def _incore(cols, by):
    return sort_by_multi(Table.from_numpy(cols, "cpu"), by).to_numpy()


# ------------------------------------------------- tests/test_dorderby.py

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_matches_incore(n_dev):
    rng = np.random.default_rng(n_dev)
    n = 1 << 12
    cols = _cols(rng, n)
    by = [("a", "desc"), "b", ("f", "desc")]
    got, pos = to.distributed_order_by_numpy(cols, by, _mesh(n_dev),
                                             capacity_factor=float(n_dev))
    want = _incore(cols, by)
    for nm in cols:
        np.testing.assert_array_equal(got[nm], want[nm], err_msg=nm)
    # the position witness reproduces the permutation exactly
    for nm in cols:
        np.testing.assert_array_equal(cols[nm][pos], want[nm])


def test_auto_capacity_hot_key_skew():
    rng = np.random.default_rng(9)
    n = 1 << 13
    cols = _cols(rng, n)
    cols["a"][:] = 7  # one key value: splitters must split by position
    got, _ = to.distributed_order_by_numpy(cols, ["a", ("b", "desc")],
                                           _mesh(8), capacity_factor="auto")
    want = _incore(cols, ["a", ("b", "desc")])
    for nm in cols:
        np.testing.assert_array_equal(got[nm], want[nm], err_msg=nm)


def test_stability_across_devices():
    rng = np.random.default_rng(3)
    n = 1 << 10
    cols = {"k": rng.integers(0, 3, n).astype(np.uint64),
            "i": np.arange(n, dtype=np.uint32)}
    got, pos = to.distributed_order_by_numpy(cols, ["k"], _mesh(4),
                                             capacity_factor=4.0)
    # ties keep global input order: i strictly increases within a key
    k, i = got["k"], got["i"]
    same = k[1:] == k[:-1]
    assert (i[1:][same] > i[:-1][same]).all()
    np.testing.assert_array_equal(i, pos.astype(np.uint32))


# ---------------- tests/test_fuzz_ops.py::test_fuzz_distributed_orderby_*

def _keys(rng, n):
    """Random keys with randomized skew and width (test_fuzz_ops._keys)."""
    style = rng.integers(0, 4)
    if style == 0:    # uniform 64-bit
        return rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if style == 1:    # few distinct values (heavy duplicates)
        k = int(rng.integers(1, 20))
        return rng.integers(0, k, n).astype(np.uint64) * np.uint64(0x9E37)
    if style == 2:    # zipf
        return (rng.zipf(1.3, n).astype(np.uint64)
                * np.uint64(0x9E3779B97F4A7C15))
    # boundary-heavy: zeros and all-ones mixed with uniform
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    k[rng.random(n) < 0.1] = 0
    k[rng.random(n) < 0.1] = np.uint64((1 << 64) - 1)
    return k


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_distributed_orderby_quantile(trial):
    from tpu_qe_torch.exchange.dquantile import distributed_quantile_numpy
    from tpu_qe_torch.ops.quantile import canon_qs, disc_rank
    rng = np.random.default_rng(7000 + trial)
    n_dev = int(rng.choice([2, 4, 8]))
    mesh = _mesh(n_dev)
    n = int(rng.integers(2, 60)) * n_dev * 8
    cols = {"k": _keys(rng, n),
            "b": rng.integers(-(1 << 10), 1 << 10, n,
                              dtype=np.int64).astype(np.int32),
            "i": np.arange(n, dtype=np.uint32)}
    by = [("k", rng.choice(["asc", "desc"])),
          ("b", rng.choice(["asc", "desc"]))]
    cf = "auto" if trial % 2 == 0 else float(n_dev)
    got, pos = to.distributed_order_by_numpy(cols, by, mesh,
                                             capacity_factor=cf)
    want = _incore(cols, by)
    for nm in cols:
        np.testing.assert_array_equal(got[nm], want[nm],
                                      err_msg=f"{trial} {nm} {by}")
    qs = sorted(rng.uniform(0, 1, int(rng.integers(1, 4))).tolist())
    gq = distributed_quantile_numpy(cols["k"], qs, mesh)
    s = np.sort(cols["k"])
    for g, (num, sh) in zip(gq, canon_qs(qs)):
        assert g == s[disc_rank(num, sh, n)], (trial, num, sh)


# --------------------------------------------- against tpu_qe's dorderby

def _straddle_case(seed):
    rng = np.random.default_rng(seed)
    n = 1 << 11
    cols = {
        "k": rng.integers(0, 9, n).astype(np.uint64)
        + np.uint64((1 << 63) - 4),
        "u": (rng.integers(-4, 4, n) + (1 << 31)).astype(np.uint32),
        "s": rng.integers(-(1 << 31), (1 << 31) - 1, n,
                          dtype=np.int64).astype(np.int32),
        "f": rng.standard_normal(n).astype(np.float32),
        "p": rng.integers(0, 1 << 64, n, dtype=np.uint64),
    }
    cols["k"][::97] = np.uint64((1 << 64) - 1)       # all-ones keys
    cols["u"][::13] = np.uint32(0xFFFFFFFF)
    return cols


BY = [("k", "desc"), "u", ("s", "asc"), ("f", "desc")]


@functools.lru_cache(maxsize=None)
def _jax_answer(n_dev, seed):
    return jo.distributed_order_by_numpy(_straddle_case(seed), BY,
                                         _jmesh(n_dev),
                                         capacity_factor="auto")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_order_by_matches_jax(n_dev):
    cols = _straddle_case(n_dev)
    got, pos = to.distributed_order_by_numpy(cols, BY, _mesh(n_dev),
                                             capacity_factor="auto")
    want, wpos = _jax_answer(n_dev, n_dev)
    for nm in cols:
        np.testing.assert_array_equal(got[nm], want[nm], err_msg=nm)
    np.testing.assert_array_equal(pos, np.asarray(wpos))
    assert pos.dtype == np.asarray(wpos).dtype == np.uint32
    perm = np.lexsort((np.arange(len(pos)), -cols["f"].astype(np.float64),
                       cols["s"], cols["u"], ~cols["k"]))
    np.testing.assert_array_equal(pos, perm)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_plan_matches_jax(n_dev):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpu_qe.table import Table as JTable
    cols = _straddle_case(n_dev)
    jmesh = _jmesh(n_dev)
    sh = NamedSharding(jmesh, P("x"))
    jt = jax.tree.map(lambda c: jax.device_put(c, sh),
                      JTable.from_numpy(cols))
    want = int(np.asarray(jo.plan_order_by_capacity(jt, BY, jmesh)).max())
    got = to.plan_order_by_capacity(to.shard_table(cols, _mesh(n_dev)), BY,
                                    _mesh(n_dev))
    assert int(got.max()) == want
    assert got.shape == (n_dev,) and bool((got == got[0]).all())


def test_positions_straddling_2_31(monkeypatch):
    # the position plane orders as u32: move every global position up
    # by 2^31 - 1000 so that they cross the sign bit of the int32 plane
    from tpu_qe_torch.bits import narrow, widen
    off = (1 << 31) - 1000
    real = to._global_pos
    monkeypatch.setattr(to, "_global_pos", lambda mesh, n_local, device:
                        narrow(widen(real(mesh, n_local, device)) + off))
    rng = np.random.default_rng(5)
    n = 1 << 11
    cols = {"k": rng.integers(0, 5, n).astype(np.uint64),
            "i": np.arange(n, dtype=np.uint32)}
    mesh = _mesh(8)
    st, pos, valid, ovf = to.distributed_order_by(
        to.shard_table(cols, mesh), ["k"], mesh, capacity_factor=8.0)
    assert not int(ovf.max())
    got_pos = np.concatenate([pos[d, :int(v)].numpy()
                              for d, v in enumerate(valid)]) - off
    perm = np.argsort(cols["k"], kind="stable")
    np.testing.assert_array_equal(got_pos, perm)
    got_i = np.concatenate([st["i"][d, :int(v)].view(torch.int32).numpy()
                            for d, v in enumerate(valid)])
    np.testing.assert_array_equal(got_i, perm)


def test_runs_hold_the_pad_rows_after_the_real_ones():
    # each shard's run: its valid prefix, then all-ones keys and position
    # and zero payloads
    rng = np.random.default_rng(11)
    n = 1 << 10
    cols = {"k": rng.integers(0, 1 << 64, n, dtype=np.uint64),
            "v": np.arange(n, dtype=np.uint32) + 1}
    mesh = _mesh(4)
    st, pos, valid, _ = to.distributed_order_by(
        to.shard_table(cols, mesh), ["k"], mesh, capacity_factor=4.0)
    assert int(valid.sum()) == n and pos.shape[1] == int(valid.max())
    for d, v in enumerate(valid.tolist()):
        assert (st["k"].lo[d, v:] == -1).all()
        assert (st["k"].hi[d, v:] == -1).all()
        assert (pos[d, v:] == 0xFFFFFFFF).all()
        assert (st["v"].view(torch.int32)[d, v:] == 0).all()
