"""tpu_qe_torch.exchange.dquantile on a LocalMesh of the CPU: every test of
tests/test_dquantile.py and the distributed cases of
tests/test_quantile_cont.py (`:126-176`), each against numpy or the
port's in-core operator at the reference's inputs and mesh sizes (bit for
bit; the float32 interpolations of CONT equal the in-core ones bit for
bit). Then each public function against tpu_qe.exchange.dquantile on the
same inputs at D = 2 and 8: values, counts, group keys, fractions and
float32 interpolations bit for bit, with values that straddle 2^31 and an
all-ones value. One case holds the port to numpy where the reference
drops a group: a real all-ones group key (ROADMAP Queue C)."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jq = importlib.import_module("tpu_qe.exchange.dquantile")
tq = importlib.import_module("tpu_qe_torch.exchange.dquantile")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.exchange.dsort import shard_column  # noqa: E402
from tpu_qe_torch.ops.quantile import (canon_qs, disc_rank,  # noqa: E402
                                       group_quantile, group_quantile_cont,
                                       quantile_cont)
from tpu_qe_torch.table import column_to_numpy  # noqa: E402

QS = [0.0, 0.25, 0.5, (9, 4), 0.99, 1.0]
CQS = [0.0, 0.25, (1, 1), 0.75, 0.9, 1.0]


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


def _oracle(vals, qs):
    s = np.sort(vals)
    return np.array([s[disc_rank(num, sh, len(vals))]
                     for num, sh in canon_qs(qs)], dtype=vals.dtype)


def _col(vals):
    return (U64.from_numpy(vals, "cpu") if vals.dtype == np.uint64 else
            shard_column(vals, tm.LocalMesh(1, "cpu"))[0])


# ------------------------------------------------ tests/test_dquantile.py

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_u64_matches_oracle(n_dev):
    rng = np.random.default_rng(n_dev)
    vals = rng.integers(0, 1 << 64, 1 << 12, dtype=np.uint64)
    got = tq.distributed_quantile_numpy(vals, QS, _mesh(n_dev))
    np.testing.assert_array_equal(got, _oracle(vals, QS))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_scalar_dtypes(dtype):
    rng = np.random.default_rng(7)
    if dtype == np.float32:
        vals = rng.standard_normal(1 << 12).astype(np.float32)
    else:
        vals = rng.integers(-9999 if dtype == np.int32 else 0, 9999,
                            1 << 12, dtype=np.int64).astype(dtype)
    got = tq.distributed_quantile_numpy(vals, QS, _mesh(8))
    np.testing.assert_array_equal(got, _oracle(vals, QS))
    assert got.dtype == dtype


def test_duplicates_and_extremes():
    # heavy duplicates + boundary values: the greedy must land on an
    # element, 0 and all-ones included
    vals = np.concatenate([
        np.zeros(100, np.uint64),
        np.full(100, 7, np.uint64),
        np.full(50, (1 << 64) - 1, np.uint64),
        np.arange(6, dtype=np.uint64) * np.uint64(1 << 40)]).astype(np.uint64)
    mesh = _mesh(4)
    got = tq.distributed_quantile_numpy(vals, QS, mesh)
    np.testing.assert_array_equal(got, _oracle(vals, QS))
    same = np.full(1 << 10, 42, dtype=np.uint64)
    got = tq.distributed_quantile_numpy(same, [0.0, 0.5, 1.0], mesh)
    assert (got == 42).all()


def test_median_is_global_not_per_shard():
    # shard d holds only the value d: every shard's local median differs
    # from the global one
    vals = np.repeat(np.arange(8, dtype=np.uint64), 128)
    got = tq.distributed_quantile_numpy(vals, [(1, 1)], _mesh(8))
    s = np.sort(vals)
    assert got[0] == s[(len(vals) + 1) // 2 - 1]


def _incore_groups(keys, vals, qs):
    res = group_quantile(U64.from_numpy(keys, "cpu"), _col(vals), qs)
    ng = int(res.num_groups)
    q = column_to_numpy(res.quantiles)[:, :ng]
    return {int(k): list(q[:, i])
            for i, k in enumerate(res.key.to_numpy()[:ng])}


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_group_quantile_matches_incore(n_dev):
    rng = np.random.default_rng(100 + n_dev)
    n = 1 << 12
    keys = rng.integers(0, 30, n).astype(np.uint64) << np.uint64(33)
    vals = rng.integers(-500, 500, n, dtype=np.int64).astype(np.int32)
    got = tq.distributed_group_quantile_numpy(keys, vals, QS, _mesh(n_dev),
                                              max_groups=64)
    assert got == _incore_groups(keys, vals, QS)


def test_group_quantile_overflow_detected():
    n = 1 << 10
    keys = np.arange(n, dtype=np.uint64)  # n distinct > max_groups
    vals = np.zeros(n, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="max_groups"):
        tq.distributed_group_quantile_numpy(keys, vals, [0.5], _mesh(4),
                                            max_groups=16)
    with pytest.raises(tq.QuantileOverflow):
        tq.distributed_group_quantile_numpy(keys, vals, [0.5], _mesh(4),
                                            max_groups=16)


def test_group_quantile_single_group_spanning_mesh():
    n = 1 << 11
    keys = np.full(n, 9, dtype=np.uint64)
    vals = np.arange(n, dtype=np.int64).astype(np.uint32)
    got = tq.distributed_group_quantile_numpy(keys, vals, [(1, 1)],
                                              _mesh(8), max_groups=8)
    assert got == {9: [np.uint32((n + 1) // 2 - 1)]}


# ------------------------- tests/test_quantile_cont.py, distributed cases

def test_distributed_global_bit_identical_to_incore():
    rng = np.random.default_rng(4)
    vals = rng.normal(0, 100, 1 << 12).astype(np.float32)
    inc = quantile_cont(torch.from_numpy(vals), CQS)
    res = tq.distributed_quantile_cont_numpy(vals, CQS, _mesh(8))
    assert torch.equal(res.lower, inc.lower)
    assert torch.equal(res.upper, inc.upper)
    assert torch.equal(res.value, inc.value)
    assert res.frac_num == inc.frac_num and res.shifts == inc.shifts


def test_distributed_global_u64():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 60, 1 << 10, dtype=np.uint64)
    inc = quantile_cont(U64.from_numpy(vals, "cpu"), [0.5, 0.99])
    res = tq.distributed_quantile_cont_numpy(vals, [0.5, 0.99], _mesh(4))
    np.testing.assert_array_equal(res.lower.to_numpy(), inc.lower.to_numpy())
    np.testing.assert_array_equal(res.upper.to_numpy(), inc.upper.to_numpy())
    assert res.value is None


def test_distributed_group_cont_matches_incore():
    mesh = _mesh(8)
    rng = np.random.default_rng(6)
    n, g = 1 << 12, 13
    keys = rng.integers(0, g, n).astype(np.uint64)
    vals = rng.normal(0, 50, n).astype(np.float32)
    inc = group_quantile_cont(U64.from_numpy(keys, "cpu"),
                              torch.from_numpy(vals), [0.25, 0.9])
    gk, lower, upper, frac, shifts, val, cnt, ng, ovf = \
        tq.distributed_group_quantile_cont(
            shard_column(keys, mesh), shard_column(vals, mesh), [0.25, 0.9],
            mesh, max_groups=32)
    assert not int(ovf)
    ngi = int(ng)
    assert ngi == int(inc.num_groups) == g
    np.testing.assert_array_equal(gk.to_numpy()[:ngi],
                                  inc.key.to_numpy()[:ngi])
    for a, b in ((lower, inc.lower), (upper, inc.upper), (frac, inc.frac),
                 (val, inc.value)):
        assert torch.equal(a[:, :ngi], b[:, :ngi])
    assert torch.equal(cnt[:ngi], inc.count[:ngi])
    assert shifts == inc.shifts


def test_distributed_group_cont_numpy_matches_incore():
    rng = np.random.default_rng(16)
    n = 1 << 11
    keys = rng.integers(0, 11, n).astype(np.uint64) << np.uint64(40)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    got = tq.distributed_group_quantile_cont_numpy(keys, vals, CQS, _mesh(4),
                                                   max_groups=16)
    inc = group_quantile_cont(U64.from_numpy(keys, "cpu"), _col(vals), CQS)
    ng = int(inc.num_groups)
    v = inc.value.numpy()[:, :ng]
    assert got == {int(k): list(v[:, i])
                   for i, k in enumerate(inc.key.to_numpy()[:ng])}


# -------------------------------------------- against tpu_qe's dquantile

def _values(kind, seed):
    rng = np.random.default_rng(seed)
    n = 1 << 11
    if kind == "u64":
        v = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        v[::31] = np.uint64((1 << 64) - 1)
        v[1::37] = np.uint64(1 << 63)
        return v
    if kind == "u32":
        v = (rng.integers(-300, 300, n) + (1 << 31)).astype(np.uint32)
        v[::29] = np.uint32(0xFFFFFFFF)
        return v
    if kind == "i32":
        return rng.integers(-(1 << 31), (1 << 31) - 1, n,
                            dtype=np.int64).astype(np.int32)
    return (rng.standard_normal(n) * 1e3).astype(np.float32)


def _group_keys(seed):
    rng = np.random.default_rng(seed + 50)
    k = rng.integers(0, 21, 1 << 11).astype(np.uint64) + np.uint64(
        (1 << 63) - 10)
    return k


@functools.lru_cache(maxsize=None)
def _jax(fn, kind, n_dev):
    vals = _values(kind, n_dev)
    if fn == "disc":
        return jq.distributed_quantile_numpy(vals, QS, _jmesh(n_dev))
    if fn == "cont":
        return jq.distributed_quantile_cont_numpy(vals, CQS, _jmesh(n_dev))
    keys = _group_keys(n_dev)
    if fn == "group":
        return jq.distributed_group_quantile_numpy(keys, vals, CQS,
                                                   _jmesh(n_dev),
                                                   max_groups=32)
    return jq.distributed_group_quantile_cont_numpy(keys, vals, CQS,
                                                    _jmesh(n_dev),
                                                    max_groups=32)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("kind", ["u64", "u32", "i32", "f32"])
def test_quantile_matches_jax(kind, n_dev):
    vals = _values(kind, n_dev)
    got = tq.distributed_quantile_numpy(vals, QS, _mesh(n_dev))
    want = np.asarray(_jax("disc", kind, n_dev))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, _oracle(vals, QS))


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("kind", ["u64", "i32", "f32"])
def test_quantile_cont_matches_jax(kind, n_dev):
    vals = _values(kind, n_dev)
    got = tq.distributed_quantile_cont_numpy(vals, CQS, _mesh(n_dev))
    want = _jax("cont", kind, n_dev)
    assert got.frac_num == want.frac_num and got.shifts == want.shifts
    if kind == "u64":
        np.testing.assert_array_equal(got.lower.to_numpy(),
                                      want.lower.to_numpy())
        np.testing.assert_array_equal(got.upper.to_numpy(),
                                      want.upper.to_numpy())
        assert got.value is None and want.value is None
        return
    np.testing.assert_array_equal(column_to_numpy(got.lower),
                                  np.asarray(want.lower))
    np.testing.assert_array_equal(column_to_numpy(got.upper),
                                  np.asarray(want.upper))
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("kind", ["u32", "i32", "f32"])
def test_group_quantile_matches_jax(kind, n_dev):
    keys, vals = _group_keys(n_dev), _values(kind, n_dev)
    got = tq.distributed_group_quantile_numpy(keys, vals, CQS, _mesh(n_dev),
                                              max_groups=32)
    want = _jax("group", kind, n_dev)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.array(got[k]), np.array(want[k]))
    assert got == _incore_groups(keys, vals, CQS)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("kind", ["u32", "f32"])
def test_group_quantile_cont_matches_jax(kind, n_dev):
    keys, vals = _group_keys(n_dev), _values(kind, n_dev)
    got = tq.distributed_group_quantile_cont_numpy(keys, vals, CQS,
                                                   _mesh(n_dev),
                                                   max_groups=32)
    want = _jax("group_cont", kind, n_dev)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.array(got[k], np.float32),
                                      np.array(want[k], np.float32))


def test_all_ones_group_key_is_a_group():
    # the reference's group table reads an all-ones key as padding and
    # drops its group; the port keeps it (numpy is the oracle)
    rng = np.random.default_rng(12)
    n = 1 << 10
    keys = rng.integers(0, 5, n).astype(np.uint64)
    keys[::3] = np.uint64((1 << 64) - 1)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    got = tq.distributed_group_quantile_numpy(keys, vals, [(1, 1)],
                                              _mesh(4), max_groups=8)
    want = {}
    for k in np.unique(keys):
        s = np.sort(vals[keys == k])
        want[int(k)] = [s[(len(s) + 1) // 2 - 1]]
    assert got == want
    jwant = jq.distributed_group_quantile_numpy(keys, vals, [(1, 1)],
                                                _jmesh(4), max_groups=8)
    assert (1 << 64) - 1 not in jwant
    assert jwant == {k: v for k, v in want.items() if k != (1 << 64) - 1}


def test_psum_on_a_local_mesh():
    mesh = _mesh(4)
    x = torch.tensor([[1, -2], [3, 1 << 40], [5, 7], [0, 0]])
    got = mesh.psum(x)
    assert got.shape == x.shape and got.dtype == torch.int64
    assert (got == torch.tensor([9, (1 << 40) + 5])).all()
    y = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    assert (mesh.psum(y) == torch.tensor([12, 16])).all()
    assert mesh.psum(y).dtype == torch.int64
