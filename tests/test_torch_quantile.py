"""tpu_qe_torch.ops.quantile against tpu_qe.ops.quantile on CPU tensors
(the radix sort runs its kernels' plain twins here).

Inputs come from numpy seeds: groups of 1, 2 and many rows, u32 values
with bit 31 set, negative i32 values, float32 values with repeats; q
values that are dyadic (exact) and snapped to the 2^-20 grid, (num, shift)
pairs, 0 and 1. Compared: num_groups and overflow, and the valid prefix
of every padded output. Tolerance: exact equality of keys, counts, ranks,
DISC values, CONT lower / upper values and frac numerators; the float32
CONT interpolation within rtol=1e-5, atol=1e-3 (XLA may fuse its multiply
and add, torch does not). The per-group rank arithmetic is held to Python
integers at counts near 2^32, where float rank math would fail.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.bits import mul_u32_wide as jmul  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe_torch.bits import U64, mul_u32_wide  # noqa: E402
from tpu_qe_torch.table import Table, column_from_numpy  # noqa: E402

jq = importlib.import_module("tpu_qe.ops.quantile")
tq = importlib.import_module("tpu_qe_torch.ops.quantile")

QS = [(1, 1), 0.99, 0.0, 1.0, 0.3, (3, 5), 0.25, (1, 0)]
DTYPES = ["uint32", "int32", "float32"]


def _np(x):
    if isinstance(x, (U64, JU64)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _bits(x):
    a = _np(x)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _keys(rng, n):
    """Keys of groups of many rows, plus a group of 2 and singletons."""
    k = rng.integers(0, 40, n).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    k[:2] = 0xFFFFFFFF00000001            # a group of 2 (bit 63 set)
    k[2:12] = np.arange(10, dtype=np.uint64) + np.uint64(1 << 40)
    return k


def _values(rng, n, dtype):
    if dtype == "float32":
        v = (rng.standard_normal(n) * 100).astype(np.float32)
        v[::13] = v[::13].round()
        return v
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v[::5] &= np.uint32(0x8000000F)
    return v.view(dtype)


@functools.lru_cache(maxsize=None)
def _data(dtype):
    rng = np.random.default_rng(3 + DTYPES.index(dtype))
    n = 3000
    return _keys(rng, n), _values(rng, n, dtype)


@functools.lru_cache(maxsize=None)
def _jax_group(dtype, max_groups):
    k, v = _data(dtype)
    key, val = JU64.from_numpy(k), jnp.asarray(v)
    return (jq.group_quantile(key, val, QS, max_groups=max_groups),
            jq.group_quantile_cont(key, val, QS, max_groups=max_groups))


def _same(got, want, m, name):
    np.testing.assert_array_equal(_bits(got)[..., :m], _bits(want)[..., :m],
                                  err_msg=name)


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("max_groups", [None, 64, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_quantile_matches_jax(dtype, max_groups, backend):
    k, v = _data(dtype)
    jd, jc = _jax_group(dtype, max_groups)
    key, val = U64.from_numpy(k, "cpu"), column_from_numpy(v, "cpu")
    d = tq.group_quantile(key, val, QS, max_groups=max_groups,
                          backend=backend)
    c = tq.group_quantile_cont(key, val, QS, max_groups=max_groups,
                               backend=backend)
    ng = int(jd.num_groups)
    m = ng if max_groups is None else min(ng, max_groups)
    for res, jres in ((d, jd), (c, jc)):
        assert int(res.num_groups) == ng
        if max_groups is None:
            assert res.overflow is None
        else:
            assert int(res.overflow) == int(jres.overflow)
        _same(res.key, jres.key, m, "key")
        _same(res.count, _np(jres.count).astype(np.int64), m, "count")
    assert d.quantiles.dtype == getattr(torch, dtype)
    _same(d.quantiles, jd.quantiles, m, "quantiles")
    _same(c.lower, jc.lower, m, "lower")
    _same(c.upper, jc.upper, m, "upper")
    _same(c.frac, _np(jc.frac).astype(np.int64), m, "frac")
    assert c.shifts == jc.shifts
    np.testing.assert_allclose(_np(c.value)[:, :m], _np(jc.value)[:, :m],
                               rtol=1e-5, atol=1e-3)


def test_max_groups_overflow_is_reported_and_counts_stay_exact():
    k, v = _data("uint32")
    res = tq.group_quantile(U64.from_numpy(k, "cpu"),
                            column_from_numpy(v, "cpu"), [0.5],
                            max_groups=16)
    assert int(res.overflow) == 1
    assert int(res.num_groups) == len(np.unique(k)) > 16
    assert res.count.shape == (16,) and res.quantiles.shape == (1, 16)


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("dtype", DTYPES + ["uint64"])
def test_global_quantiles_match_jax(dtype, backend):
    rng = np.random.default_rng(11)
    n = 777
    if dtype == "uint64":
        x = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        x[:5] = x[5]                        # ties
        jcol, col = JU64.from_numpy(x), U64.from_numpy(x, "cpu")
    else:
        x = _values(rng, n, dtype)
        jcol, col = jnp.asarray(x), column_from_numpy(x, "cpu")
    _same(tq.quantile(col, QS, backend=backend), jq.quantile(jcol, QS),
          len(QS), "disc")
    _same(tq.median(col, backend=backend), jq.median(jcol), 1, "median")
    c, jc = tq.quantile_cont(col, QS, backend=backend), jq.quantile_cont(
        jcol, QS)
    _same(c.lower, jc.lower, len(QS), "lower")
    _same(c.upper, jc.upper, len(QS), "upper")
    assert c.frac_num == jc.frac_num and c.shifts == jc.shifts
    if dtype == "uint64":
        assert c.value is None and jc.value is None
    else:
        np.testing.assert_allclose(_np(c.value), _np(jc.value), rtol=1e-5,
                                   atol=1e-3)


def test_single_row_column_and_empty_inputs():
    one = column_from_numpy(np.array([-7], np.int32), "cpu")
    assert _np(tq.quantile(one, QS)).tolist() == [-7] * len(QS)
    c = tq.quantile_cont(one, [0.5])
    assert _np(c.value).tolist() == [-7.0] and c.frac_num == (0,)
    empty = column_from_numpy(np.zeros(0, np.uint32), "cpu")
    with pytest.raises(AssertionError):
        tq.quantile(empty, [0.5])
    with pytest.raises(AssertionError):
        tq.quantile_cont(empty, [0.5])
    with pytest.raises(AssertionError):
        tq.group_quantile(U64.from_numpy(np.zeros(0, np.uint64), "cpu"),
                          empty, [0.5])


@pytest.mark.parametrize("qs", [0.5, [0.5, 0.25], [(1, 1), 0.99],
                                [(0, 0), (1, 0), (5, 31)], [1e-7, 1 - 1e-7]])
def test_canon_qs_matches_jax(qs):
    assert tq.canon_qs(qs) == jq.canon_qs(qs)


@pytest.mark.parametrize("qs", [[], [1.5], [-0.1], [(3, 1)], [(1, 32)],
                                [(1.0, 1)]])
def test_canon_qs_rejects_what_jax_rejects(qs):
    with pytest.raises(ValueError):
        jq.canon_qs(qs)
    with pytest.raises(ValueError):
        tq.canon_qs(qs)


EDGE = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                 0xFFFFFFFE, 0xFFFFFFFF, 0xDEADBEEF], np.uint64)


def _u32_plane(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("b", [0, 1, 0xFFFF, 0x10000, 0x80000000,
                               0xFFFFFFFF, 0x9E3779B9, "plane"])
def test_mul_u32_wide_is_the_exact_product(b):
    rng = np.random.default_rng(5)
    a = np.concatenate([EDGE, rng.integers(0, 1 << 32, 500,
                                           dtype=np.uint64)])
    bb = (np.concatenate([EDGE[::-1], rng.integers(0, 1 << 32, 500,
                                                   dtype=np.uint64)])
          if b == "plane" else np.full(a.shape, b, np.uint64))
    lo, hi = mul_u32_wide(_u32_plane(a), _u32_plane(bb) if b == "plane"
                          else b)
    got = [(int(x) & 0xFFFFFFFF) | ((int(y) & 0xFFFFFFFF) << 32)
           for x, y in zip(lo.tolist(), hi.tolist())]
    assert got == [int(x) * int(y) for x, y in zip(a, bb)]
    jb = jnp.asarray(bb.astype(np.uint32)) if b == "plane" else b
    jlo, jhi = jmul(jnp.asarray(a.astype(np.uint32)), jb)
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))


# counts of groups past 2^24 rows, up to 2^32 - 1: the rank arithmetic only
COUNTS = np.array([1, 2, 3, (1 << 24) + 1, (1 << 24) + 3, 123456789,
                   (1 << 31) - 1, 1 << 31, 0xFFFFFFFE, 0xFFFFFFFF],
                  np.int64)


@pytest.mark.parametrize("q", [(1, 1), (99, 7), (1, 0), (0, 3),
                               (5, 31), (2147483647, 31), 0.99, 0.3])
def test_device_ranks_are_exact_near_2_32(q):
    (num, sh), = tq.canon_qs([q])
    cnt = torch.from_numpy(COUNTS)
    r = tq._disc_rank_device(num, sh, cnt)
    assert r.tolist() == [tq.disc_rank(num, sh, int(c)) for c in COUNTS]
    f, c, fr = tq._cont_rank_device(num, sh, cnt)
    want = [tq.cont_rank(num, sh, int(n)) for n in COUNTS]
    assert list(zip(f.tolist(), c.tolist(), fr.tolist())) == want
    jcnt = jnp.asarray(COUNTS.astype(np.uint32))
    assert r.tolist() == np.asarray(
        jq._disc_rank_device(num, sh, jcnt)).astype(np.int64).tolist()
    jf, jc, jfr = jq._cont_rank_device(num, sh, jcnt)
    assert f.tolist() == np.asarray(jf).astype(np.int64).tolist()
    assert fr.tolist() == np.asarray(jfr).astype(np.int64).tolist()
    # float32 rank math misses exactly here: ceil(num * cnt / 2^sh) of
    # counts past 2^24 does not survive a float32 count
    if (num, sh) == (1, 1):
        f32 = np.ceil(COUNTS.astype(np.float32) / 2).astype(np.int64) - 1
        assert f32.tolist() != r.tolist()


def _tables(dtype):
    k, v = _data(dtype)
    return (Table({"key": U64.from_numpy(k, "cpu"),
                   "v": column_from_numpy(v, "cpu")}),
            JTable({"key": JU64.from_numpy(k), "v": jnp.asarray(v)}))


@pytest.mark.parametrize("dtype", ["uint32", "float32"])
def test_table_quantile_methods_match_jax(dtype):
    t, jt = _tables(dtype)
    _same(t.quantile(QS, key="v"), jt.quantile(QS, key="v"), len(QS), "q")
    _same(t.quantile(QS), jt.quantile(QS), len(QS), "q key")
    c, jc = t.quantile_cont(QS, key="v"), jt.quantile_cont(QS, key="v")
    _same(c.lower, jc.lower, len(QS), "lower")
    jd, jgc = _jax_group(dtype, 64)
    g = t.group_quantile("key", "v", QS, max_groups=64)
    m = int(jd.num_groups)
    _same(g.quantiles, jd.quantiles, m, "group quantiles")
    gc = t.group_quantile_cont("key", "v", QS, max_groups=64,
                               backend="torch")
    _same(gc.upper, jgc.upper, m, "group cont upper")


def test_table_group_quantile_needs_a_u64_key():
    t, jt = _tables("uint32")
    for tab in (t, jt):
        with pytest.raises(TypeError, match="must be u64"):
            tab.group_quantile("v", "v", [0.5])
        with pytest.raises(TypeError, match="must be u64"):
            tab.group_quantile_cont("v", "v", [0.5])
