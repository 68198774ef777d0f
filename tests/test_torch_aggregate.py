"""tpu_qe_torch.ops.aggregate against tpu_qe.ops.aggregate on CPU tensors
(the radix sort runs its kernels' plain twins here). Inputs come from
numpy seeds and cover bit-31 keys and values, all-equal keys, `valid`
masks that empty whole groups, and max_groups overflow.

Compared: num_groups and overflow, and the valid prefix of every padded
output (the padding is not defined by the JAX docstrings). Tolerance:
exact equality of keys, counts, u64 sums, min/max and count_distinct, and
of float32 sums and means of group_aggregate(_sorted), whose per-segment
scan folds in the JAX order. group_aggregate_multi's float sums difference
a running cumsum whose order inside a group the JAX unstable sort leaves
open, so they are held to rtol=1e-5 (the JAX package's own tolerance for
float sums, tests/test_segscan.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.ops import aggregate as jagg  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.ops import aggregate as tagg  # noqa: E402
from tpu_qe_torch.table import column_from_numpy, column_to_numpy  # noqa: E402


def _keys(rng, n, style):
    if style == "few":
        return rng.integers(0, 7, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)                  # bit 63 and bit 31 set
    if style == "equal":
        return np.full(n, 0x80000000FFFFFFFF, np.uint64)
    return rng.integers(0, 1 << 64, n, dtype=np.uint64) >> np.uint64(
        rng.integers(0, 60))


def _values(rng, n, dtype):
    if dtype == "float32":
        v = (rng.standard_normal(n) * 100).astype(np.float32)
        v[::7] = -0.0
        v[::11] = 0.0
        v[::13] = v[::13].round()                 # repeated values
        return v
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v[::5] &= np.uint32(0x8000000F)               # repeats, bit 31 set
    return v.view(dtype)


def _np(x):
    if isinstance(x, (U64, JU64)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return column_to_numpy(x) if x.dtype in (
            torch.uint32, torch.int32, torch.float32) else x.numpy()
    return np.asarray(x)


def _same_prefix(got, want, m, name, rtol=None):
    g, w = _np(got)[:m], _np(want)[:m]
    if rtol is None:
        if g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.uint64),
                                          w.astype(np.uint64), err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-3, err_msg=name)


def _compare(res, jres, max_groups=None, rtol_sums=None):
    ng = int(jres.num_groups)
    assert int(res.num_groups) == ng
    if max_groups is not None:
        assert int(res.overflow) == int(jres.overflow)
    m = ng if max_groups is None else min(ng, max_groups)
    _same_prefix(res.key, jres.key, m, "key")
    assert set(res.aggs) == set(jres.aggs)
    for a in res.aggs:
        float_sum = a.endswith("sum") and not isinstance(res.aggs[a], U64)
        _same_prefix(res.aggs[a], jres.aggs[a], m, a,
                     rtol_sums if float_sum else None)


CASES = [("count",), ("count", "sum", "min", "max"), ("count_distinct",
                                                      "count"),
         ("mean", "max"), ("sum",)]


@pytest.mark.parametrize("aggs", CASES)
@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("style", ["few", "random", "equal"])
@pytest.mark.parametrize("masked", [False, True])
def test_group_aggregate_matches_jax(aggs, dtype, style, masked):
    rng = np.random.default_rng(len(aggs) * 13 + len(style) + masked)
    n = 3000
    keys, vals = _keys(rng, n, style), _values(rng, n, dtype)
    valid = rng.random(n) < 0.6 if masked else None
    res = tagg.group_aggregate(
        U64.from_numpy(keys, "cpu"), column_from_numpy(vals, "cpu"), aggs,
        valid=None if valid is None else torch.from_numpy(valid))
    jres = jagg.group_aggregate(
        JU64.from_numpy(keys), jnp.asarray(vals), aggs,
        valid=None if valid is None else jnp.asarray(valid))
    _compare(res, jres)


@pytest.mark.parametrize("max_groups", [1, 5, 64, 5000])
@pytest.mark.parametrize("dtype", ["uint32", "float32"])
@pytest.mark.parametrize("masked", [False, True])
def test_group_aggregate_max_groups_matches_jax(max_groups, dtype, masked):
    rng = np.random.default_rng(max_groups)
    n = 2000
    keys = rng.integers(0, 40, n).astype(np.uint64) << np.uint64(31)
    vals = _values(rng, n, dtype)
    valid = rng.random(n) < 0.5 if masked else None
    aggs = ("count", "sum", "min", "max", "count_distinct", "mean")
    res = tagg.group_aggregate(
        U64.from_numpy(keys, "cpu"), column_from_numpy(vals, "cpu"), aggs,
        valid=None if valid is None else torch.from_numpy(valid),
        max_groups=max_groups)
    jres = jagg.group_aggregate(
        JU64.from_numpy(keys), jnp.asarray(vals), aggs,
        valid=None if valid is None else jnp.asarray(valid),
        max_groups=max_groups)
    _compare(res, jres, max_groups)
    if max_groups < 40:
        assert int(res.overflow) == 1


def test_count_distinct_keeps_signed_zeros_and_nan_payloads_apart():
    keys = np.zeros(6, np.uint64)
    vals = np.array([0.0, -0.0, np.nan, 1.0, 1.0, -0.0], np.float32)
    vals[2:3].view(np.uint32)[0] = 0x7FC00001            # a NaN payload
    vals = np.concatenate([vals, np.array([np.nan], np.float32)])
    keys = np.zeros(7, np.uint64)
    res = tagg.group_aggregate(U64.from_numpy(keys, "cpu"),
                               torch.from_numpy(vals), ("count_distinct",))
    jres = jagg.group_aggregate(JU64.from_numpy(keys), jnp.asarray(vals),
                                ("count_distinct",))
    assert int(res.aggs["count_distinct"][0]) == 5     # +0, -0, 1, 2 NaNs
    _compare(res, jres)


def test_empty_input_matches_jax():
    k = np.zeros(0, np.uint64)
    for mg in (None, 4):
        res = tagg.group_aggregate(U64.from_numpy(k, "cpu"),
                                   torch.zeros(0, dtype=torch.float32),
                                   ("count", "sum", "min"), max_groups=mg)
        jres = jagg.group_aggregate(JU64.from_numpy(k),
                                    jnp.zeros(0, jnp.float32),
                                    ("count", "sum", "min"), max_groups=mg)
        _compare(res, jres, mg)
        assert res.key.lo.shape[0] == (mg or 0)


@pytest.mark.parametrize("aggs", [("count", "sum", "min", "max"),
                                  ("mean",)])
@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
def test_group_aggregate_sorted_matches_jax(aggs, dtype):
    rng = np.random.default_rng(len(aggs) + len(dtype))
    n = 5000
    keys = np.sort(_keys(rng, n, "few"))
    vals = _values(rng, n, dtype)
    valid = rng.random(n) < 0.4
    valid[keys == keys[0]] = False                     # a run with no row
    res = tagg.group_aggregate_sorted(U64.from_numpy(keys, "cpu"),
                                      column_from_numpy(vals, "cpu"), aggs,
                                      valid=torch.from_numpy(valid))
    jres = jagg.group_aggregate_sorted(JU64.from_numpy(keys),
                                       jnp.asarray(vals), aggs,
                                       valid=jnp.asarray(valid))
    _compare(res, jres)


@pytest.mark.parametrize("max_groups", [None, 3, 100])
@pytest.mark.parametrize("masked", [False, True])
def test_group_aggregate_multi_matches_jax(max_groups, masked):
    rng = np.random.default_rng(7 + (max_groups or 0) + masked)
    n = 4000
    keys = _keys(rng, n, "few")
    cols = {"u": _values(rng, n, "uint32"), "i": _values(rng, n, "int32"),
            "f": _values(rng, n, "float32")}
    aggs = {"u": ("count", "sum", "min", "max"), "i": ("sum", "min", "max"),
            "f": ("sum", "min", "max")}
    valid = rng.random(n) < 0.7 if masked else None
    res = tagg.group_aggregate_multi(
        U64.from_numpy(keys, "cpu"),
        {k: column_from_numpy(v, "cpu") for k, v in cols.items()}, aggs,
        valid=None if valid is None else torch.from_numpy(valid),
        max_groups=max_groups)
    jres = jagg.group_aggregate_multi(
        JU64.from_numpy(keys), {k: jnp.asarray(v) for k, v in cols.items()},
        aggs, valid=None if valid is None else jnp.asarray(valid),
        max_groups=max_groups)
    _compare(res, jres, max_groups, rtol_sums=1e-5)
    ng = int(res.num_groups)
    signed = res.aggs["i_sum"].to_numpy()[:ng].astype(np.int64)
    want = {}
    for k, v, ok in zip(keys, cols["i"], valid if masked else [True] * n):
        if ok:
            want[k] = want.get(k, 0) + int(v)
    np.testing.assert_array_equal(signed[:min(ng, max_groups or ng)],
                                  [want[k] for k in sorted(want)][
                                      :min(ng, max_groups or ng)])


def test_bad_arguments_raise():
    k = U64.from_numpy(np.arange(4, dtype=np.uint64), "cpu")
    v = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tagg.group_aggregate(k, v, ("median",))
    with pytest.raises(ValueError):
        tagg.group_aggregate(k, None, ("sum",))
    with pytest.raises(ValueError):
        tagg.group_aggregate_sorted(k, v, ("count_distinct",))
    with pytest.raises(ValueError):
        tagg.group_aggregate_multi(k, {"v": v}, {"v": ("count_distinct",)})
