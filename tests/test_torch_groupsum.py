"""kernels/groupsum (GROUP BY's counts and exact integer sums, E2) on CPU
tensors against tpu_qe.ops.aggregate.group_aggregate_multi.

On the CPU the wrapper ``segment_sums`` takes its plain twin
``segment_sums_plain``; the CUDA kernel is held to that twin bit for bit
on the same cases in tests/test_torch_cuda.py. Each case is checked twice
here: the twin and the wrapper called on rows that numpy's stable sort
ordered, and ``group_aggregate_multi``, which calls the wrapper after the
port's own key sort. Compared: num_groups, overflow
and the valid prefix of keys, counts and u64 sums, exactly.

The cases: one group over every row; every row its own group; group ends
on both sides of the kernel's 4096-row tile edges; u32 values with bit 31
set; i32 values whose sums are negative (two's complement mod 2^64); an
invalid tail; max_groups under, at and over the group count; one column
and more than K_MAX columns; one row.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.ops import aggregate as jagg  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.kernels import LAUNCHES  # noqa: E402
from tpu_qe_torch.kernels import groupsum as gk  # noqa: E402
from tpu_qe_torch.ops import aggregate as tagg  # noqa: E402
from tpu_qe_torch.table import column_from_numpy  # noqa: E402

N = 4608          # a 4096-row tile and a ragged second
TILE = 4096


def _keys(rng, n, style):
    if style == "one":
        return np.full(n, 0x80000000FFFFFFFF, np.uint64)
    if style == "each":
        return rng.permutation(n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
    if style == "edges":
        # in sorted order, groups end at rows 4094, 4095, 4096, 4097 and
        # the last; then rows shuffled
        ends = [TILE - 2, TILE - 1, TILE, TILE + 1, n - 1]
        lengths = np.diff([-1] + ends)
        keys = np.repeat(np.arange(len(ends), dtype=np.uint64) << np.uint64(
            33), lengths)
        return keys[rng.permutation(n)]
    return rng.integers(0, 7, n).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)                  # bit 63 and bit 31 set


def _column(rng, n, kind):
    if kind == "u32":
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "u32_bit31":
        return (rng.integers(0, 1 << 31, n, dtype=np.uint64).astype(
            np.uint32) | np.uint32(0x80000000))
    if kind == "i32_negative":
        return rng.integers(-(1 << 31), -(1 << 30), n).astype(np.int32)
    return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)


# name: (n, key style, columns, masked, max_groups)
CASES = {
    "one_group": (N, "one", ("u32", "i32"), False, None),
    "each_row_its_group": (N, "each", ("u32", "i32"), False, None),
    "tile_edges": (N, "edges", ("u32", "i32"), False, None),
    "bit31_u32": (N, "few", ("u32_bit31", "i32"), False, None),
    "negative_i32": (N, "few", ("u32", "i32_negative"), False, None),
    "invalid_tail": (N, "few", ("u32", "i32"), True, None),
    "max_groups_under": (N, "few", ("u32", "i32"), True, 3),
    "max_groups_at": (N, "few", ("u32", "i32"), False, 7),
    "max_groups_over": (N, "edges", ("u32", "i32"), False, 100),
    "k1": (N, "few", ("u32",), False, None),
    "k_over_k_max": (N, "few", ("u32", "i32") * 5, False, None),
    "n1": (1, "few", ("u32", "i32"), False, None),
}


def _np(x):
    if isinstance(x, (U64, JU64)):
        return x.to_numpy()
    return np.asarray(x)


def _same(got, want, m, what):
    np.testing.assert_array_equal(_np(got)[:m].astype(np.uint64),
                                  _np(want)[:m].astype(np.uint64),
                                  err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sums_and_group_aggregate_multi_match_jax(case):
    n, style, kinds, masked, max_groups = CASES[case]
    rng = np.random.default_rng(len(case))
    keys = _keys(rng, n, style)
    names = [f"c{j}" for j in range(len(kinds))]
    cols = {nm: _column(rng, n, kind) for nm, kind in zip(names, kinds)}
    aggs = {nm: ("count", "sum") if j == 0 else ("sum",)
            for j, nm in enumerate(names)}
    valid = rng.random(n) < 0.6 if masked else None
    tvalid = None if valid is None else torch.from_numpy(valid)

    jres = jagg.group_aggregate_multi(
        JU64.from_numpy(keys), {k: jnp.asarray(v) for k, v in cols.items()},
        aggs, valid=None if valid is None else jnp.asarray(valid),
        max_groups=max_groups)
    ng = int(jres.num_groups)
    m = ng if max_groups is None else min(ng, max_groups)
    if style == "one":
        assert ng == 1
    if style == "each":
        assert ng == n
    if case == "max_groups_at":
        assert ng == max_groups

    # the twin and the wrapper, on rows sorted stably by (invalid, key)
    tcols = {nm: column_from_numpy(v, "cpu") for nm, v in cols.items()}
    invalid = np.zeros(n, bool) if valid is None else ~valid
    perm = np.lexsort((keys, invalid))
    skeys = U64.from_numpy(keys[perm], "cpu")
    sinvalid = None if valid is None else torch.from_numpy(invalid[perm])
    slo, shi, perm = skeys.lo, skeys.hi, torch.from_numpy(perm)
    order = sorted(names)
    args = (slo, shi, sinvalid, perm,
            [tcols[nm].view(torch.int32) for nm in order],
            [tcols[nm].dtype == torch.int32 for nm in order], max_groups)
    before = dict(LAUNCHES)
    for gs in (gk.segment_sums_plain(*args), gk.segment_sums(*args)):
        assert int(gs.num_groups) == ng
        _same(gs.key, jres.key, m, "key")
        _same(gs.count, jres.aggs["c0_count"], m, "count")
        for nm, s in zip(order, gs.sums):
            _same(s, jres.aggs[f"{nm}_sum"], m, nm)
    assert LAUNCHES == before

    # group_aggregate_multi, which calls it
    res = tagg.group_aggregate_multi(U64.from_numpy(keys, "cpu"), tcols,
                                     aggs, valid=tvalid,
                                     max_groups=max_groups)
    assert int(res.num_groups) == ng
    if max_groups is not None:
        assert int(res.overflow) == int(jres.overflow) == int(ng > max_groups)
    _same(res.key, jres.key, m, "key")
    assert set(res.aggs) == set(jres.aggs)
    for a in res.aggs:
        _same(res.aggs[a], jres.aggs[a], m, a)
    # the signed sums, against Python integers
    if "i32" in kinds[1:2] or "i32_negative" in kinds[1:2]:
        want = {}
        for k, v, ok in zip(keys, cols["c1"], valid if masked else [True] * n):
            if ok:
                want[k] = want.get(k, 0) + int(v)
        got = res.aggs["c1_sum"].to_numpy()[:m].astype(np.int64)
        np.testing.assert_array_equal(got,
                                      [want[k] for k in sorted(want)][:m])


def test_segment_sums_rejects_bad_arguments():
    lo = torch.zeros(8, dtype=torch.int32)
    perm = torch.arange(8)
    with pytest.raises(ValueError):            # a column of another length
        gk.segment_sums(lo, lo, None, perm, [lo[:4]], [False])
    with pytest.raises(ValueError):            # a float permutation
        gk.segment_sums(lo, lo, None, perm.float(), [lo], [False])
    with pytest.raises(ValueError):            # sign flags do not match
        gk.segment_sums(lo, lo, None, perm, [lo], [])
    with pytest.raises(ValueError):
        gk.segment_sums(lo, lo, None, perm, [lo], [False], max_groups=0)
    with pytest.raises(ValueError):            # the flags as int32
        gk.segment_sums(lo, lo, lo, perm, [lo], [False])


def test_group_aggregate_multi_counts_its_sum_columns():
    from tpu_qe_torch.utils import profiling
    rng = np.random.default_rng(3)
    keys = _keys(rng, 500, "few")
    cols = {"a": column_from_numpy(_column(rng, 500, "u32"), "cpu"),
            "b": column_from_numpy(_column(rng, 500, "i32"), "cpu"),
            "f": torch.from_numpy(rng.standard_normal(500).astype(
                np.float32))}
    with profiling.tracing():
        with profiling.span("sql.query"):
            tagg.group_aggregate_multi(
                U64.from_numpy(keys, "cpu"), cols,
                {"a": ("count", "sum", "max"), "b": ("sum",),
                 "f": ("sum", "min")})
        (rec,) = profiling.records()
    (group,) = [s for s in rec["spans"] if s["name"] == "ops.group"]
    # a's count and sum and b's sum; CPU tensors take the plain twin
    assert group["counts"] == {"sum_cols": 3, "sum_cols_kernel": 0}
