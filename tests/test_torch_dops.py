"""tpu_qe_torch.exchange.dops on a LocalMesh of the CPU: every test of
tests/test_dops.py, tests/test_dcount_distinct.py, tests/test_djoinagg.py
and tests/test_douter_join.py, the distributed cases of
tests/test_fuzz_exchange.py, tests/test_setops.py and
tests/test_fuzz_ops.py, each against its numpy oracle at the reference's
mesh sizes, inputs and tolerances (integers exact; float sums within the
reference's 1e-2 relative, min and max exact). Then one case per operator
against tpu_qe.exchange.dops on the same inputs: integers bit for bit,
float32 sums within rtol 1e-5 (tests/test_torch_aggregate.py's
tolerance); outputs in "no particular order" are compared sorted.

One case holds the port to numpy where the reference is wrong:
distributed_set_op keeps a real all-ones key, which the JAX body reads as
padding and drops (ROADMAP Queue C)."""

import collections
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jx = importlib.import_module("tpu_qe.exchange.dops")
tx = importlib.import_module("tpu_qe_torch.exchange.dops")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
tex = importlib.import_module("tpu_qe_torch.exchange")


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


# ------------------------------------------------------ tests/test_dops.py

def _fk_case(n_dev):
    rng = np.random.default_rng(n_dev)
    n_r = 1 << 10
    rkeys = np.unique(rng.integers(0, 1 << 62, 2 * n_r,
                                   dtype=np.uint64))[:n_r]
    rvals = np.arange(n_r, dtype=np.uint32) * 11 + 1
    n_l = 1 << 11
    hit = rkeys[rng.integers(0, n_r, n_l // 2)]
    miss = rng.integers(0, 1 << 62, n_l - n_l // 2, dtype=np.uint64) | (
        np.uint64(1) << np.uint64(62))      # disjoint from rkeys
    lkeys = np.concatenate([hit, miss])
    rng.shuffle(lkeys)
    return lkeys, rkeys, rvals


def _check_fk(lkeys, rkeys, rvals, matched, rv):
    pos = {int(k): i for i, k in enumerate(rkeys)}
    for i, k in enumerate(lkeys):
        if int(k) in pos:
            assert matched[i], i
            assert rv[i] == rvals[pos[int(k)]]
        else:
            assert not matched[i], i


@pytest.mark.parametrize("n_dev", [2, 8])
def test_join_matches_local_oracle(n_dev):
    lkeys, rkeys, rvals = _fk_case(n_dev)
    matched, (rv,) = tx.distributed_join_fk_numpy(
        lkeys, [], rkeys, [rvals], _mesh(n_dev), capacity_factor="auto")
    _check_fk(lkeys, rkeys, rvals, matched, rv)


def test_join_skewed_left_keys(n_dev=4):
    rng = np.random.default_rng(0)
    rkeys = np.arange(1, 65, dtype=np.uint64) * np.uint64(12345)
    rvals = np.arange(64, dtype=np.uint32)
    lkeys = rkeys[rng.zipf(1.5, size=1 << 10).clip(1, 64) - 1]
    matched, (rv,) = tx.distributed_join_fk_numpy(
        lkeys, [], rkeys, [rvals], _mesh(n_dev), capacity_factor="auto")
    assert matched.all()
    pos = {int(k): i for i, k in enumerate(rkeys)}
    assert all(rv[i] == pos[int(k)] for i, k in enumerate(lkeys))


def _count_sum_oracle(keys, vals):
    cnt = collections.Counter(int(k) for k in keys)
    sums = collections.defaultdict(int)
    for k, v in zip(keys, vals):
        sums[int(k)] += int(v)
    return cnt, sums


@pytest.mark.parametrize("n_dev", [2, 8])
def test_aggregate_count_sum_vs_numpy(n_dev):
    rng = np.random.default_rng(n_dev + 10)
    n = 1 << 12
    keys = rng.integers(0, 50, n).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("count", "sum"),
                                         capacity_factor=4.0)
    cnt, sums = _count_sum_oracle(keys, vals)
    assert set(got) == set(cnt)
    for k in cnt:
        assert got[k] == {"count": cnt[k], "sum": sums[k]}


def test_aggregate_auto_capacity_all_rows_one_key(n_dev=8):
    n = 1 << 12
    keys = np.full(n, 0xDEADBEEF, dtype=np.uint64)
    vals = np.arange(n, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("count", "sum"),
                                         capacity_factor="auto")
    assert got == {0xDEADBEEF: {"count": n, "sum": n * (n - 1) // 2}}


def test_aggregate_auto_capacity_many_groups(n_dev=4):
    rng = np.random.default_rng(31)
    n = 1 << 12
    keys = rng.integers(0, 200, n).astype(np.uint64)
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("count", "sum"),
                                         capacity_factor="auto")
    cnt, sums = _count_sum_oracle(keys, vals)
    assert got == {k: {"count": cnt[k], "sum": sums[k]} for k in cnt}


def test_aggregate_sums_past_2_32_exact(n_dev=4):
    rng = np.random.default_rng(21)
    n = 1 << 12
    keys = rng.integers(0, 4, n).astype(np.uint64)
    vals = np.full(n, 0xF0000000, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("sum", "count"),
                                         capacity_factor=4.0)
    for k in np.unique(keys):
        want = int((keys == k).sum()) * 0xF0000000
        assert want > (1 << 32)
        assert got[int(k)]["sum"] == want


def test_aggregate_min_max(n_dev=4):
    rng = np.random.default_rng(2)
    n = 1 << 12
    keys = rng.integers(0, 20, n).astype(np.uint64)
    vals = rng.integers(0, 1 << 31, n, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("count", "min", "max"),
                                         capacity_factor=4.0)
    for k in set(int(x) for x in keys):
        sel = vals[keys == k]
        assert got[k]["min"] == sel.min() and got[k]["max"] == sel.max()


def test_aggregate_all_ones_key_group(n_dev=2):
    keys = np.full(256, (1 << 64) - 1, dtype=np.uint64)
    got = tx.distributed_aggregate_numpy(keys, np.ones(256, np.uint32),
                                         _mesh(n_dev), aggs=("count", "sum"),
                                         capacity_factor=4.0)
    assert got == {(1 << 64) - 1: {"count": 256, "sum": 256}}


def test_aggregate_min_only_no_phantom_padding_group(n_dev=4):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 10, 1 << 10).astype(np.uint64)
    vals = rng.integers(0, 1 << 30, 1 << 10, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("min",), capacity_factor=4.0)
    assert set(got) == set(int(k) for k in keys)
    for k in got:
        assert got[k] == {"min": int(vals[keys == k].min())}


def _float_case():
    rng = np.random.default_rng(21)
    n = 1 << 10
    keys = rng.integers(0, 12, n).astype(np.uint64)
    vals = (rng.standard_normal(n) * 10).astype(np.float32)
    return keys, vals


def test_aggregate_float_values_sum_min_max(n_dev=4):
    keys, vals = _float_case()
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("count", "sum", "min", "max"),
                                         capacity_factor=4.0)
    for k in set(int(x) for x in keys):
        sel = vals[keys == k]
        assert got[k]["count"] == len(sel)
        assert abs(got[k]["sum"] - float(sel.sum())) < 1e-2 * max(
            1.0, abs(float(sel.sum())))
        assert got[k]["min"] == float(sel.min())
        assert got[k]["max"] == float(sel.max())


def test_aggregate_signed_negative_min_max_rejected(n_dev=2):
    mesh = _mesh(n_dev)
    keys = np.array([1, 1, 2, 2], dtype=np.uint64)
    vals = np.array([-1, 5, 3, -7], dtype=np.int32)
    with pytest.raises(ValueError, match="unsigned order"):
        tx.distributed_aggregate_numpy(keys, vals, mesh, aggs=("min",))
    got = tx.distributed_aggregate_numpy(keys, vals, mesh,
                                         aggs=("count", "sum"),
                                         capacity_factor=4.0)
    assert got[1]["count"] == 2 and got[2]["count"] == 2
    assert got[1]["sum"] & 0xFFFFFFFF == 4
    got = tx.distributed_aggregate_numpy(keys, np.abs(vals), mesh,
                                         aggs=("min",), capacity_factor=4.0)
    assert got[1]["min"] == 1 and got[2]["min"] == 3


def test_hot_left_key_splits_with_right_broadcast(n_dev=8):
    mesh = _mesh(n_dev)
    n_l = 1 << 12
    lkeys = np.full(n_l, 424242, dtype=np.uint64)
    rkeys = np.array([424242, 7, 8, 9, 10, 11, 12, 13], dtype=np.uint64)
    rvals = np.arange(len(rkeys), dtype=np.uint32) + 100
    matched, (rv,) = tx.distributed_join_fk_numpy(
        lkeys, [], rkeys, [rvals], mesh, capacity_factor="auto")
    assert matched.all() and (rv == 100).all()
    # balance: every shard receives at most 2 n / D real left rows
    from tpu_qe_torch.exchange.dsort import shard_u32, shard_u64
    res = tx.distributed_join_fk(shard_u64(lkeys, mesh), (),
                                 shard_u64(rkeys, mesh),
                                 (shard_u32(rvals, mesh),), mesh=mesh,
                                 capacity_factor=2.0,
                                 capacity_factor_right=2.0)
    per_dev = (res[2] == 0).sum(1).numpy()
    assert per_dev.max() <= 2 * n_l // n_dev, per_dev


def test_mixed_hot_and_unique_left_keys(n_dev=4):
    rng = np.random.default_rng(31)
    rkeys = np.unique(rng.integers(0, 1 << 40, 256, dtype=np.uint64))
    rvals = np.arange(len(rkeys), dtype=np.uint32) * 3 + 1
    n_l = 1 << 11
    lkeys = np.where(rng.random(n_l) < 0.6, rkeys[5],
                     rkeys[rng.integers(0, len(rkeys), n_l)])
    matched, (rv,) = tx.distributed_join_fk_numpy(
        lkeys, [], rkeys, [rvals], _mesh(n_dev), capacity_factor="auto")
    assert matched.all()
    pos = {int(k): i for i, k in enumerate(rkeys)}
    assert all(rv[i] == pos[int(k)] * 3 + 1 for i, k in enumerate(lkeys))


def _pairs_oracle(lkeys, rkeys, rvals):
    where = collections.defaultdict(list)
    for j, k in enumerate(rkeys):
        where[int(k)].append(int(rvals[j]))
    return sorted((i, v) for i, k in enumerate(lkeys)
                  for v in where.get(int(k), ()))


def _inner_case(n_dev):
    rng = np.random.default_rng(n_dev + 50)
    lkeys = rng.integers(0, 200, 1 << 11).astype(np.uint64)
    rkeys = rng.integers(0, 300, 1 << 10).astype(np.uint64)
    return lkeys, rkeys, np.arange(1 << 10, dtype=np.uint32) * 5 + 2


@pytest.mark.parametrize("n_dev", [2, 8])
def test_inner_join_duplicate_right_keys_vs_oracle(n_dev):
    lkeys, rkeys, rvals = _inner_case(n_dev)
    g, _, (rv,) = tx.distributed_join_inner_numpy(
        lkeys, [], rkeys, [rvals], _mesh(n_dev), capacity_factor=4.0,
        out_budget_factor=16.0)
    assert sorted(zip(g.tolist(), rv.tolist())) == _pairs_oracle(
        lkeys, rkeys, rvals)


def test_inner_join_left_values_carried(n_dev=4):
    rng = np.random.default_rng(3)
    n = 1 << 10
    lkeys = rng.integers(0, 64, n).astype(np.uint64)
    lvals = np.arange(n, dtype=np.uint32) * 7
    rkeys = np.tile(np.arange(64, dtype=np.uint64), 2)
    rvals = np.arange(128, dtype=np.uint32)
    g, (lv,), (rv,) = tx.distributed_join_inner_numpy(
        lkeys, [lvals], rkeys, [rvals], _mesh(n_dev), capacity_factor=4.0,
        out_budget_factor=8.0)
    assert len(g) == 2 * n
    np.testing.assert_array_equal(lv, lvals[g])
    rmap = {int(rvals[j]): int(k) for j, k in enumerate(rkeys)}
    assert all(rmap[int(v)] == int(lkeys[i]) for i, v in zip(g, rv))


def test_inner_join_output_budget_overflow_detected(n_dev=2):
    lkeys = np.full(1 << 8, 5, dtype=np.uint64)
    rkeys = np.full(1 << 8, 5, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="budget"):
        tx.distributed_join_inner_numpy(
            lkeys, [], rkeys, [np.arange(1 << 8, dtype=np.uint32)],
            _mesh(n_dev), capacity_factor=float(n_dev),
            capacity_factor_right=float(n_dev), out_budget_factor=2.0)


def _topk_order(keys, k, largest):
    n = len(keys)
    return (np.lexsort((np.arange(n), ~keys)) if largest
            else np.argsort(keys, kind="stable"))[:k]


def _topk_case(n_dev, largest):
    rng = np.random.default_rng(n_dev + 7 * largest)
    n = 1 << 12
    keys = rng.integers(0, 1 << 40, n, dtype=np.uint64)
    keys[::9] = keys[3]
    return keys, np.arange(n, dtype=np.uint32) * 3


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("largest", [False, True])
def test_top_k_matches_single_machine(n_dev, largest):
    keys, vals = _topk_case(n_dev, largest)
    ks, g, (v,) = tx.distributed_top_k_numpy(keys, [vals], _mesh(n_dev), 37,
                                             largest=largest)
    order = _topk_order(keys, 37, largest)
    np.testing.assert_array_equal(ks, keys[order])
    np.testing.assert_array_equal(g, order.astype(np.uint32))
    np.testing.assert_array_equal(v, vals[order])


def test_top_k_hot_key_everywhere(n_dev=4):
    keys = np.full(1 << 10, 5, dtype=np.uint64)
    _, g, _ = tx.distributed_top_k_numpy(keys, [], _mesh(n_dev), 8)
    np.testing.assert_array_equal(g, np.arange(8))


def test_top_k_k_exceeds_shard_size(n_dev=8):
    keys = np.random.default_rng(4).permutation(1 << 9).astype(np.uint64)
    ks, g, _ = tx.distributed_top_k_numpy(keys, [], _mesh(n_dev), 200)
    order = np.argsort(keys, kind="stable")[:200]
    np.testing.assert_array_equal(g, order.astype(np.uint32))
    np.testing.assert_array_equal(ks, keys[order])


# ---------------------------------------------- tests/test_dcount_distinct.py

def _cd_oracle(keys, values):
    return {int(k): len(np.unique(values[keys == k]))
            for k in np.unique(keys)}


def _cd_case(n_dev):
    rng = np.random.default_rng(n_dev)
    n = 1 << 12
    keys = rng.integers(0, 37, n).astype(np.uint64) << np.uint64(30)
    vals = rng.integers(0, 11, n, dtype=np.int64).astype(np.uint32)
    return keys, vals


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_count_distinct_matches_oracle(n_dev):
    keys, vals = _cd_case(n_dev)
    got = tx.distributed_count_distinct_numpy(keys, vals, _mesh(n_dev),
                                              capacity_factor=float(n_dev))
    assert got == _cd_oracle(keys, vals)


def test_count_distinct_auto_capacity_and_skew():
    rng = np.random.default_rng(0)
    n = 1 << 13
    keys = np.where(rng.random(n) < 0.7, 5,
                    rng.zipf(1.5, n) % 97).astype(np.uint64)
    vals = rng.integers(0, 50, n, dtype=np.int64).astype(np.uint32)
    got = tx.distributed_count_distinct_numpy(keys, vals, _mesh(8),
                                              capacity_factor="auto")
    assert got == _cd_oracle(keys, vals)


def test_count_distinct_all_one_key_all_distinct_values():
    n = 1 << 10
    got = tx.distributed_count_distinct_numpy(
        np.full(n, 42, dtype=np.uint64), np.arange(n, dtype=np.uint32),
        _mesh(4), capacity_factor="auto")
    assert got == {42: n}


def test_count_distinct_all_ones_key_is_exact():
    n = 1 << 10
    keys = np.full(n, (1 << 64) - 1, dtype=np.uint64)
    keys[: n // 2] = 7
    vals = np.arange(n, dtype=np.uint32) % 13
    got = tx.distributed_count_distinct_numpy(keys, vals, _mesh(4),
                                              capacity_factor="auto")
    assert got == _cd_oracle(keys, vals)


# --------------------------------------------------- tests/test_djoinagg.py

def _ja_oracle(lkeys, rkeys, rvals):
    pos = {int(k): int(v) for k, v in zip(rkeys, rvals)}
    out = {}
    for k in lkeys:
        k = int(k)
        if k in pos:
            c, s = out.get(k, (0, 0))
            out[k] = (c + 1, s + pos[k])
    return {k: {"count": c, "sum": s} for k, (c, s) in out.items()}


def _ja_case(n_dev):
    rng = np.random.default_rng(n_dev)
    n_r = 64 * n_dev
    rkeys = np.unique(rng.integers(0, 1 << 40, 4 * n_r,
                                   dtype=np.uint64))[:n_r]
    rvals = rng.integers(0, 1 << 20, n_r, dtype=np.int64).astype(np.uint32)
    n_l = 512 * n_dev
    hit = rng.random(n_l) < 0.7
    lkeys = np.where(hit, rkeys[rng.integers(0, n_r, n_l)],
                     rng.integers(0, 1 << 40, n_l, dtype=np.uint64)
                     | (np.uint64(1) << np.uint64(41)))
    return lkeys, rkeys, rvals


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_join_aggregate_matches_oracle(n_dev):
    lkeys, rkeys, rvals = _ja_case(n_dev)
    got = tx.distributed_join_aggregate_numpy(lkeys, rkeys, rvals,
                                              _mesh(n_dev),
                                              capacity_factor=float(n_dev))
    assert got == _ja_oracle(lkeys, rkeys, rvals)


def test_join_aggregate_hot_left_key_split_partials():
    rng = np.random.default_rng(0)
    n_r = 64 * 8
    rkeys = np.unique(rng.integers(0, 1 << 40, 4 * n_r,
                                   dtype=np.uint64))[:n_r]
    rvals = rng.integers(0, 1 << 20, n_r, dtype=np.int64).astype(np.uint32)
    n_l = 1 << 12
    lkeys = np.full(n_l, rkeys[17], dtype=np.uint64)
    lkeys[::13] = rkeys[rng.integers(0, n_r, len(lkeys[::13]))]
    got = tx.distributed_join_aggregate_numpy(lkeys, rkeys, rvals, _mesh(8),
                                              capacity_factor="auto")
    assert got == _ja_oracle(lkeys, rkeys, rvals)


def test_join_aggregate_exact_u64_sums_past_2_32():
    n_r = 16 * 4
    rkeys = np.arange(n_r, dtype=np.uint64) * np.uint64(1 << 33)
    rvals = np.full(n_r, (1 << 31) + 5, dtype=np.uint64).astype(np.uint32)
    lkeys = rkeys[np.arange(1 << 10) % 4]
    got = tx.distributed_join_aggregate_numpy(lkeys, rkeys, rvals, _mesh(4),
                                              capacity_factor=4.0)
    want_sum = 256 * ((1 << 31) + 5)
    assert want_sum > (1 << 32)
    for k in np.unique(lkeys):
        assert got[int(k)] == {"count": 256, "sum": want_sum}


# ------------------------------------------------- tests/test_douter_join.py

def _outer_oracle(lk, lv, rk, rv):
    rows = {}
    for i, k in enumerate(lk):
        hits = sorted(rv[rk == k].tolist())
        rows[i] = (int(lv[i]), bool(hits), hits if hits else [0])
    return rows, sorted(rv[~np.isin(rk, lk)].tolist())


def _outer_rows(g, lcols, rcols, matched, n_l):
    rows = {}
    for i in range(n_l):
        sel = g == i
        assert sel.any(), f"left row {i} missing"
        rows[i] = (int(lcols[0][sel][0]), bool(matched[sel].all()),
                   sorted(rcols[0][sel].tolist()))
        assert (matched[sel] == matched[sel][0]).all()
    return rows


def _outer_case(n_dev):
    rng = np.random.default_rng(n_dev)
    lk = rng.integers(0, 64, 256).astype(np.uint64)
    rk = (rng.integers(0, 64, 256) * 2).astype(np.uint64)
    lv = np.arange(256, dtype=np.uint32) + 1
    rv = rng.integers(1, 1 << 20, 256).astype(np.uint32)
    return lk, lv, rk, rv


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("full", [False, True])
def test_outer_join_matches_oracle(n_dev, full):
    lk, lv, rk, rv = _outer_case(n_dev)
    out = tx.distributed_join_outer_numpy(
        lk, [lv], rk, [rv], _mesh(n_dev), full=full,
        capacity_factor=float(n_dev), out_budget_factor=16.0)
    want_rows, want_ro = _outer_oracle(lk, lv, rk, rv)
    assert _outer_rows(*out[:4], 256) == want_rows
    if full:
        assert sorted(out[5][0].tolist()) == want_ro
        assert not np.isin(out[4], lk).any()


def test_outer_join_hot_key_one_device():
    n = 128
    lk = np.full(n, 7, dtype=np.uint64)
    rk = np.arange(n, dtype=np.uint64) * 2
    out = tx.distributed_join_outer_numpy(
        lk, [np.arange(n, dtype=np.uint32)], rk, [np.ones(n, np.uint32)],
        _mesh(4), full=True, capacity_factor=4.0, out_budget_factor=8.0)
    g, lcols, rcols, matched, ro_keys, ro_cols = out
    assert len(g) == n and not matched.any()
    assert (rcols[0] == 0).all()
    np.testing.assert_array_equal(np.sort(ro_keys), rk)


def test_outer_join_auto_capacity():
    rng = np.random.default_rng(9)
    n = 256
    lk = rng.integers(0, 32, n).astype(np.uint64)
    rk = rng.integers(0, 32, n).astype(np.uint64)
    out = tx.distributed_join_outer_numpy(
        lk, [np.arange(n, dtype=np.uint32)], rk,
        [np.arange(n, dtype=np.uint32)], _mesh(4), capacity_factor="auto",
        out_budget_factor=64.0)
    want_rows, _ = _outer_oracle(lk, np.arange(n), rk, np.arange(n))
    assert _outer_rows(*out[:4], n) == want_rows


# ------------------------------------ the distributed fuzz and set-op tests

@pytest.mark.parametrize("trial", range(4))
def test_fuzz_exchange_aggregate(trial):
    rng = np.random.default_rng(2000 + trial)
    n_dev = int(rng.choice([2, 4]))
    n = int(rng.integers(8, 500)) * n_dev
    keys = rng.integers(0, int(rng.integers(1, 40)), n).astype(np.uint64)
    vals = rng.integers(0, 1 << 20, n, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, _mesh(n_dev),
                                         aggs=("count", "sum", "min", "max"),
                                         capacity_factor=4.0)
    for k in set(int(x) for x in keys):
        sel = vals[keys == k]
        assert got[k] == {"count": len(sel), "sum": int(sel.sum()),
                          "min": int(sel.min()), "max": int(sel.max())}


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_exchange_inner_join(trial):
    rng = np.random.default_rng(3000 + trial)
    n_dev = int(rng.choice([2, 4]))
    n_l = int(rng.integers(4, 300)) * n_dev
    n_r = int(rng.integers(4, 300)) * n_dev
    kr = int(rng.integers(2, 60))
    lkeys = rng.integers(0, kr, n_l).astype(np.uint64)
    rkeys = rng.integers(0, kr, n_r).astype(np.uint64)
    rvals = np.arange(n_r, dtype=np.uint32) * 7 + 3
    want = _pairs_oracle(lkeys, rkeys, rvals)
    ob = max(4.0, 8.0 * len(want) / max(n_l, 1))
    kw = ({"capacity_factor": "auto"} if trial % 2 == 0 else
          {"capacity_factor": float(n_dev),
           "capacity_factor_right": float(n_dev)})
    g, _, (rv,) = tx.distributed_join_inner_numpy(
        lkeys, [], rkeys, [rvals], _mesh(n_dev), out_budget_factor=ob, **kw)
    assert sorted(zip(g.tolist(), rv.tolist())) == want, trial


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_exchange_top_k(trial):
    rng = np.random.default_rng(4000 + trial)
    n_dev = int(rng.choice([2, 8]))
    n = int(rng.integers(8, 400)) * n_dev
    keys = rng.integers(0, n, n).astype(np.uint64)
    k = int(rng.integers(1, n + 1))
    largest = bool(rng.integers(0, 2))
    _, g, _ = tx.distributed_top_k_numpy(keys, [], _mesh(n_dev), k,
                                         largest=largest)
    np.testing.assert_array_equal(g, _topk_order(keys, k, largest).astype(
        np.uint32))


def _set_oracle(a, b, op):
    ua, ub = np.unique(a), np.unique(b)
    return {"union": np.union1d, "intersect": np.intersect1d,
            "except": np.setdiff1d}[op](ua, ub)


def _set_case(op, n_dev):
    rng = np.random.default_rng(n_dev + len(op))
    a = rng.integers(0, 200, 512 * n_dev, dtype=np.uint64) << np.uint64(33)
    b = rng.integers(100, 300, 256 * n_dev, dtype=np.uint64) << np.uint64(33)
    return a, b


@pytest.mark.parametrize("op", ["union", "intersect", "except"])
@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_set_op_matches_numpy(op, n_dev):
    a, b = _set_case(op, n_dev)
    k, ca, cb = tx.distributed_set_op_numpy(a, b, _mesh(n_dev), op=op,
                                            capacity_factor=float(n_dev))
    np.testing.assert_array_equal(k, _set_oracle(a, b, op))
    for kk, xa, xb in zip(k, ca, cb):
        assert xa == (a == kk).sum() and xb == (b == kk).sum()


def test_set_op_hot_key():
    n = 1 << 12
    a = np.full(n, 7, dtype=np.uint64)
    b = np.full(n // 2, 7, dtype=np.uint64)
    b[: n // 4] = 9
    k, ca, cb = tx.distributed_set_op_numpy(a, b, _mesh(8), op="intersect",
                                            capacity_factor=8.0)
    np.testing.assert_array_equal(k, [7])
    assert ca[0] == n and cb[0] == n // 4


def test_set_op_validation():
    from tpu_qe_torch.exchange.dsort import shard_u64
    mesh = _mesh(2)
    a = shard_u64(np.zeros(4, np.uint64), mesh)
    with pytest.raises(ValueError, match="op must be"):
        tx.distributed_set_op(a, a, mesh, op="minus")


@pytest.mark.parametrize("op", ["union", "intersect", "except"])
def test_set_op_keeps_a_real_all_ones_key(op):
    # the reference drops it (its body reads an all-ones key as padding);
    # the port tells pads by their zero multiplicity: numpy's answer
    ones = np.uint64((1 << 64) - 1)
    a = np.array([1, 2, ones, 5], np.uint64)
    b = np.array([2, ones, 7, 9], np.uint64)
    k, ca, cb = tx.distributed_set_op_numpy(a, b, _mesh(2), op=op,
                                            capacity_factor=2.0)
    np.testing.assert_array_equal(k, _set_oracle(a, b, op))
    jk, _, _ = jx.distributed_set_op_numpy(a, b, _jmesh(2), op=op,
                                           capacity_factor=2.0)
    np.testing.assert_array_equal(jk, k[k != ones])


def _fuzz_keys(rng, n):
    style = rng.integers(0, 4)
    if style == 0:
        return rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if style == 1:
        k = int(rng.integers(1, 20))
        return rng.integers(0, k, n).astype(np.uint64) * np.uint64(0x9E37)
    if style == 2:
        return (rng.zipf(1.3, n).astype(np.uint64)
                * np.uint64(0x9E3779B97F4A7C15))
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    k[rng.random(n) < 0.1] = 0
    k[rng.random(n) < 0.1] = np.uint64((1 << 64) - 1)
    return k


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_ops_distributed(trial):
    rng = np.random.default_rng(3000 + trial)
    n_dev = int(rng.choice([2, 4, 8]))
    mesh = _mesh(n_dev)
    n = int(rng.integers(1, 40)) * n_dev * 8
    keys = _fuzz_keys(rng, n)
    pay = np.arange(n, dtype=np.uint32)
    cf = "auto" if trial % 2 == 0 else float(n_dev)
    k, p = tex.distributed_sort_numpy(keys, pay, mesh, capacity_factor=cf)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(p, order.astype(np.uint32))

    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    got = tx.distributed_aggregate_numpy(keys, vals, mesh,
                                         aggs=("count", "sum"),
                                         capacity_factor=cf)
    cnt, sums = _count_sum_oracle(keys, vals)
    assert got == {kk: {"count": cnt[kk], "sum": sums[kk]} for kk in cnt}

    dvals = rng.integers(0, 30, n, dtype=np.int64).astype(np.uint32)
    got_cd = tx.distributed_count_distinct_numpy(keys, dvals, mesh,
                                                 capacity_factor=cf)
    assert got_cd == _cd_oracle(keys, dvals)


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_ops_distributed_join(trial):
    rng = np.random.default_rng(4000 + trial)
    n_dev = int(rng.choice([2, 4, 8]))
    n_r = int(rng.choice([1, 2, 3])) * n_dev
    rkeys = np.unique(rng.integers(0, 1 << 40, 4 * n_r,
                                   dtype=np.uint64))[:n_r]
    rvals = rng.integers(0, 1 << 30, n_r, dtype=np.uint32)
    n_l = int(rng.integers(1, 30)) * n_dev * 8
    hit = rng.random(n_l) < rng.random()
    lkeys = np.where(hit, rkeys[rng.integers(0, n_r, n_l)],
                     rng.integers(0, 1 << 40, n_l, dtype=np.uint64)
                     | (np.uint64(1) << np.uint64(41)))
    kw = ({"capacity_factor": "auto"} if trial % 2 == 0 else
          {"capacity_factor": float(n_dev),
           "capacity_factor_right": float(n_dev)})
    matched, (rv,) = tx.distributed_join_fk_numpy(lkeys, [], rkeys, [rvals],
                                                  _mesh(n_dev), **kw)
    _check_fk(lkeys, rkeys, rvals, matched, rv)


# ------------------------------- one case per operator against JAX's dops

def test_join_fk_matches_jax():
    lkeys, rkeys, rvals = _fk_case(8)
    m, (rv,) = tx.distributed_join_fk_numpy(lkeys, [], rkeys, [rvals],
                                            _mesh(8), capacity_factor="auto")
    jm, (jrv,) = jx.distributed_join_fk_numpy(lkeys, [], rkeys, [rvals],
                                              _jmesh(8),
                                              capacity_factor="auto")
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(rv, np.asarray(jrv))


def test_join_inner_matches_jax():
    lkeys, rkeys, rvals = _inner_case(4)
    lvals = np.arange(len(lkeys), dtype=np.uint32) * 3
    got = tx.distributed_join_inner_numpy(lkeys, [lvals], rkeys, [rvals],
                                          _mesh(4), capacity_factor="auto",
                                          out_budget_factor=16.0)
    want = jx.distributed_join_inner_numpy(lkeys, [lvals], rkeys, [rvals],
                                           _jmesh(4), capacity_factor="auto",
                                           out_budget_factor=16.0)

    def rows(r):
        return sorted(zip(r[0].tolist(), r[1][0].tolist(), r[2][0].tolist()))
    assert rows(got) == rows(want)


def test_join_outer_matches_jax():
    lk, lv, rk, rv = _outer_case(8)
    kw = dict(full=True, capacity_factor=8.0, out_budget_factor=16.0)
    got = tx.distributed_join_outer_numpy(lk, [lv], rk, [rv], _mesh(8), **kw)
    want = jx.distributed_join_outer_numpy(lk, [lv], rk, [rv], _jmesh(8),
                                           **kw)

    def rows(r):
        return sorted(zip(r[0].tolist(), r[1][0].tolist(), r[2][0].tolist(),
                          r[3].tolist()))
    assert rows(got) == rows(want)
    assert sorted(zip(got[4].tolist(), got[5][0].tolist())) == sorted(
        zip(want[4].tolist(), want[5][0].tolist()))


@pytest.mark.parametrize("largest", [False, True])
def test_top_k_matches_jax(largest):
    keys, vals = _topk_case(8, largest)
    got = tx.distributed_top_k_numpy(keys, [vals], _mesh(8), 37,
                                     largest=largest)
    want = jx.distributed_top_k_numpy(keys, [vals], _jmesh(8), 37,
                                      largest=largest)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2][0], want[2][0])


@functools.lru_cache(maxsize=None)
def _agg_pair(kind):
    if kind == "f32":
        keys, vals = _float_case()
    else:
        rng = np.random.default_rng(12)
        keys = rng.integers(0, 50, 1 << 12).astype(np.uint64) << np.uint64(35)
        vals = rng.integers(0, 1 << 32, 1 << 12, dtype=np.uint64).astype(
            np.uint32)
    aggs = ("count", "sum", "min", "max")
    return (tx.distributed_aggregate_numpy(keys, vals, _mesh(4), aggs=aggs,
                                           capacity_factor="auto"),
            jx.distributed_aggregate_numpy(keys, vals, _jmesh(4), aggs=aggs,
                                           capacity_factor="auto"))


@pytest.mark.parametrize("kind", ["u32", "f32"])
def test_aggregate_matches_jax(kind):
    got, want = _agg_pair(kind)
    assert set(got) == set(want)
    for k in want:
        for a in ("count", "min", "max"):
            assert got[k][a] == want[k][a], (k, a)
        if kind == "u32":
            assert got[k]["sum"] == want[k]["sum"]
        else:
            np.testing.assert_allclose(got[k]["sum"], want[k]["sum"],
                                       rtol=1e-5)


def test_count_distinct_matches_jax():
    keys, vals = _cd_case(8)
    got = tx.distributed_count_distinct_numpy(keys, vals, _mesh(8),
                                              capacity_factor="auto")
    assert got == jx.distributed_count_distinct_numpy(
        keys, vals, _jmesh(8), capacity_factor="auto")


def test_join_aggregate_matches_jax():
    lkeys, rkeys, rvals = _ja_case(8)
    aggs = ("count", "sum", "min", "max")
    got = tx.distributed_join_aggregate_numpy(lkeys, rkeys, rvals, _mesh(8),
                                              aggs=aggs,
                                              capacity_factor="auto")
    assert got == jx.distributed_join_aggregate_numpy(
        lkeys, rkeys, rvals, _jmesh(8), aggs=aggs, capacity_factor="auto")


@pytest.mark.parametrize("op", ["union", "intersect", "except"])
def test_set_op_matches_jax(op):
    a, b = _set_case(op, 8)
    got = tx.distributed_set_op_numpy(a, b, _mesh(8), op=op,
                                      capacity_factor="auto")
    want = jx.distributed_set_op_numpy(a, b, _jmesh(8), op=op,
                                       capacity_factor="auto")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plans_match_jax():
    # the demand every "auto" wrapper sizes its exchange by
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpu_qe.bits import U64 as JU64
    from tpu_qe_torch.exchange.dsort import shard_u32, shard_u64
    lkeys, rkeys, _ = _ja_case(8)
    dvals = (lkeys % np.uint64(7)).astype(np.uint32)
    mesh, jmesh = _mesh(8), _jmesh(8)
    sh = NamedSharding(jmesh, P("x"))

    def jkey(x):
        u = JU64.from_numpy(x)
        return JU64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))

    def mx(d):
        return [int(np.asarray(x).max()) for x in (
            d if isinstance(d, tuple) else (d,))]

    lk, rk = shard_u64(lkeys, mesh), shard_u64(rkeys, mesh)
    jl, jr = jkey(lkeys), jkey(rkeys)
    pairs = [
        (tx.plan_join_capacity(lk, rk, mesh),
         jx.plan_join_capacity(jl, jr, jmesh)),
        (tx.plan_join_inner_capacity(lk, rk, mesh),
         jx.plan_join_inner_capacity(jl, jr, jmesh)),
        (tx.plan_aggregate_capacity(lk, mesh),
         jx.plan_aggregate_capacity(jl, jmesh)),
        (tx.plan_count_distinct_capacity(lk, shard_u32(dvals, mesh), mesh),
         jx.plan_count_distinct_capacity(
             jl, jax.device_put(dvals, sh), jmesh)),
        (tx.plan_set_op_capacity(lk, rk, mesh),
         jx.plan_set_op_capacity(jl, jr, jmesh)),
    ]
    for i, (g, w) in enumerate(pairs):
        assert mx(g) == mx(w), i


def _public_exchange_names():
    from tpu_qe import exchange as jex
    return sorted(n for n in dir(jex) if not n.startswith("_"))


@pytest.mark.parametrize("name", _public_exchange_names())
def test_every_public_name_of_the_exchange_resolves(name):
    # every public name of tpu_qe.exchange (its functions, classes and
    # submodules) has its counterpart in tpu_qe_torch.exchange
    assert tex.NOT_PORTED == ()
    got = getattr(tex, name)
    assert got is not None
    if name in ("dops", "dorderby", "dquantile", "dsort", "dwindow",
                "shuffle"):
        assert got.__name__ == f"tpu_qe_torch.exchange.{name}"
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(tex, "distributed_no_such_operator")
