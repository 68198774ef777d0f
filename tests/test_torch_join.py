"""tpu_qe_torch.ops.join against tpu_qe.ops.join on CPU tensors (the radix
sort runs its kernels' plain twins here). Inputs come from numpy seeds and
cover bit-31 keys, unmatched left keys, duplicate right keys and validity
masks. Tolerance: exact equality of every output the JAX docstrings
define (padded outputs: the prefix of num_out slots; join_fk's gathered
values only where matched).

One JAX output is not defined by its input: join_inner_padded and
join_outer_padded sort the right side with an unstable lax.sort, so with
duplicate right keys the right row a slot shows depends on the sort's tie
order (ROADMAP Queue C). There the tests hold the tie-free outputs equal,
the per-left-row multisets of right values equal, and the port to the
stable order.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.ops import join as jjoin  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.ops import join as tjoin  # noqa: E402
from tpu_qe_torch.table import Table, column_to_numpy  # noqa: E402

BIT31 = np.uint64(0x80000000)


def _np(x):
    if isinstance(x, (U64, JU64)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return column_to_numpy(x) if x.dtype in (
            torch.uint32, torch.int32, torch.float32) else x.numpy()
    return np.asarray(x)


def _eq(got, want, m=None, msg=""):
    g, w = _np(got), _np(want)
    if m is not None:
        g, w = g[:m], w[:m]
    assert g.shape == w.shape, msg
    if g.dtype == np.float32 or w.dtype == np.float32:
        g, w = g.view(np.uint32), w.view(np.uint32)
    np.testing.assert_array_equal(g.astype(np.uint64), w.astype(np.uint64),
                                  err_msg=msg)


def _same_tables(t, jt, m=None, mask=None):
    assert sorted(t) == sorted(jt)
    for nm in t:
        g, w = _np(t[nm]), _np(jt[nm])
        if mask is not None:
            g, w = g[mask], w[mask]
        _eq(g, w, m, nm)


def _sides(rng, n_l, n_r, dup):
    base = rng.integers(0, 1 << 64, n_r, dtype=np.uint64) | BIT31
    if dup:
        base = base[rng.integers(0, max(n_r // 4, 1), n_r)]
    lkeys = base[rng.integers(0, n_r, n_l)]
    lkeys[::9] = rng.integers(0, 1 << 64, len(lkeys[::9]), dtype=np.uint64)
    left = {"key": lkeys, "lv": rng.integers(0, 1 << 32, n_l,
                                             dtype=np.uint64).astype(np.uint32),
            "x": rng.standard_normal(n_l).astype(np.float32)}
    right = {"key": base,
             "rv": rng.integers(0, 1 << 32, n_r, dtype=np.uint64)
             .astype(np.uint32),
             "x": rng.integers(-5, 5, n_r).astype(np.int32),
             "w": rng.integers(0, 1 << 64, n_r, dtype=np.uint64)}
    return left, right


def _both(cols):
    return Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("output", ["left", "stream"])
def test_join_fk_scan_matches_jax(output, dup, masks):
    rng = np.random.default_rng(dup * 2 + masks)
    lcols, rcols = _sides(rng, 1500, 700, dup)
    (lt, jlt), (rt, jrt) = _both(lcols), _both(rcols)
    lv = rng.random(1500) < 0.8 if masks else None
    rv = rng.random(700) < 0.8 if masks else None
    got = tjoin.join_fk_scan(
        lt.drop("key"), rt.drop("key"), lt["key"], rt["key"],
        None if lv is None else torch.from_numpy(lv),
        None if rv is None else torch.from_numpy(rv), output=output)
    want = jjoin.join_fk_scan(
        jlt.drop("key"), jrt.drop("key"), jlt["key"], jrt["key"],
        None if lv is None else jnp.asarray(lv),
        None if rv is None else jnp.asarray(rv), output=output)
    if output == "left":
        _same_tables(got[0], want[0])
        _eq(got[1], want[1])
        assert 0 < int(got[1].sum()) < 1500
    else:
        for a, b, nm in zip(got[:2] + got[3:], want[:2] + want[3:],
                            ("key", "lidx", "matched", "is_left")):
            _eq(a, b, msg=nm)
        _same_tables(got.values, want.values)


def test_join_fk_and_semi_anti_match_jax():
    rng = np.random.default_rng(5)
    lcols, rcols = _sides(rng, 1000, 400, False)
    (lt, jlt), (rt, jrt) = _both(lcols), _both(rcols)
    got = tjoin.join_fk(lt, rt)
    want = jjoin.join_fk(jlt, jrt)
    m = _np(want.matched)
    _eq(got.matched, want.matched)
    _same_tables(got.table, want.table, mask=m)
    for name in ("join_semi", "join_anti"):
        t, c = getattr(lt, name)(rt)
        jt, jc = getattr(jlt, name)(jrt)
        assert int(c) == int(jc)
        _same_tables(t, jt)           # selected rows, then the rest, stably


@pytest.mark.parametrize("budget", [None, 50, 4000])
@pytest.mark.parametrize("dup", [False, True])
def test_join_inner_matches_jax(dup, budget):
    rng = np.random.default_rng(11 + dup)
    lcols, rcols = _sides(rng, 800, 500, dup)
    (lt, jlt), (rt, jrt) = _both(lcols), _both(rcols)
    got = tjoin.join_inner(lt, rt, out_budget=budget)
    want = jjoin.join_inner(jlt, jrt, out_budget=budget)
    assert int(got.num_out) == int(want.num_out)
    assert int(got.overflow) == int(want.overflow)
    m = min(int(want.num_out), budget or 1600)
    _same_tables(got.table, want.table, m)
    _eq(got.left_index, want.left_index, m)
    _eq(got.right_index, want.right_index, m)


@pytest.mark.parametrize("how", ["left", "full"])
@pytest.mark.parametrize("dup", [False, True])
def test_join_outer_matches_jax(how, dup):
    rng = np.random.default_rng(21 + dup)
    lcols, rcols = _sides(rng, 600, 900, dup)
    (lt, jlt), (rt, jrt) = _both(lcols), _both(rcols)
    got = tjoin.join_outer(lt, rt, how=how)
    want = jjoin.join_outer(jlt, jrt, how=how)
    m = int(want.num_out)
    assert int(got.num_out) == m and int(got.overflow) == int(want.overflow)
    _same_tables(got.table, want.table, m)
    for a, b in zip(got[1:4], want[1:4]):
        _eq(a, b, m)
    if how == "full":
        r = int(want.num_right_only)
        assert int(got.num_right_only) == r and r > 0
        _same_tables(got.right_only, want.right_only)   # zero padding too


def test_searchsorted_join_sorted_expand_ranges_match_jax():
    rng = np.random.default_rng(3)
    rk = np.sort(rng.integers(0, 50, 300).astype(np.uint64) << np.uint64(31))
    lk = rng.integers(0, 60, 200).astype(np.uint64) << np.uint64(31)
    lk[:3] = [0, np.uint64(0xFFFFFFFFFFFFFFFF), rk[-1]]
    r, jr = U64.from_numpy(rk, "cpu"), JU64.from_numpy(rk)
    q, jq = U64.from_numpy(lk, "cpu"), JU64.from_numpy(lk)
    for side in ("left", "right"):
        _eq(tjoin.searchsorted_u64(r, q, side), jjoin.searchsorted_u64(
            jr, jq, side))
    ranges, jranges = tjoin.join_sorted(q, r), jjoin.join_sorted(jq, jr)
    _eq(ranges.start, jranges.start)
    _eq(ranges.end, jranges.end)
    for budget in (1, 100, 5000):
        li, ri, tot, ovf = tjoin.expand_ranges(ranges, budget)
        jli, jri, jtot, jovf = jjoin.expand_ranges(jranges, budget)
        assert int(tot) == int(jtot) and int(ovf) == int(jovf)
        m = min(int(tot), budget)
        _eq(li, jli, m)
        _eq(ri, jri, m)


def _padded_case(rng, dup):
    lcols, rcols = _sides(rng, 700, 500, dup)
    lv, rv = rng.random(700) < 0.8, rng.random(500) < 0.85
    return lcols, rcols, lv, rv


def _slot_multisets(table, li, m, col):
    out = collections.defaultdict(collections.Counter)
    for i, v in zip(_np(li)[:m], _np(table[col])[:m]):
        out[int(i)][int(v)] += 1
    return out


@pytest.mark.parametrize("kind", ["inner", "left", "full"])
@pytest.mark.parametrize("dup", [False, True])
def test_padded_joins_match_jax(kind, dup):
    rng = np.random.default_rng(31 + dup)
    lcols, rcols, lv, rv = _padded_case(rng, dup)
    (lt, jlt), (rt, jrt) = _both(lcols), _both(rcols)
    args = (lt.drop("key"), rt.drop("key"), lt["key"], rt["key"],
            torch.from_numpy(lv), torch.from_numpy(rv), 6000)
    jargs = (jlt.drop("key"), jrt.drop("key"), jlt["key"], jrt["key"],
             jnp.asarray(lv), jnp.asarray(rv), 6000)
    if kind == "inner":
        got, want = (tjoin.join_inner_padded(*args),
                     jjoin.join_inner_padded(*jargs))
    else:
        got = tjoin.join_outer_padded(*args, full=kind == "full")
        want = jjoin.join_outer_padded(*jargs, full=kind == "full")
    m = int(want.num_out)
    assert int(got.num_out) == m and int(got.overflow) == int(want.overflow)
    assert m <= 6000              # no row's matches cut at the budget
    _eq(got.left_index, want.left_index, m)
    _eq(got.right_index, want.right_index, m)
    for nm in ("lv", "x"):
        _eq(got.table[nm], want.table[nm], m)
    if not dup:
        _same_tables(got.table, want.table, m)
    else:
        for col in ("rv", "right_x"):
            assert (_slot_multisets(got.table, got.left_index, m, col)
                    == _slot_multisets(want.table, want.left_index, m, col))
    if kind == "full":
        r = int(want.num_right_only)
        assert int(got.num_right_only) == r
        _eq(got.right_only["_key"], want.right_only["_key"], r)
        if not dup:
            _same_tables(got.right_only, want.right_only)


def test_padded_join_keeps_duplicate_right_rows_in_input_order():
    # the input of the Queue C entry: 100 right rows over 3 keys, all valid
    rng = np.random.default_rng(0)
    rkey = rng.integers(0, 3, 100).astype(np.uint64)
    right = {"key": rkey, "r": np.arange(100, dtype=np.uint32)}
    left = {"key": np.array([1], np.uint64)}
    (lt, jlt), (rt, jrt) = _both(left), _both(right)
    ones_l, ones_r = np.ones(1, bool), np.ones(100, bool)
    got = tjoin.join_inner_padded(lt, rt.drop("key"), lt["key"], rt["key"],
                                  torch.from_numpy(ones_l),
                                  torch.from_numpy(ones_r), 64)
    want = jjoin.join_inner_padded(jlt, jrt.drop("key"), jlt["key"],
                                   jrt["key"], jnp.asarray(ones_l),
                                   jnp.asarray(ones_r), 64)
    m = int(got.num_out)
    assert m == int(want.num_out) == int((rkey == 1).sum())
    stable = np.flatnonzero(rkey == 1).astype(np.uint32)
    np.testing.assert_array_equal(_np(got.table["r"])[:m], stable)
    assert sorted(_np(want.table["r"])[:m]) == sorted(stable)
