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


def _empty_side_tables():
    lcols = {"key": np.arange(3, dtype=np.uint64),
             "a": np.arange(3, dtype=np.uint32)}
    rcols = {"key": np.zeros(0, np.uint64), "b": np.zeros(0, np.float32)}
    return _both(lcols), _both(rcols)


@pytest.mark.parametrize("output", ["left", "stream"])
def test_fk_scan_against_an_empty_right_table_matches_jax(output):
    (lt, jlt), (rt, jrt) = _empty_side_tables()
    got = tjoin.join_fk_scan(lt.drop("key"), rt.drop("key"), lt["key"],
                             rt["key"], output=output)
    want = jjoin.join_fk_scan(jlt.drop("key"), jrt.drop("key"), jlt["key"],
                              jrt["key"], output=output)
    if output == "left":
        _same_tables(got[0], want[0])
        _eq(got[1], want[1])
        assert not got[1].any() and not _np(got[0]["b"]).any()
    else:
        for a, b, nm in zip(got[:2] + got[3:], want[:2] + want[3:],
                            ("key", "lidx", "matched", "is_left")):
            _eq(a, b, msg=nm)
        _same_tables(got.values, want.values)
        assert got.is_left.all() and got.key.lo.shape[0] == 3


def test_join_fk_against_an_empty_right_table():
    # the port gives join_fk_scan's rows (every left row, right columns 0,
    # unmatched); the JAX join_fk raises there, its Table.join does not
    (lt, jlt), (rt, jrt) = _empty_side_tables()
    got = tjoin.join_fk(lt, rt)
    assert not got.matched.any() and got.matched.shape[0] == 3
    _eq(got.table["a"], np.arange(3, dtype=np.uint32))
    _eq(got.table["key"], np.arange(3, dtype=np.uint64))
    _eq(got.table["b"], np.zeros(3, np.float32))
    with pytest.raises(IndexError):
        jjoin.join_fk(jlt, jrt)
    t, m = lt.join(rt)
    jt, jm = jlt.join(jrt)
    _same_tables(t, jt)
    _eq(m, jm)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("empty", ["right", "left", "both"])
def test_joins_with_an_empty_side_follow_sql(how, empty):
    # inner: no row; left: each left row once, right columns 0, unmatched;
    # full: the non-empty side's rows. The JAX joins raise IndexError on
    # an empty side (its binary search gathers from an empty axis).
    (lt, jlt), (rt, jrt) = _empty_side_tables()
    if empty == "left":
        (lt, jlt), (rt, jrt) = (rt, jrt), (lt, jlt)
    elif empty == "both":
        lt, jlt = rt.drop("b").with_column("a", lt["a"][:0]), None
    n_l, n_r = lt.num_rows, rt.num_rows
    if how == "inner":
        res = tjoin.join_inner(lt, rt)
        assert int(res.num_out) == 0 and int(res.overflow) == 0
    else:
        res = tjoin.join_outer(lt, rt, how=how)
        assert int(res.num_out) == n_l and int(res.overflow) == 0
        assert not res.matched[:n_l].any()
        for nm in rt.drop("key"):
            assert not _np(res.table[nm])[:n_l].any()
        _eq(res.table["a"] if "a" in lt else res.left_index[:0],
            np.arange(n_l, dtype=np.uint32), n_l)
        if how == "full":
            assert int(res.num_right_only) == n_r
            _eq(res.right_only["key"], np.arange(n_r, dtype=np.uint64), n_r)
    if jlt is not None:
        fn = (jjoin.join_inner if how == "inner" else
              lambda a, b: jjoin.join_outer(a, b, how=how))
        with pytest.raises(IndexError):
            fn(jlt, jrt)


# E3's plain twins (kernels/join.py) and join_inner's two steps: the index
# and the emit against join_sorted + expand_ranges and the JAX join_inner

def _e3_case(kind):
    """(left keys, right keys, out_budget) of a small case."""
    rng = np.random.default_rng(len(kind))
    if kind == "empty_left":
        return np.zeros(0, np.uint64), np.arange(50, dtype=np.uint64), 16
    if kind == "empty_right":
        return np.arange(40, dtype=np.uint64), np.zeros(0, np.uint64), 80
    base = rng.permutation(300).astype(np.uint64) * np.uint64(3) + BIT31
    if kind == "hi_keys":              # every word matters: hi != 0
        base = rng.integers(0, 1 << 64, 300, dtype=np.uint64) | BIT31
    if kind in ("dup", "overflow"):    # runs of up to ~8 right rows a key
        base = base[rng.integers(0, 60, 300)]
    lkeys = base[rng.integers(0, 300, 400)]
    if kind != "unique":               # and left keys matching nothing
        lkeys[::7] = rng.integers(0, 1 << 64, len(lkeys[::7]),
                                  dtype=np.uint64) | np.uint64(1)
    return lkeys, base, 100 if kind == "overflow" else 4000


E3_CASES = ["unique", "dup", "unmatched", "hi_keys", "empty_left",
            "empty_right", "overflow"]


@pytest.mark.parametrize("kind", E3_CASES)
def test_join_index_and_emit_match_join_sorted_and_jax(kind):
    from tpu_qe_torch.kernels import join as jk
    lkeys, rkeys, budget = _e3_case(kind)
    rsorted = np.sort(rkeys)
    q, r = U64.from_numpy(lkeys, "cpu"), U64.from_numpy(rsorted, "cpu")
    idx = jk.join_index(q, r)
    ranges = tjoin.join_sorted(q, r)
    c = _np(ranges.end) - _np(ranges.start)
    assert idx.start.dtype == idx.count.dtype == torch.int32
    _eq(idx.start, ranges.start)
    _eq(idx.count, c)
    assert idx.totals.tolist() == [int(c.sum()), int((c != 1).sum())]
    assert int(idx.num_out) == int(c.sum())
    li, ri = jk.join_emit(idx, budget)
    wli, wri, total, _ = tjoin.expand_ranges(ranges, budget)
    m = min(int(total), budget)
    _eq(li, wli, m)
    _eq(ri, wri, m)

    left = {"key": lkeys, "a": np.arange(len(lkeys), dtype=np.uint32)}
    right = {"key": rkeys, "b": (np.arange(len(rkeys)) * 7).astype(np.int32)}
    (lt, jlt), (rt, jrt) = _both(left), _both(right)
    got = tjoin.join_inner(lt, rt, out_budget=budget)
    if kind.startswith("empty"):     # the JAX join raises on an empty side
        assert int(got.num_out) == 0 == int(got.overflow)
        return
    want = jjoin.join_inner(jlt, jrt, out_budget=budget)
    assert int(got.num_out) == int(want.num_out) == int(c.sum())
    assert int(got.overflow) == int(want.overflow) == int(c.sum() > budget)
    _same_tables(got.table, want.table, m)
    _eq(got.left_index, want.left_index, m)
    _eq(got.right_index, want.right_index, m)
    if kind == "overflow":
        assert int(got.num_out) > budget and int(got.overflow) == 1


@pytest.mark.parametrize("kind,passes", [
    ("every_row_once", True),
    ("same_count_but_0_and_2", False),   # one row 0 matches, another 2
    ("one_row_unmatched", False),
    ("duplicate_matches", False),
])
def test_join_inner_rows_passes_the_left_through_only_if_each_matched_once(
        kind, passes):
    rng = np.random.default_rng(9)
    rkeys = rng.permutation(64).astype(np.uint64) << np.uint64(33)
    lkeys = rkeys[rng.permutation(64)[:60]]          # distinct
    if kind == "same_count_but_0_and_2":
        rkeys = np.concatenate([rkeys, lkeys[:1]])   # row 0 matches twice
        lkeys[1] = np.uint64(5)                      # row 1 not at all
    elif kind == "one_row_unmatched":
        lkeys[3] = np.uint64(5)
    elif kind == "duplicate_matches":
        rkeys = np.concatenate([rkeys, rkeys])
    left = Table.from_numpy({"key": lkeys, "a": np.arange(60, dtype=np.uint32),
                             "f": rng.standard_normal(60).astype(np.float32)},
                            device="cpu")
    right = Table.from_numpy({"key": rkeys,
                              "b": np.arange(len(rkeys), dtype=np.uint32)},
                             device="cpu")
    probe = tjoin.join_inner_index(left, right)
    num, nonunit = probe.index.totals.tolist()
    assert (num == 60) == (kind in ("every_row_once",
                                    "same_count_but_0_and_2"))
    out, passed = tjoin.join_inner_rows(left, probe, num, nonunit)
    assert passed == passes
    want = tjoin.join_inner(left, right, out_budget=max(num, 1))
    assert out.num_rows == num == int(want.num_out)
    _same_tables(out, want.table, num)
    for nm in ("a", "f"):     # the left table's own tensors, or copies
        assert (out[nm].data_ptr() == left[nm].data_ptr()) == passes


def test_join_index_and_emit_check_their_arguments_and_launch_nothing_on_cpu():
    from tpu_qe_torch.kernels import LAUNCHES
    from tpu_qe_torch.kernels import join as jk
    before = dict(LAUNCHES)
    k = U64.from_numpy(np.arange(10, dtype=np.uint64), "cpu")
    idx = jk.join_index(k, k)
    jk.join_emit(idx, 16)
    assert LAUNCHES == before
    bad = [U64(k.lo.to(torch.int64), k.hi), U64(k.lo[::2], k.hi[::2]),
           U64(k.lo, k.hi[:5]), U64(k.lo.reshape(2, 5), k.hi.reshape(2, 5))]
    for b in bad:
        with pytest.raises(ValueError):
            jk.join_index(b, k)
        with pytest.raises(ValueError):
            jk.join_index(k, b)
    with pytest.raises(ValueError):
        jk.join_emit(idx._replace(count=idx.count.to(torch.int64)), 16)
    with pytest.raises(ValueError):
        jk.join_emit(idx._replace(totals=idx.totals[:1]), 16)
    with pytest.raises(ValueError):
        jk.join_emit(idx, 0)
