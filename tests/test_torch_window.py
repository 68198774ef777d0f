"""tpu_qe_torch.ops.window against tpu_qe.ops.window.window on CPU tensors
(the radix sort runs its kernels' plain twins here).

One spec holds every function kind the reference accepts (ROWS frames
with PRECEDING / FOLLOWING, moving_count, whole-partition and total
frames, tie-aware and bounded RANGE frames); it runs over u32 / i32 / f32
values and orders with many ties, partitions of hundreds of rows and of
one row, past the blocked scan's 4096-row threshold. One JAX answer per
(values, order, output) case is held against both port backends, function
by function. Tolerance: exact equality of integers, U64 sums, ranks,
counts and values; float32 outputs (float sums and averages, averages,
percent_rank) within rtol=1e-5, atol=1e-3.

Bounded RANGE frames over int32 orders are held to a numpy brute force
(the SQL definition) instead: the reference decodes its int32 order plane
as sign-flipped bits, so its frames there are wrong where the orders span
zero, and with 64-bit types enabled (as in this test suite) it raises.
test_bounded_range_int32_order_across_zero_follows_sql pins both.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.table import Table, column_from_numpy  # noqa: E402

jw = importlib.import_module("tpu_qe.ops.window")
tw = importlib.import_module("tpu_qe_torch.ops.window")

FUNCS = {
    "rn": "row_number", "rk": ("rank",), "dr": ("dense_rank",),
    "pr": ("percent_rank",), "nt": ("ntile", 4), "nt7": ("ntile", 7),
    "rs": ("running_sum", "v"), "rmin": ("running_min", "v"),
    "rmax": ("running_max", "v"),
    "lag": ("lag", "v"), "lead": ("lead", "v", 3),
    "lag3": ("lag", "v", 7, 3), "lead2": ("lead", "v", 1, 2),
    "fv": ("first_value", "v"), "lv": ("last_value", "v"),
    "ms": ("moving_sum", "v", 3), "mmin": ("moving_min", "v", 5),
    "mmax": ("moving_max", "v", 3), "mavg": ("moving_avg", "v", 4),
    "ms1": ("moving_sum", "v", 1), "mmin1": ("moving_min", "v", 1),
    "msf": ("moving_sum", "v", 4, 3), "mminf": ("moving_min", "v", 2, 2),
    "mmaxf": ("moving_max", "v", 6, 1), "mavgf": ("moving_avg", "v", 3, 2),
    "msu": ("moving_sum", "v", None, 2), "mavgu": ("moving_avg", "v", None, 1),
    "mmaxu": ("moving_max", "v", None, 1),
    "mc": ("moving_count", 3), "mcf": ("moving_count", 2, 4),
    "mcu": ("moving_count", None, 2),
    "ts": ("total_sum", "v"), "tmin": ("total_min", "v"),
    "tmax": ("total_max", "v"), "tavg": ("total_avg", "v"),
    "pc": ("partition_count",), "ravg": ("running_avg", "v"),
    "ru": ("range_sum", "v", "unbounded"),
    "rua": ("range_avg", "v", "unbounded"),
    "rumin": ("range_min", "v", "unbounded"),
    "rumax": ("range_max", "v", "unbounded"),
    "rb": ("range_sum", "v", 3), "rb0": ("range_sum", "v", 0),
    "rba": ("range_avg", "v", 2), "rbmin": ("range_min", "v", 3),
    "rbmax": ("range_max", "v", 1), "rbbig": ("range_max", "v", 1000),
}
BOUNDED = [nm for nm, f in FUNCS.items()
           if isinstance(f, tuple) and f[0].startswith("range_")
           and f[2] != "unbounded"]
# (values, order) dtypes; None: no ORDER BY
CASES = [("uint32", "uint32"), ("int32", "int32"), ("float32", "float32"),
         ("uint32", "float32"), ("float32", "int32"), ("int32", "uint32"),
         ("uint32", None)]
N = 5000        # past the blocked scan's 4 * 1024-row threshold


def _values(rng, n, dtype):
    if dtype == "float32":
        v = (rng.standard_normal(n) * 100).astype(np.float32)
        v[::13] = v[::13].round()
        return v
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v[::5] &= np.uint32(0x8000000F)           # repeats, bit 31 set
    return v.view(dtype)


def _orders(rng, n, dtype):
    o = rng.integers(0, 40, n)                 # many ties
    if dtype == "int32":
        return (o - 20).astype(np.int32)       # spans zero
    if dtype == "float32":
        return (o * 0.75 - 10).astype(np.float32)
    return o.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _data(vdt, odt, n=N):
    rng = np.random.default_rng(17 + n)
    k = rng.integers(0, 9, n).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    k[:6] = np.arange(6, dtype=np.uint64) + np.uint64(1 << 40)  # singletons
    o = None if odt is None else _orders(rng, n, odt)
    return k, o, _values(rng, n, vdt)


def _spec(odt):
    if odt is None:
        return {nm: f for nm, f in FUNCS.items()
                if (f if isinstance(f, str) else f[0]) not in (
                    "rank", "dense_rank", "percent_rank")
                and not (isinstance(f, tuple) and f[0].startswith("range"))}
    if odt == "int32":
        return {nm: f for nm, f in FUNCS.items() if nm not in BOUNDED}
    return FUNCS


def _np(x):
    if isinstance(x, (U64, JU64)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _check(got, want, name):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
    if g.dtype == np.float32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3, err_msg=name)
    else:
        np.testing.assert_array_equal(g, w, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax(vdt, odt, output):
    k, o, v = _data(vdt, odt)
    return jw.window(JU64.from_numpy(k), _spec(odt),
                     order=None if o is None else jnp.asarray(o),
                     values={"v": jnp.asarray(v)}, output=output)


@functools.lru_cache(maxsize=None)
def _port(vdt, odt, output, backend, n=N):
    k, o, v = _data(vdt, odt, n)
    return tw.window(U64.from_numpy(k, "cpu"), _spec(odt),
                     order=None if o is None else column_from_numpy(o, "cpu"),
                     values={"v": column_from_numpy(v, "cpu")},
                     output=output, backend=backend)


PARAMS = [(vdt, odt, nm) for vdt, odt in CASES for nm in _spec(odt)]


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("vdt,odt,name", PARAMS)
def test_window_function_matches_jax(vdt, odt, name, backend):
    _check(_port(vdt, odt, "input", backend).cols[name],
           _jax(vdt, odt, "input").cols[name], name)


@pytest.mark.parametrize("vdt,odt", [("float32", "float32"),
                                     ("uint32", None)])
def test_sorted_output_matches_jax(vdt, odt):
    want = _jax(vdt, odt, "sorted")
    for backend in ("radix", "torch"):
        got = _port(vdt, odt, "sorted", backend)
        np.testing.assert_array_equal(got.pos.numpy(),
                                      _np(want.pos).astype(np.int64))
        assert got.pos.dtype == torch.int64
        for name in want.cols:
            _check(got.cols[name], want.cols[name], name)


# ------------------------------------------------ bounded RANGE, SQL oracle

def _sql_range(k, o, v, agg, x):
    """Bounded RANGE frames by their SQL definition: per row, the rows of
    its partition with order in [o_i - x, o_i] (the lower bound saturating
    in the order dtype)."""
    wide = v.astype(np.int64) if v.dtype != np.float32 else v
    out = []
    for i in range(len(k)):
        if o.dtype == np.float32:
            lo = np.float32(o[i]) - np.float32(x)
        else:
            floor = 0 if o.dtype == np.uint32 else -(1 << 31)
            lo = max(int(o[i]) - int(x), floor)
        m = (k == k[i]) & (o >= lo) & (o <= o[i])
        f = wide[m]
        if agg == "sum":
            out.append(int(f.sum()) % (1 << 64) if v.dtype != np.float32
                       else f.sum(dtype=np.float64))
        elif agg == "avg":
            out.append(float(f.sum(dtype=np.float64)) / len(f))
        else:
            out.append(f.min() if agg == "min" else f.max())
    if agg == "sum" and v.dtype != np.float32:
        return np.array(out, np.uint64)
    if agg in ("min", "max"):
        return np.array(out, wide.dtype).astype(v.dtype)
    return np.array(out)


def _check_sql(got, want, agg, name):
    g = _np(got)
    if g.dtype == np.float32:
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-2,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(g, want, err_msg=name)


@pytest.mark.parametrize("backend", ["radix", "torch"])
@pytest.mark.parametrize("vdt", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("odt", ["int32", "int32_near_min"])
def test_bounded_range_over_int32_orders_follows_sql(vdt, odt, backend):
    rng = np.random.default_rng(29)
    n = 400
    k = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(33)
    o = rng.integers(-30, 30, n).astype(np.int32)
    if odt == "int32_near_min":     # lower bounds saturate at INT_MIN
        o = (o.astype(np.int64) - (1 << 31) + 40).astype(np.int32)
    v = _values(rng, n, vdt)
    spec = {nm: FUNCS[nm] for nm in BOUNDED}
    spec["rbhuge"] = ("range_sum", "v", 1 << 33)
    res = tw.window(U64.from_numpy(k, "cpu"), spec,
                    order=column_from_numpy(o, "cpu"),
                    values={"v": column_from_numpy(v, "cpu")},
                    backend=backend)
    for nm, (kind, _, x) in spec.items():
        agg = kind.rsplit("_", 1)[1]
        _check_sql(res.cols[nm], _sql_range(k, o, v, agg, x), agg, nm)


PROBE_DIFFERS = {"sum": [2, 5, 14, 17, 21, 22, 46, 56, 62, 63],
                 "max": [5, 22]}


def test_bounded_range_int32_order_across_zero_follows_sql():
    """The port follows SQL where the reference does not: RANGE 5
    PRECEDING over an int32 order that spans zero. The reference (without
    64-bit types) differs from SQL on exactly these rows, and with them
    enabled it raises; a change on either side shows here."""
    rng = np.random.default_rng(0)
    n = 64
    k = rng.integers(0, 3, n).astype(np.uint32)
    o = rng.integers(-20, 20, n).astype(np.int32)
    v = rng.integers(0, 10, n).astype(np.uint32)
    key = k.astype(np.uint64)
    seen = {}
    for agg in ("sum", "max"):
        spec = {"r": ("range_" + agg, "v", 5)}
        want = _sql_range(key, o, v, agg, 5)
        got = tw.window(U64.from_numpy(key, "cpu"), spec,
                        order=column_from_numpy(o, "cpu"),
                        values={"v": column_from_numpy(v, "cpu")})
        _check_sql(got.cols["r"], want, agg, agg)
        args = (JU64(jnp.asarray(k), jnp.zeros(n, jnp.uint32)), spec)
        with jax.enable_x64(False):
            ref = jw.window(*args, order=jnp.asarray(o),
                            values={"v": jnp.asarray(v)}).cols["r"]
            ref = _np(ref).astype(np.uint64)
        assert np.flatnonzero(ref != want).tolist() == PROBE_DIFFERS[agg]
        with pytest.raises(TypeError):
            jw.window(*args, order=jnp.asarray(o),
                      values={"v": jnp.asarray(v)})
        seen[agg] = want, ref
    (sql_sum, ref_sum), (sql_max, ref_max) = seen["sum"], seen["max"]
    assert (sql_sum[5], ref_sum[5]) == (5, 1)       # key 0, order 1
    assert (sql_sum[2], ref_sum[2]) == (40, 39)     # key 1, order 3
    assert (sql_max[22], ref_max[22]) == (6, 0)     # key 2, order 0


# ------------------------------------------------------------ edge shapes

SMALL = {"rn": "row_number", "rk": ("rank",), "dr": ("dense_rank",),
         "pr": ("percent_rank",), "rs": ("running_sum", "v"),
         "fs": ("running_sum", "f"), "lv": ("last_value", "v"),
         "msf": ("moving_sum", "v", 2, 1), "mmin": ("moving_min", "f", 3),
         "tavg": ("total_avg", "v"), "nt": ("ntile", 3),
         "ru": ("range_sum", "f", "unbounded"),
         "rbmax": ("range_max", "v", 2), "mc": ("moving_count", 2, 1)}


@pytest.mark.parametrize("shape", ["one_partition", "singletons", "one_row"])
def test_edge_partitions_match_jax(shape):
    rng = np.random.default_rng(41)
    n = 1 if shape == "one_row" else 300
    k = (np.full(n, 0xFFFFFFFFFFFFFFFF, np.uint64) if shape != "singletons"
         else rng.permutation(n).astype(np.uint64) << np.uint64(31))
    o = rng.integers(0, 7, n).astype(np.uint32)
    v = _values(rng, n, "int32")
    f = _values(rng, n, "float32")
    want = jw.window(JU64.from_numpy(k), SMALL, order=jnp.asarray(o),
                     values={"v": jnp.asarray(v), "f": jnp.asarray(f)})
    for backend in ("radix", "torch"):
        got = tw.window(U64.from_numpy(k, "cpu"), SMALL,
                        order=column_from_numpy(o, "cpu"),
                        values={"v": column_from_numpy(v, "cpu"),
                                "f": column_from_numpy(f, "cpu")},
                        backend=backend)
        for name in SMALL:
            _check(got.cols[name], want.cols[name], name)


@pytest.mark.parametrize("output", ["input", "sorted"])
def test_empty_table_matches_jax(output):
    v = np.zeros(0, np.int32)
    f = np.zeros(0, np.float32)
    want = jw.window(JU64.from_numpy(np.zeros(0, np.uint64)), SMALL,
                     order=jnp.zeros(0, jnp.uint32),
                     values={"v": jnp.asarray(v), "f": jnp.asarray(f)},
                     output=output)
    got = tw.window(U64.from_numpy(np.zeros(0, np.uint64), "cpu"), SMALL,
                    order=column_from_numpy(np.zeros(0, np.uint32), "cpu"),
                    values={"v": column_from_numpy(v, "cpu"),
                            "f": column_from_numpy(f, "cpu")},
                    output=output)
    for name in SMALL:
        _check(got.cols[name], want.cols[name], name)
    assert (got.pos is None) == (want.pos is None)


@pytest.mark.parametrize("funcs,kw", [
    ({"x": ("nope",)}, {}),
    ({"x": ("running_sum",)}, {}),
    ({"x": ("rank",)}, {"order": False}),
    ({"x": ("range_sum", "v", -1)}, {}),
    ({"x": ("range_sum", "v", True)}, {}),
    ({"x": ("moving_sum", "v", 0)}, {}),
    ({"x": ("moving_sum", "v", None)}, {}),
    ({"x": ("moving_sum", "v", 2, -1)}, {}),
    ({"x": ("lag", "v", 0, 0)}, {}),
    ({"x": ("ntile", 0)}, {}),
    ({"x": ("moving_count", 0)}, {}),
    ({"x": ("moving_count", 2, -1)}, {}),
    ({"x": ("running_sum", "w")}, {}),
    ({"x": "row_number"}, {"output": "both"}),
])
def test_window_rejects_what_jax_rejects(funcs, kw):
    n = 8
    order = None if kw.get("order") is False else np.arange(n, dtype=np.uint32)
    out = kw.get("output", "input")
    with pytest.raises(ValueError):
        jw.window(JU64.from_numpy(np.zeros(n, np.uint64)), funcs,
                  order=None if order is None else jnp.asarray(order),
                  values={"v": jnp.zeros(n, jnp.uint32)}, output=out)
    with pytest.raises(ValueError):
        tw.window(U64.from_numpy(np.zeros(n, np.uint64), "cpu"), funcs,
                  order=None if order is None
                  else column_from_numpy(order, "cpu"),
                  values={"v": column_from_numpy(np.zeros(n, np.uint32),
                                                 "cpu")}, output=out)


def test_bounded_range_min_max_keeps_the_row_cap():
    v = torch.zeros(tw._RANGE_MM_CAP + 1, dtype=torch.int32)
    idx = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match=str(tw._RANGE_MM_CAP)):
        tw._range_minmax("min", v, idx, idx)
    assert tw._RANGE_MM_CAP == jw._RANGE_MM_CAP


def test_window_sorted_cols_keeps_the_reference_arguments():
    import inspect
    assert (list(inspect.signature(tw._window_sorted_cols).parameters)
            == list(inspect.signature(jw._window_sorted_cols).parameters))
    k, o, v = _data("uint32", "uint32", 300)
    spec = tw._canon_funcs({"rn": "row_number", "rs": ("running_sum", "v")})
    order = np.lexsort((o, k))
    sk, so = k[order], o[order]
    new = np.r_[True, sk[1:] != sk[:-1]]
    onew = new | np.r_[True, so[1:] != so[:-1]]
    flag = torch.from_numpy
    out, aux = tw._window_sorted_cols(
        spec, {"v": column_from_numpy(v[order], "cpu")},
        torch.arange(300), flag(new), flag(onew), flag(np.r_[new[1:], True]),
        need_aux=True)
    starts = np.maximum.accumulate(np.where(new, np.arange(300), 0))
    np.testing.assert_array_equal(aux["part_start"].numpy(), starts)
    np.testing.assert_array_equal(_np(out["rn"]), np.arange(300) - starts + 1)


def _tables():
    k, o, v = _data("int32", "float32", 300)
    return (Table({"key": U64.from_numpy(k, "cpu"),
                   "o": column_from_numpy(o, "cpu"),
                   "v": column_from_numpy(v, "cpu")}),
            JTable({"key": JU64.from_numpy(k), "o": jnp.asarray(o),
                    "v": jnp.asarray(v)}))


def test_table_window_matches_jax():
    funcs = {"rn": ("row_number",), "cum": ("running_sum", "v"),
             "mx": ("range_max", "v", 2.5), "pc": ("partition_count",)}
    t, jt = _tables()
    got, want = t.window("key", funcs, order="o"), jt.window("key", funcs,
                                                             order="o")
    assert got.column_names == want.column_names
    for name in want.column_names:
        _check(got[name], want[name], name)
    nord = {"rn": "row_number", "lv": ("last_value", "v")}
    got = t.window("key", nord, backend="torch")
    want = jt.window("key", nord)
    for name in nord:
        _check(got[name], want[name], name)


def test_table_window_checks_its_arguments():
    t, jt = _tables()
    for tab in (t, jt):
        with pytest.raises(TypeError, match="must be u64"):
            tab.window("v", {"rn": "row_number"})
        with pytest.raises(ValueError, match="already exists"):
            tab.window("key", {"v": "row_number"})


def test_table_window_takes_ntile_and_moving_count():
    """ntile's bucket count and moving_count's widths ride the column slot;
    the port's Table.window passes them through (and equals ops.window),
    the reference's looks them up as columns and raises KeyError."""
    t, jt = _tables()
    funcs = {"nt": ("ntile", 4), "mc": ("moving_count", 3),
             "mcu": ("moving_count", None, 2)}
    got = t.window("key", funcs, order="o")
    want = tw.window(t["key"], funcs, order=t["o"])
    for name in funcs:
        _check(got[name], want.cols[name], name)
    want = jw.window(jt["key"], funcs, order=jt["o"])
    for name in funcs:
        _check(got[name], want.cols[name], name)
    for f in funcs.values():
        with pytest.raises(KeyError):
            jt.window("key", {"x": f}, order="o")
