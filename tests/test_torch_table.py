"""tpu_qe_torch.table.Table against tpu_qe.table.Table on CPU tensors:
column conversion (how a u32 column is told apart from an i32 one),
gathers, sort_by, filter, distinct, group_by(_multi), the join and set-op
methods, and the npz layout shared with the JAX package. Inputs come from
numpy seeds; tolerance: exact equality (floats by bits).

The file ends with a hypothesis fuzz in the manner of
tests/test_fuzz_ops.py: random sizes, key skews, dtypes and masks through
both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402
from tpu_qe.table import Table as JTable  # noqa: E402
from tpu_qe.utils.checkpoint import (load_table_npz,  # noqa: E402
                                     save_table_npz)
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.table import Table  # noqa: E402


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "key": rng.integers(0, max(n // 3, 1), n).astype(np.uint64)
        * np.uint64(0x9E3779B97F4A7C15),
        "u": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        "i": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "f": rng.standard_normal(n).astype(np.float32),
    }


def test_columns_keep_their_types_and_bits():
    cols = _cols(100, 1)
    t = Table.from_numpy(cols, device="cpu")
    assert t["u"].dtype == torch.uint32 and t["i"].dtype == torch.int32
    assert t["f"].dtype == torch.float32 and isinstance(t["key"], U64)
    _same_dict(t.to_numpy(), cols)
    _same_dict(t.to_numpy(), JTable.from_numpy(cols).to_numpy())
    assert t.num_rows == 100 and t.column_names == sorted(cols)
    assert "u" in t and list(t) == sorted(cols)
    with pytest.raises(TypeError):
        Table.from_numpy({"x": np.zeros(3, np.int64)}, device="cpu")
    with pytest.raises(ValueError):
        Table({"a": torch.zeros(3), "b": torch.zeros(4)})


def test_select_drop_with_column_take_head_match_jax():
    cols = _cols(500, 2)
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    idx = np.random.default_rng(3).integers(0, 500, 800)
    _same_dict(t.take(torch.from_numpy(idx)).to_numpy(),
               jt.take(jnp.asarray(idx)).to_numpy())
    _same_dict(t.head(7).select("u", "key").to_numpy(),
               jt.head(7).select("u", "key").to_numpy())
    _same_dict(t.drop("f").with_column("g", t["i"]).to_numpy(),
               jt.drop("f").with_column("g", jt["i"]).to_numpy())


@pytest.mark.parametrize("backend", ["radix", "torch"])
def test_sort_by_filter_distinct_match_jax(backend):
    cols = _cols(3000, 4)
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    _same_dict(t.sort_by("key", backend=backend).to_numpy(),
               jt.sort_by("key").to_numpy())
    ft, fc = t.filter(lambda x: x["i"] < 0)
    jft, jfc = jt.filter(lambda x: x["i"] < 0)
    assert int(fc) == int(jfc)
    _same_dict(ft.to_numpy(), jft.to_numpy())
    k, num = t.distinct(backend=backend)
    jk, jnum = jt.distinct()
    assert int(num) == int(jnum)
    np.testing.assert_array_equal(k.to_numpy()[:int(num)],
                                  jk.to_numpy()[:int(jnum)])
    with pytest.raises(TypeError):
        t.sort_by("u")


def test_group_by_and_group_by_multi_match_jax():
    cols = _cols(2000, 5)
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    res = t.group_by("key", "u", aggs=("count", "sum", "max"))
    jres = jt.group_by("key", "u", aggs=("count", "sum", "max"))
    ng = int(jres.num_groups)
    assert int(res.num_groups) == ng
    np.testing.assert_array_equal(res.aggs["sum"].to_numpy()[:ng],
                                  jres.aggs["sum"].to_numpy()[:ng])
    np.testing.assert_array_equal(res.aggs["max"].numpy()[:ng],
                                  np.asarray(jres.aggs["max"])[:ng])
    res = t.group_by_multi("key", {"i": ("sum", "min"), "u": ("count",)})
    jres = jt.group_by_multi("key", {"i": ("sum", "min"), "u": ("count",)})
    np.testing.assert_array_equal(res.aggs["i_sum"].to_numpy()[:ng],
                                  jres.aggs["i_sum"].to_numpy()[:ng])
    np.testing.assert_array_equal(res.aggs["u_count"].numpy()[:ng],
                                  np.asarray(jres.aggs["u_count"])[:ng])


def test_table_join_methods_and_set_op_match_jax():
    lc, rc = _cols(900, 6), _cols(300, 7)
    rc["key"] = np.unique(rc["key"])
    rc = {k: v[:len(rc["key"])] for k, v in rc.items()}
    lt, jlt = Table.from_numpy(lc, device="cpu"), JTable.from_numpy(lc)
    rt, jrt = Table.from_numpy(rc, device="cpu"), JTable.from_numpy(rc)
    out, m = lt.join(rt)
    jout, jm = jlt.join(jrt)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    _same_dict(out.to_numpy(), jout.to_numpy())
    inner, jinner = lt.join_inner(rt), jlt.join_inner(jrt)
    n_out = int(jinner.num_out)
    assert int(inner.num_out) == n_out
    _same_dict({k: v[:n_out] for k, v in inner.table.to_numpy().items()},
               {k: v[:n_out] for k, v in jinner.table.to_numpy().items()})
    outer, jouter = lt.join_outer(rt, how="full"), jlt.join_outer(jrt,
                                                                  how="full")
    assert int(outer.num_right_only) == int(jouter.num_right_only)
    for op in ("union", "except"):
        got, want = lt.set_op(rt, op), jlt.set_op(jrt, op)
        np.testing.assert_array_equal(got[0].to_numpy(), want[0].to_numpy())
        assert int(got[3]) == int(want[3])


def test_npz_round_trip_and_interchange_with_jax(tmp_path):
    cols = _cols(64, 8)
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    path = t.save(str(tmp_path / "port.npz"))
    _same_dict(Table.load(path, device="cpu").to_numpy(), cols)
    _same_dict(load_table_npz(path).to_numpy(), cols)      # JAX reads it
    jpath = save_table_npz(jt, str(tmp_path / "jax.npz"))
    _same_dict(Table.load(jpath, device="cpu").to_numpy(), cols)   # and back
    with pytest.raises(ValueError):
        Table({"x@lo": t["u"]}).save(str(tmp_path / "bad.npz"))


def test_save_and_load_take_the_reference_format_argument(tmp_path):
    cols = _cols(50, 9)
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    # the reference's argument order: format second, by position or keyword
    path = t.save(str(tmp_path / "a.npz"), "npz")
    _same_dict(Table.load(path, "npz", device="cpu").to_numpy(), cols)
    path = t.save(str(tmp_path / "b"), format="npz")
    assert path.endswith("b.npz")
    _same_dict(Table.load(path, format="npz", device="cpu").to_numpy(), cols)
    _same_dict(JTable.load(path, format="npz").to_numpy(), cols)
    jpath = jt.save(str(tmp_path / "j.npz"), format="npz")
    _same_dict(Table.load(jpath, format="npz", device="cpu").to_numpy(), cols)


@pytest.mark.parametrize("format", ["parquet", "", "NPZ"])
def test_save_and_load_refuse_an_unknown_format_like_the_reference(
        tmp_path, format):
    cols = _cols(5, 10)
    t, jt = Table.from_numpy(cols, device="cpu"), JTable.from_numpy(cols)
    path = t.save(str(tmp_path / "ok.npz"))
    for table, cls in ((t, Table), (jt, JTable)):
        with pytest.raises(ValueError, match="unknown format"):
            table.save(str(tmp_path / "x"), format=format)
        with pytest.raises(ValueError, match="unknown format"):
            cls.load(path, format=format)
    assert not (tmp_path / "x.npz").exists()


def test_orbax_format_names_the_missing_package(tmp_path):
    t = Table.from_numpy(_cols(5, 11), device="cpu")
    with pytest.raises(ImportError, match="orbax"):
        t.save(str(tmp_path / "ckpt"), format="orbax")
    with pytest.raises(ImportError, match="orbax"):
        Table.load(str(tmp_path / "ckpt"), format="orbax", device="cpu")
    assert not (tmp_path / "ckpt").exists()


def test_load_takes_the_device_by_keyword_only(tmp_path):
    t = Table.from_numpy(_cols(5, 12), device="cpu")
    path = t.save(str(tmp_path / "d.npz"))
    assert Table.load(path, device=torch.device("cpu"))["u"].device.type \
        == "cpu"
    with pytest.raises(TypeError):
        Table.load(path, "npz", "cpu")


_style = st.sampled_from(["uniform", "few", "zipf", "edges"])


def _fuzz_keys(rng, n, style):
    if style == "uniform":
        return rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if style == "few":
        return rng.integers(0, 5, n).astype(np.uint64) * np.uint64(0x9E37)
    if style == "zipf":
        return rng.zipf(1.3, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    k[rng.random(n) < 0.2] = 0
    k[rng.random(n) < 0.2] = np.uint64((1 << 64) - 1)
    return k


@settings(max_examples=12, deadline=None, derandomize=True)
@given(n=st.integers(1, 700), seed=st.integers(0, 2 ** 16), style=_style,
       dtype=st.sampled_from(["uint32", "int32", "float32"]),
       masked=st.booleans(), backend=st.sampled_from(["radix", "torch"]))
def test_fuzz_operators_match_jax(n, seed, style, dtype, masked, backend):
    from tpu_qe.ops.aggregate import group_aggregate as jga
    from tpu_qe.ops.join import join_fk_scan as jfk
    from tpu_qe_torch.ops.aggregate import group_aggregate
    from tpu_qe_torch.ops.join import join_fk_scan
    from tpu_qe_torch.table import column_from_numpy

    rng = np.random.default_rng(seed)
    keys = _fuzz_keys(rng, n, style)
    if dtype == "float32":
        vals = rng.standard_normal(n).astype(np.float32)
    else:
        vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32).view(dtype)
    valid = rng.random(n) < 0.7 if masked else None
    aggs = ("count", "sum", "min", "max", "count_distinct")
    res = group_aggregate(
        U64.from_numpy(keys, "cpu"), column_from_numpy(vals, "cpu"), aggs,
        valid=None if valid is None else torch.from_numpy(valid),
        backend=backend)
    jres = jga(JU64.from_numpy(keys), jnp.asarray(vals), aggs,
               valid=None if valid is None else jnp.asarray(valid))
    ng = int(jres.num_groups)
    assert int(res.num_groups) == ng
    np.testing.assert_array_equal(res.key.to_numpy()[:ng],
                                  jres.key.to_numpy()[:ng])
    for a in aggs:
        g, w = res.aggs[a], jres.aggs[a]
        if isinstance(g, U64):
            g, w = g.to_numpy(), w.to_numpy()
        else:
            g = g.view(torch.int32).numpy() if g.dtype in (
                torch.uint32, torch.float32) else g.numpy()
            w = np.asarray(w)
            w = w.view(np.int32) if w.dtype in (np.uint32, np.float32) else w
        np.testing.assert_array_equal(g[:ng].astype(np.int64),
                                      w[:ng].astype(np.int64), err_msg=a)

    rkeys = np.unique(_fuzz_keys(rng, max(n // 2, 1), style))
    rvals = rng.integers(0, 1 << 32, len(rkeys), dtype=np.uint64).astype(
        np.uint32)
    out, m = join_fk_scan(
        Table({}), Table.from_numpy({"v": rvals}, device="cpu"),
        U64.from_numpy(keys, "cpu"), U64.from_numpy(rkeys, "cpu"),
        backend=backend)
    jout, jm = jfk(JTable({}), JTable.from_numpy({"v": rvals}),
                   JU64.from_numpy(keys), JU64.from_numpy(rkeys))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(out["v"].view(torch.int32).numpy()
                                  .view(np.uint32), np.asarray(jout["v"]))
