"""tpu_qe_torch.ops.bigouter against tpu_qe.ops.bigouter on CPU tensors
(the radix sort runs its kernels' plain twins here), at the reference
tests' sizes, LEFT and FULL. Compared bit for bit, array by array (the
right keys are injective, so the open duplicate-right-key order of
join_outer_padded cannot show): the collect=True slots (key, lidx,
matched, value) and right-only rows, and every BigOuterResult count and
check. Also: the numpy construction oracle, `bigouter_state.npz` written
by either package resuming in the other, the checks turning false on
injected faults, the CLI on the CPU and the reference's defaults."""

import dataclasses
import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jo = importlib.import_module("tpu_qe.ops.bigouter")
to = importlib.import_module("tpu_qe_torch.ops.bigouter")

FIELDS = [f.name for f in dataclasses.fields(jo.BigOuterResult)
          if f.name not in ("seconds", "rows_per_s", "phase_a_s",
                            "phase_c_s", "compile_s")]
# (n_l, n_r, buckets, how): tests/test_bigouter.py
CASES = [(1 << 12, 1 << 12, 2, "full"), (1 << 13, 1 << 11, 4, "full"),
         (1 << 12, 1 << 12, 7, "full"), (1 << 12, 1 << 12, 4, "left"),
         (1 << 12, 1 << 11, 4, "full"), (1 << 11, 1 << 11, 2, "left")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(n_l, n_r, b, how):
    return jo.join_big_outer(n_l, n_r, how=how, n_buckets=b, collect=True)


@functools.lru_cache(maxsize=None)
def _port(n_l, n_r, b, how):
    return to.join_big_outer(n_l, n_r, how=how, n_buckets=b, collect=True,
                             device="cpu")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_slots_and_counts_match_jax(case):
    res, out = _port(*case)
    jres, jout = _jax(*case)
    assert res.all_ok and jres.all_ok
    for f in FIELDS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(out) == sorted(jout)
    for k in jout:
        assert out[k].dtype == jout[k].dtype, k
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_slots_match_the_construction_oracle(case):
    n_l, n_r, _, how = case
    res, out = _port(*case)
    keys, lidx, matched, value = (out["key"], out["lidx"], out["matched"],
                                  out["value"])
    assert res.matched == (n_l + 1) // 2 and res.num_out == n_l
    assert res.right_only == (n_r // 2 if how == "full" else 0)
    assert (keys[1:] >= keys[:-1]).all()
    np.testing.assert_array_equal(np.sort(lidx), np.arange(n_l))
    np.testing.assert_array_equal(keys, jo.lkeys_numpy(n_l, n_r)[lidx])
    np.testing.assert_array_equal(matched, lidx % 2 == 0)
    np.testing.assert_array_equal(value, np.where(
        matched, jo.rval_numpy(keys), 0))      # the NULL convention
    if how == "full":
        np.testing.assert_array_equal(np.sort(out["ro_ridx"]),
                                      np.arange(1, n_r, 2))
    else:
        assert "ro_ridx" not in out


def test_numpy_twins_are_the_reference_s():
    for n_l, n_r, seed in ((1 << 11, 1 << 10, 7), (999, 64, 3)):
        np.testing.assert_array_equal(to.rkeys_numpy(n_r, seed),
                                      jo.rkeys_numpy(n_r, seed))
        np.testing.assert_array_equal(to.lkeys_numpy(n_l, n_r, seed),
                                      jo.lkeys_numpy(n_l, n_r, seed))
        k = jo.lkeys_numpy(n_l, n_r, seed)
        np.testing.assert_array_equal(to.rval_numpy(k), jo.rval_numpy(k))
        j = torch.arange(n_l, dtype=torch.int32)
        key = to._lkey_of_index(j, n_r, seed)
        got = (key.hi.numpy().view(np.uint32).astype(np.uint64)
               << np.uint64(32)) | key.lo.numpy().view(np.uint32)
        np.testing.assert_array_equal(got, k)


def test_sorted_sides_and_plan_equal_the_reference():
    n_l, n_r, b = 1 << 12, 1 << 11, 5
    left = to._make_sorted_side(n_l, n_r, 7, "left", "cpu")
    right = to._make_sorted_side(n_r, n_r, 7, "right", "cpu")
    jleft = jo._make_sorted_side(n=n_l, n_r=n_r, seed=7, side="left")
    jright = jo._make_sorted_side(n=n_r, n_r=n_r, seed=7, side="right")
    for got, want in zip(left + right, jleft + jright):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    bl, br = to._plan_buckets(*left[:2], *right[:2], b, 8192)
    jbl, jbr = jo._plan_buckets(*jleft[:2], *jright[:2], n_buckets=b,
                                per_side=8192)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jbl))
    np.testing.assert_array_equal(br.numpy(), np.asarray(jbr))


@pytest.mark.parametrize("empty", ["left", "right"])
def test_a_bucket_with_an_empty_side(empty):
    # the other side joins one invalid row; the counts stay exact
    left = to._make_sorted_side(64, 64, 7, "left", "cpu")
    right = to._make_sorted_side(64, 64, 7, "right", "cpu")
    sz_l, sz_r = (0, 64) if empty == "left" else (64, 0)
    out, _ = to._outer_bucket(0, sz_l, 0, sz_r, *left, *right, True, 7,
                              False)
    mo, vo, ov, no, nm, ne, nl, nr, roo, nro, nodd = out.tolist()
    assert (vo, ov, no, nm, nl, nr) == (1, 0, sz_l, 0, sz_l, sz_r)
    # an even row without its partner breaks the data model (every even
    # left row matches, every even right row is matched), and the checks
    # say so
    if empty == "left":        # every right row is right-only
        assert (mo, nro, nodd, roo, ne) == (1, 64, 32, 0, 0)
    else:                      # every left row takes a NULL-right slot
        assert (mo, nro, nodd, roo, ne) == (0, 0, 0, 1, 32)


def test_coverage_and_parity_preconditions():
    with pytest.raises(AssertionError, match="coverage"):
        to.join_big_outer(1 << 8, 1 << 12, device="cpu")
    with pytest.raises(AssertionError, match="parity"):
        to.join_big_outer(1 << 8, 7, device="cpu")
    with pytest.raises(AssertionError):
        to.join_big_outer(1 << 8, 1 << 8, how="right", device="cpu")


@pytest.mark.parametrize("fault", ["swap_keys", "wrong_value", "drop_row"])
def test_checks_catch_injected_faults(fault, monkeypatch):
    real = to.join_outer_padded

    def broken(left, right, lkey, rkey, l_valid, r_valid, **kw):
        res = real(left, right, lkey, rkey, l_valid, r_valid, **kw)
        t = res.table
        if fault == "swap_keys":      # two right-only rows exchange keys
            ro = res.right_only
            k = ro["_key"]
            lo = k.lo.clone()
            lo[[0, 1]] = lo[[1, 0]]
            ro = ro.with_column("_key", to.U64(lo, k.hi))
            return res._replace(right_only=ro)
        if fault == "wrong_value":
            rv = t["rv"].clone()
            rv[res.matched.nonzero()[0, 0]] ^= 1
            return res._replace(table=t.with_column("rv", rv))
        return res._replace(num_out=res.num_out - 1)     # drop_row

    monkeypatch.setattr(to, "join_outer_padded", broken)
    res = to.join_big_outer(1 << 12, 1 << 12, n_buckets=2, device="cpu")
    assert not res.all_ok
    assert not {"swap_keys": res.ro_ok, "wrong_value": res.val_ok,
                "drop_row": res.count_ok}[fault]


def _meta(n_l, n_r, full, b):
    return np.asarray([n_l, n_r, int(full), b, 7, 8192, 0x0073], np.int64)


@pytest.mark.parametrize("how", ["full", "left"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_resumes_in_the_other_package(writer, how, tmp_path,
                                            monkeypatch):
    n, b = (1 << 12, 2) if how == "full" else (1 << 11, 2)
    ck = str(tmp_path)
    first = to if writer == "port" else jo
    real = first._OuterState.record
    calls = []

    def crashing(self, bb, vals):
        real(self, bb, vals)
        calls.append(bb)
        if len(calls) == 1:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(first._OuterState, "record", crashing)
    with pytest.raises(RuntimeError, match="simulated kill"):
        first.join_big_outer(n, n, how=how, n_buckets=b, checkpoint_dir=ck,
                             **({"device": "cpu"} if first is to else {}))
    monkeypatch.setattr(first._OuterState, "record", real)
    meta = _meta(n, n, how == "full", b)
    assert int(to._OuterState.load(ck, meta).done.sum()) == 1
    if writer == "port":
        res = jo.join_big_outer(n, n, how=how, n_buckets=b,
                                checkpoint_dir=ck)
    else:
        joined = []
        real_bucket = to._outer_bucket
        monkeypatch.setattr(to, "_outer_bucket",
                            lambda *a: joined.append(1) or real_bucket(*a))
        res = to.join_big_outer(n, n, how=how, n_buckets=b,
                                checkpoint_dir=ck, device="cpu")
        assert len(joined) == 1
    want = _jax(n, n, b, how)[0]
    for f in FIELDS:
        assert getattr(res, f) == getattr(want, f), f
    whole = tmp_path / "whole"
    whole.mkdir()
    to.join_big_outer(n, n, how=how, n_buckets=b,
                      checkpoint_dir=str(whole), device="cpu")
    a = jo._OuterState.load(str(whole), meta)
    got = jo._OuterState.load(ck, meta)
    np.testing.assert_array_equal(got.bounds, a.bounds)
    np.testing.assert_array_equal(got.scalars, a.scalars)


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jo.join_big_outer).parameters
    got = inspect.signature(to.join_big_outer).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"
    assert list(to.BigOuterResult.__dataclass_fields__) == list(
        jo.BigOuterResult.__dataclass_fields__)
    assert to._OuterState.N_SCALARS == jo._OuterState.N_SCALARS == 11


@pytest.mark.parametrize("how", ["full", "left"])
def test_cli_rehearses_on_the_cpu(how, capsys, tmp_path):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigjoin", "--device", "cpu", "--n-left", "8192",
               "--n-right", "4096", "--outer", how, "--checkpoint-dir",
               str(tmp_path)])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert row["right_only"] == (2048 if how == "full" else 0)
    assert how.upper() + " OUTER" in row["metric"]
