"""tpu_qe_torch.ops.bigdistinct against tpu_qe.ops.bigdistinct on CPU
tensors (the radix sort runs its kernels' plain twins here), at the
reference tests' sizes and the non-distributed cases of
tests/test_fuzz_big.py. Compared bit for bit: the collect=True table
(key, count_distinct, count), every check and the overflow flag. Also:
a numpy oracle from the raw rows, overflow detection, the checks turning
false on injected faults, the CLI on the CPU and the reference's
defaults."""

import dataclasses
import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.ops.bigdistinct")
td = importlib.import_module("tpu_qe_torch.ops.bigdistinct")

FIELDS = [f.name for f in dataclasses.fields(jd.BigDistinctResult)
          if f.name not in ("seconds", "dedup_s", "combine_s", "rows_per_s",
                            "table")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fuzz_case(trial):
    rng = np.random.default_rng(8000 + trial)
    rs = int(rng.choice([1 << 9, 1 << 10, 1 << 11]))
    n = rs * int(rng.integers(2, 7))
    rng.choice([64, 48, 12])                      # quantile_big's draws
    rng.uniform(0, 1, int(rng.integers(1, 4)))
    return (n, int(rng.integers(2, 80)), int(rng.integers(1, 50)), rs, None)


# (n, groups, values, run_size, partial_cap): tests/test_bigdistinct.py,
# then the fuzz
CASES = [(1 << 12, 16, 4, 1 << 10, None), (1 << 12, 64, 1000, 1 << 10, None),
         (1 << 12, 7, 3, 1 << 10, None), (1 << 14, 8, 1 << 20, 1 << 12, None),
         (1 << 14, 8, 4, 1 << 12, None), (1 << 10, 32, 8, 1 << 10, None),
         (1 << 12, 256, 256, 1 << 10, 128)] + [_fuzz_case(t)
                                                for t in range(4)]


@functools.lru_cache(maxsize=None)
def _jax(n, g, v, rs, cap):
    return jd.count_distinct_big(n, n_groups=g, n_values=v, run_size=rs,
                                 partial_cap=cap, collect=True)


@functools.lru_cache(maxsize=None)
def _port(n, g, v, rs, cap):
    return td.count_distinct_big(n, n_groups=g, n_values=v, run_size=rs,
                                 partial_cap=cap, collect=True,
                                 device="cpu")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_table_and_checks_match_jax(case):
    res, jres = _port(*case), _jax(*case)
    assert res.all_ok == jres.all_ok == (case[4] is None)
    for f in FIELDS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(res.table) == sorted(jres.table)
    for k in jres.table:
        assert res.table[k].dtype == jres.table[k].dtype, k
        np.testing.assert_array_equal(res.table[k], jres.table[k],
                                      err_msg=k)


@pytest.mark.parametrize("case", [c for c in CASES if c[4] is None],
                         ids=str)
def test_table_matches_the_raw_rows(case):
    n, g, v = case[:3]
    keys, vals = jd.rows_of_index_numpy(np.arange(n, dtype=np.uint32), g, v)
    table = _port(*case).table
    uk = np.unique(keys)
    np.testing.assert_array_equal(table["key"], uk)
    np.testing.assert_array_equal(table["count"],
                                  np.bincount(keys)[uk])
    pairs = np.unique((keys.astype(np.uint64) << np.uint64(32)) | vals)
    np.testing.assert_array_equal(
        table["count_distinct"],
        np.bincount((pairs >> np.uint64(32)).astype(np.int64))[uk])


def test_overflow_is_detected_not_silent():
    res = _port(1 << 12, 256, 256, 1 << 10, 128)
    assert res.overflow and not res.all_ok


def test_rows_of_index_past_2_to_31():
    idx = np.arange((1 << 32) - 5000, (1 << 32) - 1, 7, dtype=np.int64)
    for g, v in ((7, 3), (1 << 16, 1 << 8), ((1 << 31) + 3, 5)):
        k, w = td.rows_of_index(torch.from_numpy(idx), g, v)
        jk, jw = jd.rows_of_index_numpy(idx.astype(np.uint32), g, v)
        np.testing.assert_array_equal(k.numpy().view(np.uint32), jk)
        np.testing.assert_array_equal(w.numpy().view(np.uint32), jw)
        np.testing.assert_array_equal(
            td.rows_of_index_numpy(idx.astype(np.uint32), g, v)[0], jk)


def _tables(n=1 << 12, g=16, v=4, rs=1 << 10):
    cap = min(-(-min(rs, g * v) // 128) * 128, rs)
    parts = [td._dedup_run(r, rs, g, v, cap, "cpu")[:3]
             for r in range(n // rs)]
    return [torch.cat([p[i] for p in parts]) for i in range(3)], n, g, v


@pytest.mark.parametrize("fault", ["none", "swap_keys", "wrong_value",
                                   "drop_row"])
def test_checks_catch_injected_faults(fault):
    (klo, v, occ), n, g, nv = _tables()
    if fault == "swap_keys":           # a pair moves to another group
        klo[0] = (klo[0] + 1) % g
    elif fault == "wrong_value":       # a pair's value becomes a new one
        v[1] = nv + 3
    elif fault == "drop_row":          # a row's occurrence lost
        occ[2] -= 1
    (groups_ok, cd_ok, cnt_ok, keys_ok, _), _ = td._combine(
        klo, v, occ, n, g, nv, False)
    assert groups_ok and keys_ok
    assert cd_ok == (fault != "wrong_value")
    assert cnt_ok == (fault not in ("swap_keys", "drop_row"))


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jd.count_distinct_big).parameters
    got = inspect.signature(td.count_distinct_big).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"
    assert list(td.BigDistinctResult.__dataclass_fields__) == list(
        jd.BigDistinctResult.__dataclass_fields__)


def test_cli_rehearses_on_the_cpu(capsys):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigdistinct", "--device", "cpu", "--n", "16384",
               "--run-size", "4096", "--groups", "64", "--values", "8"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    # (key, value) in 6 + 3 bits: 2 passes a run; the combine's 32-bit key
    # and 3-bit value: 5 passes
    assert row["sort_passes"] == 4 * 2 + 5 and row["runs"] == 4
