"""tpu_qe_torch.ops.bigsetops against tpu_qe.ops.bigsetops on CPU tensors
(the radix sort runs its kernels' plain twins here), at the reference
tests' sizes, UNION / INTERSECT / EXCEPT. Compared bit for bit: the
collect=True table (key, count_a, count_b), the counts and every check.
Also: an oracle from the raw key bags, overflow detection, the closed
forms, the checks turning false on injected faults, the CLI on the CPU
and the reference's defaults."""

import dataclasses
import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

js = importlib.import_module("tpu_qe.ops.bigsetops")
ts = importlib.import_module("tpu_qe_torch.ops.bigsetops")

FIELDS = [f.name for f in dataclasses.fields(js.BigSetOpResult)
          if f.name not in ("seconds", "dedup_s", "combine_s", "rows_per_s",
                            "table")]
OPS = ("union", "intersect", "except")
# (g_a, g_b, offset): tests/test_bigsetops.py, n_a 2^12, n_b 3 * 2^10
SHAPES = [(300, 200, 150), (256, 128, 0), (100, 100, 4096)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(op, n_a, n_b, g_a, g_b, offset, rs, cap=None):
    return js.set_op_big(op, n_a, n_b, g_a=g_a, g_b=g_b, offset=offset,
                         run_size=rs, partial_cap=cap, collect=True)


@functools.lru_cache(maxsize=None)
def _port(op, n_a, n_b, g_a, g_b, offset, rs, cap=None):
    return ts.set_op_big(op, n_a, n_b, g_a=g_a, g_b=g_b, offset=offset,
                         run_size=rs, partial_cap=cap, collect=True,
                         device="cpu")


CASES = [(op, 1 << 12, 3 << 10, *sh, 1 << 10) for op in OPS
         for sh in SHAPES] + [
    ("intersect", 1 << 12, 1 << 12, 96, 160, 32, 1 << 10),
    ("intersect", 1 << 10, 1 << 10, 16, 16, 1 << 16, 1 << 10),
    ("union", 1 << 12, 1 << 12, 512, 512, 0, 1 << 10, 128)]


def _raw_oracle(op, n_a, n_b, g_a, g_b, offset):
    ka = np.arange(n_a, dtype=np.uint64) % g_a
    kb = np.arange(n_b, dtype=np.uint64) % g_b + offset
    keys = {"union": np.union1d, "intersect": np.intersect1d,
            "except": np.setdiff1d}[op](np.unique(ka), np.unique(kb))
    ca = np.array([(ka == k).sum() for k in keys], np.uint32)
    cb = np.array([(kb == k).sum() for k in keys], np.uint32)
    return keys.astype(np.uint32), ca, cb


@pytest.mark.parametrize("case", CASES, ids=str)
def test_table_and_checks_match_jax(case):
    res, jres = _port(*case), _jax(*case)
    assert res.all_ok == jres.all_ok == (len(case) == 7)
    for f in FIELDS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(res.table) == sorted(jres.table)
    for k in jres.table:
        assert res.table[k].dtype == jres.table[k].dtype, k
        np.testing.assert_array_equal(res.table[k], jres.table[k],
                                      err_msg=k)


@pytest.mark.parametrize("case", [c for c in CASES if len(c) == 7],
                         ids=str)
def test_table_matches_the_raw_key_bags(case):
    res = _port(*case)
    keys, ca, cb = _raw_oracle(*case[:6])
    np.testing.assert_array_equal(res.table["key"], keys)
    np.testing.assert_array_equal(res.table["count_a"], ca)
    np.testing.assert_array_equal(res.table["count_b"], cb)
    assert res.num == res.expected_num == keys.size


def test_closed_forms_are_the_reference_s():
    for op in OPS:
        for sh in SHAPES + [(1 << 20, 1 << 20, 1 << 19)]:
            for got, want in zip(
                    ts.expected_result_numpy(op, 1 << 12, sh[0], 3 << 10,
                                             *sh[1:]),
                    js.expected_result_numpy(op, 1 << 12, sh[0], 3 << 10,
                                             *sh[1:])):
                np.testing.assert_array_equal(got, want)
    keys = np.arange(1000, dtype=np.uint32)
    np.testing.assert_array_equal(ts.side_counts_numpy(keys, 777, 300, 20),
                                  js.side_counts_numpy(keys, 777, 300, 20))


def test_overflow_is_detected_not_silent():
    res = _port("union", 1 << 12, 1 << 12, 512, 512, 0, 1 << 10, 128)
    assert res.overflow and not res.all_ok


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="op must be one of"):
        ts.set_op_big("minus", 1 << 10, 1 << 10, run_size=1 << 10,
                      device="cpu")


def _tables(n=1 << 12, g_a=300, g_b=200, offset=150, rs=1 << 10):
    klo, side, occ = [], [], []
    for s, g, off in ((0, g_a, 0), (1, g_b, offset)):
        cap = min(-(-min(rs, g) // 128) * 128, rs)
        for r in range(n // rs):
            k, o, _ = ts._dedup_run(r, rs, g, off, cap, "cpu")
            klo.append(k)
            occ.append(o)
            side.append(torch.full((cap,), s, dtype=torch.int32))
    return [torch.cat(x) for x in (klo, side, occ)]


@pytest.mark.parametrize("fault", ["none", "swap_keys", "wrong_side",
                                   "drop_row"])
def test_checks_catch_injected_faults(fault):
    klo, side, occ = _tables()
    if fault == "swap_keys":          # a key's rows move to another key
        klo[0] = 299
    elif fault == "wrong_side":       # rows of A counted as B's
        side[1] = 1
    elif fault == "drop_row":
        occ[2] -= 1
    (counts_ok, keys_ok, num), _ = ts._combine(
        klo, side, occ, "union", 1 << 12, 300, 1 << 12, 200, 150, False)
    assert keys_ok and num == 350
    assert counts_ok == (fault == "none")


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(js.set_op_big).parameters
    got = inspect.signature(ts.set_op_big).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"
    assert list(ts.BigSetOpResult.__dataclass_fields__) == list(
        js.BigSetOpResult.__dataclass_fields__)


@pytest.mark.parametrize("op", OPS)
def test_cli_rehearses_on_the_cpu(op, capsys):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigsetops", "--device", "cpu", "--op", op, "--n-a",
               "8192", "--n-b", "8192", "--run-size", "4096", "--g-a",
               "1024", "--g-b", "1024", "--offset", "512"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert op.upper() in row["metric"]
    # 11 key bits: 2 passes per run of each side; the combine's 4
    assert row["sort_passes"] == 4 * 2 + 4
