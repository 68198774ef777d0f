"""tpu_qe_torch.ops.bigagg against tpu_qe.ops.bigagg on CPU tensors (the
radix sort runs its kernels' plain twins here), at the reference tests'
sizes and the non-distributed cases of tests/test_fuzz_big.py. Compared
bit for bit: the collect=True group tables (key, count, u64 sums, min,
max) and every BigAggResult check. Also: the numpy bincount oracle, run
tables written by either package resuming in the other, the checks
turning false on a broken table, the CLI on the CPU, the reference's
defaults, and the envelope's arithmetic."""

import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jb = importlib.import_module("tpu_qe.ops.bigagg")
tb = importlib.import_module("tpu_qe_torch.ops.bigagg")

CHECKS = ("n", "n_groups", "count_ok", "sum_ok", "keys_ok", "groups_ok",
          "minmax_ok")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fuzz_case(trial):
    rng = np.random.default_rng(4000 + trial)
    run_size = 1 << int(rng.integers(9, 13))
    n = int(rng.integers(1, 9)) * run_size
    return (n, 1 << int(rng.integers(0, 15)), run_size,
            bool(rng.integers(0, 2)))


# (n, n_groups, run_size, minmax): tests/test_bigagg.py, then the fuzz
CASES = [(1 << 14, 1 << 8, 1 << 12, False), (1 << 14, 1 << 12, 1 << 12, False),
         (1 << 14, 1 << 16, 1 << 12, False), (3 << 12, 1 << 10, 1 << 12, False),
         (1 << 12, 64, 1 << 12, False), (1 << 19, 8, 1 << 16, False),
         (1 << 14, 1 << 9, 1 << 12, True)] + [_fuzz_case(t) for t in range(6)]


@functools.lru_cache(maxsize=None)
def _jax(n, g, run_size, minmax, seed=7):
    return jb.aggregate_big(n, n_groups=g, run_size=run_size, seed=seed,
                            minmax=minmax, collect=True)


@functools.lru_cache(maxsize=None)
def _port(n, g, run_size, minmax, seed=7):
    return tb.aggregate_big(n, n_groups=g, run_size=run_size, seed=seed,
                            minmax=minmax, collect=True, device="cpu")


def _oracle(n, g, seed=7):
    idx = np.arange(n, dtype=np.uint32)
    gid = jb.group_of_index_numpy(idx, g, seed)
    cnt = np.bincount(gid, minlength=g)
    sums = np.zeros(g, np.uint64)
    np.add.at(sums, gid, idx.astype(np.uint64))
    omin = np.full(g, 0xFFFFFFFF, np.uint32)
    omax = np.zeros(g, np.uint32)
    np.minimum.at(omin, gid, idx)
    np.maximum.at(omax, gid, idx)
    keep = cnt > 0
    return {"key": np.flatnonzero(keep).astype(np.uint32),
            "count": cnt[keep].astype(np.uint32), "sum": sums[keep],
            "min": omin[keep], "max": omax[keep]}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_table_and_checks_match_jax(case):
    res, table = _port(*case)
    jres, jtable = _jax(*case)
    assert res.all_ok and jres.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(table) == sorted(jtable)
    for k in jtable:
        assert table[k].dtype == jtable[k].dtype, k
        np.testing.assert_array_equal(table[k], jtable[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_table_matches_the_numpy_oracle(case):
    res, table = _port(*case)
    want = _oracle(case[0], case[1])
    for k in table:
        np.testing.assert_array_equal(table[k], want[k], err_msg=k)
    assert res.n_groups == want["key"].size


def test_sums_past_u32_are_exact():
    res, table = _port(1 << 19, 8, 1 << 16, False)
    assert table["sum"].max() > (1 << 32) and res.sum_ok


@pytest.mark.parametrize("seed", [7, 11])
def test_seed_changes_the_sums_as_in_jax(seed):
    res, table = _port(1 << 13, 1 << 6, 1 << 12, False, seed)
    _, jtable = _jax(1 << 13, 1 << 6, 1 << 12, False, seed)
    for k in jtable:
        np.testing.assert_array_equal(table[k], jtable[k])
    assert res.all_ok


MULTI = [(1, 1 << 14, 1 << 8, 1 << 12), (3, 1 << 14, 1 << 9, 1 << 12),
         (5, 1 << 13, 1 << 12, 1 << 12), (2, 1 << 19, 8, 1 << 16)]


@pytest.mark.parametrize("value_cols,n,g,rs", MULTI, ids=str)
def test_multi_matches_jax_and_numpy(value_cols, n, g, rs):
    res, table = tb.aggregate_big_multi(n, n_groups=g, run_size=rs,
                                        value_cols=value_cols, collect=True,
                                        device="cpu")
    jres, jtable = jb.aggregate_big_multi(n, n_groups=g, run_size=rs,
                                          value_cols=value_cols,
                                          collect=True)
    assert res.all_ok and jres.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(table) == sorted(jtable)
    for k in jtable:
        np.testing.assert_array_equal(table[k], jtable[k], err_msg=k)
    idx = np.arange(n, dtype=np.uint32)
    gid = jb.group_of_index_numpy(idx, g)
    keep = np.bincount(gid, minlength=g) > 0
    for c in range(value_cols):
        s = np.zeros(g, np.uint64)
        np.add.at(s, gid, (idx + c).astype(np.uint64))
        np.testing.assert_array_equal(table[f"sum{c}"], s[keep])


def test_group_hash_follows_the_reference():
    idx = np.arange(0, 1 << 20, 37, dtype=np.int64)
    for g, seed in ((1, 7), (1000, 7), (1 << 20, 3), ((1 << 32) - 5, 9)):
        got = tb._group_of_index(torch.from_numpy(idx), g, seed)
        want = jb.group_of_index_numpy(idx.astype(np.uint32), g, seed)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(
            tb.group_of_index_numpy(idx.astype(np.uint32), g, seed), want)


def test_row_indices_past_2_to_31_stay_positive():
    # a run whose rows start past 2^31 hashes and sums them as u32
    r, rs = (1 << 31) // (1 << 10) + 3, 1 << 10
    part = tb._partial_run(r, rs, 64, 7, 64, True, "cpu")
    idx = np.arange(r * rs, (r + 1) * rs, dtype=np.uint64)
    gid = jb.group_of_index_numpy(idx.astype(np.uint32), 64)
    keys, cnt, lo, hi, vmin, vmax = (part[i].numpy().view(np.uint32)
                                     for i in (0, 2, 3, 4, 5, 6))
    ng = int((cnt > 0).sum())
    sums = (hi.astype(np.uint64) << np.uint64(32)) | lo
    for i in range(ng):
        sel = idx[gid == keys[i]]
        assert cnt[i] == sel.size and sums[i] == sel.sum()
        assert vmin[i] == sel.min() and vmax[i] == sel.max()
    assert (keys[ng:] == 0xFFFFFFFF).all() and (cnt[ng:] == 0).all()


def _merged(n=1 << 12, g=64):
    parts = [tb._partial_run(r, 1 << 10, g, 7, g, False, "cpu")
             for r in range(n >> 10)]
    cols = tuple(torch.cat([p[i] for p in parts]) for i in range(5))
    return tb._merge_partials(cols), n


@pytest.mark.parametrize("fault", ["none", "swap_keys", "wrong_sum",
                                   "drop_row"])
def test_checks_catch_a_broken_table(fault):
    (gklo, gkhi, gcnt, gsums, gmin, gmax, gvalid), n = _merged()
    if fault == "swap_keys":
        gklo[[3, 4]] = gklo[[4, 3]]
    elif fault == "wrong_sum":
        gsums[0].lo[5] ^= 1
    elif fault == "drop_row":
        gvalid[7] = False
    (ng, cnt, tlo, thi, ks, mm), _ = tb._verify_and_emit(
        (gklo, gkhi, gcnt, gsums, gmin, gmax, gvalid), False, False)
    assert bool(ks) == (fault != "swap_keys")
    assert ((thi << 32 | tlo) == n * (n - 1) // 2) == (
        fault in ("none", "swap_keys"))
    assert (cnt == n) == (fault != "drop_row")
    assert mm == 1


def _kill_after(monkeypatch, module, k):
    real = module._run_ck_save
    calls = []

    def crashing(*a):
        real(*a)
        calls.append(1)
        if len(calls) == k:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(module, "_run_ck_save", crashing)
    return calls, lambda: monkeypatch.setattr(module, "_run_ck_save", real)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_run_tables_resume_in_the_other_package(writer, minmax, tmp_path,
                                                monkeypatch):
    n, g, rs = 1 << 14, 1 << 9, 1 << 12          # four runs
    ck = str(tmp_path)
    _, want = _jax(n, g, rs, minmax)
    first, resume = (tb, jb) if writer == "port" else (jb, tb)
    _, restore = _kill_after(monkeypatch, first, 2)
    kw = dict(n_groups=g, run_size=rs, minmax=minmax, checkpoint_dir=ck)
    with pytest.raises(RuntimeError, match="simulated kill"):
        first.aggregate_big(n, **kw, **({"device": "cpu"}
                                        if first is tb else {}))
    restore()
    meta = np.asarray([n, g, rs, 7, int(minmax)], np.int64)
    assert tb._run_ck_load(ck, 1, meta, "cpu") is not None
    assert tb._run_ck_load(ck, 2, meta, "cpu") is None
    # the other package resumes: it computes (and saves) only runs 2 and 3
    saved, restore = _kill_after(monkeypatch, resume, 0)
    res, table = resume.aggregate_big(n, collect=True, **kw, **(
        {"device": "cpu"} if resume is tb else {}))
    restore()
    assert res.all_ok and len(saved) == 2
    for k in want:
        np.testing.assert_array_equal(table[k], want[k], err_msg=k)
    if writer == "port":
        return
    # the port wrote run 3: the bytes the reference computes for it
    z = np.load(tb._run_ck_path(ck, 3))
    part = jb._partial_run(np.uint32(3), run_size=rs, n_groups=g, seed=7,
                           partial_cap=min(g, rs), minmax=minmax)
    assert int(z["ncols"]) == len(part) and z["c0"].dtype == np.uint32
    for i, c in enumerate(part):
        np.testing.assert_array_equal(z[f"c{i}"], np.asarray(c))


def test_mismatched_run_tables_are_not_reused(tmp_path):
    ck = str(tmp_path)
    assert tb.aggregate_big(1 << 13, n_groups=64, run_size=1 << 12,
                            checkpoint_dir=ck, device="cpu").all_ok
    res, table = tb.aggregate_big(1 << 13, n_groups=128, run_size=1 << 12,
                                  checkpoint_dir=ck, collect=True,
                                  device="cpu")
    assert res.all_ok and table["key"].max() >= 64


def test_combine_cap_asserts():
    # 2^28 table rows, held as views of one word: the check comes first
    plane = torch.zeros(1, dtype=torch.int32).expand(1 << 27)
    with pytest.raises(AssertionError, match="in-core cap"):
        tb._combine([(plane,) * 5] * 2, False, False)


def test_defaults_and_fields_are_the_reference_s():
    for fn in ("aggregate_big", "aggregate_big_multi"):
        want = inspect.signature(getattr(jb, fn)).parameters
        got = inspect.signature(getattr(tb, fn)).parameters
        assert list(got)[:len(want)] == list(want)
        for name, p in want.items():
            assert got[name].default == p.default, (fn, name)
        assert got["device"].default == "cuda"
    assert list(tb.BigAggResult.__dataclass_fields__) == list(
        jb.BigAggResult.__dataclass_fields__)


def test_ops_package_exports_the_ported_big_operators():
    import inspect

    import tpu_qe.ops as jops
    import tpu_qe_torch.ops as tops
    # the reference's whole map: the single-device and the distributed
    # out-of-core operators
    assert tops._BIG_EXPORTS == jops._BIG_EXPORTS
    for name, mod in tops._BIG_EXPORTS.items():
        fn, ref = getattr(tops, name), getattr(jops, name)
        assert fn.__module__ == f"tpu_qe_torch.ops.{mod}", name
        assert fn.__name__ == ref.__name__ == name
        if mod.startswith("dbig"):
            # the reference's parameters, defaults and order, plus at most
            # a stats dict
            jp = inspect.signature(ref).parameters
            tp = dict(inspect.signature(fn).parameters)
            assert list(tp)[:len(jp)] == list(jp), name
            for p, q in jp.items():
                assert tp[p].default == q.default, (name, p)
            assert set(tp) - set(jp) <= {"stats"}, name
    with pytest.raises(AttributeError):
        tops.no_such_operator  # noqa: B018


def _cli(capsys, argv):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(argv + ["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return rc, [json.loads(ln) for ln in lines]


@pytest.mark.parametrize("extra", [[], ["--minmax"], ["--value-cols", "3"]])
def test_cli_rehearses_on_the_cpu(extra, capsys, tmp_path):
    ck = [] if extra[:1] == ["--value-cols"] else [
        "--checkpoint-dir", str(tmp_path / "ck")]
    rc, rows = _cli(capsys, ["bench-bigagg", "--n", str(1 << 13),
                             "--run-size", str(1 << 11), "--groups", "300"]
                    + ck + extra)
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert row["value"] == "not measured" and row["device"] == "cpu"
    assert row["sort_passes"] == (4 * 12 + 8 if extra == ["--minmax"]
                                  else 4 * 8 + 8)


def test_cli_refuses_value_cols_with_minmax():
    from tpu_qe_torch.__main__ import main
    with pytest.raises(AssertionError):
        main(["bench-bigagg", "--device", "cpu", "--n", "4096",
              "--value-cols", "2", "--minmax"])


def test_envelope_counts_its_passes_scans_and_rows():
    from tpu_qe_torch.bench import sol
    name, peak = "NVIDIA H100 80GB HBM3", 3.35e12
    n, run, g = 1 << 30, 1 << 26, 1 << 20
    r, m = 16, 16 * (1 << 20)
    got = sol.bigagg_sol_seconds(n, run, g, device_name=name)
    # 8 passes of 8-byte keys with the permutation (24 B a row) per run
    # and over the combine; 4 one-plane scans (8 B a row) over both; the
    # group id and value written once (8 B)
    want = (r * 8 * run * 24 + 8 * m * 24 + 8 * 4 * (n + m) + n * 8) / peak
    assert got == pytest.approx(want)
    mm = sol.bigagg_sol_seconds(n, run, g, minmax=True, device_name=name)
    assert mm == pytest.approx(want + (r * 4 * run * 16 + 8 * 2 * m) / peak)
    v4 = sol.bigagg_sol_seconds(n, run, g, value_cols=4, device_name=name)
    assert v4 == pytest.approx(want + (8 * 6 * (n + m) + n * 12) / peak)
