"""tpu_qe_torch.ops.bigwindow against tpu_qe.ops.bigwindow on CPU tensors
(the radix sort runs its kernels' plain twins here), at the reference
tests' sizes. Compared bit for bit: the collect=True rows and window
columns (key, order, index, value, rn, rank, the exact u64 running sum,
lag) and every BigWindowResult check, the plan's splitters and bounds,
the lexicographic search and window_core on one stream and carry. Also:
the reference test's sequential oracle, `bigsort_state.npz` written by
either package resuming in the other, the checks turning false on
injected faults, the CLI on the CPU and the reference's defaults."""

import functools
import importlib
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

jw = importlib.import_module("tpu_qe.ops.bigwindow")
tw = importlib.import_module("tpu_qe_torch.ops.bigwindow")
jck = importlib.import_module("tpu_qe.utils.checkpoint")
tck = importlib.import_module("tpu_qe_torch.utils.checkpoint")

CHECKS = ("n", "partitions", "sorted_ok", "hash_ok", "window_ok",
          "count_ok", "boundary_ok")
COLS = ("key", "order", "idx", "value", "rn", "rk", "cum", "lg")
N, RUN, BUCKETS = 1 << 13, 1 << 11, 4
PARTITIONS = [1, 16, 512]       # tests/test_bigwindow.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(partitions):
    return jw.window_big(N, partitions=partitions, run_size=RUN,
                         n_buckets=BUCKETS, collect=True)


@functools.lru_cache(maxsize=None)
def _port(partitions):
    return tw.window_big(N, partitions=partitions, run_size=RUN,
                         n_buckets=BUCKETS, collect=True, device="cpu")


def _oracle(n, partitions, seed=7):
    """The reference test's sequential oracle, vectorised: lexsort by
    (key, order, index), then the window columns of each partition."""
    idx = np.arange(n, dtype=np.uint32)
    key, o, v = tw.rows_numpy(idx, partitions, seed)
    perm = np.lexsort((idx, o, key))
    sk, so, si, sv = key[perm], o[perm], idx[perm], v[perm]
    pos = np.arange(n)
    new = np.r_[True, sk[1:] != sk[:-1]]
    onew = new | np.r_[True, so[1:] != so[:-1]]
    ps = np.maximum.accumulate(np.where(new, pos, 0))
    rs = np.maximum.accumulate(np.where(onew, pos, 0))
    p0 = np.concatenate([np.zeros(1, np.uint64),
                         np.cumsum(sv.astype(np.uint64))])
    lg = np.where(new, 0, np.r_[np.uint32(0), sv[:-1]]).astype(np.uint32)
    return dict(key=sk, order=so, idx=si, value=sv,
                rn=(pos - ps + 1).astype(np.uint32),
                rk=(rs - ps + 1).astype(np.uint32),
                cum=p0[pos + 1] - p0[ps], lg=lg)


@pytest.mark.parametrize("partitions", PARTITIONS)
def test_rows_and_window_columns_match_jax(partitions):
    res, got = _port(partitions)
    jres, want = _jax(partitions)
    assert res.all_ok and jres.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(got) == sorted(want)
    for k in COLS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("partitions", PARTITIONS)
def test_matches_sequential_oracle(partitions):
    _, got = _port(partitions)
    want = _oracle(N, partitions)
    for k in COLS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_running_sum_exact_past_2_32():
    _, got = _port(1)
    assert got["cum"][-1] == got["value"].astype(np.uint64).sum()
    assert got["cum"][-1] > (1 << 32)


def _runs(n=N, run=RUN, partitions=16):
    port = [tw._make_run(r, run, partitions, 7, "cpu")
            for r in range(n // run)]
    jax_ = [jw._make_run(jnp.uint32(r), n_run=run, partitions=partitions,
                         seed=7) for r in range(n // run)]
    return port, jax_


def _np(p):
    return p.numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _runs16():
    return _runs()


def test_runs_plan_and_search_match_jax():
    port, jax_ = _runs16()
    for run, jrun in zip(port, jax_):
        for p, jp in zip(run, jrun):
            np.testing.assert_array_equal(_np(p), np.asarray(jp))
    for buckets, per_run in ((BUCKETS, 4096), (3, 100), (7, 37)):
        shi, slo, bounds = tw._plan(port, buckets, per_run)
        jhi, jlo, jbounds = jw._plan(jax_, n_buckets=buckets,
                                     per_run=per_run)
        np.testing.assert_array_equal(_np(shi), np.asarray(jhi))
        np.testing.assert_array_equal(_np(slo), np.asarray(jlo))
        np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
    # queries off the data: rows of the run, their neighbours and random
    # words, every bit 31 pattern among them
    lo, hi, o, idx, _ = port[1]
    rng = np.random.default_rng(3)
    pick = rng.integers(0, RUN, 64)
    q = [p[pick].clone() for p in (hi, lo, o, idx)]
    q[3][::2] ^= 1
    q[2][::3] = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 22,
                                              dtype=np.int32))
    q[0][::5] = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 13,
                                              dtype=np.int32))
    got = tw._searchsorted_multi((hi, lo, o, idx), q)
    want = jw._searchsorted_multi(
        tuple(jnp.asarray(_np(p)) for p in (hi, lo, o, idx)),
        [jnp.asarray(_np(p)) for p in q])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stream(pads=0):
    """Run 1 of the 16-partition data as one sorted stream, with `pads`
    sentinel rows (all-ones planes, value 0) behind it."""
    lo, hi, o, idx, v = _runs16()[0][1]
    if pads:
        ones = torch.full((pads,), -1, dtype=torch.int32)
        lo, hi, o, idx = (torch.cat([p, ones]) for p in (lo, hi, o, idx))
        v = torch.cat([v, torch.zeros(pads, dtype=torch.int32)])
    return hi, lo, o, idx, v


def _carries(lo, hi, o):
    first = [int(_np(p)[0]) for p in (lo, hi, o)]
    return {"zero": [0] * 9,
            "same_partition_and_order": [1, *first, 5, 3, 0xFFFFFFF0, 7,
                                         123],
            "same_partition": [1, first[0], first[1], first[2] ^ 1, 9, 4,
                               17, 0, 0xDEADBEEF],
            "other_partition": [1, first[0] ^ 1, first[1], first[2], 5, 3,
                                1, 2, 3]}


@pytest.mark.parametrize("pads", [0, 100])
@pytest.mark.parametrize("carry", ["zero", "same_partition_and_order",
                                   "same_partition", "other_partition"])
def test_window_core_matches_jax_on_one_stream_and_carry(carry, pads):
    hi, lo, o, idx, v = _stream(pads)
    c = _carries(lo, hi, o)[carry]
    checks, cout, planes = tw.window_core(
        hi, lo, o, idx, v, RUN, torch.tensor(c, dtype=torch.int64), 16, 7)
    jchecks, jcout, jplanes = jw.window_core(
        *(jnp.asarray(_np(p)) for p in (hi, lo, o, idx, v)),
        jnp.uint32(RUN), jnp.asarray(np.array(c, dtype=np.uint32)), 16, 7)
    np.testing.assert_array_equal(
        checks.numpy(), np.array([int(x) for x in jchecks], np.int64))
    assert checks[:3].tolist() == [1, 1, 1]
    np.testing.assert_array_equal(cout.numpy(), np.asarray(jcout))
    for p, jp in zip(planes, jplanes):
        np.testing.assert_array_equal(p[:RUN].numpy(), np.asarray(jp)[:RUN])


@pytest.mark.parametrize("fault", ["swap", "value", "window"])
def test_window_core_checks_catch_injected_faults(fault, monkeypatch):
    hi, lo, o, idx, v = (p.clone() for p in _stream())
    if fault == "swap":         # two rows of different partitions swapped
        j = int(torch.nonzero(hi[1:] != hi[:-1])[0]) + 1
        for p in (hi, lo, o, idx, v):
            p[[j - 1, j]] = p[[j, j - 1]]
    elif fault == "value":      # a value that is not its row's
        v[77] ^= 1
    else:                       # a window plane off by one
        real = tw._window_sorted_cols

        def off_by_one(*a, **kw):
            out, aux = real(*a, **kw)
            rn = out["rn"].view(torch.int32).clone()
            rn[300] += 1
            out["rn"] = rn.view(torch.uint32)
            return out, aux
        monkeypatch.setattr(tw, "_window_sorted_cols", off_by_one)
    checks, _, _ = tw.window_core(hi, lo, o, idx, v, RUN,
                                  torch.zeros(9, dtype=torch.int64), 16, 7)
    s_ok, h_ok, w_ok = checks[:3].tolist()
    assert s_ok == (fault != "swap")
    assert h_ok == (fault != "value")
    assert w_ok == (fault != "window")


def test_a_corrupted_row_in_a_run_fails_the_hash_check(monkeypatch):
    real = tw._make_run

    def corrupted(r, *a):
        run = real(r, *a)
        if r == 2:
            run[4][123] ^= -(1 << 31)   # one value, its top bit
        return run
    monkeypatch.setattr(tw, "_make_run", corrupted)
    res = tw.window_big(N, partitions=16, run_size=RUN, n_buckets=BUCKETS,
                        device="cpu")
    assert not res.hash_ok
    assert res.sorted_ok and res.window_ok and res.count_ok


def test_empty_buckets_match_jax():
    # more buckets than distinct samples: 36 of 100 buckets are empty
    kw = dict(partitions=4, run_size=64, n_buckets=100, collect=True)
    res, got = tw.window_big(64, device="cpu", **kw)
    jres, want = jw.window_big(64, **kw)
    bounds = tw._plan([tw._make_run(0, 64, 4, 7, "cpu")], 100, 4096)[2]
    assert (bounds[0, 1:] == bounds[0, :-1]).any()
    assert res.all_ok and jres.all_ok
    for k in COLS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_checks_pass_without_collect():
    res = tw.window_big(1 << 14, partitions=64, run_size=1 << 12,
                        n_buckets=4, device="cpu")
    assert res.all_ok, res


def test_uneven_buckets_and_single_run():
    res = tw.window_big(1 << 12, partitions=7, run_size=1 << 12,
                        n_buckets=3, device="cpu")
    assert res.all_ok, res


def _stop_after_two(monkeypatch, cls):
    real, calls = cls.record, []

    def record(self, b, vals):
        real(self, b, vals)
        calls.append(b)
        if len(calls) == 2:
            raise RuntimeError("simulated kill")
    monkeypatch.setattr(cls, "record", record)
    return real


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_stopped_run_resumes_in_the_other_package(writer, tmp_path,
                                                    monkeypatch):
    kw = dict(partitions=16, run_size=RUN, n_buckets=BUCKETS)
    meta = np.asarray([N, 16, RUN, BUCKETS, 7, 4096, 0xB16], np.int64)
    whole_dir = tmp_path / "whole"
    whole_dir.mkdir()
    whole = tw.window_big(N, checkpoint_dir=str(whole_dir), device="cpu",
                          **kw)
    write, resume = ((jw, jck.RunState), (tw, tck.RunState))
    if writer == "torch":
        write, resume = resume, write
    real = _stop_after_two(monkeypatch, write[1])
    wkw = {"device": "cpu"} if writer == "torch" else {}
    with pytest.raises(RuntimeError, match="simulated kill"):
        write[0].window_big(N, checkpoint_dir=str(tmp_path), **kw, **wkw)
    monkeypatch.setattr(write[1], "record", real)
    stopped = tck.RunState.load(str(tmp_path), meta)
    assert stopped is not None and stopped.done.tolist() == [1, 1, 0, 0]
    rkw = {"device": "cpu"} if writer == "jax" else {}
    res = resume[0].window_big(N, checkpoint_dir=str(tmp_path), **kw,
                               **rkw)
    assert res.all_ok and whole.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(_port(16)[0], f), f
    a = tck.RunState.load(str(whole_dir), meta)
    b = tck.RunState.load(str(tmp_path), meta)
    assert b.done.all() and (b.scalars >= 0).all()
    assert (b.scalars < (1 << 32)).all() and (a.scalars < (1 << 32)).all()
    np.testing.assert_array_equal(a.bounds, b.bounds)
    assert a.bounds.dtype == b.bounds.dtype == np.int32
    np.testing.assert_array_equal(a.scalars, b.scalars)


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jw.window_big).parameters
    got = inspect.signature(tw.window_big).parameters
    assert list(got)[:len(want)] == list(want)
    for p, w in want.items():
        assert got[p].default == w.default, p
    assert got["device"].default == "cuda"
    assert list(tw.BigWindowResult.__dataclass_fields__) == list(
        jw.BigWindowResult.__dataclass_fields__)
    assert (tw.WSPEC, tw.N_CARRY, tw.N_CHECK) == (jw.WSPEC, jw.N_CARRY,
                                                  jw.N_CHECK)
    assert list(inspect.signature(tw.window_core).parameters) == list(
        inspect.signature(jw.window_core).parameters)


def test_envelope_counts_the_passes_the_sorts_record():
    from tpu_qe_torch.bench import sol
    from tpu_qe_torch.sort import driver
    driver.RADIX_PASSES.clear()
    tw.window_big(1 << 14, partitions=64, run_size=1 << 12, n_buckets=4,
                  device="cpu")
    recorded = sol.operator_sol_seconds(driver.RADIX_PASSES, 0, 0,
                                        "H100 80GB HBM3")
    envelope = sol.bigwindow_sol_seconds(1 << 14, 1 << 12, 4,
                                         device_name="H100 80GB HBM3")
    rows_and_scans = (20 + 6 * 8) * (1 << 14) / 3.35e12
    # at ideal balance the envelope's passes are the recorded ones
    assert envelope - rows_and_scans == pytest.approx(recorded, rel=1e-9)


def _cli(argv, capsys):
    from tpu_qe_torch.__main__ import main
    rc = main(argv)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    return rc, rows


def test_cli_rehearses_on_the_cpu_and_resumes(capsys, tmp_path):
    argv = ["bench-bigwindow", "--device", "cpu", "--n", "16384",
            "--run-size", "4096", "--buckets", "4", "--checkpoint-dir",
            str(tmp_path)]
    rc, rows = _cli(argv, capsys)
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert set(row["checks"]) == {"sorted", "hash", "window", "count",
                                  "boundary"}
    assert {"metric", "value", "unit", "time_s", "phase_runs_s",
            "phase_buckets_s", "device"} <= set(row)
    # 12 passes a run and a bucket, 16 over the plan's samples
    assert row["sort_passes"] == 4 * 12 + 16 + 4 * 12
    rc, rows = _cli(argv, capsys)       # every bucket replays
    assert rc == 0 and rows[0]["verified"]
    assert rows[0]["sort_passes"] == 4 * 12


def test_cli_refuses_the_distributed_path(capsys, tmp_path):
    # --distributed --devices 2 runs the distributed operator on a
    # LocalMesh of the CPU: every check holds and the line names the mesh
    from tpu_qe_torch.__main__ import main
    argv = ["bench-bigwindow", "--device", "cpu", "--n", "16384",
            "--run-size", "2048", "--distributed", "--devices", "2"]
    assert main(argv) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert row["verified"] and all(row["checks"].values()), row
    assert row["metric"].endswith(", 2 devices"), row["metric"]
    assert row["devices"] == 2 and row["mesh"] == "LocalMesh(2, cpu)"
    assert row["time_s"] == "not measured" and row["sort_passes"] > 0
    assert row["balance"] >= 1.0, row["balance"]
    # the distributed window keeps no checkpoint (the reference asserts)
    with pytest.raises(AssertionError, match="single-chip path"):
        main(argv + ["--checkpoint-dir", str(tmp_path)])


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.window_big(1 << 10, run_size=1 << 10)
