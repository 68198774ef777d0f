"""tpu_qe_torch.sort.bigsort against tpu_qe.sort.bigsort on CPU tensors
(the radix sort runs its kernels' plain twins here), at the reference
tests' sizes (n <= 2^13, runs of 2^11 rows). Compared, bit for bit: every
BigSortResult certificate, the plan's segment boundaries and the nine
scalars of every bucket (through each package's checkpoint file), and
with collect=True the sorted keys, payloads and value columns. Also: a
numpy oracle, consume's device tensors in key order, a resume after a run
stopped mid-merge (from either package's checkpoint), and certificates
that catch a broken bucket."""

import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.hashing import keygen_hash_numpy  # noqa: E402
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.utils import checkpoint as tck  # noqa: E402

jb = importlib.import_module("tpu_qe.sort.bigsort")
tb = importlib.import_module("tpu_qe_torch.sort.bigsort")
jck = importlib.import_module("tpu_qe.utils.checkpoint")

N, RUN = 1 << 13, 1 << 11
CERTS = ("n", "sorted_ok", "hash_ok", "count_ok", "perm_ok", "boundary_ok")


def _meta(n, run, buckets, payload_cols=1, strategy="partition"):
    return np.asarray([n, run, buckets, 7, 4096, payload_cols,
                       0 if strategy == "merge" else 1], np.int64)


def _jax(strategy, payload_cols, buckets, tmp):
    res, out = jb.sort_big(N, run_size=RUN, n_buckets=buckets, collect=True,
                           checkpoint_dir=tmp, strategy=strategy,
                           payload_cols=payload_cols)
    st = jck.RunState.load(tmp, _meta(N, RUN, buckets, payload_cols,
                                      strategy))
    return res, out, st


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("jax")


def _same_outputs(got, want, payload_cols):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.uint32 and got[0].dtype == np.uint64
    if payload_cols > 1:
        assert len(got[2]) == len(want[2]) == payload_cols - 1
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("payload_cols", [1, 3])
@pytest.mark.parametrize("strategy", ["partition", "merge"])
@pytest.mark.parametrize("buckets", [4, 3])
def test_sort_big_matches_jax(strategy, payload_cols, buckets, jax_dir,
                              tmp_path):
    sub = jax_dir / f"{strategy}-{payload_cols}-{buckets}"
    sub.mkdir(exist_ok=True)
    jres, jout, jst = _jax(strategy, payload_cols, buckets, str(sub))
    res, out = tb.sort_big(N, run_size=RUN, n_buckets=buckets, collect=True,
                           checkpoint_dir=str(tmp_path), strategy=strategy,
                           payload_cols=payload_cols, device="cpu")
    assert res.all_ok and jres.all_ok
    for f in CERTS:
        assert getattr(res, f) == getattr(jres, f), f
    _same_outputs(out, jout, payload_cols)
    st = tck.RunState.load(str(tmp_path), _meta(N, RUN, buckets,
                                                payload_cols, strategy))
    np.testing.assert_array_equal(st.bounds, jst.bounds)
    np.testing.assert_array_equal(st.scalars, jst.scalars)
    np.testing.assert_array_equal(st.done, np.ones(buckets, np.int64))


@pytest.mark.parametrize("n_buckets", [2, 5])
def test_uneven_buckets_against_numpy(n_buckets):
    n = 1 << 13
    res, (keys, pay) = tb.sort_big(n, run_size=1 << 12,
                                   n_buckets=n_buckets, collect=True,
                                   device="cpu")
    assert res.all_ok, res
    want = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(want, kind="stable")
    np.testing.assert_array_equal(keys, want[order])
    np.testing.assert_array_equal(pay, order.astype(np.uint32))


def test_sort_big_incore_matches_jax():
    res = tb.sort_big_incore(N, device="cpu")
    jres = jb.sort_big_incore(N)
    assert res.all_ok
    for f in CERTS:
        assert getattr(res, f) == getattr(jres, f), f
    assert res.compile_s == 0.0 and res.phase_a_s == 0.0


def test_value_columns_follow_the_reference_generator():
    idx = np.arange(0, 1 << 16, 7, dtype=np.uint32)
    for j in range(3):
        got = tb._value_col(torch.from_numpy(idx.view(np.int32)), j, 7)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      jb._value_col_numpy(idx, j, 7))
        np.testing.assert_array_equal(tb._value_col_numpy(idx, j, 7),
                                      jb._value_col_numpy(idx, j, 7))


def test_consume_gets_device_tensors_in_key_order():
    seen = []

    def consume(b, bucket):
        c = int(bucket["count"])
        assert isinstance(bucket["key"], U64)
        assert bucket["payload"].device.type == "cpu"
        assert bucket["count"].device.type == "cpu"
        seen.append((b, bucket["key"].to_numpy()[:c],
                     bucket["payload"].numpy().view(np.uint32)[:c],
                     [v.numpy().view(np.uint32)[:c]
                      for v in bucket["values"]]))

    res = tb.sort_big(N, run_size=RUN, n_buckets=4, consume=consume,
                      payload_cols=2, device="cpu")
    assert res.all_ok
    assert [b for b, *_ in seen] == [0, 1, 2, 3]
    keys = np.concatenate([k for _, k, _, _ in seen])
    pay = np.concatenate([p for _, _, p, _ in seen])
    assert len(keys) == N and (np.diff(keys.astype(np.float64)) >= 0).all()
    np.testing.assert_array_equal(
        keys, keygen_hash_numpy(pay))
    np.testing.assert_array_equal(np.concatenate([v[0] for *_, v in seen]),
                                  jb._value_col_numpy(pay, 0, 7))


def _crash_after(monkeypatch, module, k):
    real = module.RunState.record
    calls = {"n": 0}

    def crashing(self, b, vals):
        real(self, b, vals)
        calls["n"] += 1
        if calls["n"] == k:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(module.RunState, "record", crashing)
    return lambda: monkeypatch.setattr(module.RunState, "record", real)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_after_a_run_stopped_mid_merge(tmp_path, monkeypatch,
                                              writer):
    n, run, buckets = N, RUN, 4
    want = tb.sort_big(n, run_size=run, n_buckets=buckets, device="cpu")
    assert want.all_ok
    kill = dict(port=(tck, tb.sort_big), jax=(jck, jb.sort_big))[writer]
    merged = []
    real_merge = tb._merge_bucket

    def counting(*a, **k):
        merged.append(1)
        return real_merge(*a, **k)

    monkeypatch.setattr(tb, "_merge_bucket", counting)
    restore = _crash_after(monkeypatch, kill[0], 2)
    kw = dict(run_size=run, n_buckets=buckets, checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="simulated kill"):
        if writer == "port":
            kill[1](n, device="cpu", **kw)
        else:
            kill[1](n, **kw)
    restore()
    # the port records each bucket as it is merged: the kill came before
    # the third bucket's merge
    assert len(merged) == (2 if writer == "port" else 0)
    st = tck.RunState.load(str(tmp_path), _meta(n, run, buckets))
    assert st is not None and int(st.done.sum()) == 2
    done_before = st.scalars.copy()
    # the port resumes: only the two buckets left merge, same result
    merged.clear()
    res = tb.sort_big(n, device="cpu", **kw)
    monkeypatch.setattr(tb, "_merge_bucket", real_merge)
    assert len(merged) == 2 and res.all_ok
    for f in CERTS:
        assert getattr(res, f) == getattr(want, f), f
    st = tck.RunState.load(str(tmp_path), _meta(n, run, buckets))
    assert int(st.done.sum()) == buckets
    np.testing.assert_array_equal(st.scalars[done_before[:, 2] > 0],
                                  done_before[done_before[:, 2] > 0])
    # a completed checkpoint with collect=True re-merges to the same stream
    res2, (keys, _) = tb.sort_big(n, collect=True, device="cpu", **kw)
    assert res2.all_ok
    np.testing.assert_array_equal(
        keys, np.sort(keygen_hash_numpy(np.arange(n, dtype=np.uint32))))


def test_mismatched_checkpoint_is_not_reused(tmp_path):
    kw = dict(run_size=1 << 10, checkpoint_dir=str(tmp_path), device="cpu")
    assert tb.sort_big(1 << 12, n_buckets=2, **kw).all_ok
    assert tb.sort_big(1 << 12, n_buckets=4, **kw).all_ok
    st = tck.RunState.load(str(tmp_path), _meta(1 << 12, 1 << 10, 4))
    assert st.bounds.shape == (4, 3) and int(st.done.sum()) == 4


def _sorted_bucket(n=3000, cols=1):
    idx = np.arange(n, dtype=np.uint32)
    keys = keygen_hash_numpy(idx)
    order = np.argsort(keys, kind="stable")
    k = U64.from_numpy(keys[order], "cpu")
    pay = torch.from_numpy(idx[order].view(np.int32))
    vals = [torch.from_numpy(jb._value_col_numpy(idx[order], j, 7)
                             .view(np.int32)) for j in range(cols - 1)]
    return k.lo.clone(), k.hi.clone(), pay, vals


@pytest.mark.parametrize("fault", ["none", "swap_keys", "swap_payloads",
                                   "value", "sentinel_tail"])
def test_certificates_catch_a_broken_bucket(fault, monkeypatch):
    monkeypatch.setattr(tb, "CHUNK", 1000)     # boundaries between chunks
    lo, hi, pay, vals = _sorted_bucket(cols=2)
    n_valid = lo.shape[0]
    if fault == "swap_keys":
        for p in (lo, hi, pay, vals[0]):     # whole rows out of order
            p[[999, 1000]] = p[[1000, 999]]
    elif fault == "swap_payloads":
        pay[[5, 6]] = pay[[6, 5]]
    elif fault == "value":
        vals[0][2500] ^= 1
    elif fault == "sentinel_tail":
        lo, hi = (torch.cat([p, torch.full((10,), -1, dtype=torch.int32)])
                  for p in (lo, hi))
        pay, vals = (torch.cat([pay, torch.zeros(10, dtype=torch.int32)]),
                     [torch.cat([vals[0], torch.zeros(10,
                                                      dtype=torch.int32)])])
    s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi = tb._certify(
        lo, hi, pay, vals, n_valid, 7).tolist()
    assert s_ok == (fault != "swap_keys")
    assert h_ok == (fault not in ("swap_payloads", "value"))
    assert cnt == n_valid
    assert (psum, psq) == tb._want_sums(n_valid)
    assert (flo, fhi) == (int(lo[0]) & 0xFFFFFFFF, int(hi[0]) & 0xFFFFFFFF)
    assert llo == int(lo[n_valid - 1]) & 0xFFFFFFFF


def test_defaults_are_the_reference_defaults():
    for fn in ("sort_big", "sort_big_incore"):
        want = inspect.signature(getattr(jb, fn)).parameters
        got = inspect.signature(getattr(tb, fn)).parameters
        for name, p in want.items():
            assert got[name].default == p.default, (fn, name)
    assert list(tb.BigSortResult.__dataclass_fields__) == list(
        jb.BigSortResult.__dataclass_fields__)


@pytest.mark.parametrize("extra", [[], ["--strategy", "merge"],
                                   ["--payload-cols", "3"], ["--in-core"]])
def test_bench_big_cli_rehearses_on_the_cpu(extra, capsys, tmp_path):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-big", "--device", "cpu", "--n", str(1 << 13),
               "--run-size", str(1 << 11), "--checkpoint-dir",
               str(tmp_path / "ck")] + extra)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0 and len(lines) == 1
    row = json.loads(lines[0])
    assert row["verified"] and all(row["checks"].values())
    assert row["value"] == "not measured" and row["device"] == "cpu"
    assert ("in-core" in row["metric"]) == ("--in-core" in extra)


@pytest.mark.parametrize("extra,kind", [
    (["--devices", "2"], "distributed out-of-core"),
    (["--devices", "2", "--force-composed"], "distributed out-of-core"),
    (["--devices", "1", "--force-composed", "--payload-cols", "3"],
     "distributed out-of-core (3-col rows)"),
    (["--devices", "1"], "out-of-core (D=1 delegated)"),
])
def test_bench_big_distributed_cli_rehearses_on_the_cpu(extra, kind, capsys,
                                                        tmp_path):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-big", "--device", "cpu", "--distributed", "--n",
               str(1 << 14), "--run-size", str(1 << 11), "--buckets", "2",
               "--checkpoint-dir", str(tmp_path / "ck")] + extra)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0 and len(lines) == 1
    row = json.loads(lines[0])
    assert row["verified"] and all(row["checks"].values())
    assert set(row["checks"]) == {"sorted", "hash", "count", "perm",
                                  "boundary"}
    assert row["metric"].startswith(kind + " sort 16384 u64 keys")
    assert row["devices"] == int(extra[1])
    assert 1.0 <= row["balance"] < 1.5
    assert row["value"] == "not measured" and row["device"] == "cpu"


def test_bench_big_refuses_value_columns_in_core():
    from tpu_qe_torch.__main__ import main
    with pytest.raises(AssertionError):
        main(["bench-big", "--device", "cpu", "--n", "4096", "--in-core",
              "--payload-cols", "2"])


def test_bigsort_envelope_counts_its_passes_and_rows():
    from tpu_qe_torch.bench import sol
    name, peak = "NVIDIA H100 80GB HBM3", 3.35e12
    n, run, b = 1 << 30, 1 << 26, 16
    part = sol.bigsort_sol_seconds(n, run, b, device_name=name)
    # per run one 4-byte-key pass with the permutation (8 + 8 B a row);
    # per bucket 8 passes of 8-byte keys with it (24 B); rows made and
    # read once (12 B each way)
    want = (16 * run * 16 + b * 8 * (n // b) * 24 + 2 * n * 12) / peak
    assert part == pytest.approx(want)
    merge = sol.bigsort_sol_seconds(n, run, b, strategy="merge",
                                    device_name=name)
    assert merge == pytest.approx(want + (16 * 8 * run * 24
                                          - 16 * run * 16) / peak)
    with pytest.raises(ValueError):
        sol.bigsort_sol_seconds(n, run, b, device_name="TPU v5 lite")
