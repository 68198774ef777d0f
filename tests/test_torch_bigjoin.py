"""tpu_qe_torch.ops.bigjoin against tpu_qe.ops.bigjoin on CPU tensors (the
radix sort runs its kernels' plain twins here), at the reference tests'
sizes and the non-distributed cases of tests/test_fuzz_big.py. Compared
bit for bit: the sorted sides, the bucket plan, the collect=True stream
(key, lidx, value, matched) and every BigJoinResult check. Also: the
numpy construction oracle, consume's device tensors, `bigjoin_state.npz`
written by either package resuming in the other, the checks turning
false on injected faults, the CLI on the CPU, the reference's defaults
and the envelope's arithmetic."""

import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.hashing import keygen_hash_numpy, murmur_fmix32_numpy  # noqa: E402

jb = importlib.import_module("tpu_qe.ops.bigjoin")
tb = importlib.import_module("tpu_qe_torch.ops.bigjoin")

CHECKS = ("n_l", "n_r", "matched", "match_ok", "val_ok", "count_ok")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fuzz_case(trial):
    rng = np.random.default_rng(6000 + trial)
    return (1 << int(rng.integers(10, 14)), 1 << int(rng.integers(10, 14)),
            int(rng.integers(2, 9)))


# (n_l, n_r, buckets): tests/test_bigjoin.py, then the fuzz
CASES = [(1 << 12, 1 << 12, 2), (1 << 13, 1 << 11, 4), (1 << 11, 1 << 13, 4),
         (1 << 12, 1 << 12, 7), (1 << 14, 1 << 14, 8)] + [
    _fuzz_case(t) for t in range(4)]


@functools.lru_cache(maxsize=None)
def _jax(n_l, n_r, b):
    return jb.join_big(n_l, n_r, n_buckets=b, collect=True)


@functools.lru_cache(maxsize=None)
def _port(n_l, n_r, b):
    return tb.join_big(n_l, n_r, n_buckets=b, collect=True, device="cpu")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_stream_and_checks_match_jax(case):
    res, out = _port(*case)
    jres, jout = _jax(*case)
    assert res.all_ok and jres.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(out) == sorted(jout)
    for k in jout:
        assert out[k].dtype == jout[k].dtype, k
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)


def _np_lkeys(n_l, n_r, seed=7):
    j = np.arange(n_l, dtype=np.uint32)
    i = (j * np.uint32(2654435761)) % np.uint32(n_r)
    hit = keygen_hash_numpy(i, seed) & ~np.uint64(1)
    miss = keygen_hash_numpy(j, seed + 1) | np.uint64(1)
    return np.where(j % 2 == 0, hit, miss)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_stream_matches_the_construction_oracle(case):
    n_l, n_r, _ = case
    res, out = _port(*case)
    keys, lidx, value, matched = (out["key"], out["lidx"], out["value"],
                                  out["matched"])
    assert res.matched == (n_l + 1) // 2
    assert (keys[1:] >= keys[:-1]).all()
    np.testing.assert_array_equal(np.sort(lidx), np.arange(n_l))
    want = _np_lkeys(n_l, n_r)[lidx]
    np.testing.assert_array_equal(keys, want)
    np.testing.assert_array_equal(matched, lidx % 2 == 0)
    val = murmur_fmix32_numpy(((want ^ (want >> np.uint64(32)))
                               & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                              ^ np.uint32(0xABCD1234))
    np.testing.assert_array_equal(value, np.where(matched, val, 0))


@pytest.mark.parametrize("case", [(1 << 13, 1 << 11, 4, 8192),
                                  (3000, 1 << 10, 7, 300)], ids=str)
def test_sorted_sides_and_plan_equal_the_reference(case):
    n_l, n_r, b, per_side = case
    left = tb._make_sorted_side(n_l, n_r, 7, "left", "cpu")
    right = tb._make_sorted_side(n_r, n_r, 7, "right", "cpu")
    jleft = jb._make_sorted_side(n=n_l, n_r=n_r, seed=7, side="left")
    jright = jb._make_sorted_side(n=n_r, n_r=n_r, seed=7, side="right")
    for got, want in zip(left + right, jleft + jright):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    bl, br = tb._plan_buckets(*left[:2], *right, b, per_side)
    jbl, jbr = jb._plan_buckets(*jleft[:2], *jright, n_buckets=b,
                                per_side=per_side)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jbl))
    np.testing.assert_array_equal(br.numpy(), np.asarray(jbr))


def test_wrapping_multiply_of_the_left_keys():
    # j * 2654435761 passes 2^32 from j = 2: the product wraps before mod
    j = np.arange(0, 1 << 20, 3, dtype=np.uint32)
    for n_r in (3, 1000, (1 << 31) + 11):
        got = tb._lkey_of_index(torch.from_numpy(j.view(np.int32)), n_r, 7)
        want = _np_lkeys(1 << 20, n_r)[j]
        np.testing.assert_array_equal(U64_np(got), want)


def U64_np(k):
    return (k.hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)
            | k.lo.numpy().view(np.uint32))


def test_consume_gets_device_tensors_in_key_order():
    seen = []

    def consume(b, bucket):
        assert bucket["value"].device.type == "cpu"
        assert int(bucket["valid"].sum()) == bucket["valid"].shape[0]
        seen.append((b, U64_np(bucket["key"]),
                     int(bucket["matched"].sum())))

    n = 1 << 12
    res = tb.join_big(n, n, n_buckets=4, consume=consume, device="cpu")
    assert res.all_ok and [s[0] for s in seen] == [0, 1, 2, 3]
    keys = np.concatenate([s[1] for s in seen])
    np.testing.assert_array_equal(keys, _port(n, n, 4)[1]["key"])
    assert sum(s[2] for s in seen) == res.matched


def test_an_empty_side_in_a_bucket_joins_nothing():
    llo, lhi, lidx = tb._make_sorted_side(64, 64, 7, "left", "cpu")
    rlo, rhi = tb._make_sorted_side(64, 64, 7, "right", "cpu")
    out, stream = tb._join_bucket(0, 64, 0, 0, llo, lhi, lidx, rlo, rhi)
    mo, vo, nm, ne, nl, nr = out.tolist()
    assert (mo, vo, nm, nl, nr) == (0, 1, 0, 64, 0) and ne == 32
    assert int(stream[3].abs().sum()) == 0
    out, stream = tb._join_bucket(5, 0, 0, 64, llo, lhi, lidx, rlo, rhi)
    assert out.tolist() == [1, 1, 0, 0, 0, 64]
    assert stream[0].shape == (0,)


@pytest.mark.parametrize("fault", ["swap_keys", "wrong_value", "flip_match",
                                   "drop_row"])
def test_checks_catch_injected_faults(fault, monkeypatch):
    real = tb.join_fk_scan

    def broken(left, right, lkey, rkey, **kw):
        if fault == "swap_keys":       # two left rows exchange keys
            lo = lkey.lo.clone()
            lo[[0, -1]] = lo[[-1, 0]]
            lkey = tb.U64(lo, lkey.hi)
        out, matched = real(left, right, lkey, rkey, **kw)
        if fault == "wrong_value":
            out["rv"][matched.nonzero()[0, 0]] ^= 1
        elif fault == "flip_match":
            matched = matched.clone()
            matched[0] = ~matched[0]
        return out, matched

    monkeypatch.setattr(tb, "join_fk_scan", broken)
    if fault == "drop_row":
        real_plan = tb._seg_plan
        monkeypatch.setattr(tb, "_seg_plan", lambda bounds, n: (
            real_plan(bounds, n)[0], real_plan(bounds, n)[1] - (
                np.arange(len(bounds) + 1) == 1)))
    res = tb.join_big(1 << 12, 1 << 12, n_buckets=4, device="cpu")
    assert not res.all_ok
    if fault == "swap_keys":      # a flag or a value no longer fits
        assert not (res.match_ok and res.val_ok)
    else:
        assert not {"wrong_value": res.val_ok, "flip_match": res.match_ok,
                    "drop_row": res.count_ok}[fault]


def _meta(n_l, n_r, b):
    return np.asarray([n_l, n_r, b, 7, 8192], np.int64)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_resumes_in_the_other_package(writer, tmp_path, monkeypatch):
    n, b = 1 << 12, 4
    ck = str(tmp_path)
    first = tb if writer == "port" else jb
    real = first._JoinState.record
    calls = []

    def crashing(self, bb, vals):
        real(self, bb, vals)
        calls.append(bb)
        if len(calls) == 2:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(first._JoinState, "record", crashing)
    with pytest.raises(RuntimeError, match="simulated kill"):
        first.join_big(n, n, n_buckets=b, checkpoint_dir=ck,
                       **({"device": "cpu"} if first is tb else {}))
    monkeypatch.setattr(first._JoinState, "record", real)
    assert int(tb._JoinState.load(ck, _meta(n, n, b)).done.sum()) == 2
    if writer == "port":       # the reference resumes the port's state
        res = jb.join_big(n, n, n_buckets=b, checkpoint_dir=ck)
    else:
        joined = []
        real_bucket = tb._join_bucket
        monkeypatch.setattr(tb, "_join_bucket",
                            lambda *a: joined.append(1) or real_bucket(*a))
        res = tb.join_big(n, n, n_buckets=b, checkpoint_dir=ck,
                          device="cpu")
        assert len(joined) == 2
    # the resumed state holds buckets of both packages: a whole run's
    whole = tmp_path / "whole"
    whole.mkdir()
    tb.join_big(n, n, n_buckets=b, checkpoint_dir=str(whole), device="cpu")
    a = tb._JoinState.load(str(whole), _meta(n, n, b))
    got = tb._JoinState.load(ck, _meta(n, n, b))
    assert res.all_ok and res.matched == n // 2
    np.testing.assert_array_equal(got.bounds, a.bounds)
    np.testing.assert_array_equal(got.scalars, a.scalars)
    assert got.done.all()
    # collect on a finished state joins every bucket again
    res2, out = tb.join_big(n, n, n_buckets=b, checkpoint_dir=ck,
                            collect=True, device="cpu")
    assert res2.all_ok
    np.testing.assert_array_equal(out["key"], _port(n, n, 4)[1]["key"])


def test_state_files_do_not_collide_with_the_sort(tmp_path):
    import os

    from tpu_qe_torch.sort import bigsort
    ck = str(tmp_path)
    assert bigsort.sort_big(1 << 12, run_size=1 << 10, n_buckets=2,
                            checkpoint_dir=ck, device="cpu").all_ok
    assert tb.join_big(1 << 11, 1 << 11, n_buckets=2, checkpoint_dir=ck,
                       device="cpu").all_ok
    assert {"bigsort_state.npz", "bigjoin_state.npz"} <= set(os.listdir(ck))


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jb.join_big).parameters
    got = inspect.signature(tb.join_big).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"
    assert list(tb.BigJoinResult.__dataclass_fields__) == list(
        jb.BigJoinResult.__dataclass_fields__)
    assert tb._JoinState.N_SCALARS == jb._JoinState.N_SCALARS == 6


@pytest.mark.parametrize("cmd", ["bench-bigagg", "bench-bigjoin",
                                 "bench-bigpipe", "bench-bigtopk",
                                 "bench-bigdistinct", "bench-bigsetops"])
def test_cli_defaults_are_the_reference_cli_s(cmd, monkeypatch):
    import tpu_qe.__main__ as jmain
    from tpu_qe_torch import __main__ as tmain
    seen = {}
    fn = "_cmd_" + cmd.replace("-", "_")
    monkeypatch.setattr(jmain, fn, lambda a: seen.setdefault("jax", a) and 0)
    monkeypatch.setattr(tmain, "_cmd_bench_bigops",
                        lambda a: seen.setdefault("port", a) and 0)
    jmain.main([cmd])
    tmain.main([cmd])
    want, got = vars(seen["jax"]), vars(seen["port"])
    for k, v in want.items():
        if k not in ("fn", "verbose"):
            assert got[k] == v, (cmd, k)
    assert got["device"] == "cuda" and got["trace_dir"] is None


# small sizes that divide over 1, 2 and 4 shards of two runs each
_DIST_SIZES = {
    "bench-bigagg": ["--n", "16384", "--run-size", "2048", "--groups",
                     "512"],
    "bench-bigjoin": ["--n-left", "8192", "--n-right", "8192",
                      "--run-size", "1024"],
    "bench-bigpipe": ["--n-left", "8192", "--n-right", "8192",
                      "--run-size", "1024", "--groups", "64"],
    "bench-bigtopk": ["--n", "16384", "--run-size", "2048", "--k", "16"],
    "bench-bigdistinct": ["--n", "16384", "--run-size", "2048", "--groups",
                          "64", "--values", "8"],
    "bench-bigsetops": ["--n-a", "8192", "--n-b", "8192", "--run-size",
                        "1024", "--g-a", "300", "--g-b", "200", "--offset",
                        "150"],
}


@pytest.mark.parametrize("cmd", ["bench-bigagg", "bench-bigjoin",
                                 "bench-bigpipe", "bench-bigtopk",
                                 "bench-bigdistinct", "bench-bigsetops"])
@pytest.mark.parametrize("flag", [["--distributed", "--devices", "2"],
                                  ["--distributed", "--devices", "4"],
                                  ["--distributed", "--devices", "1",
                                   "--force-composed"]])
def test_cli_refuses_the_distributed_path(cmd, flag, capsys):
    # --distributed runs the distributed operator on a LocalMesh of the
    # CPU (at --devices 1 the composed path with --force-composed): every
    # check holds and the line names the mesh
    import json

    from tpu_qe_torch.__main__ import main
    d = int(flag[2])
    assert main([cmd, "--device", "cpu"] + _DIST_SIZES[cmd] + flag) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert row["verified"] and all(row["checks"].values()), row
    assert row["metric"].endswith(f", {d} devices"), row["metric"]
    assert row["devices"] == d and row["mesh"] == f"LocalMesh({d}, cpu)"
    assert row["time_s"] == "not measured" and row["sort_passes"] > 0
    if cmd in ("bench-bigjoin", "bench-bigpipe", "bench-bigdistinct",
               "bench-bigsetops"):
        assert row["balance"] >= 1.0, row["balance"]
    else:       # no row moves between the shards
        assert "balance" not in row


@pytest.mark.parametrize("extra", [[], ["--buckets", "3"]])
def test_cli_rehearses_on_the_cpu(extra, capsys, tmp_path):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigjoin", "--device", "cpu", "--n-left", "8192",
               "--n-right", "4096", "--checkpoint-dir",
               str(tmp_path / "ck")] + extra)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert row["matched"] == 4096 and row["value"] == "not measured"
    buckets = int(extra[1]) if extra else 2
    # left and right sorts, the plan's samples, one sort per bucket
    assert row["sort_passes"] == 8 * (3 + buckets)


def test_envelope_counts_its_passes_scans_and_rows():
    from tpu_qe_torch.bench import sol
    name, peak = "NVIDIA H100 80GB HBM3", 3.35e12
    n, b = 1 << 29, 16
    got = sol.bigjoin_sol_seconds(n, n, b, device_name=name)
    # 8 passes with the permutation (24 B a row) per side, over 16384
    # samples and per bucket of 2^26 rows; 4 one-plane scans of both
    # sides' rows; 12 + 8 bytes a row generated
    want = (2 * 8 * n * 24 + 8 * 16384 * 24 + b * 8 * (2 * n // b) * 24
            + 8 * 4 * 2 * n + 20 * n) / peak
    assert got == pytest.approx(want)
