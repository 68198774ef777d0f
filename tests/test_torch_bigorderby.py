"""tpu_qe_torch.ops.bigorderby against tpu_qe.ops.bigorderby on CPU tensors
(the radix sort runs its kernels' plain twins here), at the reference
tests' sizes. Compared bit for bit: the collect=True columns (a, b, idx,
pay), every BigOrderByResult check, the sorted runs and the plan's
bounds. Also: numpy's lexsort, the checks turning false on injected
faults, the CLI on the CPU and the reference's defaults."""

import functools
import importlib
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

jo = importlib.import_module("tpu_qe.ops.bigorderby")
to = importlib.import_module("tpu_qe_torch.ops.bigorderby")

CHECKS = ("n", "a_card", "sorted_ok", "hash_ok", "boundary_ok", "count_ok",
          "perm_ok")
N, RUN = 1 << 12, 1 << 10
CASES = [(7, 4), (1 << 10, 3), (1, 2)]     # tests/test_bigorderby.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(a_card, buckets):
    return jo.order_by_big(N, a_card=a_card, run_size=RUN,
                           n_buckets=buckets, collect=True)


@functools.lru_cache(maxsize=None)
def _port(a_card, buckets):
    return to.order_by_big(N, a_card=a_card, run_size=RUN,
                           n_buckets=buckets, collect=True, device="cpu")


def _oracle(n, a_card):
    a, b, pay = to.rows_numpy(np.arange(n, dtype=np.uint32), a_card)
    # ORDER BY a DESC, b ASC, input position (stability); DESC on u64 by
    # the bitwise complement
    perm = np.lexsort((np.arange(n), b, ~a))
    return a[perm], b[perm], perm.astype(np.uint32), pay[perm]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_columns_and_checks_match_jax(case):
    res, got = _port(*case)
    jres, want = _jax(*case)
    assert res.all_ok and jres.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    assert sorted(got) == sorted(want) == ["a", "b", "idx", "pay"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_matches_numpy_lexsort(case):
    _, got = _port(*case)
    for k, w in zip(("a", "b", "idx", "pay"), _oracle(N, case[0])):
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("a_card,buckets,per_run", [(7, 4, 4096),
                                                    (1, 3, 100)])
def test_runs_and_plan_match_jax(a_card, buckets, per_run):
    runs = [to._make_run(r, RUN, a_card, 7, "cpu") for r in range(N // RUN)]
    jruns = [jo._make_run(jnp.uint32(r), n_run=RUN, a_card=a_card, seed=7)
             for r in range(N // RUN)]
    for run, jrun in zip(runs, jruns):
        for p, jp in zip(run, jrun):
            np.testing.assert_array_equal(p.numpy().view(np.uint32),
                                          np.asarray(jp))
    bounds = to._plan(runs, buckets, per_run)
    jbounds = jo._plan(jruns, n_buckets=buckets, per_run=per_run)
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))


def test_empty_buckets_match_jax():
    # more buckets than distinct samples: some buckets are empty
    kw = dict(a_card=4, run_size=64, n_buckets=100, collect=True)
    res, got = to.order_by_big(64, device="cpu", **kw)
    jres, want = jo.order_by_big(64, **kw)
    bounds = to._plan([to._make_run(0, 64, 4, 7, "cpu")], 100, 4096)
    assert (bounds[0, 1:] == bounds[0, :-1]).any()
    assert res.all_ok and jres.all_ok
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_certificates_at_scale_shape():
    res = to.order_by_big(1 << 14, run_size=1 << 12, n_buckets=5,
                          device="cpu")
    assert res.all_ok, res


def test_single_bucket_single_run():
    n = 1 << 10
    res, got = to.order_by_big(n, a_card=3, run_size=n, n_buckets=2,
                               collect=True, device="cpu")
    assert res.all_ok
    np.testing.assert_array_equal(got["idx"], _oracle(n, 3)[2])


@pytest.mark.parametrize("fault", ["none", "swap", "payload", "boundary"])
def test_bucket_checks_catch_injected_faults(fault):
    cols = [p.clone() for p in to._make_run(0, RUN, 7, 7, "cpu")]
    carry = torch.zeros(to.N_CARRY, dtype=torch.int64)
    if fault == "swap":             # two rows of different keys swapped
        j = int(torch.nonzero(cols[2][1:] != cols[2][:-1])[0]) + 1
        for p in cols:
            p[[j - 1, j]] = p[[j, j - 1]]
    elif fault == "payload":
        cols[4][9] ^= 1
    elif fault == "boundary":       # the previous bucket ended past us
        carry[:4] = torch.tensor([0xFFFFFFFF] * 4)
    checks, new = to._bucket(*cols, carry, 7, 7)
    s_ok, h_ok, b_ok, cnt = checks.tolist()
    assert (s_ok, h_ok, b_ok) == (fault != "swap", fault != "payload",
                                  fault != "boundary")
    assert cnt == RUN
    want_sum = RUN * (RUN - 1) // 2
    assert new[4:].tolist() == [want_sum & 0xFFFFFFFF, want_sum >> 32]


def test_a_foreign_row_fails_the_permutation_certificate(monkeypatch):
    # run 1 holds index n + 7 (a consistent row that is not in the table)
    # in place of one of its own: every other check still holds
    real_cols = to._cols_of

    def make_run(r, n_run, a_card, seed, device):
        idx = torch.arange(r * n_run, (r + 1) * n_run, dtype=torch.int32)
        if r == 1:
            idx[7] = N + 7
        return to.sort_planes([*real_cols(idx, a_card, seed)[:3], idx,
                               real_cols(idx, a_card, seed)[3]], 3)
    monkeypatch.setattr(to, "_make_run", make_run)
    res = to.order_by_big(N, a_card=7, run_size=RUN, n_buckets=4,
                          device="cpu")
    assert not res.perm_ok
    assert res.sorted_ok and res.hash_ok and res.boundary_ok
    assert res.count_ok


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jo.order_by_big).parameters
    got = inspect.signature(to.order_by_big).parameters
    assert list(got)[:len(want)] == list(want)
    for p, w in want.items():
        assert got[p].default == w.default, p
    assert got["device"].default == "cuda"
    assert list(to.BigOrderByResult.__dataclass_fields__) == list(
        jo.BigOrderByResult.__dataclass_fields__)
    assert (to.N_PLANES, to.N_COLS, to.N_CARRY, to.N_CHECK) == (
        jo.N_PLANES, jo.N_COLS, jo.N_CARRY, jo.N_CHECK)


def test_cli_rehearses_on_the_cpu(capsys):
    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigorderby", "--device", "cpu", "--n", "16384",
               "--run-size", "4096"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert set(row["checks"]) == {"sorted", "hash", "boundary", "count",
                                  "perm"}
    assert {"metric", "value", "unit", "time_s", "phase_runs_s",
            "phase_buckets_s", "device"} <= set(row)
    # 12 passes a run and a bucket (2 buckets), 16 over the samples
    assert row["sort_passes"] == 4 * 12 + 16 + 2 * 12


def test_cli_refuses_the_distributed_path(capsys):
    # --distributed --devices 2 runs the distributed operator on a
    # LocalMesh of the CPU: every check holds and the line names the mesh
    from tpu_qe_torch.__main__ import main
    argv = ["bench-bigorderby", "--device", "cpu", "--n", "16384",
            "--run-size", "2048", "--distributed", "--devices", "2"]
    assert main(argv) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert row["verified"] and all(row["checks"].values()), row
    assert row["metric"].endswith(", 2 devices"), row["metric"]
    assert row["devices"] == 2 and row["mesh"] == "LocalMesh(2, cpu)"
    assert row["time_s"] == "not measured" and row["sort_passes"] > 0
    assert row["balance"] >= 1.0, row["balance"]


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.order_by_big(1 << 10, run_size=1 << 10)
