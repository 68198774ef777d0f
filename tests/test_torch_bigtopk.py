"""tpu_qe_torch.ops.bigtopk against tpu_qe.ops.bigtopk on CPU tensors (the
radix sort runs its kernels' plain twins here), at the reference tests'
sizes, smallest and largest. Compared bit for bit: the winners' keys and
payloads and every BigTopKResult check. Also: numpy's stable sort, the
checks turning false on injected faults, the CLI on the CPU and the
reference's defaults."""

import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.hashing import keygen_hash_numpy  # noqa: E402

jt = importlib.import_module("tpu_qe.ops.bigtopk")
tt = importlib.import_module("tpu_qe_torch.ops.bigtopk")

CHECKS = ("n", "k", "hash_ok", "order_ok", "distinct_ok")
# (n, k, run_size, largest): tests/test_bigtopk.py, then k of 1
CASES = [(1 << 14, 16, 1 << 12, False), (1 << 14, 16, 1 << 12, True),
         (1 << 14, 1 << 12, 1 << 12, False), (3 << 12, 100, 1 << 12, False),
         (1 << 12, 5, 1 << 12, True), (1 << 13, 1, 1 << 11, True),
         (1 << 14, 1 << 10, 1 << 12, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(n, k, run_size, largest):
    return jt.top_k_big(n, k, run_size=run_size, largest=largest,
                        collect=True)


@functools.lru_cache(maxsize=None)
def _port(n, k, run_size, largest):
    return tt.top_k_big(n, k, run_size=run_size, largest=largest,
                        collect=True, device="cpu")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_winners_and_checks_match_jax(case):
    res, (keys, pay) = _port(*case)
    jres, (jkeys, jpay) = _jax(*case)
    assert res.all_ok and jres.all_ok
    for f in CHECKS:
        assert getattr(res, f) == getattr(jres, f), f
    assert keys.dtype == jkeys.dtype and pay.dtype == jpay.dtype
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(pay, jpay)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_winners_match_numpy_s_stable_sort(case):
    n, k, _, largest = case
    _, (keys, pay) = _port(*case)
    allk = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(~allk if largest else allk, kind="stable")[:k]
    np.testing.assert_array_equal(keys, allk[order])
    np.testing.assert_array_equal(pay, order.astype(np.uint32))


def test_ties_break_by_payload_across_runs(monkeypatch):
    # every key equal: the winners are the first k row indices, in order
    from tpu_qe_torch.bits import U64

    def same_key(idx, seed=7):
        return U64(torch.full_like(idx, 5), torch.full_like(idx, 9))

    monkeypatch.setattr(tt, "keygen_hash", same_key)
    for largest in (False, True):
        res, (keys, pay) = tt.top_k_big(1 << 12, 40, run_size=1 << 10,
                                        largest=largest, collect=True,
                                        device="cpu")
        assert res.all_ok
        np.testing.assert_array_equal(pay, np.arange(40))
        assert (keys == (9 << 32 | 5)).all()


def _winners(k=32):
    parts = [tt._run_topk(r, 1 << 10, k, 7, False, "cpu") for r in range(4)]
    lo, hi, pay = (torch.cat([p[i] for p in parts]) for i in range(3))
    return tt._sorted_head(lo, hi, pay, k)


@pytest.mark.parametrize("fault", ["none", "swap_keys", "wrong_payload",
                                   "duplicate_row"])
def test_checks_catch_injected_faults(fault):
    wlo, whi, wpay = (x.clone() for x in _winners())
    if fault == "swap_keys":          # two winners out of order
        for p in (wlo, whi, wpay):
            p[[3, 4]] = p[[4, 3]]
    elif fault == "wrong_payload":
        wpay[5] ^= 1
    elif fault == "duplicate_row":    # a row picked twice, another lost
        for p in (wlo, whi, wpay):
            p[7] = p[6]
    *_, h_ok, o_ok, d_ok = tt._verify_winners(wlo, whi, wpay, 32, 7, False)
    assert bool(o_ok) == (fault != "swap_keys")
    assert bool(h_ok) == (fault != "wrong_payload")
    assert bool(d_ok) == (fault != "duplicate_row")


def test_preconditions():
    with pytest.raises(AssertionError):
        tt.top_k_big(1 << 13, (1 << 11) + 1, run_size=1 << 11, device="cpu")
    with pytest.raises(AssertionError):
        tt.top_k_big(1 << 13, 0, run_size=1 << 11, device="cpu")


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jt.top_k_big).parameters
    got = inspect.signature(tt.top_k_big).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"
    assert list(tt.BigTopKResult.__dataclass_fields__) == list(
        jt.BigTopKResult.__dataclass_fields__)


@pytest.mark.parametrize("extra", [[], ["--largest"]])
def test_cli_rehearses_on_the_cpu(extra, capsys):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigtopk", "--device", "cpu", "--n", "16384",
               "--run-size", "4096", "--k", "64"] + extra)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    # 8 passes per run and over the candidates, 4 over the winners'
    # payloads (a lone plane)
    assert row["sort_passes"] == 4 * 8 + 8 + 4
