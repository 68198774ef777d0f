"""tpu_qe_torch.ops.bigquantile against tpu_qe.ops.bigquantile on CPU
tensors (the radix sort runs its kernels' plain twins here), at the
reference tests' sizes. Compared bit for bit: the sorted run keys, the
selected values, ranks, cnt_lt / cnt_le and the certificate, and the
PERCENTILE_CONT fields. Also: the numpy oracle of the reference tests,
the passes the key bits allow, the certificate turning false for a value
that is not the rank's element, the CLI on the CPU and the reference's
defaults."""

import functools
import importlib
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe.hashing import keygen_hash_numpy  # noqa: E402
from tpu_qe.ops.quantile import canon_qs, disc_rank  # noqa: E402

jq = importlib.import_module("tpu_qe.ops.bigquantile")
tq = importlib.import_module("tpu_qe_torch.ops.bigquantile")

QS = [0.0, 0.1, 0.5, (3, 2), 0.99, 1.0]     # tests/test_bigquantile.py
N, RUN = 1 << 12, 1 << 10
KEY_BITS = [64, 40, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(key_bits):
    return jq.quantile_big(N, QS, run_size=RUN, key_bits=key_bits)


@functools.lru_cache(maxsize=None)
def _port(key_bits):
    return tq.quantile_big(N, QS, run_size=RUN, key_bits=key_bits,
                           device="cpu")


def _port_runs(key_bits, n=N, run=RUN):
    runs = [tq._make_sorted_run_keys(r, run, 7, key_bits, "cpu")
            for r in range(n // run)]
    return runs, torch.stack([tq.signed_key(lo, hi) for lo, hi in runs])


def _u64(lo, hi):
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))


def _oracle_keys(n, key_bits):
    k = keygen_hash_numpy(np.arange(n, dtype=np.uint32), 7)
    if key_bits < 64:
        k = k & np.uint64((1 << key_bits) - 1)
    return k


@pytest.mark.parametrize("key_bits", KEY_BITS)
def test_values_ranks_and_certificate_match_jax(key_bits):
    res, jres = _port(key_bits), _jax(key_bits)
    assert res.all_ok and jres.all_ok and res.n_runs == jres.n_runs == 4
    assert res.ranks == jres.ranks and res.n == jres.n
    assert res.values.dtype == jres.values.dtype == np.uint64
    np.testing.assert_array_equal(res.values, jres.values)


@pytest.mark.parametrize("key_bits", KEY_BITS)
def test_sorted_runs_and_counts_match_jax(key_bits):
    runs, resident = _port_runs(key_bits)
    jruns = [jq._make_sorted_run_keys(jnp.uint32(r), n_run=RUN, seed=7,
                                      key_bits=key_bits)
             for r in range(N // RUN)]
    for (lo, hi), (jlo, jhi) in zip(runs, jruns):
        np.testing.assert_array_equal(_u64(lo.numpy().view(np.uint32),
                                           hi.numpy().view(np.uint32)),
                                      _u64(jlo, jhi))
    ranks = _jax(key_bits).ranks
    p, cert, lt, le = tq._select_from_runs(resident, ranks)
    jlo, jhi, jcert, jlt, jle = jq._select_from_runs(
        tuple(r[0] for r in jruns), tuple(r[1] for r in jruns), ranks)
    np.testing.assert_array_equal(p.numpy().view(np.uint64), _u64(jlo, jhi))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt))
    np.testing.assert_array_equal(le.numpy(), np.asarray(jle))
    assert bool(cert) and bool(jcert)


def test_cont_matches_jax():
    res = tq.quantile_cont_big(N, QS, run_size=RUN, device="cpu")
    jres = jq.quantile_cont_big(N, QS, run_size=RUN)
    assert res.all_ok and jres.all_ok
    for f in ("n", "frac_num", "shifts", "n_runs"):
        assert getattr(res, f) == getattr(jres, f), f
    for f in ("lower", "upper"):
        assert getattr(res, f).dtype == np.uint64
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))


@pytest.mark.parametrize("key_bits", KEY_BITS)
def test_matches_numpy_oracle(key_bits):
    keys = np.sort(_oracle_keys(N, key_bits))
    want = [keys[disc_rank(num, sh, N)] for num, sh in canon_qs(QS)]
    np.testing.assert_array_equal(_port(key_bits).values,
                                  np.array(want, dtype=np.uint64))


def test_single_run_and_heavy_duplicates():
    n = 1 << 10
    res = tq.quantile_big(n, [(1, 1)], run_size=n, key_bits=2, device="cpu")
    assert res.all_ok
    keys = np.sort(_oracle_keys(n, 2))           # values in {0, 1, 2, 3}
    assert res.values[0] == keys[(n + 1) // 2 - 1]


def test_certificate_ranks_are_exact():
    res = tq.quantile_big(N, [0.25, 0.75], run_size=1 << 11, key_bits=16,
                          device="cpu")
    keys = _oracle_keys(N, 16)
    for v, r in zip(res.values, res.ranks):
        assert (keys < v).sum() <= r < (keys <= v).sum()
        assert (keys == v).any()                 # always a data element


@pytest.mark.parametrize("key_bits,passes", [(64, 8), (40, 5), (8, 1)])
def test_run_sorts_take_the_passes_of_their_key_bits(key_bits, passes):
    from tpu_qe_torch.sort import driver
    driver.RADIX_PASSES.clear()
    tq._make_sorted_run_keys(0, RUN, 7, key_bits, "cpu")
    assert sum(driver.RADIX_PASSES.values()) == passes


@pytest.mark.parametrize("fault", ["none", "next_value", "other_rank"])
def test_certificate_fails_for_a_value_not_at_its_rank(fault):
    _, resident = _port_runs(64)
    ranks = _jax(64).ranks
    p, cert, lt, le = tq._select_from_runs(resident, ranks)
    assert bool(cert)
    if fault == "next_value":       # distinct 64-bit keys: not an element
        p = p.clone()
        p[2] += 1
    elif fault == "other_rank":     # an element, at the neighbour's rank
        p = p.clone()
        p[2] = p[3]
    r = torch.tensor(ranks)
    lt, le = (tq._counts(resident, p ^ tq._INT64_MIN, side)
              for side in ("left", "right"))
    assert bool(((lt <= r) & (r < le)).all()) == (fault == "none")


def test_defaults_and_fields_are_the_reference_s():
    for name in ("quantile_big", "quantile_cont_big"):
        want = inspect.signature(getattr(jq, name)).parameters
        got = inspect.signature(getattr(tq, name)).parameters
        assert list(got)[:len(want)] == list(want)
        for p, w in want.items():
            assert got[p].default == w.default, (name, p)
        assert got["device"].default == "cuda"
    for cls in ("BigQuantileResult", "BigContQuantileResult"):
        assert list(getattr(tq, cls).__dataclass_fields__) == list(
            getattr(jq, cls).__dataclass_fields__)


@pytest.mark.parametrize("extra", [[], ["--cont"]])
def test_cli_rehearses_on_the_cpu(extra, capsys):
    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigquantile", "--device", "cpu", "--n", "16384",
               "--run-size", "4096"] + extra)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["cert_ok"] and row["verified"] and row["runs"] == 4
    assert row["sort_passes"] == 4 * 8
    fields = {"metric", "value", "unit", "time_s", "runs", "cert_ok",
              "device"}
    if not extra:
        fields |= {"phase_runs_s", "phase_select_s"}
    assert fields <= set(row)
    assert row["time_s"] == "not measured"


def test_cli_refuses_the_distributed_path(capsys):
    # --distributed --devices 2 runs the distributed operator on a
    # LocalMesh of the CPU: every check holds and the line names the mesh
    from tpu_qe_torch.__main__ import main
    argv = ["bench-bigquantile", "--device", "cpu", "--n", "16384",
            "--run-size", "2048", "--distributed", "--devices", "2"]
    assert main(argv) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert row["verified"] and all(row["checks"].values()), row
    assert row["metric"].endswith(", 2 devices"), row["metric"]
    assert row["devices"] == 2 and row["mesh"] == "LocalMesh(2, cpu)"
    assert row["time_s"] == "not measured" and row["sort_passes"] > 0
    assert row["runs"] == 8 and "balance" not in row    # no row moves


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for fn in (tq.quantile_big, tq.quantile_cont_big):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(1 << 10, [0.5], run_size=1 << 10)
