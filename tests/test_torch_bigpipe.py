"""tpu_qe_torch.ops.bigpipe against tpu_qe.ops.bigpipe on CPU tensors (the
radix sort runs its kernels' plain twins here), at the reference tests'
sizes. Compared bit for bit: the collect=True group table (key, count,
u64 sum) and every BigPipeResult check. Also: the numpy GROUP BY of the
construction's matches, the checks turning false on injected faults, the
CLI on the CPU, the reference's defaults and the envelope's
arithmetic."""

import functools
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_qe.hashing import keygen_hash_numpy, murmur_fmix32_numpy  # noqa: E402

jp = importlib.import_module("tpu_qe.ops.bigpipe")
tp = importlib.import_module("tpu_qe_torch.ops.bigpipe")

CHECKS = ("n_l", "n_r", "matched", "n_groups", "join_ok", "count_ok",
          "keys_ok")
# (n_l, n_r, groups, buckets): tests/test_bigpipe.py
CASES = [(1 << 12, 1 << 12, 1 << 8, 2), (1 << 13, 1 << 11, 1 << 6, 4),
         (1 << 11, 1 << 13, 1 << 12, 3), (1 << 12, 1 << 12, 1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(n_l, n_r, g, b):
    return jp.join_aggregate_big(n_l, n_r, n_groups=g, n_buckets=b,
                                 collect=True)


@functools.lru_cache(maxsize=None)
def _port(n_l, n_r, g, b):
    return tp.join_aggregate_big(n_l, n_r, n_groups=g, n_buckets=b,
                                 collect=True, device="cpu")


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


def _oracle(n_l, n_r, g):
    j = np.arange(n_l, dtype=np.uint32)
    i = (j * np.uint32(2654435761)) % np.uint32(n_r)
    keys = keygen_hash_numpy(i) & ~np.uint64(1)
    m = j % 2 == 0
    vals = murmur_fmix32_numpy(
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ^ (keys >> np.uint64(32)).astype(np.uint32)
        ^ np.uint32(0xABCD1234)).astype(np.uint64)
    gid = jp.group_of_join_key_numpy(keys, g)
    cnt = np.bincount(gid[m], minlength=g)
    sums = np.zeros(g, np.uint64)
    np.add.at(sums, gid[m], vals[m])
    keep = cnt > 0
    return (np.flatnonzero(keep).astype(np.uint32),
            cnt[keep].astype(np.uint32), sums[keep])


@pytest.mark.parametrize("case", CASES, ids=str)
def test_table_matches_the_numpy_oracle(case):
    res, table = _port(*case)
    okey, ocnt, osum = _oracle(*case[:3])
    assert res.matched == (case[0] + 1) // 2
    np.testing.assert_array_equal(table["key"], okey)
    np.testing.assert_array_equal(table["count"], ocnt)
    np.testing.assert_array_equal(table["sum"], osum)


def test_group_hash_follows_the_reference():
    keys = keygen_hash_numpy(np.arange(5000, dtype=np.uint32))
    for g in (1, 7, 1 << 16):
        want = jp.group_of_join_key_numpy(keys, g)
        np.testing.assert_array_equal(tp.group_of_join_key_numpy(keys, g),
                                      want)
        k = tp.U64.from_numpy(keys, "cpu")
        ones = torch.ones(5000, dtype=torch.int32)
        part = tp._bucket_partial(k.lo, k.hi, ones, ones, ones, g,
                                  min(g, 5000))
        ng = int((part[2] != 0).sum())
        np.testing.assert_array_equal(part[0][:ng].numpy().view(np.uint32),
                                      np.unique(want))


@pytest.mark.parametrize("fault", ["wrong_value", "drop_row", "swap_keys"])
def test_checks_catch_injected_faults(fault, monkeypatch):
    real = tp._bucket_partial

    def broken(klo, khi, value, matched, valid, n_groups, partial_cap):
        if fault == "drop_row":           # one matched row never counted
            matched = matched.clone()
            matched[matched.nonzero()[0, 0]] = 0
        elif fault == "swap_keys":        # two group keys exchange places
            out = list(real(klo, khi, value, matched, valid, n_groups,
                            partial_cap))
            out[0] = out[0].clone()
            out[0][[0, 1]] = out[0][[1, 0]]
            return tuple(out)
        return real(klo, khi, value, matched, valid, n_groups, partial_cap)

    monkeypatch.setattr(tp, "_bucket_partial", broken)
    if fault == "wrong_value":            # a joined value off by one bit
        bj = importlib.import_module("tpu_qe_torch.ops.bigjoin")
        real_join = bj.join_fk_scan

        def wrong(*a, **kw):
            out, matched = real_join(*a, **kw)
            out["rv"][matched.nonzero()[0, 0]] ^= 1
            return out, matched
        monkeypatch.setattr(bj, "join_fk_scan", wrong)
    res, table = tp.join_aggregate_big(1 << 12, 1 << 12, n_groups=1 << 8,
                                       n_buckets=2, collect=True,
                                       device="cpu")
    _, want = _jax(1 << 12, 1 << 12, 1 << 8, 2)
    if fault == "swap_keys":
        # the certificates cannot see a group's rows under another key:
        # the oracle does
        assert res.all_ok
        assert not np.array_equal(table["count"], want["count"])
    else:
        assert not {"wrong_value": res.join_ok,
                    "drop_row": res.count_ok}[fault]


def test_defaults_and_fields_are_the_reference_s():
    want = inspect.signature(jp.join_aggregate_big).parameters
    got = inspect.signature(tp.join_aggregate_big).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert got["device"].default == "cuda"
    assert list(tp.BigPipeResult.__dataclass_fields__) == list(
        jp.BigPipeResult.__dataclass_fields__)


def test_cli_rehearses_on_the_cpu(capsys):
    import json

    from tpu_qe_torch.__main__ import main
    rc = main(["bench-bigpipe", "--device", "cpu", "--n-left", "8192",
               "--n-right", "8192", "--groups", "100", "--buckets", "3"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    assert row["verified"] and all(row["checks"].values())
    assert row["matched"] == 4096 and row["time_s"] == "not measured"
    # the join's 6 sorts, a 9-pass GROUP BY per bucket and the combine's 8
    assert row["sort_passes"] == 8 * 6 + 9 * 3 + 8


def test_envelope_adds_the_partial_group_by_to_the_join_s():
    from tpu_qe_torch.bench import sol
    name, peak = "NVIDIA H100 80GB HBM3", 3.35e12
    n, b, g = 1 << 29, 16, 1 << 16
    rows = n // b
    got = sol.bigpipe_sol_seconds(n, n, b, g, device_name=name)
    join = sol.bigjoin_sol_seconds(n, n, b, device_name=name)
    # per bucket 8 passes of 24 B a row and one of 16 B (a lone 1-bit
    # plane), the combine's 8 over b * g rows, 4 scans over the left rows
    want = (b * (8 * rows * 24 + rows * 16) + 8 * b * g * 24
            + 8 * 4 * n) / peak
    assert got == pytest.approx(join + want)
