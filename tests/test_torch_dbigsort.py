"""tpu_qe_torch.sort.dbigsort on a LocalMesh of the CPU: every test of
tests/test_dbigsort.py against numpy's stable sort of the regenerated
keys (bit for bit, every certificate true), at the reference's mesh sizes
and inputs; the segment exchange against a hand-built plan; then
sort_big_distributed against tpu_qe.sort.dbigsort on the same
configuration at D = 2 and 8 (keys, payloads, value columns and the
checkpointed plan and per-bucket scalars bit for bit), a checkpoint that
crosses between the packages. The bench-big --distributed CLI is
rehearsed in tests/test_torch_bigsort.py."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jd = importlib.import_module("tpu_qe.sort.dbigsort")
td = importlib.import_module("tpu_qe_torch.sort.dbigsort")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.hashing import keygen_hash_numpy  # noqa: E402
from tpu_qe_torch.utils import checkpoint as tck  # noqa: E402

CERTS = ("n", "sorted_ok", "hash_ok", "count_ok", "perm_ok", "boundary_ok")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return tm.LocalMesh(n, "cpu")


def _jmesh(n):
    from tpu_qe.exchange import make_mesh
    return make_mesh(n)


def _oracle(n, key_bits=64):
    keys = td.keygen_masked_numpy(np.arange(n, dtype=np.uint32),
                                  key_bits=key_bits)
    order = np.argsort(keys, kind="stable")
    return keys[order], order.astype(np.uint32)


def _run(n_dev, n_runs, run_size, buckets_per_dev, key_bits=64, **kw):
    n = n_dev * n_runs * run_size
    res, (keys, pay) = td.sort_big_distributed(
        n, _mesh(n_dev), run_size=run_size, buckets_per_dev=buckets_per_dev,
        key_bits=key_bits, collect=True, **kw)
    assert res.all_ok, res
    want_keys, want_pay = _oracle(n, key_bits)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(pay, want_pay)
    return res


# ------------------------------------------------- tests/test_dbigsort.py

def test_8dev_bit_exact():
    _run(n_dev=8, n_runs=4, run_size=2048, buckets_per_dev=2)


def test_8dev_single_bucket_per_dev():
    _run(n_dev=8, n_runs=2, run_size=1024, buckets_per_dev=1)


def test_2dev_many_buckets():
    _run(n_dev=2, n_runs=3, run_size=1536, buckets_per_dev=5)


def test_4dev_single_run_per_dev():
    _run(n_dev=4, n_runs=1, run_size=4096, buckets_per_dev=3)


def test_1dev_delegates_to_bigsort(monkeypatch):
    # D = 1: the exchange has nothing to move, so the call delegates to
    # sort_big (same data model and checks)
    from tpu_qe_torch.sort import bigsort
    calls = []
    real = bigsort.sort_big

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(bigsort, "sort_big", spy)
    _run(n_dev=1, n_runs=4, run_size=2048, buckets_per_dev=4)
    assert len(calls) == 1 and calls[0]["n_buckets"] == 4


def test_1dev_forced_composed_path(monkeypatch):
    # force_composed keeps the whole machinery at D = 1
    from tpu_qe_torch.sort import bigsort
    monkeypatch.setattr(bigsort, "sort_big", None)
    _run(n_dev=1, n_runs=4, run_size=2048, buckets_per_dev=4,
         force_composed=True)


def test_adversarial_duplicates_16_keys():
    # 2^4 distinct keys over 64 K rows: every key is hot; exact capacities
    # absorb the skew and ties come back in index order
    _run(n_dev=8, n_runs=4, run_size=2048, buckets_per_dev=2, key_bits=4)


def test_adversarial_duplicates_2_keys():
    _run(n_dev=4, n_runs=2, run_size=2048, buckets_per_dev=2, key_bits=1)


def test_few_samples_still_exact():
    # sampling moves only the balance: capacities come from the exact
    # boundaries
    _run(n_dev=8, n_runs=4, run_size=2048, buckets_per_dev=2,
         samples_per_run=4)


def test_matches_unmasked_keygen():
    n = 1 << 12
    np.testing.assert_array_equal(
        td.keygen_masked_numpy(np.arange(n, dtype=np.uint32), key_bits=64),
        keygen_hash_numpy(np.arange(n, dtype=np.uint32)))


def test_rejects_indivisible_n():
    with pytest.raises(AssertionError):
        td.sort_big_distributed(4 * 2048 + 1, _mesh(4), run_size=2048)


def test_checkpoint_resume(tmp_path, monkeypatch):
    """Stopped after one bucket round, the resumed run completes with the
    same certificates; a complete checkpoint replays, and collect
    re-merges bit for bit."""
    mesh = _mesh(4)
    n = 4 * 2 * 2048
    kw = dict(run_size=2048, buckets_per_dev=2)
    ckdir = str(tmp_path)
    want = td.sort_big_distributed(n, mesh, **kw)
    assert want.all_ok
    real_record = tck.RunState.record
    calls = {"n": 0}

    def crashing_record(self, b, vals):
        real_record(self, b, vals)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated kill")

    monkeypatch.setattr(tck.RunState, "record", crashing_record)
    with pytest.raises(RuntimeError, match="simulated kill"):
        td.sort_big_distributed(n, mesh, checkpoint_dir=ckdir, **kw)
    monkeypatch.setattr(tck.RunState, "record", real_record)
    res = td.sort_big_distributed(n, mesh, checkpoint_dir=ckdir, **kw)
    assert res.all_ok
    for f in CERTS:
        assert getattr(res, f) == getattr(want, f), f
    res2, (keys, pay) = td.sort_big_distributed(
        n, mesh, checkpoint_dir=ckdir, collect=True, **kw)
    assert res2.all_ok
    want_keys, want_pay = _oracle(n)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(pay, want_pay)


def test_two_tier_exchange_unequal_caps():
    # a hand-built plan whose diagonal share (cap_blk = 1024) is far
    # larger than any off-diagonal segment (cap_off = 16); shard 1's own
    # segment starts at 1014 and runs to 1038, which the reference reaches
    # by a clamped window and the port slices exactly
    mesh = _mesh(2)
    run = 2048
    col = torch.from_numpy(np.stack([d * 10000 + np.arange(run)
                                     for d in range(2)]).astype(np.int32))
    starts = torch.tensor([[0, 1000], [4, 14]])
    sizes = torch.tensor([[1000, 10], [10, 1024]])
    blo, bhi, bpay = td.exchange_segments(mesh, starts, sizes,
                                          [col, col, col], 1024, 16)
    ones = -1

    def valid(dest, src):
        row = blo[dest, src].numpy()
        return row[row != ones]

    np.testing.assert_array_equal(valid(0, 0), np.arange(0, 1000))
    np.testing.assert_array_equal(valid(0, 1), 10000 + np.arange(4, 14))
    np.testing.assert_array_equal(valid(1, 0), np.arange(1000, 1010))
    np.testing.assert_array_equal(valid(1, 1), 10000 + np.arange(14, 1038))
    assert (bpay[0, 1, 10:] == 0).all() and (bhi[1, 0, 10:] == -1).all()


def test_payload_cols_distributed():
    # table-shaped rows through the composed path, values verified per row
    from tpu_qe_torch.sort.bigsort import _value_col_numpy
    n = 4 * 2 * 2048
    res, (keys, pay, vals) = td.sort_big_distributed(
        n, _mesh(4), run_size=2048, buckets_per_dev=2, collect=True,
        payload_cols=3, force_composed=True)
    assert res.all_ok, res
    want = keygen_hash_numpy(np.arange(n, dtype=np.uint32))
    order = np.argsort(want, kind="stable")
    np.testing.assert_array_equal(keys, want[order])
    np.testing.assert_array_equal(pay, order.astype(np.uint32))
    assert len(vals) == 2
    for j, v in enumerate(vals):
        np.testing.assert_array_equal(
            v, _value_col_numpy(order.astype(np.uint32), j))


def test_quantize_is_the_reference_rule():
    for demand, quantum, ceiling in ((0, 256, 4096), (1, 256, 4096),
                                     (257, 256, 4096), (5000, 256, 4096),
                                     ((1 << 23) + 1, 1 << 20, 1 << 26)):
        assert td.quantize(demand, quantum, ceiling) == jd._quantize(
            demand, quantum, ceiling)


def test_defaults_are_the_reference_defaults():
    import inspect
    jp = inspect.signature(jd.sort_big_distributed).parameters
    tp = inspect.signature(td.sort_big_distributed).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
    assert list(tp)[:len(jp)] == list(jp)


def test_sort_package_names_it_lazily():
    import tpu_qe_torch.sort as ts
    assert ts.sort_big_distributed is td.sort_big_distributed
    with pytest.raises(AttributeError):
        ts.no_such_sort  # noqa: B018


# ------------------------------------------- against tpu_qe's dbigsort

def _meta(n, n_dev, run, b, payload_cols=1, key_bits=64):
    return np.asarray([n, n_dev, run, b, 7, min(4096, run), key_bits,
                       payload_cols], np.int64)


@functools.lru_cache(maxsize=None)
def _jax(n_dev, key_bits, payload_cols, ckdir):
    n = n_dev * 2 * 2048
    out = jd.sort_big_distributed(n, _jmesh(n_dev), run_size=2048,
                                  buckets_per_dev=2, key_bits=key_bits,
                                  collect=True, checkpoint_dir=ckdir,
                                  payload_cols=payload_cols,
                                  force_composed=True)
    st = tck.RunState.load(ckdir, _meta(n, n_dev, 2048, 2, payload_cols,
                                        key_bits))
    return out, st


@pytest.mark.parametrize("n_dev,key_bits,payload_cols",
                         [(2, 64, 1), (8, 64, 2), (8, 3, 1)])
def test_sort_big_distributed_matches_jax(n_dev, key_bits, payload_cols,
                                          tmp_path_factory):
    n = n_dev * 2 * 2048
    jdir = str(tmp_path_factory.mktemp(f"j{n_dev}{key_bits}{payload_cols}"))
    tdir = str(tmp_path_factory.mktemp(f"t{n_dev}{key_bits}{payload_cols}"))
    (jres, jout), jst = _jax(n_dev, key_bits, payload_cols, jdir)
    res, out = td.sort_big_distributed(
        n, _mesh(n_dev), run_size=2048, buckets_per_dev=2,
        key_bits=key_bits, collect=True, checkpoint_dir=tdir,
        payload_cols=payload_cols)
    for f in CERTS:
        assert getattr(res, f) == getattr(jres, f), f
    np.testing.assert_array_equal(out[0], jout[0])
    np.testing.assert_array_equal(out[1], jout[1])
    assert out[0].dtype == np.uint64 and out[1].dtype == np.uint32
    if payload_cols > 1:
        for g, w in zip(out[2], jout[2]):
            np.testing.assert_array_equal(g, w)
    st = tck.RunState.load(tdir, _meta(n, n_dev, 2048, 2, payload_cols,
                                       key_bits))
    np.testing.assert_array_equal(st.bounds, jst.bounds)
    np.testing.assert_array_equal(st.done, jst.done)
    # every shard's nine scalars of every bucket round (an empty bucket's
    # first and last words are the sentinel's in both)
    np.testing.assert_array_equal(st.scalars, jst.scalars)


def test_resumes_from_a_jax_checkpoint(tmp_path, monkeypatch):
    # the reference stops after one bucket round; the port finishes it
    from tpu_qe.utils import checkpoint as jck
    n, mesh_n = 4 * 2 * 2048, 4
    kw = dict(run_size=2048, buckets_per_dev=2)
    real = jck.RunState.record

    def stop(self, b, vals):
        real(self, b, vals)
        raise RuntimeError("stopped")
    monkeypatch.setattr(jck.RunState, "record", stop)
    with pytest.raises(RuntimeError, match="stopped"):
        jd.sort_big_distributed(n, _jmesh(mesh_n), checkpoint_dir=str(
            tmp_path), **kw)
    monkeypatch.setattr(jck.RunState, "record", real)
    st = tck.RunState.load(str(tmp_path), _meta(n, mesh_n, 2048, 2))
    assert int(st.done.sum()) == 1
    res = td.sort_big_distributed(n, _mesh(mesh_n), checkpoint_dir=str(
        tmp_path), **kw)
    assert res.all_ok
    (tmp_path / "whole").mkdir()
    whole = jd.sort_big_distributed(n, _jmesh(mesh_n), checkpoint_dir=str(
        tmp_path / "whole"), **kw)
    a = tck.RunState.load(str(tmp_path), _meta(n, mesh_n, 2048, 2))
    b = tck.RunState.load(str(tmp_path / "whole"), _meta(n, mesh_n, 2048,
                                                           2))
    assert whole.all_ok and a.done.all()
    np.testing.assert_array_equal(a.scalars, b.scalars)
