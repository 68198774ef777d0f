"""tpu_qe_torch.exchange.dwindow on a LocalMesh of the CPU: every test of
tests/test_dwindow.py and the distributed cases of
tests/test_window_moving.py (`:200-442`) and tests/test_window_whole.py
(`:80`, `:94`), each against the port's local window (ops/window.py,
itself held to the JAX operator by tests/test_torch_window.py) at the
reference's inputs, mesh sizes and tolerances: integer columns bit for
bit, float32 sums and averages within the reference's stated tolerance
(a forced segment start at each shard's first row restarts the float32
prefix). Then distributed_window_numpy against tpu_qe.exchange.dwindow on
the same inputs at D = 2 and 8 over one spec of every kind the
distributed window takes, with orders and values that straddle 2^31, an
all-ones key with an all-ones order and a partition that spans every
shard: integers bit for bit, float32 within the reference's tolerance.
Global positions moved across 2^31 check the position plane's u32 order.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jw = importlib.import_module("tpu_qe.exchange.dwindow")
tw = importlib.import_module("tpu_qe_torch.exchange.dwindow")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")
from tpu_qe_torch.bits import U64  # noqa: E402
from tpu_qe_torch.ops.window import window  # noqa: E402
from tpu_qe_torch.table import column_from_numpy, column_to_numpy  # noqa


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


def _local(keys, order, values, funcs):
    res = window(U64.from_numpy(keys, "cpu"), funcs,
                 order=None if order is None
                 else column_from_numpy(order, "cpu"),
                 values={k: column_from_numpy(v, "cpu")
                         for k, v in values.items()})
    return {nm: column_to_numpy(c) for nm, c in res.cols.items()}


def _check(keys, order, values, funcs, n_dev, floats=(), rtol=2e-4,
           atol=1e-3, **kw):
    got = tw.distributed_window_numpy(keys, funcs, _mesh(n_dev),
                                      order=order, values=values, **kw)
    want = _local(keys, order, values, funcs)
    for name in funcs:
        if name in floats:
            np.testing.assert_allclose(want[name], got[name], rtol=rtol,
                                       atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
            assert got[name].dtype == want[name].dtype, name


# --------------------------------------------------- tests/test_dwindow.py

FUNCS = {
    "rn": ("row_number",),
    "rk": ("rank",),
    "dr": ("dense_rank",),
    "cs": ("running_sum", "v"),
    "cm": ("running_min", "v"),
    "cx": ("running_max", "v"),
    "lg": ("lag", "v", 7),
    "ld": ("lead", "v", 9),
}


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_matches_local_random(n_dev):
    rng = np.random.default_rng(n_dev)
    n = 8 * 1024
    keys = rng.integers(0, 50, n).astype(np.uint64)
    order = rng.integers(0, 4, n, dtype=np.uint32)  # heavy order ties
    values = {"v": rng.integers(0, 1 << 32, n).astype(np.uint32)}
    _check(keys, order, values, FUNCS, n_dev, capacity_factor=float(n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_all_equal_keys_one_partition_spans_every_device(n_dev):
    # the case the carry chain exists for: one partition, split across
    # every shard by the skew-splitting router
    rng = np.random.default_rng(99)
    n = 4096
    keys = np.full(n, 42, np.uint64)
    order = rng.integers(0, 3, n, dtype=np.uint32)
    values = {"v": rng.integers(0, 1 << 32, n).astype(np.uint32)}
    _check(keys, order, values, FUNCS, n_dev, capacity_factor=float(n_dev))


def test_running_sum_exact_past_2_32_across_devices():
    n = 8192
    keys = np.zeros(n, np.uint64)
    values = {"v": np.full(n, 0xFFFFFFFF, np.uint32)}
    got = tw.distributed_window_numpy(keys, {"cs": ("running_sum", "v")},
                                      _mesh(8), values=values,
                                      capacity_factor=8.0)
    want = np.cumsum(np.full(n, 0xFFFFFFFF, np.uint64))
    np.testing.assert_array_equal(got["cs"], want)
    assert want[-1] > (1 << 40)


def test_float_running_sum_distributed():
    rng = np.random.default_rng(5)
    n = 4096
    keys = rng.integers(0, 9, n).astype(np.uint64)
    order = rng.random(n).astype(np.float32)
    values = {"v": rng.random(n).astype(np.float32)}
    _check(keys, order, values, {"cs": ("running_sum", "v")}, 4,
           floats=("cs",), rtol=1e-4, atol=1e-5, capacity_factor=4.0)


def test_int32_order_and_values():
    rng = np.random.default_rng(6)
    n = 2048
    keys = rng.integers(0, 20, n).astype(np.uint64)
    order = rng.integers(-1000, 1000, n, dtype=np.int32)
    values = {"v": rng.integers(-500, 500, n, dtype=np.int32)}
    funcs = {"rk": ("rank",), "cm": ("running_min", "v"),
             "lg": ("lag", "v", -1)}
    _check(keys, order, values, funcs, 4, capacity_factor=4.0)


def test_zipf_skew_auto_capacity():
    rng = np.random.default_rng(7)
    n = 16384
    keys = (rng.zipf(1.3, n) % 97).astype(np.uint64)
    order = rng.integers(0, 1 << 20, n, dtype=np.uint32)
    values = {"v": rng.integers(0, 1 << 16, n).astype(np.uint32)}
    _check(keys, order, values, FUNCS, 8, capacity_factor="auto")


def test_partition_boundary_lag_lead():
    # partitions of 100 rows straddle the 512-row shard boundaries
    n = 4096
    keys = (np.arange(n) // 100).astype(np.uint64)
    order = np.arange(n, dtype=np.uint32)
    values = {"v": np.arange(n, dtype=np.uint32) * 3 + 1}
    funcs = {"lg": ("lag", "v", 0), "ld": ("lead", "v", 0),
             "rn": ("row_number",)}
    _check(keys, order, values, funcs, 8, capacity_factor=8.0)


TOTAL_FUNCS = {
    "ts": ("total_sum", "vu"),
    "tsi": ("total_sum", "vi"),      # i32 with negatives: pair-exact
    "tmn": ("total_min", "vi"),
    "tmx": ("total_max", "vf"),
    "pc": ("partition_count",),
    "lg3": ("lag", "vu", 7, 3),
    "ld2": ("lead", "vi", -1, 2),
    "ld5": ("lead", "vf", 0.5, 5),
    "rs": ("running_sum", "vu"),
    "rn": ("row_number",),
}


def _vals3(rng, n):
    return {"vu": rng.integers(0, 1000, n).astype(np.uint32),
            "vi": rng.integers(-500, 500, n).astype(np.int32),
            "vf": rng.random(n).astype(np.float32)}


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_whole_partition_and_offsets_match_local(n_dev):
    rng = np.random.default_rng(10 + n_dev)
    n = 4096
    keys = rng.integers(0, 9, n).astype(np.uint64)
    order = rng.integers(0, 50, n).astype(np.uint32)
    _check(keys, order, _vals3(rng, n), TOTAL_FUNCS, n_dev,
           floats=("tmx", "ld5"), capacity_factor="auto")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_avgs_match_local_to_f32(n_dev):
    # averages divide patched sums by global denominators: the local
    # division's float32 class, compared to tolerance
    rng = np.random.default_rng(20 + n_dev)
    n = 4096
    keys = rng.integers(0, 7, n).astype(np.uint64)
    order = rng.integers(0, 99, n).astype(np.uint32)
    funcs = {"ta": ("total_avg", "vu"), "ra": ("running_avg", "vu"),
             "taf": ("total_avg", "vf")}
    _check(keys, order, _vals3(rng, n), funcs, n_dev,
           floats=("ta", "ra", "taf"), capacity_factor="auto")


def test_one_partition_spans_every_device_totals():
    rng = np.random.default_rng(33)
    n = 4096
    keys = np.zeros(n, np.uint64)
    order = rng.integers(0, 50, n).astype(np.uint32)
    _check(keys, order, _vals3(rng, n), TOTAL_FUNCS, 8,
           floats=("tmx", "ld5"), rtol=2e-3, capacity_factor="auto")


def test_i32_negative_running_sums_distributed_exact():
    # sign-extended sums are two's-complement exact across the chain
    rng = np.random.default_rng(44)
    n = 2048
    keys = rng.integers(0, 5, n).astype(np.uint64)
    order = rng.integers(0, 99, n).astype(np.uint32)
    vi = rng.integers(-500, 500, n).astype(np.int32)
    funcs = {"rs": ("running_sum", "vi"), "ms": ("moving_sum", "vi", 4)}
    for n_dev in (2, 8):
        got = tw.distributed_window_numpy(keys, funcs, _mesh(n_dev),
                                          order=order, values={"vi": vi},
                                          capacity_factor="auto")
        want = _local(keys, order, {"vi": vi}, funcs)
        for nm in funcs:
            np.testing.assert_array_equal(got[nm].view(np.int64),
                                          want[nm].view(np.int64),
                                          err_msg=nm)


# ------------------- tests/test_window_moving.py, the distributed cases

MFUNCS = {
    "ms": ("moving_sum", "v", 17),
    "mn": ("moving_min", "v", 9),
    "mx": ("moving_max", "v", 33),
    "ma": ("moving_avg", "v", 5),
    # a running function beside them: the scalar chain and the row halo
    # in one spec
    "cs": ("running_sum", "v"),
}


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_distributed_moving_matches_local(n_dev):
    rng = np.random.default_rng(n_dev + 40)
    n = 2048
    keys = rng.integers(0, 23, n).astype(np.uint64)
    order = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    values = {"v": rng.integers(0, 1 << 32, n).astype(np.uint32)}
    _check(keys, order, values, MFUNCS, n_dev, capacity_factor=float(n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_moving_int32_negatives(n_dev):
    rng = np.random.default_rng(n_dev + 60)
    n = 2048
    keys = rng.integers(0, 23, n).astype(np.uint64)
    order = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    values = {"v": rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)}
    funcs = {"ms": ("moving_sum", "v", 17), "ma": ("moving_avg", "v", 9),
             "cs": ("running_sum", "v")}
    _check(keys, order, values, funcs, n_dev, capacity_factor=float(n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_moving_sum_float32_close_not_bitexact(n_dev):
    # a partition that extends back past the halo restarts the float32
    # prefix at the forced break: within the operator's own
    # prefix-difference error, not bit for bit
    rng = np.random.default_rng(n_dev + 90)
    n = 4096
    keys = rng.integers(0, 3, n).astype(np.uint64)  # long partitions
    order = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    values = {"v": rng.random(n).astype(np.float32)}
    _check(keys, order, values, {"ms": ("moving_sum", "v", 33)}, n_dev,
           floats=("ms",), rtol=1e-4, atol=1e-3,
           capacity_factor=float(n_dev))


@pytest.mark.parametrize("n_dev", [4, 8])
def test_distributed_moving_halo_spans_multiple_devices(n_dev):
    # k far larger than a shard's rows: the halo composes across several
    # predecessors, and one partition spans the whole mesh
    rng = np.random.default_rng(7)
    n = 1024
    keys = np.zeros(n, np.uint64)
    order = np.arange(n, dtype=np.uint32)
    values = {"v": rng.integers(0, 1 << 32, n).astype(np.uint32)}
    funcs = {"ms": ("moving_sum", "v", 700),
             "mn": ("moving_min", "v", 515)}
    _check(keys, order, values, funcs, n_dev, capacity_factor=float(n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_following_frames(n_dev):
    # the double halo: the tail halo for the PRECEDING reach, the head
    # halo (placed over the pad slots) for the FOLLOWING reach
    rng = np.random.default_rng(9)
    n = 4096
    keys = rng.integers(0, 9, n).astype(np.uint64)
    order = rng.integers(0, 10 ** 6, n).astype(np.uint32)
    vals = {"vu": rng.integers(0, 1000, n).astype(np.uint32),
            "vi": rng.integers(-500, 500, n).astype(np.int32)}
    funcs = {"s": ("moving_sum", "vu", 3, 2),
             "si": ("moving_sum", "vi", 2, 4),
             "mn": ("moving_min", "vi", 4, 2),
             "av": ("moving_avg", "vu", 3, 3)}
    _check(keys, order, vals, funcs, n_dev, floats=("av",),
           capacity_factor="auto")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_range_unbounded_vs_local(n_dev):
    # tie-aware RANGE frames: forward partition-prefix carry plus the
    # backward run-suffix chain
    rng = np.random.default_rng(31)
    n = 4096
    keys = rng.integers(0, 4, n).astype(np.uint64)
    order = rng.integers(0, 6, n).astype(np.uint32)    # runs span shards
    vals = {"vu": rng.integers(0, 1000, n).astype(np.uint32),
            "vi": rng.integers(-500, 500, n).astype(np.int32),
            "vf": rng.normal(size=n).astype(np.float32)}
    funcs = {"rs": ("range_sum", "vu", "unbounded"),
             "ri": ("range_sum", "vi", "unbounded"),
             "rm": ("range_min", "vi", "unbounded"),
             "rx": ("range_max", "vf", "unbounded"),
             "ra": ("range_avg", "vu", "unbounded")}
    _check(keys, order, vals, funcs, n_dev, floats=("ra", "rx"), rtol=1e-5,
           atol=1e-4, capacity_factor="auto")


def test_distributed_range_single_run_all_devices():
    # one partition with one order value over the whole mesh: the S_run
    # chain walks through every single-run shard to the run's end
    rng = np.random.default_rng(32)
    n = 2048
    keys = np.zeros(n, np.uint64)
    order = np.zeros(n, np.uint32)
    vi = rng.integers(-500, 500, n).astype(np.int32)
    funcs = {"ri": ("range_sum", "vi", "unbounded"),
             "rm": ("range_min", "vi", "unbounded")}
    _check(keys, order, {"vi": vi}, funcs, 8, capacity_factor="auto")


def test_distributed_rejects_what_is_in_core_only():
    keys = np.zeros(64, np.uint64)
    order = np.arange(64, dtype=np.uint32)
    v = {"v": np.arange(64, dtype=np.uint32)}
    for funcs in ({"m": ("moving_sum", "v", None, 2)},
                  {"r": ("range_sum", "v", 3)}):
        with pytest.raises(ValueError, match="in-core only"):
            tw.distributed_window_numpy(keys, funcs, _mesh(2), order=order,
                                        values=v)
    with pytest.raises(ValueError, match="order column"):
        tw.distributed_window_numpy(keys, {"r": ("rank",)}, _mesh(2))


# ------------------- tests/test_window_whole.py, the distributed cases

WFUNCS = {"fv": ("first_value", "v"), "lv": ("last_value", "v"),
          "nt": ("ntile", 3), "pr": ("percent_rank",)}


def _data(seed, n, n_part):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_part, n).astype(np.uint64)
    order = rng.integers(0, 40, n).astype(np.uint32)  # ties likely
    vals = rng.integers(1, 1 << 20, n).astype(np.uint32)
    return keys, order, vals


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("n_part", [1, 7, 64])
def test_distributed_bit_identical(n_dev, n_part):
    keys, order, vals = _data(n_dev * 100 + n_part, 1024, n_part)
    _check(keys, order, {"v": vals}, WFUNCS, n_dev,
           capacity_factor=float(n_dev))


def test_distributed_with_running_mix():
    keys, order, vals = _data(42, 512, 5)
    funcs = dict(WFUNCS)
    funcs["rs"] = ("running_sum", "v")
    funcs["rn"] = "row_number"
    _check(keys, order, {"v": vals}, funcs, 4, capacity_factor=4.0)


# --------------------------------------------- against tpu_qe's dwindow

JFUNCS = {
    "rn": ("row_number",), "rk": ("rank",), "dr": ("dense_rank",),
    "pr": ("percent_rank",), "nt": ("ntile", 4),
    "cs": ("running_sum", "vu"), "csi": ("running_sum", "vi"),
    "csf": ("running_sum", "vf"), "cm": ("running_min", "vi"),
    "cx": ("running_max", "vu"),
    "lg": ("lag", "vu", 7), "ld": ("lead", "vi", -3),
    "lg3": ("lag", "vu", 5, 3), "ld2": ("lead", "vf", 0.5, 2),
    "fv": ("first_value", "vu"), "lv": ("last_value", "vi"),
    "ms": ("moving_sum", "vu", 4), "mn": ("moving_min", "vi", 3),
    "mf": ("moving_max", "vu", 2, 3), "mc": ("moving_count", 3, 1),
    "ts": ("total_sum", "vi"), "tx": ("total_max", "vu"),
    "pc": ("partition_count",), "ta": ("total_avg", "vu"),
    "ra": ("running_avg", "vi"),
    "rs": ("range_sum", "vu", "unbounded"),
    "rm": ("range_min", "vi", "unbounded"),
    "rav": ("range_avg", "vi", "unbounded"),
}
J_FLOATS = ("pr", "csf", "ld2", "ta", "ra", "rav")


def _jcase(seed):
    """Keys with an all-ones key and a hot partition that spans every
    shard, orders and values that straddle 2^31."""
    rng = np.random.default_rng(seed)
    n = 2048
    keys = rng.integers(0, 6, n).astype(np.uint64)
    keys[rng.random(n) < 0.4] = np.uint64(3)                 # hot
    keys[::41] = np.uint64((1 << 64) - 1)
    order = (rng.integers(-3, 3, n) + (1 << 31)).astype(np.uint32)
    order[::41] = np.uint32(0xFFFFFFFF)
    vals = {"vu": (rng.integers(-50, 50, n) + (1 << 31)).astype(np.uint32),
            "vi": rng.integers(-(1 << 31), (1 << 31) - 1, n,
                               dtype=np.int64).astype(np.int32),
            "vf": rng.random(n).astype(np.float32)}
    return keys, order, vals


@functools.lru_cache(maxsize=None)
def _jax_window(n_dev):
    keys, order, vals = _jcase(n_dev)
    return jw.distributed_window_numpy(keys, JFUNCS, _jmesh(n_dev),
                                       order=order, values=vals,
                                       capacity_factor="auto")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_window_matches_jax(n_dev):
    keys, order, vals = _jcase(n_dev)
    got = tw.distributed_window_numpy(keys, JFUNCS, _mesh(n_dev),
                                      order=order, values=vals,
                                      capacity_factor="auto")
    want = _jax_window(n_dev)
    for nm in JFUNCS:
        w = np.asarray(want[nm])
        if nm in J_FLOATS:
            np.testing.assert_allclose(got[nm], w, rtol=2e-4, atol=1e-3,
                                       err_msg=nm)
        else:
            np.testing.assert_array_equal(got[nm], w, err_msg=nm)
            assert got[nm].dtype == w.dtype, nm
    loc = _local(keys, order, vals, JFUNCS)
    for nm in JFUNCS:
        if nm not in J_FLOATS:
            np.testing.assert_array_equal(got[nm], loc[nm], err_msg=nm)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_plan_matches_jax(n_dev):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpu_qe.bits import U64 as JU64
    from tpu_qe_torch.exchange.dsort import shard_column, shard_u64
    keys, order, _ = _jcase(n_dev)
    jmesh = _jmesh(n_dev)
    sh = NamedSharding(jmesh, P("x"))
    u = JU64.from_numpy(keys)
    jkey = JU64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))
    want = int(np.asarray(jw.plan_window_capacity(
        jkey, jax.device_put(order, sh), jmesh)).max())
    mesh = _mesh(n_dev)
    got = tw.plan_window_capacity(shard_u64(keys, mesh),
                                  shard_column(order, mesh), mesh)
    assert int(got.max()) == want


def test_positions_straddling_2_31(monkeypatch):
    # the position plane (a routing key, the pos output) orders as u32
    from tpu_qe_torch.bits import narrow, widen
    from tpu_qe_torch.exchange.dsort import shard_column, shard_u64
    off = (1 << 31) - 700
    real = tw._global_pos
    monkeypatch.setattr(tw, "_global_pos", lambda mesh, n_local, device:
                        narrow(widen(real(mesh, n_local, device)) + off))
    rng = np.random.default_rng(8)
    n = 2048
    keys = rng.integers(0, 3, n).astype(np.uint64)
    order = rng.integers(0, 4, n).astype(np.uint32)
    vals = {"v": rng.integers(0, 1 << 32, n).astype(np.uint32)}
    funcs = {"rn": ("row_number",), "cs": ("running_sum", "v"),
             "lg": ("lag", "v", 0, 2)}
    mesh = _mesh(8)
    res, ovf = tw.distributed_window(shard_u64(keys, mesh), funcs, mesh,
                                     order=shard_column(order, mesh),
                                     values={"v": shard_column(vals["v"],
                                                               mesh)},
                                     capacity_factor=8.0)
    assert not int(ovf.max())
    want = _local(keys, order, vals, funcs)
    valid = res.valid.tolist()
    pos = np.concatenate([res.pos[d, :v].numpy() for d, v in
                          enumerate(valid)]) - off
    np.testing.assert_array_equal(pos, np.lexsort((np.arange(n), order,
                                                   keys)))
    for nm, c in res.cols.items():
        flat = column_to_numpy(c) if not isinstance(c, U64) else U64(
            c.lo, c.hi).to_numpy()
        got = np.concatenate([flat[d, :v] for d, v in enumerate(valid)])
        np.testing.assert_array_equal(got, want[nm][pos], err_msg=nm)
