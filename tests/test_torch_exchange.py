"""tpu_qe_torch.exchange (mesh, shuffle, dsort) and
pipeline.sorted_morton_index_distributed against tpu_qe.exchange on a
LocalMesh of the CPU at the reference tests' mesh sizes (D in 1, 2, 4, 8;
the JAX side on the suite's 8 virtual devices).

Every test of tests/test_exchange.py and the sort case of
tests/test_fuzz_exchange.py runs on the port against its numpy oracle
(numpy's stable argsort) and against one JAX answer per case: `valid` per
shard, the valid prefixes (keys and payload), the overflow flag and
plan_sort_capacity's demand, all bit for bit. The shuffle functions
(splitters, routes, the partition by destination, offdiag_demand and
every output of exchange) are held to JAX under shard_map, and the routes
and the partition on crafted planes whose keys, positions and payloads
straddle 2^31, where a signed compare would go wrong.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tpu_qe.bits import U64 as JU64  # noqa: E402

jd = importlib.import_module("tpu_qe.exchange.dsort")
js = importlib.import_module("tpu_qe.exchange.shuffle")
td = importlib.import_module("tpu_qe_torch.exchange.dsort")
ts = importlib.import_module("tpu_qe_torch.exchange.shuffle")
tm = importlib.import_module("tpu_qe_torch.exchange.mesh")

GOLD = np.uint64(0x9E3779B97F4A7C15)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arange(n):
    return np.arange(n, dtype=np.uint32)


def _zipf(seed, a, n=1 << 13):
    ranks = np.random.default_rng(seed).zipf(a, size=n).astype(np.uint64)
    return ranks * GOLD


def _uniform(seed, n):
    return np.random.default_rng(seed).integers(0, 1 << 64, size=n,
                                                dtype=np.uint64)


def _max_keys():
    keys = _uniform(1, 1 << 10)
    keys[::5] = np.uint64(0xFFFFFFFFFFFFFFFF)     # real all-ones keys
    return keys


def _dup_keys(seed):
    keys = _uniform(seed, 1 << 13)
    keys[::5] = keys[1]
    return keys


def _fuzz(trial):
    rng = np.random.default_rng(1000 + trial)
    n_dev = int(rng.choice([2, 4, 8]))
    overlap = int(rng.choice([1, 2]))
    n = int(rng.integers(4, 600)) * n_dev * (overlap * 2)
    dup = int(rng.integers(1, 1 + n))
    keys = rng.integers(0, dup, n).astype(np.uint64) * np.uint64(
        rng.integers(1, 1 << 40))
    return keys, _arange(n), n_dev, (("capacity_factor", "auto"),
                                     ("overlap", overlap))


def _reversal(n):
    return np.arange(n, 0, -1).astype(np.uint64)


# name -> (keys, payload or None, D, kw items); tests/test_exchange.py in
# its order, then tests/test_fuzz_exchange.py's sort trials
CASES = {
    **{f"uniform_d{d}": (lambda d=d: (_uniform(d, 1 << 13), _arange(1 << 13),
                                      d, ())) for d in (2, 4, 8)},
    "zipf": lambda: (_zipf(42, 1.3), _arange(1 << 13), 8,
                     (("capacity_factor", 4.0),)),
    "all_equal": lambda: (np.full(1 << 10, 12345, np.uint64),
                          _arange(1 << 10), 4, ()),
    "max_keys": lambda: (_max_keys(), _arange(1 << 10), 4,
                         (("capacity_factor", 4.0),)),
    "overflow": lambda: (_reversal(1 << 10), None, 4,
                         (("capacity_factor", 1.0),)),
    "keys_only": lambda: (_uniform(3, 1 << 12), None, 8, ()),
    "single_device": lambda: (_uniform(5, 1 << 12), _arange(1 << 12), 1,
                              ()),
    "all_equal_split": lambda: (np.full(1 << 12, 777, np.uint64),
                                _arange(1 << 12), 8, ()),
    "zipf_low_capacity": lambda: (_zipf(11, 1.2), _arange(1 << 13), 8,
                                  (("capacity_factor", 2.0),)),
    "reversal_auto": lambda: (_reversal(1 << 13), _arange(1 << 13), 8,
                              (("capacity_factor", "auto"),)),
    "auto_zipf": lambda: (_zipf(13, 1.2), _arange(1 << 13), 8,
                          (("capacity_factor", "auto"),)),
    "auto_identity": lambda: (np.full(1 << 12, 7, np.uint64), None, 8,
                              (("capacity_factor", "auto"),)),
    **{f"overlap_d{d}_k{k}": (lambda d=d, k=k: (
        _dup_keys(100 * d + k), _arange(1 << 13), d,
        (("capacity_factor", 3.0), ("overlap", k))))
       for d in (2, 4, 8) for k in (2, 4)},
    "zipf_overlap": lambda: (_zipf(77, 1.3), _arange(1 << 13), 8,
                             (("capacity_factor", 4.0), ("overlap", 4))),
    "all_equal_overlap": lambda: (np.full(1 << 12, 99, np.uint64),
                                  _arange(1 << 12), 4, (("overlap", 2),)),
    "overlap_overflow": lambda: (_reversal(1 << 12), None, 4,
                                 (("capacity_factor", 1.0),
                                  ("overlap", 2))),
    **{f"fuzz{t}": (lambda t=t: _fuzz(t)) for t in range(6)},
}
OVERFLOWS = {"overflow", "overlap_overflow"}


def _resolve(kw, plan):
    """kw with capacity_factor="auto" replaced by the planned capacity."""
    kw = dict(kw)
    if kw.get("capacity_factor") == "auto":
        del kw["capacity_factor"]
        if plan is not None:
            kw["capacity"] = ts.pow2_capacity(plan)
    return kw


def _compact(valid, *planes):
    return [np.concatenate([p[d, :v] for d, v in enumerate(valid)])
            for p in planes]


@functools.lru_cache(maxsize=None)
def _jax(name):
    keys, payload, d, kw = CASES[name]()
    mesh = jd.make_mesh(d)
    sh = NamedSharding(mesh, P("x"))
    u = JU64.from_numpy(keys)
    key = JU64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))
    plan = (int(np.asarray(jd.plan_sort_capacity(key, mesh)).max())
            if d > 1 else None)
    pays = () if payload is None else (
        jax.device_put(jnp.asarray(payload), sh),)
    res, ovf = jd.distributed_sort(key, *pays, mesh=mesh,
                                   **_resolve(kw, plan))
    out = {"valid": np.asarray(res.valid).reshape(d),
           "overflow": int(np.asarray(ovf).max()), "plan": plan,
           "lo": np.asarray(res.key.lo).reshape(d, -1),
           "hi": np.asarray(res.key.hi).reshape(d, -1)}
    if payload is not None:
        out["pay"] = np.asarray(res.payloads[0]).reshape(d, -1)
    return out


@functools.lru_cache(maxsize=None)
def _port(name):
    keys, payload, d, kw = CASES[name]()
    mesh = tm.LocalMesh(d, "cpu")
    key = td.shard_u64(keys, mesh)
    plan = int(td.plan_sort_capacity(key, mesh).max()) if d > 1 else None
    pays = () if payload is None else (td.shard_u32(payload, mesh),)
    res, ovf = td.distributed_sort(key, *pays, mesh=mesh,
                                   **_resolve(kw, plan))
    out = {"valid": res.valid.numpy(), "overflow": int(ovf.max()),
           "plan": plan, "lo": td.collect_u32(res.key.lo, mesh),
           "hi": td.collect_u32(res.key.hi, mesh)}
    if payload is not None:
        out["pay"] = td.collect_u32(res.payloads[0], mesh)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_sort_matches_jax_and_numpy(name):
    keys, payload, d, kw = CASES[name]()
    got, want = _port(name), _jax(name)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["overflow"] == want["overflow"]
    assert got["plan"] == want["plan"]
    planes = ["lo", "hi"] + (["pay"] if payload is not None else [])
    for p, (g, w) in zip(planes, zip(_compact(want["valid"],
                                              *[got[p] for p in planes]),
                                     _compact(want["valid"],
                                              *[want[p] for p in planes]))):
        np.testing.assert_array_equal(g, w, err_msg=p)
    if name in OVERFLOWS:
        assert got["overflow"] == 1
        with pytest.raises(RuntimeError, match="capacity"):
            td.distributed_sort_numpy(keys, payload, tm.LocalMesh(d, "cpu"),
                                      **dict(kw))
        return
    assert got["overflow"] == 0
    out = td.distributed_sort_numpy(keys, payload, tm.LocalMesh(d, "cpu"),
                                    **dict(kw))
    order = np.argsort(keys, kind="stable")
    k, p = (out, None) if payload is None else out
    np.testing.assert_array_equal(k, keys[order])
    if payload is not None:
        np.testing.assert_array_equal(p, order.astype(np.uint32))


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("k", [2, 4])
def test_overlap_is_bit_identical_to_the_monolithic_exchange(d, k):
    # the overlap case is held to JAX; the monolithic run of the same
    # keys to it (and to numpy)
    keys = _dup_keys(100 * d + k)
    mesh = tm.LocalMesh(d, "cpu")
    res, ovf = td.distributed_sort(td.shard_u64(keys, mesh),
                                   td.shard_u32(_arange(1 << 13), mesh),
                                   mesh=mesh, capacity_factor=3.0)
    ovl = _port(f"overlap_d{d}_k{k}")
    assert int(ovf.max()) == 0
    np.testing.assert_array_equal(res.valid.numpy(), ovl["valid"])
    mono = _compact(ovl["valid"], *(td.collect_u32(c, mesh) for c in (
        res.key.lo, res.key.hi, res.payloads[0])))
    for a, p in zip(mono, ("lo", "hi", "pay")):
        np.testing.assert_array_equal(a, _compact(ovl["valid"], ovl[p])[0])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(mono[2], order.astype(np.uint32))


def test_padded_runs_equal_the_reference_runs():
    # the port sorts only the real rows, yet its pad tail is the JAX tail
    for name in ("uniform_d4", "zipf", "overlap_d4_k2"):
        got, want = _port(name), _jax(name)
        for p in ("lo", "hi", "pay"):
            np.testing.assert_array_equal(got[p], want[p], err_msg=name)


def test_all_equal_keys_split_evenly_across_shards():
    # position splitters route an all-equal dataset identically: every
    # shard ends with n/D rows, none of them moved
    valid = _port("all_equal_split")["valid"]
    assert (np.abs(valid - (1 << 12) // 8) <= 2).all(), valid


def test_auto_capacity_is_demand_sized():
    # identity route: no off-diagonal demand -> the 16-row floor
    mesh = tm.LocalMesh(8, "cpu")
    key = td.shard_u64(np.full(1 << 12, 7, np.uint64), mesh)
    assert td.auto_capacity(key, mesh) == 16
    assert _jax("auto_identity")["plan"] == _port("auto_identity")["plan"]


def test_asserts_of_the_reference():
    mesh = tm.LocalMesh(4, "cpu")
    key = td.shard_u64(_uniform(0, 1 << 10), mesh)
    with pytest.raises(AssertionError):
        td.distributed_sort(key, mesh=mesh, overlap=3)
    with pytest.raises(AssertionError):      # the rank outgrows bit 31
        td.distributed_sort(key, mesh=mesh, capacity=1 << 30)
    with pytest.raises(ValueError, match="split"):
        td.shard_u64(_uniform(0, 1001), mesh)


def test_both_backends_agree():
    keys, payload = _zipf(42, 1.3), _arange(1 << 13)
    mesh = tm.LocalMesh(8, "cpu")
    a = td.distributed_sort_numpy(keys, payload, mesh, capacity_factor=4.0)
    b = td.distributed_sort_numpy(keys, payload, mesh, capacity_factor=4.0,
                                  backend="torch")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------ the mesh itself

def test_make_mesh():
    m = tm.make_mesh(4, device="cpu")
    assert isinstance(m, tm.LocalMesh) and m.n_dev == 4
    assert tm.make_mesh(device="cpu").n_dev == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.LocalMesh(2)


def test_local_mesh_collectives():
    m = tm.LocalMesh(3, "cpu")
    x = torch.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(m.all_gather(x).numpy(),
                                  np.tile(np.arange(12), (3, 1)))
    blocks = torch.arange(18).reshape(3, 3, 2)
    np.testing.assert_array_equal(m.all_to_all(blocks).numpy(),
                                  blocks.numpy().transpose(1, 0, 2))
    np.testing.assert_array_equal(m.pmax(torch.tensor([4, 9, 2])).numpy(),
                                  [9, 9, 9])
    np.testing.assert_array_equal(m.ranks().numpy(), [0, 1, 2])
    np.testing.assert_array_equal(m.shard(torch.arange(6)).numpy(),
                                  [[0, 1], [2, 3], [4, 5]])


# ----------------------------------------- shuffle functions vs shard_map

def _jax_shards(fn, d, *arrays):
    """fn under shard_map on a mesh of d, every input split on axis 0;
    each output gains a leading shard axis: a list of (d, ...) arrays."""
    mesh = jd.make_mesh(d)

    def body(*a):
        return tuple(jnp.asarray(o)[None] for o in fn(*a))

    f = shard_map(body, mesh=mesh, in_specs=tuple(P("x") for _ in arrays),
                  out_specs=P("x"), check_vma=False)
    return [np.asarray(o) for o in jax.jit(f)(*arrays)]


def _t(a, d):
    """numpy u32 (n,) -> (d, n/d) int32 planes."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32)).reshape(d, -1)


def _np(x):
    return np.asarray(x.numpy()).view(np.uint32) if x.dtype == torch.int32 \
        else np.asarray(x.numpy())


def _planes(seed, n, d, hot=True):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if hot:                   # a hot key, and keys around bit 31
        lo[::3], hi[::3] = 0x80000000, 0x7FFFFFFF
        hi[1::7] = 0x80000001
    pos = (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(
        np.uint32)
    return lo, hi, pos


@pytest.mark.parametrize("d", [2, 4, 8])
def test_splitters_and_routes_match_shard_map(d):
    n, spd = 512 * d, 64
    lo, hi, pos = _planes(d, n, d)
    mesh = tm.LocalMesh(d, "cpu")
    nv = np.array([(37 * (i + 1)) % 512 + 1 for i in range(d)], np.uint32)

    def jfn(lo, hi, pos, nv):
        sp = js.sample_splitters(lo, hi, d, spd)
        spv = js.sample_splitters(lo, hi, d, spd, n_valid=nv[0])
        spp = js.sample_splitters_pos(lo, hi, pos, d, spd)
        spm = js.sample_splitters_multi([hi, lo, pos], d, spd)
        return (*sp, *spv, *spp, *spm,
                js.route_by_splitters(lo, hi, *sp),
                js.route_by_splitters_pos(lo, hi, pos, *spp),
                js.route_by_splitters_multi([hi, lo, pos], spm))

    want = _jax_shards(jfn, d, jnp.asarray(lo), jnp.asarray(hi),
                       jnp.asarray(pos), jnp.asarray(nv))
    tlo, thi, tpos = _t(lo, d), _t(hi, d), _t(pos, d)
    sp = ts.sample_splitters(mesh, tlo, thi, d, spd)
    spv = ts.sample_splitters(mesh, tlo, thi, d, spd,
                              n_valid=torch.from_numpy(nv.astype(np.int64)))
    spp = ts.sample_splitters_pos(mesh, tlo, thi, tpos, d, spd)
    spm = ts.sample_splitters_multi(mesh, [thi, tlo, tpos], d, spd)
    got = [*sp, *spv, *spp, *spm]
    for i, g in enumerate(got):    # the same splitters on every shard
        for s in range(d):
            np.testing.assert_array_equal(_np(g), want[i][s], err_msg=i)
    routes = [ts.route_by_splitters(tlo, thi, *sp),
              ts.route_by_splitters_pos(tlo, thi, tpos, *spp),
              ts.route_by_splitters_multi([thi, tlo, tpos], spm)]
    for g, w in zip(routes, want[len(got):]):
        np.testing.assert_array_equal(_np(g), w)


def test_routes_compare_unsigned_across_bit_31():
    # keys, positions and splitters on both sides of 2^31: a signed
    # compare would send every row above 2^31 to shard 0
    vals = np.array([0, 1, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    lo, hi, pos = (a.ravel() for a in np.meshgrid(vals, vals, vals))
    sp_lo = np.array([0x7FFFFFFF, 0x80000000, 0x80000000, 0xFFFFFFFF],
                     np.uint32)
    sp_hi = np.array([0x7FFFFFFF, 0x7FFFFFFF, 0x80000000, 0x80000001],
                     np.uint32)
    sp_pos = np.array([0x80000000, 0x7FFFFFFF, 0xFFFFFFFE, 1], np.uint32)
    want_pos = js.route_by_splitters_pos(*(jnp.asarray(a) for a in (
        lo, hi, pos, sp_lo, sp_hi, sp_pos)))
    want = js.route_by_splitters(*(jnp.asarray(a) for a in (
        lo, hi, sp_lo, sp_hi)))
    want_multi = js.route_by_splitters_multi(
        [jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pos)],
        [jnp.asarray(sp_hi), jnp.asarray(sp_lo), jnp.asarray(sp_pos)])
    t = [_t(a, 1) for a in (lo, hi, pos)]
    s = [_t(a, 1)[0] for a in (sp_lo, sp_hi, sp_pos)]
    np.testing.assert_array_equal(
        _np(ts.route_by_splitters_pos(*t, *s))[0], np.asarray(want_pos))
    np.testing.assert_array_equal(
        _np(ts.route_by_splitters(t[0], t[1], s[0], s[1]))[0],
        np.asarray(want))
    np.testing.assert_array_equal(
        _np(ts.route_by_splitters_multi([t[1], t[0], t[2]],
                                        [s[1], s[0], s[2]]))[0],
        np.asarray(want_multi))
    assert len(np.unique(np.asarray(want_pos))) == 5
    g = ts.cmp_gt(t[0], t[1], s[0][1], s[1][1])
    np.testing.assert_array_equal(g.numpy()[0], np.asarray(js.cmp_gt(
        jnp.asarray(lo), jnp.asarray(hi), sp_lo[1], sp_hi[1])))


@pytest.mark.parametrize("d", [3, 8])
def test_partition_by_dest_is_stable_across_bit_31(d):
    rng = np.random.default_rng(d)
    n = 1000
    dest = rng.integers(0, d, n).astype(np.uint32)
    cols = [np.uint32(0x7FFFFFF0) + np.arange(n, dtype=np.uint32),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]
    want = js._partition_by_dest(jnp.asarray(dest),
                                 [jnp.asarray(c) for c in cols], d)
    for backend in ("radix", "torch"):
        cols_s, dest_s, counts, offsets = ts._partition_by_dest(
            _t(dest, 1), [_t(c, 1) for c in cols], d, backend)
        for g, w in zip(cols_s, want[0]):
            np.testing.assert_array_equal(_np(g)[0], np.asarray(w))
        np.testing.assert_array_equal(dest_s.numpy()[0], np.asarray(want[1]))
        np.testing.assert_array_equal(counts.numpy()[0], np.asarray(want[2]))
        np.testing.assert_array_equal(offsets.numpy()[0],
                                      np.asarray(want[3]))


@pytest.mark.parametrize("d,capacity", [(2, 300), (4, 16), (8, 64)])
def test_exchange_and_demand_match_shard_map(d, capacity):
    n = 256 * d
    lo, hi, pos = _planes(10 + d, n, d)
    mesh = tm.LocalMesh(d, "cpu")
    spd = 32

    def jfn(lo, hi, pos):
        sp = js.sample_splitters_pos(lo, hi, pos, d, spd)
        dest = js.route_by_splitters_pos(lo, hi, pos, *sp)
        recv, flag, rank, counts, ovf = js.exchange(
            dest, [lo, hi, pos], [js._ONES, js._ONES, jnp.uint32(0)], d,
            capacity)
        return (*recv, flag, rank, counts, ovf,
                js.offdiag_demand(dest, d))

    want = _jax_shards(jfn, d, jnp.asarray(lo), jnp.asarray(hi),
                       jnp.asarray(pos))
    t = [_t(a, d) for a in (lo, hi, pos)]
    sp = ts.sample_splitters_pos(mesh, *t, d, spd)
    dest = ts.route_by_splitters_pos(*t, *sp)
    recv, flag, rank, counts, ovf = ts.exchange(
        mesh, dest, t, [ts.ONES, ts.ONES, 0], d, capacity)
    got = [*recv, flag, rank, counts, ovf,
           ts.offdiag_demand(mesh, dest, d)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            _np(g).astype(np.int64), w.reshape(g.shape).astype(np.int64),
            err_msg=str(i))


def test_pow2_capacity():
    for demand in (0, 1, 15, 16, 17, 1000, 1 << 20, 3_000_001):
        assert ts.pow2_capacity(demand) == js.pow2_capacity(demand)
        assert ts.pow2_capacity(demand, 1.5) == js.pow2_capacity(demand,
                                                                 1.5)


# ------------------------------------------------- the distributed flagship

@pytest.mark.parametrize("n_dev,overlap", [(2, 1), (8, 2)])
def test_distributed_flagship_pipeline(n_dev, overlap):
    """Mesh-sharded morton encode + distributed sort equals the port's
    single-device encode_points + sort_u64 exactly, as the reference test
    holds its own pipeline. (JAX's distributed pipeline encodes under jit,
    whose float rounding differs from eager encoding in a few codes, as
    that test notes; the port's encode_points equals JAX's eager one,
    tests/test_torch_morton_kernel.py.)"""
    from tpu_qe_torch import morton
    from tpu_qe_torch.pipeline import sorted_morton_index_distributed
    from tpu_qe_torch.sort import sort_u64

    rng = np.random.default_rng(n_dev)
    n = 1 << 13
    x, y, z = (rng.uniform(-50, 50, n).astype(np.float32) for _ in range(3))
    params = morton.MortonParams.for_scene(
        np.array([-50.0] * 3, np.float32), np.array([50.0] * 3, np.float32),
        "cpu")
    mesh = tm.LocalMesh(n_dev, "cpu")
    res, overflow = sorted_morton_index_distributed(x, y, z, params, mesh,
                                                    overlap=overlap)
    assert int(overflow.max()) == 0
    code = morton.encode_points(*(torch.from_numpy(c) for c in (x, y, z)),
                                params)
    skey, (sidx,) = sort_u64(code, torch.arange(n, dtype=torch.int32))
    valid = res.valid.numpy()
    lo, hi, pay = _compact(valid, res.key.lo.numpy(), res.key.hi.numpy(),
                           res.payloads[0].numpy())
    np.testing.assert_array_equal(lo, skey.lo.numpy())
    np.testing.assert_array_equal(hi, skey.hi.numpy())
    np.testing.assert_array_equal(pay, sidx.numpy())
