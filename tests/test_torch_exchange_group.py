"""The GroupMesh backend (one rank per process over torch.distributed,
gloo on the CPU) against the LocalMesh at the same mesh size, D = 2 and 4.

Each world is spawned once per module (torch.multiprocessing, a free
localhost port, a 120 s limit so that a hang fails instead of holding the
suite) and runs the whole batch: the distributed sort of uniform, Zipf and
all-equal keys, keys only, overlap=2 and an overflowing route (which must
raise on every rank), then distributed_aggregate, distributed_join_fk,
distributed_top_k, the mesh's psum, distributed_window (a partition that
spans every rank, the scalar chain, both row halos, totals and RANGE),
distributed_order_by and the global and per-group distributed quantiles. Every rank's answer
must equal the LocalMesh answer bit for bit. This file imports nothing of JAX: the spawned ranks import
it.
"""

import os
import pickle
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tpu_qe_torch.exchange import dops, dsort, mesh as tm  # noqa: E402

SPAWN_LIMIT_S = 120
N = 1 << 11


def _uniform(seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, N,
                                                dtype=np.uint64)


def _zipf(seed):
    return (np.random.default_rng(seed).zipf(1.3, N).astype(np.uint64)
            * np.uint64(0x9E3779B97F4A7C15))


def _sort(keys, payload=True, **kw):
    def run(mesh):
        pay = np.arange(len(keys), dtype=np.uint32) if payload else None
        return dsort.distributed_sort_numpy(keys, pay, mesh, **kw)
    return run


def _aggregate(mesh):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, N).astype(np.uint64) << np.uint64(33)
    vals = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    return dops.distributed_aggregate_numpy(
        keys, vals, mesh, aggs=("count", "sum", "min", "max"),
        capacity_factor="auto")


def _join_fk(mesh):
    rng = np.random.default_rng(6)
    rkeys = np.unique(rng.integers(0, 1 << 40, 512, dtype=np.uint64))[:256]
    rvals = rng.integers(0, 1 << 30, 256, dtype=np.uint32)
    lkeys = np.where(rng.random(N) < 0.5, rkeys[rng.integers(0, 256, N)],
                     rng.integers(0, 1 << 40, N, dtype=np.uint64))
    lkeys[::3] = rkeys[7]                                  # a hot key
    return dops.distributed_join_fk_numpy(lkeys, [], rkeys, [rvals], mesh,
                                          capacity_factor="auto")


def _top_k(mesh):
    keys = _uniform(7) >> np.uint64(50)                    # many ties
    vals = np.arange(N, dtype=np.uint32) * 3
    return (dops.distributed_top_k_numpy(keys, [vals], mesh, 100),
            dops.distributed_top_k_numpy(keys, [vals], mesh, 100,
                                         largest=True))


def _psum(mesh):
    r = mesh.ranks() + 1
    return mesh.psum(torch.stack([r, r << 40, -r], 1))[0].tolist()


def _window(mesh):
    from tpu_qe_torch.exchange import dwindow
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 5, N).astype(np.uint64)
    keys[: N // 2] = 3                                  # spans every rank
    order = (rng.integers(-4, 4, N) + (1 << 31)).astype(np.uint32)
    vals = {"v": rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(
        np.uint32)}
    funcs = {"rn": ("row_number",), "rk": ("rank",),
             "cs": ("running_sum", "v"), "lg": ("lag", "v", 0, 3),
             "ms": ("moving_sum", "v", 5), "ld": ("lead", "v", 1, 2),
             "ts": ("total_sum", "v"), "rs": ("range_sum", "v", "unbounded")}
    return dwindow.distributed_window_numpy(keys, funcs, mesh, order=order,
                                            values=vals,
                                            capacity_factor="auto")


def _order_by(mesh):
    from tpu_qe_torch.exchange import dorderby
    rng = np.random.default_rng(10)
    cols = {"k": rng.integers(0, 7, N).astype(np.uint64),
            "b": rng.integers(-(1 << 31), (1 << 31) - 1, N,
                              dtype=np.int64).astype(np.int32),
            "i": np.arange(N, dtype=np.uint32)}
    return dorderby.distributed_order_by_numpy(
        cols, [("k", "desc"), "b"], mesh, capacity_factor="auto")


def _quantile(mesh):
    from tpu_qe_torch.exchange import dquantile
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1 << 64, N, dtype=np.uint64)
    keys = rng.integers(0, 13, N).astype(np.uint64)
    qs = [0.0, 0.25, (1, 1), 0.99, 1.0]
    return (dquantile.distributed_quantile_numpy(vals, qs, mesh),
            dquantile.distributed_group_quantile_numpy(
                keys, (vals >> np.uint64(40)).astype(np.uint32), qs, mesh,
                max_groups=16))


CASES = {
    "uniform": _sort(_uniform(1)),
    "zipf": _sort(_zipf(2), capacity_factor=4.0),
    "all_equal": _sort(np.full(N, 777, np.uint64)),
    "overflow": _sort(np.arange(N, 0, -1).astype(np.uint64),
                      payload=False, capacity_factor=1.0),
    "keys_only": _sort(_uniform(3), payload=False),
    "overlap2": _sort(_uniform(4), capacity_factor=3.0, overlap=2),
    "aggregate": _aggregate,
    "join_fk": _join_fk,
    "top_k": _top_k,
    "psum": _psum,
    "window": _window,
    "order_by": _order_by,
    "quantile": _quantile,
}


def _answer(name, mesh):
    try:
        return CASES[name](mesh)
    except RuntimeError as e:
        return ("raised", str(e))


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = tm.make_mesh()
        assert isinstance(mesh, tm.GroupMesh) and mesh.n_dev == world
        out = {name: _answer(name, mesh) for name in CASES}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # under pytest-xdist several test processes share the CPU's cores:
    # torch's own thread pool on top of them only makes its ops wait
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    """(D, [each rank's answers]) from one spawned gloo world."""
    d = request.param
    out_dir = str(tmp_path_factory.mktemp(f"gloo{d}"))
    ctx = mp.start_processes(_rank, args=(d, _free_port(), out_dir),
                             nprocs=d, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo world of {d} ranks did not finish "
                            f"in {SPAWN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    answers = []
    for r in range(d):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            answers.append(pickle.load(f))
    return d, answers


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_equals_the_local_mesh(world, name):
    d, answers = world
    want = _answer(name, tm.LocalMesh(d, "cpu"))
    if name == "overflow":
        assert want[0] == "raised" and "capacity" in want[1]
    for rank, got in enumerate(answers):
        assert _same(got[name], want), (name, rank)
