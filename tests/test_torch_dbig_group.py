"""The nine distributed out-of-core operators (tpu_qe_torch/ops/dbig*.py)
on a GroupMesh (one rank per process over torch.distributed, gloo on the
CPU) against a LocalMesh of the same size, D = 2.

The world is spawned once per module (torch.multiprocessing, a free
localhost port, a 120 s limit so that a hang fails instead of holding the
suite) and runs every operator at the smallest sizes of its reference
tests: GROUP BY with min / max and through a checkpoint (rank 0 writes,
a second call resumes from it), the FK join through a checkpoint, the
fused join -> GROUP BY, top-k (largest), COUNT(DISTINCT), UNION, the
quantiles (DISC and CONT), the window and the ORDER BY. Every rank's
answer (every result field but the times, and the collected tables) must
equal the LocalMesh answer bit for bit. This file imports nothing of JAX:
the spawned ranks import it.
"""

import dataclasses
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tpu_qe_torch.exchange import mesh as tm  # noqa: E402
from tpu_qe_torch.ops import (dbigagg, dbigdistinct, dbigjoin,  # noqa: E402
                              dbigorderby, dbigpipe, dbigquantile,
                              dbigsetops, dbigtopk, dbigwindow)

SPAWN_LIMIT_S = 120
WORLD = 2
QS = [0.0, 0.1, (1, 1), 0.99, 1.0]


def _plain(x):
    """A result without its times: dataclasses as dicts of their other
    fields, recursively."""
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()
                if not (k.endswith("_s") or k == "seconds")}
    if isinstance(x, (tuple, list)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _agg(mesh, ckdir):
    return dbigagg.aggregate_big_distributed(
        1 << 14, mesh, n_groups=1 << 9, run_size=1 << 12, collect=True,
        minmax=True)


def _agg_checkpoint(mesh, ckdir):
    kw = dict(n_groups=1 << 8, run_size=1 << 11, collect=True,
              checkpoint_dir=ckdir)
    first = dbigagg.aggregate_big_distributed(1 << 14, mesh, **kw)
    return first, dbigagg.aggregate_big_distributed(1 << 14, mesh, **kw), \
        sorted(os.listdir(ckdir))


def _join_checkpoint(mesh, ckdir):
    kw = dict(run_size=1 << 11, buckets_per_dev=2, checkpoint_dir=ckdir)
    first = dbigjoin.join_big_distributed(1 << 13, 1 << 13, mesh, **kw)
    meta = np.asarray([1 << 13, 1 << 13, WORLD, 1 << 11, 2, 7, 1 << 11],
                      np.int64)
    st = dbigjoin._DJoinState.load(ckdir, meta)
    return (first, dbigjoin.join_big_distributed(1 << 13, 1 << 13, mesh,
                                                 **kw),
            st.bounds, st.scalars)


def _pipe(mesh, ckdir):
    return dbigpipe.join_aggregate_big_distributed(
        1 << 13, 1 << 13, mesh, n_groups=1 << 7, run_size=1 << 10,
        collect=True)


def _topk(mesh, ckdir):
    return dbigtopk.top_k_big_distributed(1 << 14, 16, mesh,
                                          run_size=1 << 12, largest=True,
                                          collect=True)


def _distinct(mesh, ckdir):
    return dbigdistinct.count_distinct_big_distributed(
        1 << 13, mesh, n_groups=16, n_values=4, run_size=1 << 10,
        collect=True)


def _setops(mesh, ckdir):
    return dbigsetops.set_op_big_distributed(
        "union", 1 << 13, 1 << 13, mesh, g_a=300, g_b=200, offset=150,
        run_size=1 << 10, collect=True)


def _quantile(mesh, ckdir):
    return (dbigquantile.quantile_big_distributed(1 << 13, QS, mesh,
                                                  run_size=1 << 10),
            dbigquantile.quantile_cont_big_distributed(
                1 << 13, [(1, 1), (3, 2)], mesh, run_size=1 << 10))


def _window(mesh, ckdir):
    return dbigwindow.window_big_distributed(
        1 << 13, mesh, partitions=16, run_size=1 << 10, buckets_per_dev=2,
        collect=True)


def _order_by(mesh, ckdir):
    return dbigorderby.order_by_big_distributed(
        1 << 13, mesh, a_card=19, run_size=1 << 10, buckets_per_dev=2,
        collect=True)


CASES = {
    "agg": _agg, "agg_checkpoint": _agg_checkpoint,
    "join_checkpoint": _join_checkpoint, "pipe": _pipe, "topk": _topk,
    "distinct": _distinct, "setops": _setops, "quantile": _quantile,
    "window": _window, "order_by": _order_by,
}


def _answer(name, mesh, ckdir):
    os.makedirs(ckdir, exist_ok=True)
    return _plain(CASES[name](mesh, ckdir))


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = tm.make_mesh()
        assert isinstance(mesh, tm.GroupMesh) and mesh.n_dev == world
        out = {}
        for name in CASES:
            # one directory for the world: rank 0 writes, every rank reads
            out[name] = _answer(name, mesh, os.path.join(out_dir, name))
            dist.barrier()
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's answers from one spawned gloo world of WORLD ranks."""
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    ctx = mp.start_processes(_rank, args=(WORLD, _free_port(), out_dir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo world of {WORLD} ranks did not "
                            f"finish in {SPAWN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    answers = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            answers.append(pickle.load(f))
    return answers


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
    with tempfile.TemporaryDirectory() as d:
        want = _answer(name, tm.LocalMesh(WORLD, "cpu"), d)
    for rank, got in enumerate(world):
        assert _same(got[name], want), (name, rank)
