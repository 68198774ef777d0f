"""`Database.sql(q, mesh=)` on a GroupMesh (one rank per process over
torch.distributed, gloo on the CPU) against the LocalMesh at the same
mesh size, D = 2.

The world is spawned once per module (torch.multiprocessing, a free
localhost port, a 120 s limit so that a hang fails instead of holding the
suite). Every rank registers the same tables and runs one query of each
shape family of tests/sql_dist_battery.py through `make_mesh()`: GROUP BY
with every aggregate, COUNT(DISTINCT) of u64 values, the percentiles,
HAVING, a three-column GROUP BY, DISTINCT, the fused JOIN with WHERE, a
set op, the windows and ORDER BY with LIMIT and a float DESC key. Every
rank's answer must equal the LocalMesh answer bit for bit. This file
imports nothing of JAX.
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

import sql_dist_battery as B  # noqa: E402
from tpu_qe_torch.exchange import mesh as tm  # noqa: E402
from tpu_qe_torch.sql import Database  # noqa: E402

SPAWN_LIMIT_S = 120
WORLD = 2
CASES = ["group_by_aggregates", "float_aggregate", "count_distinct_u64",
         "percentiles", "percentile_cont", "having",
         "group_by_three_columns", "select_distinct_two_columns_where",
         "where_with_join_left", "set_op_except_all", "window",
         "lag_lead_offset_k", "whole_partition_frames", "order_by_limit",
         "where_order_by_float_key_desc", "count_frames"]


def _answer(name, mesh):
    f = B.FAMILIES[name]
    db = Database("cpu")
    for nm, cols in B.tables(f.seed_for(WORLD)).items():
        db.register(nm, cols)
    return db.sql(f.sql, mesh=mesh)


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


@pytest.mark.parametrize("name", CASES)
def test_every_rank_equals_the_local_mesh(world, name):
    want = _answer(name, tm.LocalMesh(WORLD, "cpu"))
    for rank, got in enumerate(world):
        assert list(got[name]) == list(want), (name, rank)
        for col in want:
            a, b = np.asarray(got[name][col]), np.asarray(want[col])
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8)), (name, rank, col)
