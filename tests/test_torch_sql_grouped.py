"""The grouped answer of sql/grouped.py: no query leaves a tensor in
cyclic garbage (so nothing of it waits for the cyclic collector once
Database.sql returns), and CASE over aggregates on the group frame.

No JAX: numpy is the oracle."""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from tpu_qe_torch.exchange import LocalMesh
from tpu_qe_torch.sql import Database

N = 1 << 12


def _cols(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 9, N).astype(np.uint32),
            "v": rng.integers(0, 1000, N).astype(np.uint32)}


def _db() -> Database:
    db = Database("cpu")
    db.register("t", _cols())
    db.register_virtual("big", N, {
        "k": lambda i: (i & 3).view(torch.uint32),
        "v": lambda i: (i % 1000).view(torch.uint32)})
    return db


QUERIES = {
    "group_by": ("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM t GROUP BY k",
                 False),
    "group_by_having": ("SELECT k, SUM(v) AS s FROM t GROUP BY k "
                        "HAVING COUNT(*) > 3", False),
    "global_sum_where": ("SELECT SUM(v) AS s FROM t WHERE v > 10", False),
    "expression_arguments": ("SELECT k, SUM(v * 2) AS s, MEDIAN(v) AS m, "
                             "COUNT(DISTINCT v % 7) AS d FROM t GROUP BY k",
                             False),
    "virtual_group_by": ("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM big "
                         "GROUP BY k", None),
    "mesh_group_by": ("SELECT k, COUNT(*) AS c FROM t GROUP BY k", True),
    "mesh_group_by_having": ("SELECT k, COUNT(*) AS c FROM t GROUP BY k "
                             "HAVING SUM(v) > 3", True),
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_query_leaves_no_tensor_in_cyclic_garbage(name):
    sql, mesh = QUERIES[name]
    db = _db()
    # a virtual table runs in runs of N rows (the default is 2^26)
    kw = ({"mesh": LocalMesh(2, "cpu")} if mesh
          else {"run_size": N} if mesh is None else {})
    db.sql(sql, **kw)           # first use: imports and caches
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = db.sql(sql, **kw)
        gc.collect()
        left = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert out and all(len(v) for v in out.values())
    assert left == [], [(t.dtype, tuple(t.shape)) for t in left]


def _numpy_case_having(k, v):
    out = {"k": [], "s": []}
    for g in np.unique(k):
        sel = v[k == g]
        s = int(sel.sum())
        # CASE WHEN MIN(v) > 0 THEN SUM(v) ELSE 0 END > 200000
        if (s if sel.min() > 0 else 0) > 200000:
            out["k"].append(g)
            out["s"].append(s)
    return out


@pytest.mark.parametrize("table", ["t", "big"])
def test_case_over_aggregates_in_having_matches_numpy(table):
    db = _db()
    got = db.sql(f"SELECT k, SUM(v) AS s FROM {table} GROUP BY k HAVING "
                 "CASE WHEN MIN(v) > 0 THEN SUM(v) ELSE 0 END > 200000 "
                 "ORDER BY k", run_size=N)
    if table == "t":
        k, v = _cols()["k"], _cols()["v"]
    else:
        i = np.arange(N, dtype=np.uint32)
        k, v = i & 3, i % 1000
    want = _numpy_case_having(k, v)
    assert 0 < len(want["k"]) < len(np.unique(k))
    assert got["k"].tolist() == want["k"]
    assert got["s"].tolist() == want["s"]
