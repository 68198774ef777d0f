"""Virtual tables and one query per verb family of the port's out-of-core
SQL tier (tpu_qe_torch/sql/bigexec.py), shared by
tests/test_torch_sql_big.py, tests/test_torch_sql_vvjoin.py,
tests/test_torch_cuda.py and chip_smoke.py. The port's only: it imports
no JAX, so it also runs where JAX is missing.

The generators are the port's twins of tests/test_sql_big.py's and
tests/test_sql_vvjoin.py's: each takes the int32 plane of the u32 row
indices and returns a u32 (torch.uint32), i32 or f32 column. The sizes are
those files': N = 3 * 2^12 + 17 rows (a tail run that does not divide),
runs of 2^12, and for the virtual x virtual join NF = N fact rows against
ND = 2^9 dimension rows.

Comparison rule (tests/test_sql_big.py's `_cmp`): integers exact, floats
at rtol 1e-5 and atol 1e-3 (a float SUM / AVG's float32 rounding follows
the row order inside a group, which the reference's unstable sorts leave
open).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_qe_torch.bits import mul_lo32, narrow, widen
from tpu_qe_torch.hashing import murmur_fmix32
from tpu_qe_torch.sql import Database
from tpu_qe_torch.table import from_plane

N = (1 << 12) * 3 + 17          # non-dividing tail run
RUN = 1 << 12
NF = N                          # virtual x virtual: fact rows
ND = 1 << 9                     # dimension rows (unique keys 0..511)
RTOL, ATOL = 1e-5, 1e-3


def u32(p: torch.Tensor) -> torch.Tensor:
    """An int32 plane as the u32 column with its bits."""
    return from_plane(p, torch.uint32)


def fact_gens() -> dict:
    """tests/test_sql_big.py's table t."""
    return {
        "k": lambda i: u32(murmur_fmix32(i) & 63),
        "v": lambda i: (murmur_fmix32(i ^ 0xA5A5) & 0xFFFF) - 0x8000,
        "u": lambda i: u32(murmur_fmix32(i ^ 7) & 999),
        "f": lambda i: ((widen(murmur_fmix32(i ^ 3)) >> 8).to(torch.float32)
                        * 2.0 ** -24),
        "id": u32,
    }


def dim_np() -> dict:
    """tests/test_sql_big.py's in-core dimension d: keys 0..47 of the
    fact's 64 k values (LEFT joins surface unmatched rows), unique."""
    dk = np.arange(48, dtype=np.uint32)
    return {"dk": dk,
            "w": (dk * np.uint32(2654435761)) >> np.uint32(22),
            "r": (dk % 5).astype(np.int32) - np.int32(2)}


def vv_fact_gens() -> dict:
    """tests/test_sql_vvjoin.py's fact f: keys 0..767, of which 512..767
    have no dimension row."""
    g = fact_gens()
    return {"fk": lambda i: u32(narrow(widen(murmur_fmix32(i)) % 768)),
            "v": g["v"], "u": g["u"], "id": g["id"]}


def vv_dim_gens() -> dict:
    """tests/test_sql_vvjoin.py's virtual dimension d (unique keys)."""
    return {
        "dk": u32,
        "w": lambda i: u32(narrow(mul_lo32(widen(i), 2654435761) >> 22)),
        "grp": lambda i: u32(i & 15),
        "fw": lambda i: widen(i).to(torch.float32) * 0.25,
    }


def materialize(gens: dict, n: int) -> dict:
    """The generated columns of rows 0..n-1 as numpy."""
    from tpu_qe_torch.table import column_to_numpy
    idx = torch.arange(n, dtype=torch.int32)
    return {nm: column_to_numpy(fn(idx)) for nm, fn in gens.items()}


def database(device) -> Database:
    """The family battery's tables on `device`: virtual t (N rows), the
    in-core dimension d, and for the virtual x virtual join the virtual f
    (NF rows) and vd (ND rows)."""
    db = Database(device)
    db.register_virtual("t", N, fact_gens())
    db.register("d", dim_np())
    db.register_virtual("f", NF, vv_fact_gens())
    db.register_virtual("vd", ND, vv_dim_gens())
    return db


# family -> (query, ordered): ordered results are compared row by row,
# the others as sorted row sets
_WIN = "OVER (PARTITION BY k ORDER BY u"
_RANGE = f"{_WIN} RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)"
FAMILIES = {
    "group_having": (
        "SELECT k, SUM(u) AS s, COUNT(*) AS c FROM t WHERE v > 0 AND "
        "u % 3 <> 1 GROUP BY k HAVING COUNT(*) > 40 ORDER BY s DESC "
        "LIMIT 11", True),
    "percentiles": (
        "SELECT k, MEDIAN(v) AS m, PERCENTILE_DISC(0.9) WITHIN GROUP "
        "(ORDER BY u) AS p90, PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY "
        "v) AS pc FROM t GROUP BY k ORDER BY k", False),
    "count_distinct": (
        "SELECT k, COUNT(DISTINCT u) AS cd, COUNT(*) AS c FROM t GROUP BY "
        "k ORDER BY k", False),
    "head_where": (
        "SELECT k, u, v % 7 AS m FROM t WHERE u % 97 = 3 LIMIT 60", True),
    "orderby_limit": (
        "SELECT k, v, u, id FROM t WHERE u % 3 = 1 ORDER BY v DESC, u, id "
        "LIMIT 25", True),
    "distinct": (
        "SELECT DISTINCT k, u % 5 AS m FROM t ORDER BY k, m LIMIT 100",
        True),
    "join_inner": (
        "SELECT d.r AS r, COUNT(*) AS c, SUM(v) AS s, MAX(w) AS mw FROM t "
        "JOIN d ON t.k = d.dk GROUP BY d.r ORDER BY r", False),
    "join_left": (
        "SELECT d__matched AS m, COUNT(*) AS c, SUM(u) AS s FROM t LEFT "
        "JOIN d ON k = dk GROUP BY m ORDER BY m", False),
    "vvjoin_inner": (
        "SELECT grp, COUNT(*) AS c, SUM(u) AS s, SUM(v) AS sv FROM f JOIN "
        "vd ON fk = dk GROUP BY grp ORDER BY grp", False),
    "vvjoin_left": (
        "SELECT vd__matched AS m, COUNT(*) AS c, SUM(w) AS s FROM f LEFT "
        "JOIN vd ON fk = dk GROUP BY m ORDER BY m", False),
    "union_all": (
        "SELECT k FROM t WHERE v > 0 UNION ALL SELECT k FROM t WHERE "
        "v > 16000", False),
    "intersect": (
        "SELECT u FROM t WHERE u < 400 INTERSECT SELECT u FROM t WHERE "
        "u % 3 = 0 ORDER BY u", False),
    "window_prefix": (
        f"SELECT k, u, id, ROW_NUMBER() {_WIN}) AS rn, RANK() {_WIN}) AS "
        f"rk, SUM(v) {_WIN}) AS rs, LAG(u) {_WIN}) AS lg FROM t LIMIT 50",
        True),
    "window_whole": (
        "SELECT k, id, COUNT(*) OVER (PARTITION BY k) AS pc, SUM(u) OVER "
        "(PARTITION BY k) AS ts, MIN(v) OVER (PARTITION BY k) AS mn, "
        "AVG(f) OVER (PARTITION BY k) AS av FROM t WHERE u < 700 LIMIT 64",
        True),
    "window_range": (
        f"SELECT k, u, id, SUM(v) {_RANGE} AS rs, MIN(v) {_RANGE} AS rm, "
        f"MAX(f) {_RANGE} AS rx, AVG(v) {_RANGE} AS ra FROM t LIMIT 40",
        True),
}


def run(db, run_size: int = RUN) -> dict:
    """Every family's result on `db` (a port or a JAX Database)."""
    return {fam: db.sql(q, run_size=run_size)
            for fam, (q, _) in FAMILIES.items()}


def differs(got: dict, want: dict, ordered: bool) -> str | None:
    """None when two results agree under the comparison rule, else what
    differs. Unordered results are compared as sorted row sets."""
    if sorted(got) != sorted(want):
        return f"columns {sorted(got)} vs {sorted(want)}"
    names = sorted(want)
    n = len(np.asarray(want[names[0]])) if names else 0
    pg = pw = np.arange(n)
    if not ordered:
        pg = np.lexsort([np.asarray(got[c]).astype(np.float64)
                         for c in reversed(names)])
        pw = np.lexsort([np.asarray(want[c]).astype(np.float64)
                         for c in reversed(names)])
    for c in names:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        if len(a) != len(b):
            return f"{c}: {len(a)} rows vs {len(b)}"
        a, b = a[pg], b[pw]
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            if not np.allclose(a.astype(np.float64), b.astype(np.float64),
                               rtol=RTOL, atol=ATOL):
                return f"{c}: {a[:8]} vs {b[:8]}"
        elif not np.array_equal(a.astype(np.int64), b.astype(np.int64)):
            return f"{c}: {a[:8]} vs {b[:8]}"
    return None
