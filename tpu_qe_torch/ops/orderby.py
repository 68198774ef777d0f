"""Multi-column ORDER BY: one lexicographic sort over mixed-type keys; the
port of tpu_qe/ops/orderby.py.

Each key column contributes its order-preserving u32 planes
(bits.sortable_u32; U64 keys hi then lo) and DESC inverts a plane's bits.
The JAX package appends the row position as the last key so that its
unstable sort is stable; ``sort_planes`` is stable, so the port sorts by
the key planes alone and gets the same order.
"""

from __future__ import annotations

from tpu_qe_torch.bits import U64, sortable_u32, sortable_u32_inverse
from tpu_qe_torch.sort.planes import argsort_planes
from tpu_qe_torch.table import Table, take_column


def canon_by(by) -> tuple[tuple[str, bool], ...]:
    """Normalize the ORDER BY spec: items are "name" or ("name", dir)
    with dir in {"asc", "desc"}. Returns ((name, descending), ...)."""
    out = []
    for item in ([by] if isinstance(by, str) else list(by)):
        if isinstance(item, str):
            out.append((item, False))
            continue
        name, d = item
        if d not in ("asc", "desc"):
            raise ValueError(f"direction must be 'asc'|'desc', got {d!r}")
        out.append((name, d == "desc"))
    if not out:
        raise ValueError("ORDER BY needs at least one key column")
    names = [nm for nm, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate ORDER BY column in {names}")
    return tuple(out)


def key_planes(table: Table, spec) -> tuple[list, list]:
    """Transformed int32 key planes (major -> minor) and per-plane
    metadata [(colname, which, dtype, descending)]; `which` is "hi"/"lo"
    for U64 planes, None for scalar columns."""
    planes, meta = [], []
    for name, desc in spec:
        c = table[name]
        if isinstance(c, U64):
            for which, p in (("hi", c.hi), ("lo", c.lo)):
                planes.append(~p if desc else p)
                meta.append((name, which, None, desc))
        else:
            b = sortable_u32(c)
            planes.append(~b if desc else b)
            meta.append((name, None, c.dtype, desc))
    return planes, meta


def reconstruct_keys(sorted_planes, meta) -> dict:
    """Invert key_planes over the sorted planes: {name: column}."""
    cols: dict = {}
    halves: dict = {}
    for p, (name, which, dtype, desc) in zip(sorted_planes, meta):
        b = ~p if desc else p
        if which is not None:
            halves.setdefault(name, {})[which] = b
            if len(halves[name]) == 2:
                cols[name] = U64(halves[name]["lo"], halves[name]["hi"])
        else:
            cols[name] = sortable_u32_inverse(b, dtype)
    return cols


def sort_by_multi(table: Table, by, backend: str = "radix") -> Table:
    """Rows reordered by the multi-column ORDER BY spec, stably.

    by: "name", or a sequence of "name" / ("name", "asc"|"desc"). Key
    columns may be U64, uint32, int32 or float32 (IEEE order: -inf < ... <
    inf < NaN bit patterns); the other columns ride along.
    """
    spec = canon_by(by)
    planes, meta = key_planes(table, spec)
    if table.num_rows == 0:
        return table
    splanes, perm = argsort_planes(planes, backend=backend)
    cols = reconstruct_keys(splanes, meta)
    keys = {nm for nm, _ in spec}
    for nm in table:
        if nm not in keys:
            cols[nm] = take_column(table[nm], perm)
    return Table({nm: cols[nm] for nm in table})
