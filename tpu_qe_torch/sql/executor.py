"""SQL executor: logical planning + execution over the device operators;
the port of tpu_qe/sql/executor.py (its in-core tier).

The front door to the engine: `Database.sql("SELECT ...")` parses
(sql/parser.py), binds column references against registered Tables, and
executes on the Database's device through the operator families:

    row-level expressions      torch elementwise code (WHERE masks,
                               projected expressions, CASE WHEN)
    WHERE                      ops/filter.compact (stable partition)
    JOIN (inner/left/full)     inner: ops/join.join_inner_index, one read
                               of its exact totals, join_inner_rows (the
                               left columns passed through where each row
                               matched once); outer: join_outer with the
                               exact-count + overflow-retry budget
                               discipline (never silent truncation)
    FROM a, b, ... (commas)    sql/planner.py: the same inner joins, in the
                               order it picks from the WHERE's equalities
                               and the tables' row counts
    GROUP BY / aggregates      ops/aggregate.group_aggregate_multi (one
                               shared key sort; EXACT u64/i64 integer
                               sums) + group_aggregate for
                               COUNT(DISTINCT x)
    percentiles                ops/quantile.group_quantile(_cont)
    window calls               ops/window.window (one composite sort)
    ORDER BY / LIMIT           ops/orderby.sort_by_multi (row results);
                               group frames order on the host (they are
                               G-bounded readbacks, i.e. output-scale)
    UNION/INTERSECT/EXCEPT     ops/setops.set_op (+ ALL variants from
                               the returned exact per-side
                               multiplicities)

Every data sort of these operators runs through sort/planes.py: the B1
histogram, B2 scan and B3 rank + scatter kernels on the card, their plain
twins on CPU tensors. No n-row path calls torch.sort, torch.argsort or
torch.unique.

Host/device boundary: n-row work always runs on the device; once a result
is reduced to output scale (a compacted group frame, a LIMIT head, a
set-op key table) it is read back and finished with numpy.

Type model: columns are uint32 / int32 / float32 / u64 (U64 planes). A
u32 column is a torch.uint32 tensor in a Table; inside expressions it is
its int32 bit-pattern plane (table.plane) under the tag "u32", because
torch's uint32 tensors reject comparisons, shifts and division. There are
no NULLs in the data model; LEFT/FULL OUTER joins surface SQL's NULLs as
zero-filled right columns plus a `<binding>__matched` u32 column
(COALESCE(col, 0) semantics). Integer arithmetic is 32-bit with C-style
truncating / and % (sqlite's semantics at 32-bit width; a zero divisor
reads as 1, so v / 0 = v and v % 0 = 0); aggregate SUM of integer columns
is exact 64-bit.

Queries over virtual (out-of-core) tables, registered with
`register_virtual`, run through sql/bigexec.py. With `mesh=` (a LocalMesh
or GroupMesh of exchange/mesh.py) the recognized query shapes run through
the distributed operators of exchange/ (see Database._sql_distributed):
the registered columns are read back to the host, re-sharded onto the
mesh's device, and every shape the layer does not recognize raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import SIGN_BIT, U64, narrow, sortable_u32, widen
from tpu_qe_torch.config import resolve_device
from tpu_qe_torch.sort.driver import signed_key
from tpu_qe_torch.sql import parser as P
from tpu_qe_torch.sql.grouped import (DArray, DeviceOps, GroupFrame,
                                      NumpyOps, _AGG_FUNCS, _I64_MIN,
                                      _PCT_FUNCS, _auto_name, _calls,
                                      aggregate_calls, expr_aliases,
                                      plan_aggregates)
from tpu_qe_torch.sql.planner import (column_refs, has_implicit_joins,
                                      plan_query)
from tpu_qe_torch.table import DTYPES, Table, column_to_numpy, from_plane
from tpu_qe_torch.utils.profiling import span

SqlError = P.SqlError

_WINDOW_FUNCS = {
    "row_number": "row_number", "rank": "rank", "dense_rank": "dense_rank",
    "sum": "running_sum", "min": "running_min", "max": "running_max",
    "lag": "lag", "lead": "lead", "first_value": "first_value",
    "last_value": "last_value", "ntile": "ntile",
    "percent_rank": "percent_rank",
}
_DTYPE = {"u32": torch.int32, "i32": torch.int32, "f32": torch.float32,
          "bool": torch.bool}
_CMP = {"=": torch.eq, "<>": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}


def _window_kind(c) -> str:
    """Effective window kind of one OVER call after the ORDER-BY
    presence and ROWS-frame remaps: AVG picks moving/running/total by
    frame and ORDER BY; COUNT with ORDER BY IS row_number (the engine's
    ROWS framing) and without is the partition size; a ROWS frame turns
    the running family into the moving family (width frame_rows+1,
    clamped at partition starts); running aggregates without ORDER BY are
    the whole-partition frame (total_*)."""
    ocol = c.window.order_by
    fr = c.window.frame_rows
    fo = c.window.frame_follow
    has_frame = fr is not None or fo is not None
    if c.func == "avg":
        kind = ("moving_avg" if has_frame
                else "running_avg" if ocol is not None else "total_avg")
    elif c.func == "count":
        kind = ("row_number" if ocol is not None else "partition_count")
        if has_frame:
            kind = "moving_count"
    else:
        kind = _WINDOW_FUNCS.get(c.func)
    if kind is None:
        raise SqlError(f"unknown window function {c.func}")
    if has_frame:
        remap = {"running_sum": "moving_sum", "running_min": "moving_min",
                 "running_max": "moving_max", "moving_avg": "moving_avg",
                 "moving_count": "moving_count"}
        if kind not in remap:
            raise SqlError(f"{c.func} does not take a ROWS frame")
        if ocol is None:
            raise SqlError("a ROWS frame needs ORDER BY inside OVER")
        kind = remap[kind]
    frange = c.window.frame_range
    if frange is not None:
        # RANGE frames: order-VALUE window bounds; 'unbounded' is SQL's
        # tie-aware default frame, a numeric bound is [order - x, order]
        remap_r = {"running_sum": "range_sum",
                   "running_min": "range_min",
                   "running_max": "range_max",
                   "running_avg": "range_avg"}
        if kind not in remap_r:
            raise SqlError(f"{c.func} does not take a RANGE frame")
        if ocol is None:
            raise SqlError("a RANGE frame needs ORDER BY inside OVER")
        kind = remap_r[kind]
    if kind in ("running_sum", "running_min", "running_max") \
            and ocol is None:
        kind = {"running_sum": "total_sum", "running_min": "total_min",
                "running_max": "total_max"}[kind]
    return kind


# ---------------------------------------------------------------------------
# typed values: a tensor (or U64) + SQL-ish type tag
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TV:
    """Typed value: tensor (or U64, or a host int for "bigint") + tag in
    {"u32","i32","f32","u64","bool","bigint"}. A u32 value is its int32
    bit-pattern plane. lit_value carries the host value of integer
    literals (mixed u32/i32 arithmetic retags nonnegative literals instead
    of bit-viewing a large u32 column as signed)."""
    arr: object
    tag: str
    lit_value: int | float | None = None


def _tag_of(col) -> str:
    if isinstance(col, U64):
        return "u64"
    return {torch.uint32: "u32", torch.int32: "i32", torch.float32: "f32",
            torch.bool: "bool"}[col.dtype]


def _plane(col):
    """A Table column as an expression value: u32 columns as their int32
    plane, every other column as it is."""
    return col.view(torch.int32) if (isinstance(col, torch.Tensor)
                                     and col.dtype == torch.uint32) else col


def _column(arr, tag: str):
    """An expression value as a Table column (the inverse of _plane)."""
    if tag == "u32" and arr.dtype == torch.int32:
        return from_plane(arr, torch.uint32)
    return arr


def _pow2_cap(g: int, n: int) -> int:
    c = 1
    while c < g:
        c <<= 1
    return min(c, n)


# Every read of a device value on the host waits for the device: each is
# one sql.sync span, so a traced query counts its synchronisations.

def _cpu(t: torch.Tensor) -> torch.Tensor:
    """t copied to the host: one synchronisation, traced as sql.sync."""
    with span("sql.sync"):
        return t.cpu()


def _int(t: torch.Tensor) -> int:
    """A 0-d device value read back as an int: one synchronisation,
    traced as sql.sync."""
    with span("sql.sync"):
        return int(t)


def _upload(key: U64, device: torch.device) -> U64:
    """Host planes copied to `device`: a copy from pageable memory waits
    for the device, so each plane is one sql.sync span."""
    def up(p):
        with span("sql.sync"):
            return p.to(device)
    return U64(up(key.lo), up(key.hi))


def _host(col) -> np.ndarray:
    """A device column read back as numpy (u32 as uint32, U64 as uint64
    from two copies, other tensors in their dtype)."""
    if isinstance(col, U64):
        return U64(_cpu(col.lo), _cpu(col.hi)).to_numpy()
    if col.dtype in DTYPES:
        return column_to_numpy(_cpu(col))
    return _cpu(col).numpy()


def _host_value(tv: TV, n: int) -> np.ndarray:
    """A row-level value broadcast to n rows and read back once: u32
    planes as numpy uint32, U64 as uint64, bool as bool."""
    if isinstance(tv.arr, U64):
        return _host(tv.arr)
    if not isinstance(tv.arr, torch.Tensor):
        raise SqlError("a u64 literal is not a row-level column")
    a = _cpu(tv.arr.expand(n) if tv.arr.dim() == 0 else tv.arr).numpy()
    return a.view(np.uint32) if tv.tag == "u32" else a


def _head_np(arr, g: int) -> np.ndarray:
    """The first g rows of a device column, read back (u32 columns come
    back as numpy uint32, U64 as uint64). The JAX package slices to a
    power-of-two cap first to bound its compile count; torch compiles
    nothing, so the slice is exactly g rows."""
    return _host(_slice(arr, 0, g))


def _sortable(arr, tag: str) -> torch.Tensor:
    """int32 plane whose unsigned order is the value order (the port of
    bits.sortable_u32 over tagged values; a bijection, so equality is
    preserved). Takes a value or a Table column."""
    if tag == "bool":
        return arr.to(torch.int32)
    if tag == "u32":
        return _plane(arr)
    if tag == "i32":
        return arr ^ SIGN_BIT
    b = arr.view(torch.int32)      # f32: IEEE total order
    return torch.where(b < 0, ~b, b ^ SIGN_BIT)


def _lift_key(col, tag: str) -> U64:
    """Injective map of any column type into a u64 key (order-preserving
    for 32-bit types via _sortable; equality-preserving always)."""
    if tag == "u64":
        return col
    b = _sortable(col, tag)
    return U64(b, torch.zeros_like(b))


def _unlift_key(lo: np.ndarray, tag: str) -> np.ndarray:
    """Host-side inverse of _lift_key's lo plane (numpy uint32) for 32-bit
    types."""
    if tag == "u32":
        return lo
    if tag == "i32":
        return (lo ^ np.uint32(0x80000000)).view(np.int32)
    if tag == "f32":
        was_positive = (lo >> 31) == 1
        return np.where(was_positive, lo ^ np.uint32(0x80000000),
                        ~lo).view(np.float32)
    raise SqlError(f"cannot invert key tag {tag}")


_HOST_GROUPS = NumpyOps(head=_head_np, unlift=_unlift_key)


def _shift_in(p: torch.Tensor) -> torch.Tensor:
    """p's rows shifted down one, row 0 taking ~p[0] (so it differs)."""
    return torch.cat([~p[:1], p[:-1]])


def _dense_group_ids(planes: tuple):
    """Dense lexicographic group ids for a composite key of ANY arity.

    ONE multi-plane stable sort (sort/planes.argsort_planes: the radix
    kernels on the card) + neighbor-compare segment boundaries number the
    distinct key tuples 0..G-1 in lexicographic plane order. The JAX
    package then sorts twice more: by position, to return each row's id in
    input order, and by first-occurrence position, to compact each group's
    first plane values to the head in id order. Those orders are an
    inverse permutation (a scatter) and a stable partition of the
    boundary rows here: the outputs depend only on the values, so they are
    the same bits.

    planes: tuple of int32 sortable planes (u64 columns contribute their
    hi and lo planes). Returns (gid int32 plane in input row order,
    compacted first-occurrence planes in id order, n_groups 0-d int64)."""
    from tpu_qe_torch.ops.filter import stable_partition
    from tpu_qe_torch.sort.planes import argsort_planes
    n = planes[0].shape[0]
    dev = planes[0].device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                tuple(p.clone() for p in planes),
                torch.zeros((), dtype=torch.int64, device=dev))
    spl, perm = argsort_planes(list(planes))
    newseg = torch.zeros(n, dtype=torch.bool, device=dev)
    for p in spl:
        newseg |= p != _shift_in(p)
    ids_sorted = (torch.cumsum(newseg, 0) - 1).to(torch.int32)
    gid = torch.empty_like(ids_sorted)
    gid[perm] = ids_sorted
    first = stable_partition(newseg)
    return gid, tuple(p[first] for p in spl), newseg.sum(dtype=torch.int64)


# ---------------------------------------------------------------------------
# expression evaluation (device, elementwise)
# ---------------------------------------------------------------------------

def _promote(a: TV, b: TV) -> str:
    for t in (a.tag, b.tag):
        if t in ("u64", "bigint"):
            raise SqlError("arithmetic on u64 values is not supported "
                           "(u64 columns serve as keys; compare/group/"
                           "join them instead)")
    if "f32" in (a.tag, b.tag):
        return "f32"
    if "i32" in (a.tag, b.tag) or "bool" in (a.tag, b.tag):
        return "i32"
    return "u32"


def _cast(v: TV, tag: str, n: int) -> torch.Tensor:
    """v as a tensor of `tag`'s dtype, 0-d literals broadcast to n rows.
    u32 -> i32 is a bit view (both are int32 planes); u32 -> f32 converts
    the unsigned value."""
    arr = v.arr
    if arr.dim() == 0:
        arr = arr.expand(n)
    if v.tag == "u32" and tag == "f32":
        return widen(arr).to(torch.float32)
    return arr.to(_DTYPE[tag])


class _RowEnv:
    """Column bindings for row-level expression evaluation."""

    def __init__(self, table: Table, names: dict, tags: dict,
                 device: torch.device, subqueries: dict | None = None):
        self.table = table          # physical Table
        self.names = names          # ref key -> physical column name
        self.tags = tags            # physical column name -> tag
        self.device = device        # where literals are built
        # id(InSelect) -> its subquery's column, evaluated (_InSide)
        self.subqueries = subqueries or {}

    def resolve(self, col: P.Col) -> str:
        k = col.key
        if k in self.names:
            return self.names[k]
        raise SqlError(f"unknown column {k!r} (known: "
                       f"{sorted(self.names)})")

    def col(self, col: P.Col) -> TV:
        phys = self.resolve(col)
        return TV(_plane(self.table[phys]), self.tags[phys])

    def lit(self, value, tag: str) -> torch.Tensor:
        """A 0-d literal of `tag`'s dtype on the env's device (u32 as its
        int32 bit pattern), so torch's type promotion never widens a
        column. Filled on the device: a host-to-device copy would wait for
        the work queued before it (the out-of-core runs queue theirs)."""
        if tag == "u32":
            value = value - (1 << 32) if value >= 1 << 31 else value
        return torch.full((), value, dtype=_DTYPE[tag], device=self.device)


def _eval_traced(e, env: _RowEnv, n: int) -> TV:
    """_eval of a top-level expression (WHERE, a select item, an
    aggregate argument), traced as sql.expr with its device time."""
    with span("sql.expr", device=env.device):
        return _eval(e, env, n)


def _eval(e, env: _RowEnv, n: int) -> TV:
    """Evaluate a scalar (non-aggregate, non-window) expression to a TV
    over the env's rows. Literals stay 0-d and broadcast lazily."""
    if isinstance(e, P.Lit):
        v = e.value
        if isinstance(v, float):
            return TV(env.lit(v, "f32"), "f32")
        if isinstance(v, int):
            if -(1 << 31) <= v < (1 << 31):
                return TV(env.lit(v, "i32"), "i32", lit_value=v)
            if 0 <= v < (1 << 32):
                return TV(env.lit(v, "u32"), "u32", lit_value=v)
            if 0 <= v < (1 << 64):
                # stays a host int: valid only against u64 columns
                return TV(v, "bigint")
            raise SqlError(f"integer literal {v} out of u64 range")
        raise SqlError("string literals are only supported in "
                       "comparisons against string-typed columns "
                       "(none exist in this engine)")
    if isinstance(e, P.Col):
        return env.col(e)
    if isinstance(e, P.Unary):
        v = _eval(e.operand, env, n)
        if e.op == "not":
            if v.tag != "bool":
                raise SqlError("NOT applied to a non-boolean")
            return TV(~v.arr, "bool")
        tag = "f32" if v.tag == "f32" else "i32"
        return TV(-_cast(v, tag, n), tag)
    if isinstance(e, P.Binary):
        return _eval_binary(e, env, n)
    if isinstance(e, P.Between):
        lo = P.Binary(">=", e.operand, e.lo)
        hi = P.Binary("<=", e.operand, e.hi)
        out = _eval(P.Binary("and", lo, hi), env, n)
        return TV(~out.arr, "bool") if e.negated else out
    if isinstance(e, P.InList):
        ors = None
        for item in e.items:
            t = P.Binary("=", e.operand, item)
            ors = t if ors is None else P.Binary("or", ors, t)
        out = _eval(ors, env, n)
        return TV(~out.arr, "bool") if e.negated else out
    if isinstance(e, P.InSelect):
        return _in_select(e, env, n)
    if isinstance(e, P.Case):
        default = (_eval(e.default, env, n) if e.default is not None
                   else TV(env.lit(0, "i32"), "i32"))
        tag = default.tag
        vals = []
        for cond, val in e.whens:
            tv = _eval(val, env, n)
            tag = _promote(TV(None, tag), TV(None, tv.tag))
            vals.append(tv)
        out = _cast(default, tag, n)
        # SQL CASE takes the FIRST matching WHEN: apply in reverse so
        # earlier arms overwrite later ones
        for (cond, _), tv in list(zip(e.whens, vals))[::-1]:
            c = _eval(cond, env, n)
            if c.tag != "bool":
                raise SqlError("CASE WHEN condition must be boolean")
            out = torch.where(c.arr, _cast(tv, tag, n), out)
        return TV(out, tag)
    if isinstance(e, P.Call):
        raise SqlError(f"misplaced call {e.func}(...) — aggregates need "
                       "GROUP BY context, window calls need OVER")
    raise SqlError(f"unsupported expression node {type(e).__name__}")


def _lag_args(c) -> tuple:
    """Validate LAG/LEAD(col [, offset [, default]]) arguments: returns
    (fill, offset)."""
    def lit(e, what):
        if isinstance(e, P.Lit):
            return e.value
        if isinstance(e, P.Unary) and e.op == "-" \
                and isinstance(e.operand, P.Lit):
            return -e.operand.value
        raise SqlError(f"{c.func} {what} must be a literal")
    off = 1
    fill = 0
    if len(c.args) >= 2:
        off = lit(c.args[1], "offset")
        if not isinstance(off, int):
            # int(1.5) would silently shift by 1 — reject instead
            raise SqlError(f"{c.func} offset must be an integer "
                           f"literal, got {off!r}")
    if len(c.args) >= 3:
        fill = lit(c.args[2], "default")
    if off < 1:
        raise SqlError(f"{c.func} offset must be >= 1, got {off}")
    if len(c.args) > 3:
        raise SqlError(f"{c.func} takes at most three arguments")
    return fill, off


def _u64_cmp(op: str, a: U64, b: U64) -> torch.Tensor:
    """Unsigned u64 comparison through the order-preserving int64 key."""
    return _CMP[op](signed_key(a.lo, a.hi), signed_key(b.lo, b.hi))


def _wide(t: TV, n: int) -> torch.Tensor:
    """A u32 or i32 value's exact int64 value, broadcast to n rows."""
    arr = t.arr.expand(n) if t.arr.dim() == 0 else t.arr
    return widen(arr) if t.tag == "u32" else arr.to(torch.int64)


def _divide(op: str, tag: str, x: torch.Tensor, y: torch.Tensor,
            y_lit) -> torch.Tensor:
    """Integer / and % with C semantics (truncate toward zero; the
    remainder takes the dividend's sign; u32 operands unsigned). A zero
    divisor reads as 1, so x / 0 = x and x % 0 = 0. INT_MIN / -1 wraps to
    INT_MIN with remainder 0, as in JAX.

    The division runs on exact int64 values and wraps back to 32 bits:
    int32 division of INT_MIN by -1 (and by 0) traps on the host. A
    literal divisor other than 0 and -1 cannot trap and divides the int32
    plane directly."""
    if tag == "i32" and y_lit is not None and y_lit not in (0, -1):
        y = y.to(torch.int32)
        return (torch.div(x, y, rounding_mode="trunc") if op == "/"
                else torch.fmod(x, y))
    if tag == "u32":
        x, y = widen(x), widen(y)
    else:
        x, y = x.to(torch.int64), y.to(torch.int64)
    y = torch.where(y == 0, 1, y)
    q = torch.div(x, y, rounding_mode="trunc")
    out = q if op == "/" else x - q * y
    return out.to(torch.int32)       # wraps mod 2^32


def _eval_binary(e: P.Binary, env: _RowEnv, n: int) -> TV:
    op = e.op
    a = _eval(e.left, env, n)
    b = _eval(e.right, env, n)
    if op in ("and", "or"):
        if a.tag != "bool" or b.tag != "bool":
            raise SqlError(f"{op.upper()} applied to non-booleans")
        return TV(a.arr & b.arr if op == "and" else a.arr | b.arr, "bool")

    if "u64" in (a.tag, b.tag):
        if op not in _CMP:
            raise SqlError("only comparisons are supported on u64 "
                           "columns")
        if a.tag != "u64" or b.tag != "u64":
            # literal side: lift a non-negative integer literal
            lit, col = (a, b) if a.tag != "u64" else (b, a)
            if lit.tag == "bigint":
                iv = int(lit.arr)
            elif lit.lit_value is not None:
                iv = int(lit.lit_value)
            elif lit.arr.dim() == 0:        # a constant expression
                iv = _int(widen(lit.arr) if lit.tag == "u32"
                          else lit.arr)
            else:
                raise SqlError("u64 columns compare against u64 "
                               "columns or integer literals")
            if iv < 0:
                raise SqlError("u64 compared against a negative literal")
            pair = U64(env.lit(iv & 0xFFFFFFFF, "u32"),
                       env.lit(iv >> 32, "u32"))
            a2, b2 = ((pair, col.arr) if a.tag != "u64"
                      else (col.arr, pair))
        else:
            a2, b2 = a.arr, b.arr
        return TV(_u64_cmp(op, a2, b2), "bool")

    if {a.tag, b.tag} == {"u32", "i32"}:
        # mixed signedness: bit-viewing a large u32 as i32 silently
        # corrupts comparisons/division (u > 5 empty for u >= 2^31).
        # A nonnegative int literal joins the u32 side losslessly;
        # otherwise comparisons go exact on the int64 values (arithmetic
        # keeps the documented mod-2^32 semantics).
        if a.tag == "i32" and a.lit_value is not None \
                and a.lit_value >= 0:
            a = TV(env.lit(a.lit_value, "u32"), "u32", a.lit_value)
        elif b.tag == "i32" and b.lit_value is not None \
                and b.lit_value >= 0:
            b = TV(env.lit(b.lit_value, "u32"), "u32", b.lit_value)
        elif op in _CMP:
            return TV(_CMP[op](_wide(a, n), _wide(b, n)), "bool")

    tag = _promote(a, b)
    x, y = _cast(a, tag, n), _cast(b, tag, n)
    if op in _CMP:
        if tag == "u32" and op not in ("=", "<>"):
            # unsigned order of the planes: flip the sign bits
            x, y = x ^ SIGN_BIT, y ^ SIGN_BIT
        return TV(_CMP[op](x, y), "bool")
    if op == "+":
        return TV(x + y, tag)
    if op == "-":
        return TV(x - y, tag)
    if op == "*":
        return TV(x * y, tag)
    if op in ("/", "%"):
        if tag == "f32":
            if op == "/":
                return TV(x / y, tag)
            q = torch.trunc(x / y)
            return TV(x - q * y, tag)
        return TV(_divide(op, tag, x, y, b.lit_value), tag)
    raise SqlError(f"unsupported operator {op!r}")


class _AggArgs:
    """The in-core resolver of aggregate arguments (sql/grouped.py's
    value_of): a plain column resolves through the row environment; an
    expression (SUM(a*b), COUNT(DISTINCT x % 5)) evaluates once to a
    synthetic device column."""

    def __init__(self, env: _RowEnv, n: int):
        self.env, self.n = env, n
        self.names: dict[str, str] = {}       # repr(expr) -> name
        self.cols: dict[str, object] = {}     # synthetic name -> column

    def __call__(self, arg) -> str:
        if isinstance(arg, P.Col):
            return self.env.resolve(arg)
        rep = repr(arg)
        if rep in self.names:
            return self.names[rep]
        if _calls(arg, window=False) or _calls(arg, window=True):
            raise SqlError("nested calls inside aggregate "
                           "arguments are not supported")
        tv = _eval_traced(arg, self.env, self.n)
        arr = tv.arr
        tag = tv.tag
        if tag == "bigint":
            raise SqlError("a u64 literal is only valid in a "
                           "comparison against a u64 column")
        if tag == "bool":
            arr, tag = arr.to(torch.int32), "u32"
        if not isinstance(arr, U64) and arr.dim() == 0:
            arr = arr.expand(self.n)
        nm = f"__aggexpr{len(self.names)}"
        self.names[rep] = nm
        self.cols[nm] = _column(arr, tag)
        self.env.tags[nm] = tag
        return nm

    def column(self, name: str):
        return self.cols[name] if name in self.cols \
            else self.env.table[name]


# ---------------------------------------------------------------------------
# result frames
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Frame:
    """Result columns + tags. Columns may be HOST numpy arrays
    (output-scale frames: group tables, set-op keys) or still-DEVICE
    Table columns (torch.uint32 for u32, torch.bool for bool, U64) from
    plain SELECTs; device columns stay on the device until `_materialize`,
    so ORDER BY / LIMIT run there and the readback is bounded by the LIMIT
    head rather than n."""
    cols: dict                   # name -> np array | tensor | U64
    tags: dict                   # name -> tag
    final: bool = False          # ORDER BY / LIMIT / OFFSET applied

    @property
    def num_rows(self) -> int:
        if not self.cols:
            return 0
        c = next(iter(self.cols.values()))
        return c.lo.shape[0] if isinstance(c, U64) else c.shape[0]


def _is_dev(col) -> bool:
    return isinstance(col, (U64, torch.Tensor))


def _materialize(fr: Frame) -> Frame:
    """Read every still-device column back to numpy with the JAX
    package's dtypes: uint32 for u32 columns, bool for the bool tag (also
    when it rode a sort as u32), int64 for i64sum pairs. Traced as
    sql.finish."""
    cols = {}
    with span("sql.finish"):
        for k, v in fr.cols.items():
            tag = fr.tags.get(k)
            if isinstance(v, U64):
                raw = _host(v)
                cols[k] = raw.view(np.int64) if tag == "i64sum" else raw
            elif isinstance(v, torch.Tensor):
                a = _host(v)
                cols[k] = a.astype(bool) if tag == "bool" else a
            else:
                cols[k] = v
    return Frame(cols, fr.tags)


def _resolve_order_name(fr: Frame, name: str) -> str:
    if name in fr.cols:
        return name
    # qualified ref vs auto-named output (t.id -> id), or bare ref vs a
    # qualified output column
    cands = [c for c in fr.cols
             if c == name.split(".")[-1] or c.split(".")[-1] == name]
    if len(cands) != 1:
        raise SqlError(f"ORDER BY column {name!r} is not in the "
                       f"result (columns: {sorted(fr.cols)})")
    return cands[0]


_DEV_SORT_TAGS = frozenset(["u32", "i32", "f32", "u64", "bool"])


def _slice(v, a: int, b: int | None):
    return U64(v.lo[a:b], v.hi[a:b]) if isinstance(v, U64) else v[a:b]


def _device_order_limit(fr: Frame, order_by, limit) -> Frame | None:
    """ORDER BY + LIMIT executed on the device (ops/orderby.sort_by_multi,
    one stable lexicographic sort) when every column is still on the
    device with a sortable tag; LIMIT heads are sliced there so only
    `limit` rows are read back. Returns None when the frame needs the host
    path (mixed host columns, i64 window outputs)."""
    if not all(_is_dev(v) and fr.tags.get(k) in _DEV_SORT_TAGS
               for k, v in fr.cols.items()):
        return None
    # bools ride the sort as u32 (the tag restores them)
    cols = {k: (v.to(torch.int32).view(torch.uint32)
                if not isinstance(v, U64) and v.dtype == torch.bool else v)
            for k, v in fr.cols.items()}
    if order_by:
        from tpu_qe_torch.ops.orderby import sort_by_multi
        by = []
        seen = set()
        for item in order_by:
            nm = _resolve_order_name(fr, item.col.key)
            if nm in seen:
                continue        # later duplicate keys cannot re-order
            seen.add(nm)
            by.append((nm, "desc" if item.desc else "asc"))
        t = sort_by_multi(Table(cols), by)
        cols = {k: t[k] for k in cols}
    if limit is not None:
        cols = {k: _slice(v, 0, limit) for k, v in cols.items()}
    return _materialize(Frame(cols, fr.tags))


def _frame_order_limit(fr: Frame, order_by, limit,
                       offset: int = 0) -> Frame:
    """ORDER BY + LIMIT [OFFSET]: on the device while the frame still is
    (row-scale results), else host np.lexsort (output-scale group
    frames). np.lexsort takes keys least-significant first (last key is
    primary), so the input-position key goes first (stable tie-break) and
    order items are appended in reverse. OFFSET fetches limit+offset rows
    and drops the head. The host path is traced as sql.finish."""
    eff = None if limit is None else limit + offset
    if (order_by or limit is not None) and any(
            _is_dev(v) for v in fr.cols.values()):
        out = _device_order_limit(fr, order_by, eff)
        if out is not None:
            if offset:
                out = Frame({k: v[offset:]
                             for k, v in out.cols.items()}, out.tags)
            return out
    fr = _materialize(fr)
    with span("sql.finish"):
        if order_by:
            keys = [np.arange(fr.num_rows)]
            for item in reversed(order_by):
                name = _resolve_order_name(fr, item.col.key)
                k = fr.cols[name]
                if item.desc:
                    if k.dtype == np.uint64:
                        k = np.iinfo(np.uint64).max - k
                    elif k.dtype.kind == "f":
                        k = -k.astype(np.float64)
                    else:
                        k = -(k.astype(np.int64))
                keys.append(k)
            perm = np.lexsort(keys)
            fr = Frame({k: v[perm] for k, v in fr.cols.items()}, fr.tags)
        if limit is not None:
            fr = Frame({k: v[offset:offset + limit]
                        for k, v in fr.cols.items()}, fr.tags)
    return fr


def _sortable_f64(f: torch.Tensor) -> torch.Tensor:
    """int64 whose order as unsigned bits is the order of the float64
    values f (-0.0 and 0.0 alike)."""
    b = (f + 0.0).view(torch.int64)
    return torch.where(b < 0, ~b, b ^ _I64_MIN)


def _order_planes(v: DArray) -> list:
    """int32 planes whose unsigned lexicographic order is the order of a
    device frame column's values (-0.0 and 0.0 tie, as in numpy)."""
    t, dt = v.t, v.dtype
    if dt.kind == "b":
        return [t.to(torch.int32)]
    if dt.kind == "f" and dt.itemsize == 4:
        return [_sortable(t + 0.0, "f32")]
    if dt.kind == "f":
        k = _sortable_f64(t)
    elif dt.itemsize <= 4:              # a 32-bit value in int64
        return [narrow(t if dt.kind == "u" else t + (1 << 31))]
    else:
        k = t if dt.kind == "u" else t ^ _I64_MIN
    return [narrow(k >> 32), narrow(k)]


def _device_group_order(cols: dict, tags: dict, q: P.Query) -> dict:
    """A device group frame's rows in q's ORDER BY (one stable sort of the
    keys' planes: the host frame's lexsort order), then its OFFSET and
    LIMIT, on the device."""
    fr, planes, seen = Frame(cols, tags), [], set()
    for item in q.order_by:
        nm = _resolve_order_name(fr, item.col.key)
        if nm in seen:
            continue            # later duplicate keys cannot re-order
        seen.add(nm)
        ps = _order_planes(cols[nm])
        planes += [~p for p in ps] if item.desc else ps
    end = None if q.limit is None else q.offset + q.limit
    if not planes:
        return {k: DArray(v.t[q.offset:end], v.dtype)
                for k, v in cols.items()}
    from tpu_qe_torch.sort.planes import argsort_planes
    idx = argsort_planes(planes)[1][q.offset:end]
    return {k: DArray(v.t[idx], v.dtype) for k, v in cols.items()}


def _read_rows(cols: dict) -> dict:
    """A device frame's columns read to the host in their numpy dtypes:
    one copy of all of them, as 64-bit words."""
    words = torch.stack([v.t.to(torch.float64).view(torch.int64)
                         if v.dtype.kind == "f" else v.t.to(torch.int64)
                         for v in cols.values()])
    out = {}
    for row, (nm, v) in zip(_cpu(words).numpy(), cols.items()):
        out[nm] = (row.view(np.float64).astype(v.dtype)
                   if v.dtype.kind == "f" else row != 0
                   if v.dtype.kind == "b" else row.astype(v.dtype))
    return out


# ---------------------------------------------------------------------------
# IN (SELECT ...): the subquery's column and the probe
# ---------------------------------------------------------------------------

_SUBQUERY_TIER = ("IN (SELECT ...) runs in the in-core tier only: {} does "
                  "not run subqueries")


@dataclasses.dataclass
class _InSide:
    """An IN's subquery, evaluated: its one column on the device (a tensor
    or U64 under a row-expression tag, or "i64" / "f64" for the int64 and
    float64 values of a grouped answer), and whether the column is sorted
    (a GROUP BY's key, which its HAVING kept in order)."""
    arr: object
    tag: str
    sorted: bool


def _in_column(col, tag: str) -> tuple:
    """A subquery frame's column as (values, tag) of _in_keys."""
    if isinstance(col, DArray):
        dt = col.dtype
        if dt == np.uint64:
            return U64(narrow(col.t), narrow(col.t >> 32)), "u64"
        if dt.kind in "iu" and dt.itemsize == 4:
            return narrow(col.t), "u32" if dt.kind == "u" else "i32"
        return col.t, {"b": "bool", "i": "i64", "f": "f32"
                       if dt.itemsize == 4 else "f64"}[dt.kind]
    if tag in ("i64sum", "u64sum"):         # a window's exact sum
        return (col.hi.to(torch.int64) << 32) | widen(col.lo), tag[:3]
    return _plane(col), tag


def _value64(arr, tag: str) -> tuple:
    """(int64 or float64 values, kind) of an IN side of any tag."""
    if tag == "u32":
        return widen(arr), "uint"
    if tag == "bool":
        return arr.to(torch.int64), "uint"
    if tag == "u64":
        return (arr.hi.to(torch.int64) << 32) | widen(arr.lo), "u64"
    if tag in ("i32", "i64"):
        return arr.to(torch.int64), "int"
    return arr.to(torch.float64), "float"


def _key64(k: torch.Tensor) -> U64:
    return U64(narrow(k), narrow(k >> 32))


def _in_keys(outer: tuple, sub: tuple) -> tuple:
    """u64 keys of both sides of an IN, equal where the values are (SQL's
    =), and a mask of the outer rows that can match (None: all): the
    lifted key where the tags agree, else each value in one domain."""
    (a, at), (b, bt) = outer, sub
    if at == bt and at in ("u32", "i32", "bool", "u64"):
        return _lift_key(a, at), _lift_key(b, bt), None
    (x, xk), (y, yk) = _value64(a, at), _value64(b, bt)
    ok = None
    if "float" in (xk, yk):         # as float64, -0.0 = 0.0
        def f64(v, kind):
            f = v.to(torch.float64)
            if kind == "u64":
                f = torch.where(v < 0, f + 2.0 ** 64, f)
            return _sortable_f64(f)
        x, y = f64(x, xk), f64(y, yk)
    elif "u64" in (xk, yk):         # as u64 bits
        if yk == "int":
            raise SqlError("IN (SELECT ...) compares u64 values with a "
                           "signed subquery column")
        if xk == "int":
            ok = x >= 0
    else:                           # as int64, in order
        x, y = x ^ _I64_MIN, y ^ _I64_MIN
    return _key64(x), _key64(y), ok


def _in_select(e: P.InSelect, env: _RowEnv, n: int) -> TV:
    """The IN's mask: each row's operand probed against the subquery's
    sorted column with E3's join index (kernels/join.join_index); a row is
    kept where it matched at least once."""
    from tpu_qe_torch.kernels.join import join_index
    from tpu_qe_torch.sort.planes import argsort_planes
    side = env.subqueries.get(id(e))
    if side is None:
        raise SqlError("IN (SELECT ...) is supported in WHERE only")
    tv = _eval(e.operand, env, n)
    if tv.tag == "bigint":
        raise SqlError("a u64 literal is only valid in a comparison "
                       "against a u64 column")
    arr = tv.arr
    if not isinstance(arr, U64) and arr.dim() == 0:
        arr = arr.expand(n)
    lk, rk, ok = _in_keys((arr, tv.tag), (side.arr, side.tag))
    if not side.sorted:
        (hi, lo), _ = argsort_planes([rk.hi, rk.lo])
        rk = U64(lo, hi)
    found = join_index(U64(lk.lo.contiguous(), lk.hi.contiguous()),
                       U64(rk.lo.contiguous(), rk.hi.contiguous())
                       ).count > 0
    return TV(found if ok is None else found & ok, "bool")


# ---------------------------------------------------------------------------
# Database
# ---------------------------------------------------------------------------

class Database:
    """Named-table registry + SQL entry point, on one device (the card
    unless the caller names another; a CUDA device without CUDA raises).

    >>> db = Database()
    >>> db.register("t", {"k": np.arange(8, dtype=np.uint32),
    ...                   "v": np.ones(8, np.float32)})
    >>> db.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    """

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._tables: dict[str, Table] = {}
        self._virtual: dict = {}       # name -> bigexec.VirtualTable

    def register(self, name: str, table) -> None:
        """Register a table: the JAX package's numpy dict (uint64, uint32,
        int32, float32 arrays), or a Table of this package on the
        Database's device."""
        if name.lower() in self._virtual:
            raise SqlError(f"{name!r} is already a virtual table")
        if not isinstance(table, Table):
            table = Table.from_numpy(table, device=self.device)
        for nm in table:
            c = table[nm]
            dev = (c.lo if isinstance(c, U64) else c).device
            if dev.type != self.device.type or (
                    (dev.index or 0) != (self.device.index or 0)):
                raise SqlError(f"column {nm!r} of table {name!r} lies on "
                               f"{dev}, the Database on {self.device}")
        self._tables[name.lower()] = table

    def register_virtual(self, name: str, n: int, columns: dict) -> None:
        """Register an out-of-core VIRTUAL table of n rows generated on the
        Database's device. Queries against it run through the out-of-core
        executor (sql/bigexec.py): one run of rows at a time, partial
        results only, the data never whole.

        Each column is a callable fn(idx) -> column. idx is the int32 bit
        plane of the u32 row indices (the house convention of
        hashing.murmur_fmix32 and keygen_hash: the index i >= 2^31 reads
        as i - 2^32). The callable returns a column the way a Table holds
        one, of idx's shape: torch.uint32 for u32 (table.from_plane of an
        int32 plane), torch.int32 for i32, torch.float32 for f32; the
        column's SQL type comes from that dtype. Anything else (U64,
        int64, bool, another shape) raises SqlError. A bare `lambda i: i`
        is therefore an i32 column that goes negative at 2^31: the u32 row
        index is `lambda i: table.from_plane(i, torch.uint32)`. torch's
        uint32 tensors reject +, %, >> and <, so a callable computes on
        the int32 plane (or on int64 values, bits.widen / bits.narrow) and
        views the result as uint32 at the end."""
        if name.lower() in self._tables:
            raise SqlError(f"{name!r} is already a registered table")
        from tpu_qe_torch.sql.bigexec import probe_virtual
        self._virtual[name.lower()] = probe_virtual(n, columns, self.device)

    def _virtual_of(self, q: P.Query):
        """The virtual table a query runs over: its first select's, or any
        side's of a set-op chain (bigexec._setop_big resolves every side
        itself); None for an in-core query."""
        vt = self._virtual.get(q.selects[0].table.name.lower())
        if vt is None and q.set_ops:
            for s in q.selects:
                vt = self._virtual.get(s.table.name.lower())
                if vt is not None:
                    break
        return vt

    def _plan(self, q: P.Query):
        """`q` with its comma-joined SELECTs planned into inner joins
        (sql/planner.py), and each SELECT's plan (None if unplanned).
        Traced as sql.plan where there is a comma join."""
        if not has_implicit_joins(q):
            return q, [None] * len(q.selects)
        tables = {}
        for s in q.selects:
            for ref in [s.table] + [j.table for j in s.joins]:
                nm = ref.name.lower()
                if nm in self._tables:
                    t = self._tables[nm]
                    tables[nm] = (t.num_rows, t.column_names)
                elif nm in self._virtual:
                    vt = self._virtual[nm]
                    tables[nm] = (vt.n, list(vt.columns))
        with span("sql.plan") as traced:
            q, plans = plan_query(q, tables)
            planned = [p for p in plans if p is not None]
            traced.count(joins=sum(p.joins for p in planned),
                         start_rows=sum(p.start_rows for p in planned))
        return q, plans

    def sql(self, query: str, mesh=None, run_size: int = 1 << 26,
            max_groups: int = 1 << 16, stats: dict | None = None) -> dict:
        """Run one SQL query; returns {column_name: numpy array}.

        run_size / max_groups apply to VIRTUAL (out-of-core) tables: rows
        per run and the per-run group-table bound (exact overflow
        detection: raise it if a query reports overflow); stats, if given,
        receives the out-of-core phase times.

        mesh: a LocalMesh or GroupMesh (exchange/mesh.py). Recognized query
        shapes execute through the distributed operator layer (exchange/),
        sharded over the mesh (see _sql_distributed); unrecognized shapes
        raise rather than silently falling back to one device.

        Traced as the root span sql.query."""
        with span("sql.query"):
            with span("sql.parse"):
                q = P.parse(query)
            q, plans = self._plan(q)
            vt = self._virtual_of(q)
            if (vt is not None or mesh is not None) and any(
                    P.in_selects(s) for s in q.selects):
                raise SqlError(_SUBQUERY_TIER.format(
                    "mesh= (the distributed tier)" if vt is None
                    else "the out-of-core tier (virtual tables)"))
            if vt is not None:
                if mesh is not None:
                    raise SqlError("mesh= with a virtual table is not "
                                   "supported (the out-of-core executor "
                                   "is single-chip; see ops/dbigagg for "
                                   "the distributed composition)")
                from tpu_qe_torch.sql.bigexec import select_big
                return select_big(vt, q, run_size=run_size,
                                  max_groups=max_groups, stats=stats,
                                  db=self)
            if mesh is not None:
                return self._sql_distributed(q, mesh)
            # one SELECT's grouped answer may take the query's ORDER BY
            # and LIMIT on the device (its frame is then final)
            tail = q if len(q.selects) == 1 else None
            frames = [self._select(s, p, tail)
                      for s, p in zip(q.selects, plans)]
            if len(frames) > 1:
                frames = [_materialize(f) for f in frames]
            fr = frames[0]
            for (op, all_), nxt in zip(q.set_ops, frames[1:]):
                fr = self._set_op(fr, nxt, op, all_)
            if not fr.final:
                fr = _frame_order_limit(fr, q.order_by, q.limit, q.offset)
            return dict(_materialize(fr).cols)

    def explain(self, query: str, mesh=None) -> str:
        """Plan audit: which tier and operator family one query maps to,
        WITHOUT executing anything. One line per plan step; the JAX
        package's text for its in-core, out-of-core and distributed
        tiers."""
        q, plans = self._plan(P.parse(query))
        sel = q.selects[0]
        vt = None
        for s in q.selects:
            vt = self._virtual.get(s.table.name.lower())
            if vt is not None:
                break
        has_aggs = self._has_aggs(sel) or sel.having is not None
        has_win = any(it.expr != "*" and _calls(it.expr, window=True)
                      for it in sel.items)
        lines = [f"join order: {' -> '.join(p.order)} (FROM's commas "
                 "planned: most rows first, then the fewest connected)"
                 for p in plans if p]

        def fin(tier, *steps):
            out = [f"tier: {tier}"]
            if sel.where is not None:
                out.append("where: device expression mask"
                           + (" (fused into each run program)"
                              if tier.startswith("out-of-core") else ""))
            out += list(steps) + lines
            if q.order_by and "order" not in " ".join(steps):
                where = "host G-bounded frame" if has_aggs else "device"
                out.append(f"order/limit: {where} lexsort"
                           + (f", limit {q.limit}" if q.limit
                              is not None else "")
                           + (f" offset {q.offset}" if q.offset else ""))
            return "\n".join(out)

        if vt is not None:
            tier, n_runs = "out-of-core (virtual table)", "ceil(n / run_size)"
            if q.set_ops:
                return fin(tier, "set-op chain: per-side per-run (key, "
                                 "count) compaction (bigexec._setop_big / "
                                 "ops/bigsetops shape) + host multiset "
                                 "algebra")
            if has_win:
                return fin(tier, "window: LIMIT-bounded prefix selection "
                                 f"(bigexec._topk_idx over {n_runs} runs) "
                                 "+ in-core window machinery over the "
                                 "candidates; whole-partition side channel "
                                 "via per-run partial aggregates")
            if sel.joins:
                if (len(sel.joins) == 1 and sel.joins[0].table.name
                        .lower() in self._virtual):
                    lines.append(
                        "join: virtual x virtual — both sides' (key, "
                        "index) planes sorted resident, key-space "
                        "bucket plan, per-bucket FK join carrying the "
                        "right row index, columns regenerated from "
                        "joined indices (bigexec._vv_agg_partials)")
                else:
                    lines.append("join: resident dimension threaded "
                                 "through every run program "
                                 "(bigexec._prep_join)")
            if sel.distinct:
                return fin(tier, "distinct: per-run dedup compaction "
                                 "(bigexec._distinct_big) + host unique")
            if sel.group_by or has_aggs:
                pct = any(c.func in _PCT_FUNCS for it in sel.items
                          if it.expr != "*"
                          for c in _calls(it.expr, window=False))
                return fin(tier,
                           f"aggregate: per-run partials over {n_runs}"
                           " runs (bigexec._agg_partials, G-bounded "
                           "readbacks) + exact host combine"
                           + ("; percentiles: segment-bounded device "
                              "bisection (_big_group_quantiles)"
                              if pct else ""))
            if q.order_by:
                return fin(tier, "order by: per-run top-(limit+offset) "
                                 "selection (bigexec._topk_idx) + host "
                                 "candidate combine")
            return fin(tier, "head: sequential run scans, early exit at "
                             "limit+offset rows (bigexec._head_big)")
        if mesh is not None:
            tier = f"distributed ({mesh.n_dev} devices)"
            if len(q.selects) > 1:
                return fin(tier, "set-op: distributed_set_op "
                                 "(exchange/dops)")
            if sel.distinct:
                return fin(tier, "distinct: count-only "
                                 "distributed_aggregate over packed "
                                 "keys (_dist_distinct)")
            if sel.joins:
                return fin(tier, "join+group: "
                                 "distributed_join_aggregate (fused "
                                 "two-exchange FK path)")
            if sel.group_by or has_aggs:
                k = len(sel.group_by)
                return fin(tier,
                           "aggregate: distributed_aggregate"
                           + (f" over a rank-packed {k}-column "
                              "composite key" if k > 1 else "")
                           + " (exchange/dops; percentiles via the "
                             "zero-row-movement bisection)")
            if has_win:
                return fin(tier, "window: distributed_window "
                                 "(exchange/dwindow: splitter "
                                 "exchange + carry chain + row halos)")
            return fin(tier, "order by: distributed_order_by "
                             "(exchange/dorderby)")
        if q.set_ops:
            lines.append("set-op chain: host multiset algebra over "
                         "materialized sides")
        if sel.joins:
            lines.append("join: ops/join scan-join (sort + segmented "
                         "sweeps, no gathers)")
        if sel.distinct:
            lines.append("distinct: device dedup (_distinct_frame)")
        if sel.group_by or has_aggs:
            k = len(sel.group_by)
            lines.append(
                "aggregate: group_aggregate_multi over "
                + ("a U64-packed key" if k <= 2
                   else f"dense group ids (_dense_group_ids, "
                        f"{k}-column composite)"))
        if has_win:
            lines.append("window: ops/window segmented sweeps (one "
                         "composite sort per (PARTITION BY, ORDER "
                         "BY) spec)")
        if not lines:
            lines.append("scan: device expression projection")
        return fin("in-core (device-resident)")

    # -- distributed execution (mesh=) ----------------------------------------
    def _sql_distributed(self, q: P.Query, mesh) -> dict:
        """Execute recognized query shapes through the distributed layer
        (exchange/dops, dquantile, dwindow, dorderby) over a mesh.

        Shapes (everything else raises — no silent one-device fallback):
          - set-op chains of plain single-column SELECTs
                                        -> distributed_set_op
          - GROUP BY 1..k columns + COUNT/SUM/MIN/MAX/AVG/
            COUNT(DISTINCT [u64])       -> distributed_aggregate /
                                           distributed_count_distinct
            (k >= 2 columns rank-pack into one u64 via _group_pack;
             u64 COUNT(DISTINCT) dictionary-ranks to dense u32)
          - SELECT DISTINCT col[, col]  -> count-only aggregate
                                           (_dist_distinct)
          - one inner JOIN + GROUP BY the join key, aggs over one right
            column                      -> distributed_join_aggregate
                                           (the fused two-exchange path)
          - top-level window calls over plain columns
                                        -> distributed_window
          - plain column SELECT + ORDER BY -> distributed_order_by
        GROUP BY aggregates, ORDER BY, and windows accept WHERE
        (device-evaluated mask + reserved-pad re-sharding: a pad GROUP
        key / pad PARTITION / direction-extreme ORDER rows — which also
        lifts the rows-divide-the-mesh restriction for those shapes);
        GROUP BY takes HAVING (evaluated on the replicated G-bounded
        group frame) and the ordered-set aggregates
        (PERCENTILE_DISC/CONT WITHIN GROUP, MEDIAN) via the
        zero-row-movement bisection. int32 SUM/MIN/MAX with negatives
        raise (the distributed aggregate combines u32 bit patterns —
        the signed-exact extension lives in the in-core path only).
        WHERE with JOIN pushes down to the referenced side's table
        scan (single-side predicates only).

        The shards live on the mesh's device; a Database on another
        device (a CUDA Database over a CPU mesh) is the caller's choice.
        """
        def unsup(what):
            return SqlError(f"{what} is not supported with mesh= "
                            "(distributed shapes: see _sql_distributed)")

        if len(q.selects) > 1:
            fr = self._dist_setop_chain(q, mesh)
            return dict(_frame_order_limit(fr, q.order_by, q.limit,
                                           q.offset).cols)
        sel = q.selects[0]
        if sel.having is not None and not (
                not sel.joins and (sel.group_by or self._has_aggs(sel))):
            raise unsup("HAVING outside GROUP BY aggregates")
        if sel.distinct:
            if sel.joins or sel.group_by or self._has_aggs(sel):
                raise unsup("SELECT DISTINCT with joins or aggregates")
            fr = self._dist_distinct(sel, mesh)
            return dict(_frame_order_limit(fr, q.order_by, q.limit,
                                           q.offset).cols)
        if sel.joins:
            fr = self._dist_join_agg(sel, mesh)
        elif sel.group_by or self._has_aggs(sel):
            fr = self._dist_group(sel, mesh)
        elif any(it.expr != "*" and _calls(it.expr, window=True)
                 for it in sel.items):
            fr = self._dist_window(sel, mesh)
        else:
            fr = self._dist_order_by(sel, q, mesh)
            return dict(Frame(
                {k: v[q.offset:(None if q.limit is None
                                else q.offset + q.limit)]
                 for k, v in fr.cols.items()}
                if q.limit is not None or q.offset else fr.cols,
                fr.tags).cols)
        return dict(_frame_order_limit(fr, q.order_by, q.limit,
                                       q.offset).cols)

    def _dist_table(self, ref: P.TableRef):
        """One registered table read back to host numpy columns (one
        device-to-host copy a column): the distributed SQL layer
        materializes host columns before re-sharding them onto the
        mesh."""
        t = self._tables.get(ref.name.lower())
        if t is None:
            raise SqlError(f"unknown table {ref.name!r}")
        cols = t.to_numpy()
        tags = {nm: _tag_of(t[nm]) for nm in t.column_names}
        return cols, tags

    @staticmethod
    def _plain_col(e, what="distributed select items") -> str:
        if not isinstance(e, P.Col):
            raise SqlError(f"{what} must be plain columns")
        return e.name

    def _dist_setop_chain(self, q: P.Query, mesh) -> Frame:
        from tpu_qe_torch.exchange.dops import distributed_set_op_numpy
        sides = []
        for sel in q.selects:
            if (sel.joins or sel.where is not None or sel.group_by
                    or len(sel.items) != 1 or sel.items[0].expr == "*"):
                raise SqlError("distributed set ops take plain "
                               "single-column SELECTs")
            cols, tags = self._dist_table(sel.table)
            nm = self._plain_col(sel.items[0].expr)
            out = sel.items[0].alias or nm
            sides.append((cols[nm], tags[nm], out))
        if len(sides) != 2:
            raise SqlError("distributed set ops take exactly two "
                           "selects (intermediate results do not "
                           "re-shard)")
        (acol, atag, aname) = sides[0]
        (bcol, btag, _) = sides[1]
        op, all_ = q.set_ops[0]
        if atag != btag:
            raise SqlError(f"set-op column dtypes differ ({atag} vs "
                           f"{btag}) — positional pairing would "
                           "silently promote")
        # ALL variants expand from the operator's exact per-key
        # (count_a, count_b) multiplicities: UNION ALL = ca+cb copies,
        # INTERSECT ALL = min(ca, cb), EXCEPT ALL = max(ca-cb, 0)
        # over the union key set (keys only in a keep ca copies)
        keys, ca, cb = distributed_set_op_numpy(
            _lift64_np(acol), _lift64_np(bcol), mesh,
            op="union" if all_ and op == "except" else op,
            capacity_factor="auto")
        if all_:
            if op == "union":
                reps = ca.astype(np.int64) + cb.astype(np.int64)
            elif op == "intersect":
                reps = np.minimum(ca, cb).astype(np.int64)
            else:
                reps = np.maximum(ca.astype(np.int64)
                                  - cb.astype(np.int64), 0)
            keys = np.repeat(keys, reps)
        return Frame({aname: _unlift64_np(np.sort(keys), acol.dtype)},
                     {aname: atag})

    def _agg_calls_of(self, sel: P.Select):
        calls = []
        for it in sel.items:
            if it.expr == "*":
                raise SqlError("SELECT * in a distributed aggregate")
            cs = _calls(it.expr, window=False)
            if cs and (len(cs) != 1 or cs[0] is not it.expr):
                raise SqlError("distributed aggregates must be "
                               "top-level select items")
            calls += cs
        if sel.having is not None:
            calls += _calls(sel.having, window=False)
        return calls

    def _where_mask(self, sel: P.Select) -> np.ndarray:
        """Distributed WHERE: the predicate is elementwise, so it runs
        through the device expression engine over the registered table
        and the boolean mask reads back once (the filtered frame then
        re-shards through the numpy wrappers)."""
        return self._where_mask_on(sel.table, sel.where)

    def _where_mask_on(self, ref: P.TableRef, where) -> np.ndarray:
        """Evaluate a boolean predicate over one registered table
        (device expression engine, one mask readback)."""
        table, names, tags = self._bind_table(ref)
        env = _RowEnv(table, names, tags, self.device)
        tv = _eval(where, env, table.num_rows)
        if tv.tag != "bool":
            raise SqlError("WHERE must be boolean")
        return _host_value(tv, table.num_rows)

    @staticmethod
    def _group_pack(cols: dict, tags: dict, gnames: list):
        """Pack 1..k group columns into ONE u64 key plane for the
        distributed exchanges (which move a single U64 key).

        One column lifts directly (order-preserving bit lift). Two or
        more columns RANK-PACK: per-column np.unique ranks in mixed
        radix, so the packed u64 orders lexicographically by column
        VALUES and decodes exactly. The distributed SQL layer
        materializes host columns before re-sharding (see _dist_table),
        so the host-side dictionary is within this layer's execution
        model. The all-ones u64 stays reserved for mesh padding: ranks
        multiply to < 2^63.

        Returns (gkey u64[n], unpack: sorted u64 keys -> {name: col}).
        """
        if len(gnames) == 1:
            nm = gnames[0]
            if cols[nm].dtype == np.bool_:
                def unpackb(gvals: np.ndarray) -> dict:
                    return {nm: gvals.astype(bool)}
                return cols[nm].astype(np.uint64), unpackb

            def unpack1(gvals: np.ndarray) -> dict:
                return {nm: _unlift64_np(gvals, cols[nm].dtype)}
            return _lift64_np(cols[nm]), unpack1
        uniqs, card = [], []
        gkey = None
        for nm in gnames:
            u, inv = np.unique(cols[nm], return_inverse=True)
            uniqs.append(u)
            card.append(max(len(u), 1))
            r = inv.astype(np.uint64)
            gkey = r if gkey is None \
                else gkey * np.uint64(card[-1]) + r
        prod = 1
        for c in card:
            prod *= c
        if prod >= (1 << 63):
            raise SqlError("GROUP BY cardinality product exceeds the "
                           "u64 composite key space — reduce the "
                           "number of group columns or their "
                           "cardinalities")

        def unpack(gvals: np.ndarray) -> dict:
            out, rem = {}, gvals.copy()
            for nm, u, c in zip(gnames[::-1], uniqs[::-1], card[::-1]):
                out[nm] = u[(rem % np.uint64(c)).astype(np.int64)]
                rem = rem // np.uint64(c)
            return out
        return gkey, unpack

    def _dist_group(self, sel: P.Select, mesh) -> Frame:
        from tpu_qe_torch.exchange.dops import (
            distributed_aggregate_numpy, distributed_count_distinct_numpy)
        cols, tags = self._dist_table(sel.table)
        if not sel.group_by:
            raise SqlError("distributed aggregates need GROUP BY")
        gnames = [g.name for g in sel.group_by]
        aliases = expr_aliases(sel)
        gexprs = []         # the expression each group column stands for
        for g, gname in zip(sel.group_by, gnames):
            if gname in cols:
                gexprs.append(g)
                continue
            if gname in aliases:
                # aliased group expression (GROUP BY v % 5 AS m,
                # sqlite-style): evaluate through the device engine
                # over the unfiltered table; the host column then
                # filters and packs like a physical one
                table, names, tags_ = self._bind_table(sel.table)
                env = _RowEnv(table, names, tags_, self.device)
                tv = _eval(aliases[gname], env, table.num_rows)
                cols[gname] = _host_value(tv, table.num_rows)
                tags[gname] = tv.tag
                gexprs.append(aliases[gname])
                continue
            raise SqlError(f"unknown column {gname!r}")
        PADKEY = int(np.uint64(0xFFFFFFFFFFFFFFFF))
        if sel.where is not None:
            # WHERE is elementwise: evaluate the mask through the
            # device expression engine, filter the host frame, and pad
            # back to a mesh multiple below
            mask = self._where_mask(sel)
            cols = {k: v[mask] for k, v in cols.items()}
        # the all-ones u64 key is RESERVED at this layer (results drop
        # it as the padding group; the quantile exchange uses it as the
        # distinct-key sentinel) — 32-bit group columns cannot produce
        # it (they lift with hi == 0), and rank-packed composites stay
        # below 2^63; reject it on a single u64 column rather than
        # silently dropping a real group. Checked AFTER the WHERE
        # filter: a query whose predicate removes every reserved-key
        # row is valid.
        if len(gnames) == 1 and tags[gnames[0]] == "u64" and bool(
                (cols[gnames[0]] == np.uint64(PADKEY)).any()):
            raise SqlError("u64 group keys may not use the reserved "
                           "max value 2^64-1 (distributed padding / "
                           "sentinel key)")
        gkey, unpack_groups = self._group_pack(cols, tags, gnames)
        # pad to a mesh multiple with the reserved group key (dropped
        # from the results). This also lifts the rows-divide-the-mesh
        # restriction.
        n_dev = mesh.n_dev
        n_pad = (-len(gkey)) % n_dev
        if n_pad or len(gkey) == 0:
            n_pad = n_pad if len(gkey) else n_dev
            gkey = np.concatenate(
                [gkey, np.full(n_pad, PADKEY, np.uint64)])
            cols = {k: np.concatenate([v, np.zeros(n_pad, v.dtype)])
                    for k, v in cols.items()}
        calls = self._agg_calls_of(sel)
        for c in calls:
            if c.func in _AGG_FUNCS and c.distinct and c.func != "count":
                raise SqlError("DISTINCT only inside COUNT()")
        plan = plan_aggregates(calls, self._plain_col)
        for vn, aggs in plan.aggspec.items():
            if tags[vn] == "u64":
                raise SqlError("aggregates over u64 columns are not "
                               "supported")
            if tags[vn] == "i32" and {"sum", "min", "max"} & set(aggs) \
                    and (cols[vn] < 0).any():
                raise SqlError(
                    "distributed SUM/MIN/MAX over int32 with negatives "
                    "is not supported (u32 bit-pattern combine); use "
                    "the local path or bias-map the column")
        if any(tags[vn] == "u64" for vn, _kind in plan.pct_specs):
            raise SqlError("percentiles over u64 columns are not "
                           "supported distributed")

        # one distributed_aggregate per value column; the count rides
        # the plan's count column (or a dedicated count when none)
        results: dict[int, dict] = {}
        for vn, aggs in plan.aggspec.items():
            res = distributed_aggregate_numpy(
                gkey, cols[vn], mesh, aggs=aggs, capacity_factor="auto")
            for k, row in res.items():
                dst = results.setdefault(k, {})
                for a, v in row.items():
                    dst[f"{vn}_{a}"] = v
        count_key = f"{plan.count_col}_count"
        if not plan.aggspec:
            count_key = "count"
            res = distributed_aggregate_numpy(
                gkey, np.zeros(len(gkey), np.uint32), mesh,
                aggs=("count",), capacity_factor="auto")
            for k, row in res.items():
                results.setdefault(k, {})["count"] = row["count"]
        for vn in plan.distinct:
            if tags[vn] == "u64":
                # dictionary-rank the u64 values to dense u32 on the
                # host (this layer already holds host columns):
                # COUNT(DISTINCT rank) == COUNT(DISTINCT value), and
                # ranks < n < 2^32 always fit the exchange's u32 plane
                _, inv_ = np.unique(_lift64_np(cols[vn]),
                                    return_inverse=True)
                bits = inv_.astype(np.uint32)
            elif tags[vn] == "u32":
                bits = cols[vn]
            else:
                bits = sortable_u32(torch.from_numpy(np.ascontiguousarray(
                    cols[vn]))).numpy().view(np.uint32)
            res = distributed_count_distinct_numpy(
                gkey, bits, mesh, capacity_factor="auto")
            for k, v in res.items():
                results.setdefault(k, {})[f"{vn}_count_distinct"] = v
        if plan.pct_specs:
            from tpu_qe_torch.exchange.dquantile import (
                QuantileOverflow, distributed_group_quantile_cont_numpy,
                distributed_group_quantile_numpy)
            for (vn, kind), qlist in plan.pct_specs.items():
                fn = (distributed_group_quantile_numpy if kind == "disc"
                      else distributed_group_quantile_cont_numpy)
                # the exact group count is already known from the
                # aggregate pass above (results covers every group incl.
                # the pad group): seed max_groups there so the retry
                # loop (kept as the exact-overflow backstop) never pays a
                # wasted execution
                mg = _pow2_cap(max(len(results), 1) + 1, 1 << 62)
                while True:
                    try:
                        res = fn(gkey, cols[vn], qlist, mesh,
                                 max_groups=mg)
                        break
                    except QuantileOverflow:
                        # only the exact-overflow signal retries with a
                        # larger cap; any other failure surfaces at once
                        if mg >= len(gkey):
                            raise
                        mg = min(mg * 4, max(len(gkey), 1))
                for k, v in res.items():
                    dst = results.setdefault(k, {})
                    for qi, val in enumerate(v):
                        dst[f"{vn}_{kind}_{qi}"] = val
        results.pop(PADKEY, None)     # the reserved padding group
        gvals = np.array(sorted(results), np.uint64)
        g = len(gvals)
        gcols_out = unpack_groups(gvals)

        # the G-bounded group frame, replicated on the host
        rows = [results[k] for k in gvals]
        aggs = {}
        for vn, specs in plan.aggspec.items():
            for a in specs:
                v = np.array([r[f"{vn}_{a}"] for r in rows])
                aggs[f"{vn}_{a}"] = (v.astype(cols[vn].dtype)
                                     if a in ("min", "max")
                                     and tags[vn] == "f32" else v)
        distinct = {vn: np.array([r[f"{vn}_count_distinct"] for r in rows],
                                 np.int64) for vn in plan.distinct}
        pct = {}
        for (vn, kind), qlist in plan.pct_specs.items():
            for qi in range(len(qlist)):
                v = np.array([r[f"{vn}_{kind}_{qi}"] for r in rows])
                pct[(vn, kind, qi)] = (v if kind == "cont"
                                       else v.astype(cols[vn].dtype))
        for it in sel.items:
            if not (isinstance(it.expr, P.Call) or it.alias in gnames
                    or isinstance(it.expr, P.Col)
                    and it.expr.name in gnames):
                raise SqlError("distributed aggregate items are the "
                               "group column or aggregate calls")
        if sel.having is not None:
            self._check_dist_having(sel.having, gnames)
        frame = GroupFrame(
            plan, g, [(c, e, gcols_out[c.name]) for c, e
                      in zip(sel.group_by, gexprs)],
            np.array([r[count_key] for r in rows], np.int64), aggs,
            distinct, pct)
        return Frame(*frame.select(sel))

    @staticmethod
    def _check_dist_having(e, gnames: list) -> None:
        """The HAVING shapes the mesh= tier evaluates on its group frame:
        aggregate calls, group columns, literals and NOT, negation and
        binary operators over them."""
        if isinstance(e, P.Col) and e.name not in gnames:
            raise SqlError(f"HAVING column {e.key!r} is not "
                           "a group column")
        if isinstance(e, P.Unary):
            Database._check_dist_having(e.operand, gnames)
        elif isinstance(e, P.Binary):
            Database._check_dist_having(e.left, gnames)
            Database._check_dist_having(e.right, gnames)
        elif not isinstance(e, (P.Call, P.Col, P.Lit)):
            raise SqlError("unsupported HAVING expression "
                           f"{type(e).__name__}")

    def _dist_distinct(self, sel: P.Select, mesh) -> Frame:
        """SELECT DISTINCT col[, col...] [WHERE ...]: the GROUP BY
        machinery with no aggregates — one count-only distributed
        aggregate over the packed key plane; only the G-bounded
        distinct key set returns (dedup IS the compression)."""
        from tpu_qe_torch.exchange.dops import distributed_aggregate_numpy
        cols, tags = self._dist_table(sel.table)
        gnames, outs = [], []
        for i, it in enumerate(sel.items):
            nm = self._plain_col(it.expr, "distributed DISTINCT items")
            if nm not in cols:
                raise SqlError(f"unknown column {nm!r}")
            if nm not in gnames:
                gnames.append(nm)
            outs.append((it.alias or nm, nm))
        if sel.where is not None:
            mask = self._where_mask(sel)
            cols = {k: v[mask] for k, v in cols.items()}
        PADKEY = int(np.uint64(0xFFFFFFFFFFFFFFFF))
        if len(gnames) == 1 and tags[gnames[0]] == "u64" and bool(
                (cols[gnames[0]] == np.uint64(PADKEY)).any()):
            raise SqlError("u64 DISTINCT keys may not use the reserved "
                           "max value 2^64-1 (distributed padding)")
        gkey, unpack_groups = self._group_pack(cols, tags, gnames)
        n_dev = mesh.n_dev
        n_pad = (-len(gkey)) % n_dev
        if n_pad or len(gkey) == 0:
            n_pad = n_pad if len(gkey) else n_dev
            gkey = np.concatenate(
                [gkey, np.full(n_pad, PADKEY, np.uint64)])
        res = distributed_aggregate_numpy(
            gkey, np.zeros(len(gkey), np.uint32), mesh,
            aggs=("count",), capacity_factor="auto")
        res.pop(PADKEY, None)
        gvals = np.array(sorted(res), np.uint64)
        gcols = unpack_groups(gvals)
        return Frame({on: gcols[nm] for on, nm in outs},
                     {on: str(gcols[nm].dtype) for on, nm in outs})

    def _dist_join_agg(self, sel: P.Select, mesh) -> Frame:
        from tpu_qe_torch.exchange.dops import (
            distributed_join_aggregate_numpy)
        if len(sel.joins) != 1 or sel.joins[0].how != "inner":
            raise SqlError("distributed joins: exactly one INNER JOIN")
        j = sel.joins[0]
        lcols, ltags = self._dist_table(sel.table)
        rcols, rtags = self._dist_table(j.table)
        lb, rb = sel.table.binding, j.table.binding

        def side_of(c: P.Col):
            if c.table == lb or (c.table is None and c.name in lcols
                                 and c.name not in rcols):
                return "l", c.name
            if c.table == rb or (c.table is None and c.name in rcols):
                return "r", c.name
            raise SqlError(f"cannot resolve {c.key!r}")

        ls, lkn = side_of(j.left_col)
        rs, rkn = side_of(j.right_col)
        if (ls, rs) == ("r", "l"):
            lkn, rkn = rkn, lkn
        if sel.where is not None:
            # WHERE pushes down to ONE side's table scan (SQL
            # semantics: filter before the inner join is equivalent
            # when the predicate references one side only); the mask
            # evaluates through the device expression engine over that
            # side and the filtered frame pads back below
            from tpu_qe_torch.sql.bigexec import _walk_cols
            wc: list = []
            _walk_cols(sel.where, wc)
            wsides = {side_of(c)[0] for c in wc}
            if len(wsides) != 1:
                raise SqlError(
                    "distributed WHERE with JOIN must reference one "
                    "side's columns only (single-side pushdown)")
            if wsides == {"l"}:
                mask = self._where_mask_on(sel.table, sel.where)
                lcols = {k: v[mask] for k, v in lcols.items()}
            else:
                mask = self._where_mask_on(j.table, sel.where)
                rcols = {k: v[mask] for k, v in rcols.items()}
        lkey, rkey = _lift64_np(lcols[lkn]), _lift64_np(rcols[rkn])
        if len(sel.group_by) != 1:
            raise SqlError("distributed join needs GROUP BY the join "
                           "key (the fused join->GROUP BY path)")
        gs, gn = side_of(sel.group_by[0])
        if gs != "l" or gn != lkn:
            raise SqlError("distributed join aggregates GROUP BY the "
                           "LEFT join key")
        calls = self._agg_calls_of(sel)
        vcols = set()
        aggs = set()
        for c in calls:
            if c.distinct:
                raise SqlError("COUNT(DISTINCT) is not supported in the "
                               "distributed fused join")
            if c.func == "count":
                aggs.add("count")
                continue
            s, vn = side_of(c.args[0]) if c.args and isinstance(
                c.args[0], P.Col) else (None, None)
            if s != "r":
                raise SqlError("distributed fused join aggregates RIGHT "
                               "value columns")
            vcols.add(vn)
            aggs.update({"avg": {"sum", "count"}}.get(c.func, {c.func}))
        if len(vcols) != 1:
            raise SqlError("distributed fused join takes exactly one "
                           "right value column")
        vn = vcols.pop()
        if rtags[vn] == "i32" and ({"sum", "min", "max"} & aggs) \
                and (rcols[vn] < 0).any():
            raise SqlError("distributed SUM/MIN/MAX over int32 with "
                           "negatives is not supported")
        # the fused path is the FK join: the straddler-broadcast bound
        # (n_dev-1 slots) holds only for unique right keys, and SQL's
        # one-to-many JOIN semantics differ from FK pick-one anyway —
        # detect the shape here rather than overflow inside the exchange
        if len(np.unique(rcols[rkn])) != len(rcols[rkn]):
            raise SqlError("distributed fused join requires unique "
                           "right join keys (the FK/dimension shape)")
        aggs.add("count")
        # pad both sides to a mesh multiple (lifts the rows-divide-the-
        # mesh restriction; WHERE makes lengths arbitrary). Left pads
        # share ONE reserved key; right pads get DISTINCT reserved keys
        # (the exchange requires unique right keys). 32-bit join keys
        # lift with hi == 0 and can never collide with the reserved top
        # band; u64 keys inside the band raise rather than alias.
        n_dev = mesh.n_dev
        TOP = np.uint64(0xFFFFFFFFFFFFFFFF)
        band_lo = TOP - np.uint64(n_dev)
        for kk, tg in ((lkey, ltags[lkn]), (rkey, rtags[rkn])):
            if tg == "u64" and bool((kk > band_lo).any()):
                raise SqlError("u64 join keys may not use the top "
                               f"{n_dev + 1} values (reserved for "
                               "distributed mesh padding)")
        lpad = (-len(lkey)) % n_dev if len(lkey) else n_dev
        rpad = (-len(rkey)) % n_dev if len(rkey) else n_dev
        rv = np.asarray(rcols[vn])
        if lpad:
            lkey = np.concatenate([lkey, np.full(lpad, TOP, np.uint64)])
        if rpad:
            rkey = np.concatenate(
                [rkey, TOP - np.uint64(1)
                 - np.arange(rpad, dtype=np.uint64)])
            rv = np.concatenate([rv, np.zeros(rpad, rv.dtype)])
        res = distributed_join_aggregate_numpy(
            lkey, rkey, rv, mesh, aggs=tuple(sorted(aggs)),
            capacity_factor="auto")
        gvals = np.array(sorted(res), np.uint64)

        def col_of(c: P.Call):
            if c.func == "count":
                return np.array([res[k]["count"] for k in gvals],
                                np.int64)
            if c.func == "avg":
                s = np.array([res[k]["sum"] for k in gvals], np.float64)
                n = np.array([res[k]["count"] for k in gvals],
                             np.float64)
                return s / np.maximum(n, 1)
            return np.array([res[k][c.func] for k in gvals])

        out, otags = {}, {}
        for i, it in enumerate(sel.items):
            name = it.alias or _auto_name(it.expr, i)
            if isinstance(it.expr, P.Col):
                out[name] = _unlift64_np(gvals, lcols[lkn].dtype)
            elif isinstance(it.expr, P.Call):
                out[name] = col_of(it.expr)
            else:
                raise SqlError("distributed join items are the group "
                               "column or aggregate calls")
            otags[name] = str(out[name].dtype)
        return Frame(out, otags)

    def _dist_window(self, sel: P.Select, mesh) -> Frame:
        from tpu_qe_torch.exchange.dwindow import distributed_window_numpy
        cols, tags = self._dist_table(sel.table)
        if sel.where is not None:
            # WHERE before windows is SQL semantics; the filtered frame
            # pads back to a mesh multiple below with a RESERVED pad
            # partition (hi != 0 — 32-bit partition keys cannot collide),
            # so real partitions' carry chains never see pad rows and
            # the pad outputs trim off the tail
            mask = self._where_mask(sel)
            cols = {k: v[mask] for k, v in cols.items()}
        funcs, values, plain = {}, {}, []
        i64names: set = set()
        spec = None
        for i, it in enumerate(sel.items):
            if it.expr == "*":
                raise SqlError("SELECT * with distributed windows")
            name = it.alias or _auto_name(it.expr, i)
            if isinstance(it.expr, P.Col):
                plain.append((name, it.expr.name))
                continue
            c = it.expr
            if not (isinstance(c, P.Call) and c.window is not None):
                raise SqlError("distributed window items are plain "
                               "columns or window calls")
            if len(c.window.partition_by) != 1:
                raise SqlError("distributed windows partition by one "
                               "column")
            key = (c.window.partition_by[0].name,
                   c.window.order_by.name if c.window.order_by else None)
            if spec is None:
                spec = key
            elif spec != key:
                # whole-partition calls (no ORDER BY) may ride an
                # ordered spec over the same partition column — their
                # kinds are order-independent
                if key[0] == spec[0] and (key[1] is None
                                          or spec[1] is None):
                    if spec[1] is None:
                        spec = key
                else:
                    raise SqlError("distributed windows share one "
                                   "(PARTITION BY, ORDER BY) spec")
            fr = c.window.frame_rows
            if c.window.frame_range not in (None, "unbounded"):
                raise SqlError("bounded RANGE frames are in-core only "
                               "(an order-VALUE bound reaches back an "
                               "unbounded number of rows — no finite "
                               "row halo covers it)")
            # the shared in-core kind resolver: frames, whole-partition
            # (total_*) remaps, COUNT<->row_number/partition_count,
            # AVG's moving/running/total split — all supported by the
            # dwindow chain (total carries + offset-k halos)
            kind = _window_kind(c)
            if kind in ("row_number", "rank", "dense_rank",
                        "percent_rank", "partition_count"):
                funcs[name] = (kind,)
            elif kind == "moving_count":
                funcs[name] = (kind, None if fr is None else fr + 1,
                               c.window.frame_follow or 0)
            elif kind == "ntile":
                funcs[name] = (kind, int(c.args[0].value))
            else:
                vn = self._plain_col(c.args[0], "window arguments")
                values[vn] = cols[vn]
                if kind in ("lag", "lead"):
                    fill, off = _lag_args(c)
                    funcs[name] = (kind, vn, fill, off)
                elif kind.startswith("moving_"):
                    fo = c.window.frame_follow
                    funcs[name] = (
                        (kind, vn, None if fr is None else fr + 1, fo)
                        if fo else (kind, vn, fr + 1))
                elif kind.startswith("range_"):
                    funcs[name] = (kind, vn, "unbounded")
                else:
                    funcs[name] = (kind, vn)
                if kind in ("running_sum", "moving_sum", "total_sum",
                            "range_sum") \
                        and tags[vn] == "i32":
                    # sign-extended pair sums come back as u64 bit
                    # patterns — resolve to two's-complement i64 at
                    # emission (matches the local path's i64sum tag)
                    i64names.add(name)
        if spec is None:
            raise SqlError("no window calls found")
        pname, oname = spec
        PADKEY = np.uint64(0xFFFFFFFFFFFFFFFF)
        pkey = _lift64_np(cols[pname])
        if tags[pname] == "u64" and bool((pkey == PADKEY).any()):
            raise SqlError("u64 partition keys may not use the "
                           "reserved max value 2^64-1")
        n_dev = mesh.n_dev
        m = len(pkey)
        n_pad = (-m) % n_dev if m else n_dev
        if n_pad:
            pkey = np.concatenate([pkey,
                                   np.full(n_pad, PADKEY, np.uint64)])
            values = {k: np.concatenate([v, np.zeros(n_pad, v.dtype)])
                      for k, v in values.items()}
        order = None if oname is None else cols[oname]
        if n_pad and order is not None:
            order = np.concatenate([order,
                                    np.zeros(n_pad, order.dtype)])
        res = distributed_window_numpy(
            pkey, funcs, mesh, order=order,
            values=values, capacity_factor="auto")
        out, otags = {}, {}
        for i, it in enumerate(sel.items):
            name = it.alias or _auto_name(it.expr, i)
            if isinstance(it.expr, P.Col):
                out[name] = cols[it.expr.name]
            else:
                # pad-partition outputs sit at the input-order tail
                v = res[name][:m] if n_pad else res[name]
                if name in i64names:
                    v = v.view(np.int64)
                out[name] = v
            otags[name] = str(out[name].dtype)
        return Frame(out, otags)

    @staticmethod
    def _order_pad_extreme(dtype, desc: bool) -> np.ndarray:
        """One row of the value that sorts LAST under the given direction
        — pads built from it land at the global tail of the distributed
        ORDER BY (their transformed planes are all-ones and their input
        positions exceed every real row's, so the stability tie-break
        keeps them strictly after any equal real row). A float32 pad is a
        NaN bit pattern built as uint32 and viewed: float arithmetic on
        it could canonicalize the NaN and move it ahead of a real row."""
        if dtype == np.uint32:
            return np.array([0 if desc else 0xFFFFFFFF], np.uint32)
        if dtype == np.int32:
            return np.array([-(1 << 31) if desc else (1 << 31) - 1],
                            np.int32)
        if dtype == np.float32:
            bits = 0xFFFFFFFF if desc else 0x7FFFFFFF   # -NaN / +NaN
            return np.array([bits], np.uint32).view(np.float32)
        if dtype == np.uint64:
            return np.array([0 if desc else 0xFFFFFFFFFFFFFFFF], np.uint64)
        raise SqlError(f"ORDER BY over unsupported dtype {dtype}")

    def _dist_order_by(self, sel: P.Select, q: P.Query, mesh) -> Frame:
        from tpu_qe_torch.exchange.dorderby import distributed_order_by_numpy
        cols, tags = self._dist_table(sel.table)
        sel_names = []
        for i, it in enumerate(sel.items):
            if it.expr == "*":
                sel_names += [(nm, nm) for nm in sorted(cols)]
                continue
            nm = self._plain_col(it.expr)
            sel_names.append((it.alias or nm, nm))
        if not q.order_by:
            raise SqlError("distributed plain SELECT needs ORDER BY "
                           "(it IS the distributed operator)")
        by = [(item.col.name, "desc" if item.desc else "asc")
              for item in q.order_by]
        if sel.where is not None:
            mask = self._where_mask(sel)
            cols = {k: v[mask] for k, v in cols.items()}
        need = {src for _, src in sel_names} | {b[0] for b in by}
        # pad to a mesh multiple with rows that sort strictly last
        # (also lifts the rows-divide-the-mesh restriction here)
        n_dev = mesh.n_dev
        m = len(next(iter(cols.values())))
        n_pad = (-m) % n_dev if m else n_dev
        if n_pad:
            dirs = dict(by)

            def pad_col(nm):
                c = cols[nm]
                if nm in dirs:
                    # np.repeat copies the pad's bytes (NaN payloads too)
                    return np.repeat(self._order_pad_extreme(
                        c.dtype, dirs[nm] == "desc"), n_pad)
                return np.zeros(n_pad, c.dtype)
            cols = {nm: np.concatenate([cols[nm], pad_col(nm)])
                    for nm in cols}
        st, _pos = distributed_order_by_numpy(
            {nm: cols[nm] for nm in need}, by, mesh,
            capacity_factor="auto")
        if n_pad:
            st = {nm: v[:-n_pad] for nm, v in st.items()}
        return Frame({out: st[src] for out, src in sel_names},
                     {out: tags[src] for out, src in sel_names})

    # -- FROM/JOIN ----------------------------------------------------------
    def _bind_table(self, ref: P.TableRef, keep=None):
        """The table's columns (those in `keep`, if given) as the
        physical columns of `binding.column` and their bare names."""
        t = self._tables.get(ref.name.lower())
        if t is None:
            raise SqlError(f"unknown table {ref.name!r}")
        phys, names, tags = {}, {}, {}
        for c in t.column_names:
            if keep is not None and c not in keep:
                continue
            pname = f"{ref.binding}.{c}"
            phys[pname] = t[c]
            names[pname] = pname
            names.setdefault(c, pname)
            tags[pname] = _tag_of(t[c])
        return Table(phys), names, tags

    def _from_clause(self, sel: P.Select, keep=None):
        """The joined rows of sel's FROM; `keep` (a plan's) names the
        columns to carry of each binding."""
        from tpu_qe_torch.ops import join as J
        keep = keep or {}
        table, names, tags = self._bind_table(sel.table,
                                              keep.get(sel.table.binding))
        ambiguous: set[str] = set()
        for j in sel.joins:
            rt, rnames, rtags = self._bind_table(j.table,
                                                 keep.get(j.table.binding))
            # resolve keys: left from current env, right from the new one
            lenv = _RowEnv(table, names, tags, self.device)
            renv = _RowEnv(rt, rnames, rtags, self.device)
            try:
                ltv = lenv.col(j.left_col)
                rtv = renv.col(j.right_col)
            except SqlError:
                # ON u.k = t.k — SQL accepts either operand order
                ltv = lenv.col(j.right_col)
                rtv = renv.col(j.left_col)
            # lifted u64 join keys ride as a temp column through the
            # operator (dropped from the output below)
            lt = table.with_column("__sqlkey", _lift_key(ltv.arr, ltv.tag))
            rt2 = rt.with_column("__sqlkey", _lift_key(rtv.arr, rtv.tag))
            # the executor reads the output count, so it holds the span
            with span("ops.join", device=self.device,
                      rows_left=table.num_rows,
                      rows_right=rt.num_rows) as traced:
                if j.how == "inner":
                    # one read of the exact totals sizes the output before
                    # any slot is written; where every left row matched
                    # once the left columns pass through uncopied
                    probe = J.join_inner_index(lt, rt2, key="__sqlkey")
                    num, nonunit = _cpu(probe.index.totals).tolist()
                    out, passthrough = J.join_inner_rows(
                        lt, probe, num, nonunit, key="__sqlkey")
                    valid_n, matched = num, None
                    traced.count(passthrough=int(passthrough))
                else:
                    budget = max(table.num_rows, rt.num_rows, 16)
                    while True:
                        # exact-count overflow-retry discipline: num_out
                        # is exact even past the budget, so one readback
                        # decides the rerun
                        res = J.join_outer(lt, rt2, key="__sqlkey",
                                           how=j.how, out_budget=budget)
                        matched = res.matched
                        num = _int(res.num_out)
                        if num <= budget:
                            out, valid_n = res.table.drop("__sqlkey"), num
                            break
                        budget = max(2 * budget, num)
                traced.count(rows_out=num)
            # merge environments; clashes become ambiguous bare names
            newnames = dict(names)
            for k, v in rnames.items():
                if "." not in k and k in newnames:
                    ambiguous.add(k)
                    continue
                newnames[k] = v
            newtags = dict(tags)
            newtags.update(rtags)
            cols = {pname: out[pname] for pname in set(newnames.values())}
            if matched is not None:
                # NULL surface: right columns of unmatched left rows are
                # zero-filled by the operator; the mask column lets
                # queries distinguish real zeros (COALESCE semantics)
                mname = f"{j.table.binding}__matched"
                cols[mname] = _u32_flag(matched)
                newnames[mname] = mname
                newtags[mname] = "u32"
            if j.how == "full":
                # right-only rows: real right side, NULL (zero) left side
                # — appended below the left-expanded section, with
                # __left_matched marking which side is real per row
                ro, n_ro = res.right_only, _int(res.num_right_only)
                cols2 = {}
                for pname, c in cols.items():
                    if pname == mname:
                        rr = _u32_flag(torch.ones(n_ro, dtype=torch.bool,
                                                  device=self.device))
                    elif pname in ro:
                        rr = _slice(ro[pname], 0, n_ro)
                    else:
                        rr = J._zero_column(c, n_ro, self.device)
                    if isinstance(c, U64):
                        cols2[pname] = U64(
                            torch.cat([c.lo[:valid_n], rr.lo]),
                            torch.cat([c.hi[:valid_n], rr.hi]))
                    else:
                        cols2[pname] = torch.cat([c[:valid_n], rr])
                lm = "__left_matched"
                cols2[lm] = _u32_flag(torch.arange(
                    valid_n + n_ro, device=self.device) < valid_n)
                newnames[lm] = lm
                newtags[lm] = "u32"
                cols = cols2
                valid_n = valid_n + n_ro
            table = Table(cols)
            names, tags = newnames, newtags
            # slice to the exact output rows (host boundary: num_out was
            # already read back for the overflow check)
            table = table.head(valid_n) if j.how != "full" else table
        for a in ambiguous:
            names.pop(a, None)
        return table, names, tags

    # -- SELECT core ----------------------------------------------------------
    def _select(self, sel: P.Select, plan=None, tail=None,
                keep: bool = False) -> Frame:
        """sel's answer. tail: the query, where its ORDER BY and LIMIT
        apply to this SELECT alone; keep: sel is an IN's subquery, whose
        answer stays on the device (DISTINCT left out: the probe ignores
        duplicates). Each IN (SELECT ...) of the WHERE runs first, once."""
        subqueries = {}
        nodes = P.in_selects(sel)
        if nodes:
            where = P.in_selects(sel.where)
            if len(where) != len(nodes):
                raise SqlError("IN (SELECT ...) is supported in WHERE only")
            subqueries = {id(nd): self._subquery(nd, sel) for nd in where}
        with span("sql.from"):
            table, names, tags = self._from_clause(
                sel, plan.keep if plan else None)
        env = _RowEnv(table, names, tags, self.device, subqueries)
        n = table.num_rows

        if sel.where is not None:
            tv = _eval_traced(sel.where, env, n)
            if tv.tag != "bool":
                raise SqlError("WHERE must be boolean")
            from tpu_qe_torch.ops.filter import compact
            mask = tv.arr.expand(n) if tv.arr.dim() == 0 else tv.arr
            # the executor reads the kept count, so it holds the span
            with span("ops.compact", rows_in=n) as traced:
                ct, cnt = compact(table, mask)
                k = _int(cnt)
                traced.count(rows_kept=k)
            table = ct.head(k)
            env = _RowEnv(table, names, tags, self.device)
            n = k

        if sel.group_by or self._has_aggs(sel):
            fr = self._grouped(sel, env, n, None if sel.distinct else tail,
                               keep)
        else:
            fr = self._plain(sel, env, n)
        if sel.distinct and not keep:
            fr = self._distinct_frame(fr)
        return fr

    def _names_of(self, sel: P.Select) -> set:
        """The column references sel's FROM binds (bare and qualified)."""
        out = set()
        for ref in [sel.table] + [j.table for j in sel.joins]:
            t = self._tables.get(ref.name.lower())
            for c in t.column_names if t is not None else ():
                out |= {c, f"{ref.binding}.{c}"}
        return out

    def _subquery(self, node: P.InSelect, outer: P.Select) -> _InSide:
        """An IN's subquery, run once through the in-core path; its one
        column stays on the device. Traced as sql.subquery, with its device
        time."""
        sub = node.select
        for ref in [sub.table] + [j.table for j in sub.joins]:
            if ref.name.lower() in self._virtual:
                raise SqlError(_SUBQUERY_TIER.format(
                    "the out-of-core tier (virtual tables)"))
        own, outer_names = self._names_of(sub), self._names_of(outer)
        aliases = {it.alias for it in sub.items if it.alias}
        for c in sorted(column_refs(sub), key=lambda c: c.key):
            if c.key not in own and c.key not in aliases \
                    and c.key in outer_names:
                raise SqlError(f"correlated subquery: IN (SELECT ...) "
                               f"names {c.key!r} of the outer query; only "
                               "an uncorrelated subquery is supported")
        q, (plan,) = self._plan(P.Query((sub,), (), (), None))
        with span("sql.subquery", device=self.device):
            fr = self._select(q.selects[0], plan, keep=True)
            ((name, col),) = fr.cols.items()
            arr, tag = _in_column(col, fr.tags[name])
        # a lone GROUP BY column, selected, comes out in its key's order
        return _InSide(arr, tag, sub.group_by == (sub.items[0].expr,))

    @staticmethod
    def _has_aggs(sel: P.Select) -> bool:
        for it in sel.items:
            if it.expr == "*":
                continue
            if _calls(it.expr, window=False):
                return True
        return False

    # -- plain (non-aggregate) SELECT -----------------------------------------
    def _plain(self, sel: P.Select, env: _RowEnv, n: int) -> Frame:
        # window calls first: one ops/window call per (partition, order)
        # spec computes every requested function in one composite sort.
        # Columns stay ON THE DEVICE here — _frame_order_limit runs ORDER
        # BY / LIMIT there and _materialize draws the readback boundary
        # at output scale (LIMIT heads read `limit` rows, not n).
        wcols = self._window_columns(sel, env, n)
        cols, tags = {}, {}
        for i, it in enumerate(sel.items):
            if it.expr == "*":
                # every physical column exactly once: the bare name
                # where it is unambiguous, else the qualified ref (SQL
                # * after a join returns BOTH sides' columns — incl.
                # the join key, whose bare name is ambiguous)
                bare = {phys for ref, phys in env.names.items()
                        if "." not in ref}
                for ref, phys in sorted(env.names.items()):
                    if ("." in ref) == (phys in bare):
                        continue
                    cols[ref] = env.table[phys]
                    tags[ref] = env.tags[phys]
                continue
            name = it.alias or _auto_name(it.expr, i)
            if id(it.expr) in wcols:
                cols[name], tags[name] = wcols[id(it.expr)]
                continue
            tv = _eval_traced(it.expr, env, n)
            arr = tv.arr
            if tv.tag == "bigint":
                raise SqlError("a u64 literal is only valid in a "
                               "comparison against a u64 column")
            if not isinstance(arr, U64) and arr.dim() == 0:
                arr = arr.expand(n)
            cols[name] = _column(arr, tv.tag)
            tags[name] = tv.tag
        return Frame(cols, tags)

    @staticmethod
    def _window_columns(sel: P.Select, env: _RowEnv, n: int) -> dict:
        """Evaluate every windowed call in the select list; returns
        {id(Call): (column, tag)} keyed by AST node identity."""
        calls = []
        for it in sel.items:
            if it.expr == "*":
                continue
            for c in _calls(it.expr, window=True):
                if c is not it.expr:
                    raise SqlError("window calls must be top-level "
                                   "select items (no arithmetic around "
                                   "them yet)")
                calls.append(c)
        if not calls:
            return {}
        from tpu_qe_torch.ops.window import window as run_window
        out = {}
        # group calls by (partition cols, order col) — each distinct spec
        # is one device window program
        by_spec: dict = {}
        for c in calls:
            key = (tuple(col.key for col in c.window.partition_by),
                   c.window.order_by.key if c.window.order_by else None)
            by_spec.setdefault(key, []).append(c)
        for (pcols, ocol), cs in by_spec.items():
            if not pcols:
                raise SqlError("OVER () without PARTITION BY is not "
                               "supported")
            ptvs = [env.col(P.Col(*reversed(p.split("."))) if "." in p
                            else P.Col(p)) for p in pcols]
            if len(ptvs) == 1:
                pkey = _lift_key(ptvs[0].arr, ptvs[0].tag)
            elif len(ptvs) == 2 and all(t.tag != "u64" for t in ptvs):
                pkey = U64(_sortable(ptvs[1].arr, ptvs[1].tag),
                           _sortable(ptvs[0].arr, ptvs[0].tag))
            else:
                raise SqlError("PARTITION BY supports one column of any "
                               "type or two 32-bit columns")
            order = None
            if ocol is not None:
                otv = env.col(P.Col(*reversed(ocol.split("."))) if "."
                              in ocol else P.Col(ocol))
                if otv.tag == "u64":
                    raise SqlError("u64 ORDER BY inside OVER is not "
                                   "supported")
                order = _column(otv.arr, otv.tag)
            funcs, values, tagof = {}, {}, {}
            for i, c in enumerate(cs):
                wname = f"w{i}"
                fr = c.window.frame_rows
                kind = _window_kind(c)
                if kind in ("row_number", "rank", "dense_rank",
                            "percent_rank", "partition_count"):
                    funcs[wname] = (kind,)
                    tagof[wname] = ("f32" if kind == "percent_rank"
                                    else "u32")
                elif kind == "moving_count":
                    fo = c.window.frame_follow or 0
                    funcs[wname] = (kind,
                                    None if fr is None else fr + 1, fo)
                    tagof[wname] = "u32"
                elif kind == "ntile":
                    if len(c.args) != 1 or not isinstance(c.args[0],
                                                          P.Lit):
                        raise SqlError("ntile takes an integer literal")
                    funcs[wname] = (kind, int(c.args[0].value))
                    tagof[wname] = "u32"
                else:
                    if len(c.args) < 1 or not isinstance(c.args[0], P.Col):
                        raise SqlError(f"{c.func}(...) OVER needs a "
                                       "plain column argument")
                    vtv = env.col(c.args[0])
                    vn = f"v{i}"
                    values[vn] = _column(vtv.arr, vtv.tag)
                    if kind in ("lag", "lead"):
                        fill, off = _lag_args(c)
                        funcs[wname] = (kind, vn, fill, off)
                        tagof[wname] = vtv.tag
                    elif kind.startswith("moving_"):
                        fo = c.window.frame_follow
                        funcs[wname] = (
                            (kind, vn,
                             None if fr is None else fr + 1, fo)
                            if fo else (kind, vn, fr + 1))
                        tagof[wname] = ("f32" if kind == "moving_avg"
                                        else vtv.tag)
                    elif kind.startswith("range_"):
                        funcs[wname] = (kind, vn,
                                        c.window.frame_range)
                        tagof[wname] = ("f32" if kind == "range_avg"
                                        else vtv.tag)
                    else:
                        funcs[wname] = (kind, vn)
                        tagof[wname] = (
                            "f32" if kind in ("running_avg",
                                              "total_avg")
                            else vtv.tag)
            res = run_window(pkey, funcs, order=order, values=values)
            for i, c in enumerate(cs):
                wname = f"w{i}"
                v = res.cols[wname]
                if isinstance(v, U64):
                    # integer sums: u32 inputs are non-negative (u64
                    # view exact); i32 sign-extended pairs read as
                    # two's-complement i64 — both resolved at
                    # _materialize via the tag (stays on device here)
                    vtag = None
                    for a in c.args:
                        if isinstance(a, P.Col):
                            vtag = env.tags[env.resolve(a)]
                    out[id(c)] = (v, "i64sum" if vtag == "i32"
                                  else "u64sum")
                else:
                    out[id(c)] = (v, tagof[wname])
        return out

    # -- GROUP BY / aggregates --------------------------------------------
    def _grouped(self, sel: P.Select, env: _RowEnv, n: int, tail=None,
                 keep: bool = False) -> Frame:
        """The grouped answer of sel over env's n rows. tail: the query
        (its ORDER BY, LIMIT, OFFSET) where they apply to this answer
        alone; keep: the answer feeds an IN and stays on the device. Where
        every group is read (no HAVING, no LIMIT below the groups) the
        frame is read to the host and finished there; else HAVING, the
        select items and tail's ORDER BY / LIMIT run on the device and
        only the rows left are read (the frame is then final). Traced as
        sql.grouped, with the rows read as groups_read."""
        from tpu_qe_torch.ops.aggregate import (group_aggregate,
                                                group_aggregate_multi)
        from tpu_qe_torch.ops.quantile import (group_quantile,
                                               group_quantile_cont)
        dev = self.device
        gcols = list(sel.group_by)
        # GROUP BY may name a select-item alias of a row expression
        # (GROUP BY v % 5 AS m) — evaluate the aliased expression as the
        # group column, sqlite-style
        aliases = expr_aliases(sel)
        gtvs, gexprs = [], []
        for c in gcols:
            if c.table is None and c.name not in env.names \
                    and c.name in aliases:
                tv = _eval_traced(aliases[c.name], env, n)
                if not isinstance(tv.arr, U64) and tv.arr.dim() == 0:
                    tv = TV(tv.arr.expand(n), tv.tag, tv.lit_value)
                gtvs.append(tv)
                gexprs.append(aliases[c.name])
            else:
                gtvs.append(env.col(c))
                gexprs.append(c)
        # composite group key
        gid_side = _ng = None     # dense-id side planes (3+ columns)
        if not gcols:
            zeros = torch.zeros(n, dtype=torch.int32, device=dev)
            gkey = U64(zeros, zeros)
        elif len(gtvs) == 1:
            gkey = _lift_key(gtvs[0].arr, gtvs[0].tag)
        elif len(gtvs) == 2 and all(t.tag != "u64" for t in gtvs):
            gkey = U64(_sortable(gtvs[1].arr, gtvs[1].tag),
                       _sortable(gtvs[0].arr, gtvs[0].tag))
        else:
            # 3+ columns (or 2 with a u64 member): dense lexicographic
            # group ids via _dense_group_ids — the id IS the U64 key
            # for every downstream aggregation, and the compacted
            # first-occurrence planes carry the group columns' values
            planes: list = []
            for t in gtvs:
                if t.tag == "u64":
                    planes += [t.arr.hi, t.arr.lo]
                else:
                    planes.append(_sortable(t.arr, t.tag))
            gid, gid_side, _ng = _dense_group_ids(tuple(planes))
            gkey = U64(gid, torch.zeros_like(gid))

        calls = aggregate_calls(sel)
        for c in calls:
            if c.func not in _AGG_FUNCS:
                continue
            if c.within_order is not None:
                raise SqlError(f"{c.func} does not take WITHIN GROUP")
            if c.distinct and c.func != "count":
                raise SqlError("DISTINCT is only supported inside "
                               "COUNT()")
            if c.func != "count" and len(c.args) != 1:
                raise SqlError(f"{c.func}(...) takes one argument")
        args = _AggArgs(env, n)
        plan = plan_aggregates(calls, args)
        if any(env.tags[col] == "u64" for col, _kind in plan.pct_specs):
            raise SqlError("percentiles over u64 columns are not "
                           "supported in SQL (use Table.quantile)")
        if any(env.tags[col] == "u64" for col in plan.aggspec):
            raise SqlError("aggregates over u64 columns are not "
                           "supported")

        # run the multi-aggregate: values keyed by source column
        values = {col: args.column(col) for col in plan.aggspec}
        mres = (group_aggregate_multi(gkey, values, plan.aggspec)
                if values else group_aggregate(gkey, aggs=("count",)))
        with span("sql.grouped") as traced:
            g = _int(mres.num_groups)
            # the answer stays on the device where only part of it is
            # read, and where an IN reads none of it
            on_device = keep or self._partial(sel, tail, g)
            # the G groups as a GroupFrame: read back to numpy by the host
            # ops (every n-row device output is head-sliced ON THE DEVICE
            # before the read), or kept on the device by DeviceOps
            ops = DeviceOps(dev) if on_device else _HOST_GROUPS
            cnt = ops.head(mres.aggs[f"{plan.count_col}_count"]
                           if plan.aggspec else mres.aggs["count"], g)
            aggs: dict = {}
            for name, arr in (mres.aggs or {}).items():
                if isinstance(arr, U64):
                    raw = ops.head(arr, g)
                    src = name.rsplit("_", 1)[0]
                    aggs[name] = (ops.view(raw, np.int64)
                                  if env.tags.get(src) == "i32" else raw)
                else:
                    v = ops.head(arr, g)
                    aggs[name] = (ops.astype(v, np.float64)
                                  if name.endswith("_sum")
                                  and ops.dtype(v) == np.float32 else v)
            distinct: dict = {}
            for col in plan.distinct:
                tv = args.column(col)
                if env.tags[col] == "u64":
                    # the count_distinct agg dedups ONE u32 plane riding
                    # the (key, value) sort; dropping the hi plane would
                    # undercount pairs sharing low bits. Dense-rank the
                    # u64 values instead (_dense_group_ids over the hi/lo
                    # planes — one extra sort): ranks preserve equality
                    # exactly and fit u32 (n < 2^32)
                    bits, _s, _n2 = _dense_group_ids((tv.hi, tv.lo))
                else:
                    bits = _sortable(tv, env.tags[col])
                dres = group_aggregate(gkey, from_plane(bits, torch.uint32),
                                       aggs=("count_distinct",))
                dg = _int(dres.num_groups)
                assert dg == g, (dg, g)
                distinct[col] = ops.astype(
                    ops.head(dres.aggs["count_distinct"], g), np.int64)
            # ordered-set aggregates: one group_quantile[_cont] per
            # (value column, kind) computes every requested q in one sorted
            # layout; readbacks are g-bounded device head slices
            pct: dict = {}
            for (col, kind), qlist in plan.pct_specs.items():
                val = args.column(col)
                if n == 0:      # no group: the operators take no empty input
                    for qi in range(len(qlist)):
                        pct[(col, kind, qi)] = (
                            ops.head(val, 0) if kind == "disc"
                            else ops.empty(np.float32))
                    continue
                if kind == "disc":
                    qr = group_quantile(gkey, val, qlist)
                    rows = qr.quantiles
                else:
                    qr = group_quantile_cont(gkey, val, qlist)
                    rows = qr.value          # f32 interpolation
                qg = _int(qr.num_groups)
                assert qg == g, (qg, g)
                for qi in range(len(qlist)):
                    pct[(col, kind, qi)] = ops.head(rows[qi], g)

            # group-key output values
            gvals: dict = {}

            def word(p):
                return ops.head(from_plane(p, torch.uint32), g)
            if gid_side is not None:
                # dense-id path: group g's column values sit at row g of
                # the compacted first-occurrence planes (id order == the
                # aggregation's key order: ids 0..G-1, all present)
                assert g == _int(_ng), (g, _ng)
                off = 0
                for c2, t in zip(gcols, gtvs):
                    if t.tag == "u64":
                        gvals[c2.key] = ops.u64(word(gid_side[off]),
                                                word(gid_side[off + 1]))
                        off += 2
                    elif t.tag == "bool":
                        gvals[c2.key] = ops.astype(
                            ops.head(gid_side[off], g), bool)
                        off += 1
                    else:
                        gvals[c2.key] = ops.unlift(word(gid_side[off]),
                                                   t.tag)
                        off += 1
            elif len(gtvs) == 1:
                t = gtvs[0]
                if t.tag == "u64":
                    gvals[gcols[0].key] = ops.head(mres.key, g)
                else:
                    gvals[gcols[0].key] = ops.unlift(word(mres.key.lo),
                                                     t.tag)
            elif len(gtvs) == 2:
                khi, klo = word(mres.key.hi), word(mres.key.lo)
                gvals[gcols[0].key] = ops.unlift(khi, gtvs[0].tag)
                gvals[gcols[1].key] = ops.unlift(klo, gtvs[1].tag)

            frame = GroupFrame(
                plan, g,
                [(c, e, gvals[c.key]) for c, e in zip(gcols, gexprs)],
                ops.astype(cnt, np.int64), aggs, distinct, pct, ops)
            with span("sql.finish"):
                cols, tags = frame.select(sel)
            if not on_device:
                traced.count(groups_read=g)
                return Frame(cols, tags)
            if keep:
                traced.count(groups_read=0)
                return Frame(cols, tags)
            if tail is not None:
                cols = _device_group_order(cols, tags, tail)
            out = _read_rows(cols)
            traced.count(groups_read=len(next(iter(out.values()))))
            return Frame(out, tags, final=tail is not None)

    @staticmethod
    def _partial(sel: P.Select, tail, g: int) -> bool:
        """Whether only part of a grouped answer's g groups is read: it has
        a HAVING, or the query's LIMIT (and OFFSET) stop below g."""
        return sel.having is not None or (
            tail is not None and tail.limit is not None
            and tail.limit + tail.offset < g)

    # -- DISTINCT / set ops -------------------------------------------------
    @staticmethod
    def _distinct_frame(fr: Frame) -> Frame:
        if not fr.cols:
            return fr
        names = sorted(fr.cols)
        # device path: 1-2 still-device columns dedup through the GROUP
        # BY boundary machinery (one sort, no aggregates) — the readback
        # is bounded by the distinct count, not n
        tags = [fr.tags.get(nm) for nm in names]
        if (all(_is_dev(fr.cols[nm]) for nm in names)
                and all(t in _DEV_SORT_TAGS for t in tags)
                and (len(names) == 1
                     or (len(names) == 2 and "u64" not in tags))):
            from tpu_qe_torch.ops.aggregate import group_aggregate
            if len(names) == 1:
                key = _lift_key(fr.cols[names[0]], tags[0])
            else:
                key = U64(_sortable(fr.cols[names[1]], tags[1]),
                          _sortable(fr.cols[names[0]], tags[0]))
            res = group_aggregate(key, aggs=("count",))
            g = _int(res.num_groups)
    
            def unlift(p, t):
                words = _head_np(from_plane(p, torch.uint32), g)
                if t == "bool":
                    return words.astype(bool)
                return _unlift_key(words, t)
            if len(names) == 1 and tags[0] == "u64":
                cols = {names[0]: _head_np(res.key, g)}
            elif len(names) == 1:
                cols = {names[0]: unlift(res.key.lo, tags[0])}
            else:
                cols = {names[0]: unlift(res.key.hi, tags[0]),
                        names[1]: unlift(res.key.lo, tags[1])}
            # preserve the frame's positional column order (set ops
            # pair positionally downstream)
            return Frame({k: cols[k] for k in fr.cols}, fr.tags)
        fr = _materialize(fr)
        arr = np.stack([fr.cols[k].view(np.uint64)
                        if fr.cols[k].dtype == np.uint64
                        else fr.cols[k].astype(np.float64).view(np.uint64)
                        if fr.cols[k].dtype.kind == "f"
                        else fr.cols[k].astype(np.int64).view(np.uint64)
                        for k in names])
        _, idx = np.unique(arr, axis=1, return_index=True)
        idx.sort()
        return Frame({k: v[idx] for k, v in fr.cols.items()}, fr.tags)

    def _set_op(self, a: Frame, b: Frame, op: str, all_: bool) -> Frame:
        # SQL set ops pair columns POSITIONALLY (frames preserve
        # select-item order); output names come from the first select
        na, nb = list(a.cols), list(b.cols)
        if len(na) != len(nb):
            raise SqlError(f"{op.upper()}: mismatched column counts")
        if op == "union" and all_:
            # positional pairing must also match dtypes: concatenating
            # u64 with float silently promotes to float64 and corrupts
            # u64 values > 2^53
            for k, kb in zip(na, nb):
                if a.cols[k].dtype != b.cols[kb].dtype:
                    raise SqlError(
                        f"UNION ALL: mismatched column dtypes at "
                        f"{k!r}/{kb!r} ({a.cols[k].dtype} vs "
                        f"{b.cols[kb].dtype})")
            cols = {k: np.concatenate([a.cols[k], b.cols[kb]])
                    for k, kb in zip(na, nb)}
            return Frame(cols, a.tags)
        if len(na) != 1:
            raise SqlError(f"{op.upper()} supports single-column selects "
                           "(use UNION ALL for multi-column append)")
        ka, kb = a.cols[na[0]], b.cols[nb[0]]
        if ka.dtype != kb.dtype:
            raise SqlError(f"{op.upper()}: mismatched column dtypes "
                           f"({ka.dtype} vs {kb.dtype})")
        from tpu_qe_torch.ops.setops import set_op as dev_set_op
        pa = _upload(U64.from_numpy(_lift64_np(ka), "cpu"), self.device)
        pb = _upload(U64.from_numpy(_lift64_np(kb), "cpu"), self.device)
        # EXCEPT ALL keeps max(ca-cb, 0) copies of EVERY key (Postgres
        # multiset semantics) — keys present in both sides with ca > cb
        # survive, so the multiplicities must come from the union key
        # set, not the except-distinct one
        keys, c_a, c_b, num = dev_set_op(
            pa, pb, "union" if (all_ and op == "except") else op)
        m = _int(num)
        k64 = _head_np(keys, m)
        ca = _head_np(c_a, m).astype(np.int64)
        cb = _head_np(c_b, m).astype(np.int64)
        if not all_:
            reps = np.ones(m, np.int64)
        elif op == "union":
            reps = ca + cb
        elif op == "intersect":
            reps = np.minimum(ca, cb)
        else:
            reps = np.maximum(ca - cb, 0)
        vals = np.repeat(k64, reps)
        return Frame({na[0]: _unlift64_np(vals, ka.dtype)}, a.tags)


def _u32_flag(m: torch.Tensor) -> torch.Tensor:
    """A bool tensor as a u32 column of 0 / 1."""
    return m.to(torch.int32).view(torch.uint32)


def _lift64_np(k: np.ndarray) -> np.ndarray:
    """Order- and equality-preserving injective map of a host frame
    column into u64 (set-op key lifting). Inverse: _unlift64_np."""
    if k.dtype == np.uint64:
        return k
    if k.dtype == np.uint32:
        return k.astype(np.uint64)
    if k.dtype == np.int32:
        return (k.view(np.uint32).astype(np.uint64)
                ^ np.uint64(0x80000000))
    if k.dtype == np.int64:
        return k.view(np.uint64) ^ np.uint64(1 << 63)
    if k.dtype == np.float32:
        b = k.view(np.uint32)
        s = (b >> 31) == 1
        return np.where(s, ~b, b | np.uint32(0x80000000)).astype(
            np.uint64)
    if k.dtype == np.float64:
        b = k.view(np.uint64)
        s = (b >> 63) == 1
        return np.where(s, ~b, b | np.uint64(1 << 63))
    raise SqlError(f"set-op over unsupported dtype {k.dtype}")


def _unlift64_np(v: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint64:
        return v
    if dtype == np.uint32:
        return v.astype(np.uint32)
    if dtype == np.int32:
        return (v.astype(np.uint32) ^ np.uint32(0x80000000)).view(
            np.int32)
    if dtype == np.int64:
        return (v ^ np.uint64(1 << 63)).view(np.int64)
    if dtype == np.float32:
        b = v.astype(np.uint32)
        was_pos = (b >> 31) == 1
        return np.where(was_pos, b ^ np.uint32(0x80000000), ~b).view(
            np.float32)
    if dtype == np.float64:
        was_pos = (v >> 63) == 1
        return np.where(was_pos, v ^ np.uint64(1 << 63), ~v).view(
            np.float64)
    raise SqlError(f"set-op over unsupported dtype {dtype}")
