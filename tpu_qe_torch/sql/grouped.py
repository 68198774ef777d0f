"""What a grouped SQL answer means, for the three tiers.

A GROUP BY or a global aggregate is answered by the in-core executor
(executor.Database._grouped), its mesh= path (Database._dist_group) and
the out-of-core executor (bigexec._agg_big). Each tier computes its
groups and aggregates its own way; this module owns what they share:

    aggregate_calls   the aggregate calls of the select items and HAVING
    plan_aggregates   which aggregates each value column needs (AVG as
                      SUM, the count riding one column), the COUNT
                      (DISTINCT) columns and the percentile specs
    GroupFrame        the G groups: HAVING and the select items evaluated
                      over them, through a table of operations: NUMPY
                      (host arrays; every tier) or DeviceOps (tensors on
                      the card, DArray; the in-core tier, where only part
                      of the groups is read back or none)

A tier resolves an aggregate argument to a value-column name with its own
resolver and keeps its own refusals, worded as the reference words them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_qe_torch.bits import U64, narrow, widen
from tpu_qe_torch.sql import parser as P
from tpu_qe_torch.utils.profiling import span

SqlError = P.SqlError

_AGG_FUNCS = frozenset(["count", "sum", "min", "max", "avg"])
# ordered-set aggregates: PERCENTILE_DISC/CONT(q) WITHIN GROUP
# (ORDER BY col) + MEDIAN(col) sugar — ops/quantile.py at group scale
_PCT_FUNCS = frozenset(["percentile_disc", "percentile_cont", "median"])


def _walk(e):
    yield e
    if isinstance(e, P.Unary):
        yield from _walk(e.operand)
    elif isinstance(e, P.Binary):
        yield from _walk(e.left)
        yield from _walk(e.right)
    elif isinstance(e, P.Between):
        yield from _walk(e.operand)
        yield from _walk(e.lo)
        yield from _walk(e.hi)
    elif isinstance(e, P.InList):
        yield from _walk(e.operand)
        for it in e.items:
            yield from _walk(it)
    elif isinstance(e, P.Case):
        for c, v in e.whens:
            yield from _walk(c)
            yield from _walk(v)
        if e.default is not None:
            yield from _walk(e.default)
    elif isinstance(e, P.Call):
        for a in e.args:
            if a != "*":
                yield from _walk(a)


def _calls(e, *, window: bool):
    return [c for c in _walk(e)
            if isinstance(c, P.Call) and (c.window is not None) == window]


def _auto_name(e, i: int) -> str:
    """The output name of an unaliased select item (a repeated function
    takes its position as a suffix instead of colliding)."""
    if isinstance(e, P.Col):
        return e.name
    if isinstance(e, P.Call):
        return f"{e.func}_{i}" if i else e.func
    return f"col_{i}"


def expr_aliases(sel: P.Select) -> dict:
    """Select-item aliases of row expressions, which GROUP BY and ORDER
    BY may name (GROUP BY v % 5 AS m, sqlite-style): alias ->
    expression."""
    return {it.alias: it.expr for it in sel.items
            if it.expr != "*" and it.alias
            and not _calls(it.expr, window=False)}


def aggregate_calls(sel: P.Select) -> list:
    """The aggregate calls of the select items and HAVING, in order."""
    calls = []
    for it in sel.items:
        if it.expr != "*":
            calls += _calls(it.expr, window=False)
    if sel.having is not None:
        calls += _calls(sel.having, window=False)
    return calls


@dataclasses.dataclass
class AggPlan:
    """The aggregates one grouped answer computes, by value column."""
    aggspec: dict = dataclasses.field(default_factory=dict)
    #   value column -> sorted aggregate names (AVG as "sum"; "count"
    #   rides count_col, the first value column in sorted order)
    count_col: str | None = None
    distinct: list = dataclasses.field(default_factory=list)
    #   COUNT(DISTINCT) value columns, each once
    pct_specs: dict = dataclasses.field(default_factory=dict)
    #   (value column, "disc" | "cont") -> [(num, shift) quantiles]
    pct_of: dict = dataclasses.field(default_factory=dict)
    #   id(percentile call) -> (value column, kind, index of its q)
    column_of: dict = dataclasses.field(default_factory=dict)
    #   id(SUM/MIN/MAX/AVG or COUNT(DISTINCT) call) -> value column


def plan_aggregates(calls: list, value_of) -> AggPlan:
    """Plan `calls` (the aggregate calls, checked by the tier).
    value_of(arg) is the tier's resolver: an argument expression (or a
    WITHIN GROUP column) -> its value-column name. Percentile arguments
    resolve first, then the others in call order."""
    from tpu_qe_torch.ops.quantile import canon_qs
    for c in calls:
        if c.func not in _AGG_FUNCS and c.func not in _PCT_FUNCS:
            raise SqlError(f"unknown aggregate {c.func}")
    plan = AggPlan()
    for c in calls:
        if c.func not in _PCT_FUNCS:
            continue
        if c.func == "median":
            if len(c.args) != 1 or c.within_order is not None:
                raise SqlError("MEDIAN takes one column or expression")
            col, kind, q = value_of(c.args[0]), "disc", (1, 1)
        else:
            if c.within_order is None:
                raise SqlError(f"{c.func} needs WITHIN GROUP "
                               "(ORDER BY col)")
            if len(c.args) != 1 or not isinstance(c.args[0], P.Lit):
                raise SqlError(f"{c.func} takes one numeric literal")
            kind = "disc" if c.func == "percentile_disc" else "cont"
            col = value_of(c.within_order)
            (q,) = canon_qs([float(c.args[0].value)])
        qs = plan.pct_specs.setdefault((col, kind), [])
        if q not in qs:
            qs.append(q)
        plan.pct_of[id(c)] = (col, kind, qs.index(q))
    for c in calls:
        if c.func in _PCT_FUNCS or c.func == "count" and (
                c.args == ("*",) or not c.distinct):
            continue        # COUNT(*) and COUNT(x) read the count
        col = plan.column_of[id(c)] = value_of(c.args[0])
        if c.distinct:
            if col not in plan.distinct:
                plan.distinct.append(col)
            continue
        want = "sum" if c.func == "avg" else c.func
        plan.aggspec[col] = tuple(sorted(set(plan.aggspec.get(col, ()))
                                         | {want}))
    # the count always rides one column (COUNT(*), AVG, HAVING)
    if plan.aggspec:
        plan.count_col = min(plan.aggspec)
        plan.aggspec[plan.count_col] = tuple(sorted(
            set(plan.aggspec[plan.count_col]) | {"count"}))
    return plan


class GroupFrame:
    """A grouped answer's G groups, as columns of G rows: numpy arrays on
    the host, or device tensors (DArray) where the in-core tier keeps the
    answer on the card until its rows are final. `ops` (NUMPY or a
    DeviceOps) is the table of operations the evaluator runs on them, so
    both evaluate one set of expression semantics.

    groups: [(GROUP BY column, the expression it stands for, values)] —
    the expression is the column itself, or the row expression its alias
    names; count: the int64 group sizes; aggs: "<column>_<aggregate>" ->
    values; distinct: column -> COUNT(DISTINCT) values; pct: (column,
    kind, qi) -> percentile values. Each tier hands in the dtypes its
    answers take.
    """

    def __init__(self, plan: AggPlan, g: int, groups: list,
                 count, aggs: dict, distinct: dict, pct: dict,
                 ops: "NumpyOps | DeviceOps | None" = None):
        self.plan, self.g = plan, g
        self.ops = NUMPY if ops is None else ops
        self.groups = groups
        self.count, self.aggs = count, aggs
        self.distinct, self.pct = distinct, pct
        self.by_expr: dict[str, object] = {}
        for _col, expr, vals in groups:
            self.by_expr.setdefault(repr(expr), vals)

    def group_values(self, e: P.Col):
        """A column reference's group column: the same key, or the same
        name where either side is unqualified."""
        for col, _expr, vals in self.groups:
            if col.key == e.key or (col.name == e.name and (
                    e.table is None or col.table is None)):
                return vals
        raise SqlError(f"column {e.key!r} is not in GROUP BY")

    def aggregate(self, c: P.Call):
        plan = self.plan
        if c.func in _PCT_FUNCS:
            return self.pct[plan.pct_of[id(c)]]
        if id(c) not in plan.column_of:
            return self.count       # COUNT(*), COUNT(x)
        col = plan.column_of[id(c)]
        if c.distinct:
            return self.distinct[col]
        if c.func == "avg":
            return self.ops.avg(self.aggs[f"{col}_sum"], self.count)
        return self.aggs[f"{col}_{c.func}"]

    def eval(self, e):
        """An expression over the groups: a group column or the
        expression a GROUP BY alias names, an aggregate call, or
        literals, NOT, negation, binary operators and CASE over them."""
        ops = self.ops
        if isinstance(e, P.Call):   # no group expression holds a call
            return self.aggregate(e)
        if not isinstance(e, P.Lit) and repr(e) in self.by_expr:
            return self.by_expr[repr(e)]
        if isinstance(e, P.Col):
            return self.group_values(e)
        if isinstance(e, P.Lit):
            return ops.lit(e.value)
        if isinstance(e, P.Unary):
            v = self.eval(e.operand)
            return ops.not_(v) if e.op == "not" else ops.neg(v)
        if isinstance(e, P.Binary):
            return ops.binop(e.op, self.eval(e.left), self.eval(e.right))
        if isinstance(e, P.Case):
            out = (self.eval(e.default) if e.default is not None
                   else ops.lit(np.int64(0)))
            out = ops.rows(out, self.g)
            # the FIRST matching WHEN wins: apply the arms in reverse
            for cond, val in e.whens[::-1]:
                out = ops.where(ops.truth(self.eval(cond)),
                                ops.rows(self.eval(val), self.g), out)
            return out
        raise SqlError(f"unsupported grouped expression "
                       f"{type(e).__name__}")

    def select(self, sel: P.Select) -> tuple[dict, dict]:
        """HAVING applied and the select items named and built: (columns,
        dtype tags), the columns of the frame's kind."""
        ops = self.ops
        keep = None
        if sel.having is not None:
            keep = ops.rows(ops.truth(self.eval(sel.having)), self.g)
        cols = {}
        for i, it in enumerate(sel.items):
            if it.expr == "*":
                raise SqlError("SELECT * with GROUP BY is not supported")
            name = it.alias or _auto_name(it.expr, i)
            cols[name] = ops.rows(self.eval(it.expr), self.g)
        cols = ops.keep(cols, keep, self.g)
        return cols, {k: str(ops.dtype(v)) for k, v in cols.items()}


class NumpyOps:
    """The host frame's operations over numpy arrays (literals 0-d). The
    in-core tier builds its frame from device outputs with `head` (the
    first g rows read back) and `unlift` (a u32 key word to its column's
    value), which it hands in."""

    def __init__(self, head=None, unlift=None):
        self.head, self.unlift = head, unlift

    lit = staticmethod(np.asarray)

    @staticmethod
    def rows(v, g: int):
        return np.broadcast_to(v, (g,))

    @staticmethod
    def truth(v):
        return np.asarray(v).astype(bool)

    @staticmethod
    def not_(v):
        return ~np.asarray(v).astype(bool)

    @staticmethod
    def neg(v):
        return -v

    @staticmethod
    def binop(op: str, a, b):
        return _np_binop(op, a, b)

    where = staticmethod(np.where)

    @staticmethod
    def astype(v, dtype):
        return v.astype(dtype)

    @staticmethod
    def view(v, dtype):
        return v.view(dtype)

    @staticmethod
    def avg(s, count):
        return s.astype(np.float64) / np.maximum(count, 1)

    @staticmethod
    def u64(hi, lo):
        return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)

    @staticmethod
    def empty(dtype):
        return np.zeros(0, dtype)

    @staticmethod
    def keep(cols: dict, keep, g: int) -> dict:
        keep = np.ones(g, bool) if keep is None else keep
        return {k: np.asarray(v)[keep] for k, v in cols.items()}

    @staticmethod
    def dtype(v):
        return np.asarray(v).dtype


NUMPY = NumpyOps()


def _np_binop(op: str, a, b):
    if op == "and":
        return a.astype(bool) & b.astype(bool)
    if op == "or":
        return a.astype(bool) | b.astype(bool)
    if op in ("=", "<>", "<", "<=", ">", ">="):
        f = {"=": np.equal, "<>": np.not_equal, "<": np.less,
             "<=": np.less_equal, ">": np.greater,
             ">=": np.greater_equal}[op]
        return f(a, b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if np.asarray(a).dtype.kind == "f" or np.asarray(b).dtype.kind \
                == "f":
            return a / b
        return np.trunc(np.asarray(a, np.float64)
                        / np.asarray(b, np.float64)).astype(np.int64)
    if op == "%":
        return np.fmod(np.asarray(a, np.int64), np.asarray(b, np.int64))
    raise SqlError(f"unsupported operator {op!r}")


# ---------------------------------------------------------------------------
# the device frame: the same operations over tensors on the card
# ---------------------------------------------------------------------------

_BOOL, _I64, _F64, _U64 = (np.dtype(t) for t in ("bool", "int64", "float64",
                                                 "uint64"))
_I64_MIN = -(1 << 63)
_CMP = {"=": torch.eq, "<>": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}
# a comparison whose left side is above (below) every value of the right
_ABOVE = {"=": False, "<>": True, "<": False, "<=": False, ">": True,
          ">=": True}
_BELOW = {"=": False, "<>": True, "<": True, "<=": True, ">": False,
          ">=": False}
_NP_OF = {torch.uint32: np.dtype("uint32"), torch.int32: np.dtype("int32"),
          torch.float32: np.dtype("float32"), torch.int64: _I64,
          torch.float64: _F64, torch.bool: _BOOL}


@dataclasses.dataclass(frozen=True)
class DArray:
    """A column of a device frame as the host frame would hold it: dtype is
    the host array's numpy dtype; t the tensor of its values, int64 for
    every integer dtype (uint64 as its bit pattern), float32, float64 or
    bool, 0-d for a literal."""
    t: torch.Tensor
    dtype: np.dtype


def _store(dtype: np.dtype) -> torch.dtype:
    """The tensor dtype that holds values of a numpy dtype in a DArray."""
    if dtype.kind == "b":
        return torch.bool
    if dtype.kind == "f":
        return torch.float64 if dtype.itemsize == 8 else torch.float32
    return torch.int64


def _wrap(t: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """int64 values taken modulo the width of an integer dtype, as numpy's
    arithmetic in that dtype wraps."""
    if dtype.itemsize == 8:
        return t
    mask = (1 << 8 * dtype.itemsize) - 1
    if dtype.kind == "u":
        return t & mask
    half = 1 << 8 * dtype.itemsize - 1
    return ((t + half) & mask) - half


def _as(v: DArray, dtype: np.dtype) -> torch.Tensor:
    """v's values in dtype's tensor form, as numpy's astype gives them."""
    t = v.t
    if dtype.kind == "b":
        return t if t.dtype == torch.bool else t != 0
    if dtype.kind == "f":
        if v.dtype == _U64:                 # bits at or past 2^63
            f = t.to(torch.float64)
            return torch.where(t < 0, f + 2.0 ** 64, f).to(_store(dtype))
        return t.to(_store(dtype))
    return _wrap(t.to(torch.int64), dtype)


def _compare(op: str, a: DArray, b: DArray) -> torch.Tensor:
    """numpy's comparison: floats in the common float type, integers by
    their exact values (uint64 included)."""
    f = _CMP[op]
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        rt = np.result_type(a.dtype, b.dtype)
        return f(_as(a, rt), _as(b, rt))
    x, y = _as(a, _I64), _as(b, _I64)
    ua, ub = a.dtype == _U64, b.dtype == _U64
    if ua and ub:
        return f(x ^ _I64_MIN, y ^ _I64_MIN)
    r = f(x, y)
    if ua:                  # a uint64 at or past 2^63 is above any int64
        return torch.where(x < 0, _ABOVE[op], r)
    if ub:
        return torch.where(y < 0, _BELOW[op], r)
    return r


class DeviceOps:
    """NumpyOps's operations over DArray columns on one device, with
    numpy's result dtypes and values (integer sums exact in 64 bits).
    `keep` reads the kept count, one synchronisation (sql.sync); nothing
    else reads the device."""

    def __init__(self, device: torch.device):
        self.device = device

    def lit(self, value) -> DArray:
        dtype = np.asarray(value).dtype
        if dtype.kind not in "biuf":
            raise SqlError(f"a {dtype} literal in a grouped expression")
        value = value.item() if isinstance(value, np.generic) else value
        if dtype == _U64 and value >= 1 << 63:
            value -= 1 << 64
        return DArray(torch.full((), value, dtype=_store(dtype),
                                 device=self.device), dtype)

    @staticmethod
    def rows(v: DArray, g: int) -> DArray:
        return DArray(v.t.expand(g), v.dtype) if v.t.dim() == 0 else v

    @staticmethod
    def truth(v: DArray) -> DArray:
        return DArray(_as(v, _BOOL), _BOOL)

    @staticmethod
    def not_(v: DArray) -> DArray:
        return DArray(~_as(v, _BOOL), _BOOL)

    @staticmethod
    def neg(v: DArray) -> DArray:
        if v.dtype.kind == "b":
            raise SqlError("negation of a boolean")
        return DArray(_wrap(-v.t, v.dtype) if v.dtype.kind in "iu" else -v.t,
                      v.dtype)

    @staticmethod
    def binop(op: str, a: DArray, b: DArray) -> DArray:
        """_np_binop's semantics."""
        if op in ("and", "or"):
            x, y = _as(a, _BOOL), _as(b, _BOOL)
            return DArray(x & y if op == "and" else x | y, _BOOL)
        if op in _CMP:
            return DArray(_compare(op, a, b), _BOOL)
        if op == "/" and "f" not in (a.dtype.kind, b.dtype.kind):
            q = torch.trunc(_as(a, _F64) / _as(b, _F64))
            return DArray(q.to(torch.int64), _I64)
        if op == "%":
            x, y = _as(a, _I64), _as(b, _I64)
            zero = y == 0
            return DArray(torch.where(zero, 0, torch.fmod(
                x, torch.where(zero, 1, y))), _I64)
        if op not in ("+", "-", "*", "/"):
            raise SqlError(f"unsupported operator {op!r}")
        rt = np.result_type(a.dtype, b.dtype)
        x, y = _as(a, rt), _as(b, rt)
        if rt.kind == "b":
            if op == "+":
                return DArray(x | y, rt)
            if op == "*":
                return DArray(x & y, rt)
            raise SqlError(f"{op!r} of two booleans")
        r = {"+": torch.add, "-": torch.sub, "*": torch.mul,
             "/": torch.div}[op](x, y)
        return DArray(_wrap(r, rt) if rt.kind in "iu" else r, rt)

    @staticmethod
    def where(m: DArray, a: DArray, b: DArray) -> DArray:
        rt = np.result_type(a.dtype, b.dtype)
        return DArray(torch.where(m.t, _as(a, rt), _as(b, rt)), rt)

    @staticmethod
    def astype(v: DArray, dtype) -> DArray:
        dtype = np.dtype(dtype)
        return DArray(_as(v, dtype), dtype)

    @staticmethod
    def view(v: DArray, dtype) -> DArray:
        """int64 <-> uint64: the same bits."""
        return DArray(v.t, np.dtype(dtype))

    @staticmethod
    def avg(s: DArray, count: DArray) -> DArray:
        return DArray(_as(s, _F64) / count.t.clamp(min=1).to(torch.float64),
                      _F64)

    @staticmethod
    def u64(hi: DArray, lo: DArray) -> DArray:
        return DArray((hi.t << 32) | lo.t, _U64)

    def empty(self, dtype) -> DArray:
        dtype = np.dtype(dtype)
        return DArray(torch.zeros(0, dtype=_store(dtype), device=self.device),
                      dtype)

    @staticmethod
    def head(arr, g: int) -> DArray:
        """The first g rows of a device output as the host frame would
        read them (executor._head_np), left on the device."""
        if isinstance(arr, U64):
            return DArray((arr.hi[:g].to(torch.int64) << 32)
                          | widen(arr.lo[:g]), _U64)
        t, dtype = arr[:g], _NP_OF[arr.dtype]
        if t.dtype == torch.uint32:
            t = widen(t.view(torch.int32))
        elif dtype.kind == "i":
            t = t.to(torch.int64)
        return DArray(t, dtype)

    @staticmethod
    def unlift(v: DArray, tag: str) -> DArray:
        """executor._unlift_key over the device: a u32 key word (the
        sortable form of a 32-bit column) back to the column's value."""
        if tag == "u32":
            return v
        if tag == "i32":
            return DArray(v.t - (1 << 31), np.dtype("int32"))
        if tag == "f32":
            bits = torch.where(v.t >> 31 == 1, v.t ^ (1 << 31),
                               ~v.t & 0xFFFFFFFF)
            return DArray(narrow(bits).view(torch.float32),
                          np.dtype("float32"))
        raise SqlError(f"cannot invert key tag {tag}")

    def keep(self, cols: dict, keep: DArray | None, g: int) -> dict:
        """The rows where keep holds, in order: one read of their count."""
        if keep is None:
            return cols
        from tpu_qe_torch.ops.filter import stable_partition
        with span("sql.sync"):
            k = int(keep.t.sum())
        idx = stable_partition(keep.t)[:k]
        return {nm: DArray(v.t[idx], v.dtype) for nm, v in cols.items()}

    @staticmethod
    def dtype(v: DArray) -> np.dtype:
        return v.dtype
