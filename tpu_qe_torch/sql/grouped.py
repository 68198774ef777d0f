"""What a grouped SQL answer means on the host, for the three tiers.

A GROUP BY or a global aggregate is answered by the in-core executor
(executor.Database._grouped), its mesh= path (Database._dist_group) and
the out-of-core executor (bigexec._agg_big). Each tier computes its
groups and aggregates its own way; this module owns what they share:

    aggregate_calls   the aggregate calls of the select items and HAVING
    plan_aggregates   which aggregates each value column needs (AVG as
                      SUM, the count riding one column), the COUNT
                      (DISTINCT) columns and the percentile specs
    GroupFrame        the G groups as numpy arrays: HAVING and the select
                      items evaluated over them

A tier resolves an aggregate argument to a value-column name with its own
resolver and keeps its own refusals, worded as the reference words them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_qe_torch.sql import parser as P

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
    """A grouped answer's G groups on the host, as numpy arrays of G rows.

    groups: [(GROUP BY column, the expression it stands for, values)] —
    the expression is the column itself, or the row expression its alias
    names; count: the int64 group sizes; aggs: "<column>_<aggregate>" ->
    values; distinct: column -> COUNT(DISTINCT) values; pct: (column,
    kind, qi) -> percentile values. Each tier hands in the dtypes its
    answers take.
    """

    def __init__(self, plan: AggPlan, g: int, groups: list,
                 count: np.ndarray, aggs: dict, distinct: dict, pct: dict):
        self.plan, self.g = plan, g
        self.groups = groups
        self.count, self.aggs = count, aggs
        self.distinct, self.pct = distinct, pct
        self.by_expr: dict[str, np.ndarray] = {}
        for _col, expr, vals in groups:
            self.by_expr.setdefault(repr(expr), vals)

    def group_values(self, e: P.Col) -> np.ndarray:
        """A column reference's group column: the same key, or the same
        name where either side is unqualified."""
        for col, _expr, vals in self.groups:
            if col.key == e.key or (col.name == e.name and (
                    e.table is None or col.table is None)):
                return vals
        raise SqlError(f"column {e.key!r} is not in GROUP BY")

    def aggregate(self, c: P.Call) -> np.ndarray:
        plan = self.plan
        if c.func in _PCT_FUNCS:
            return self.pct[plan.pct_of[id(c)]]
        if id(c) not in plan.column_of:
            return self.count       # COUNT(*), COUNT(x)
        col = plan.column_of[id(c)]
        if c.distinct:
            return self.distinct[col]
        if c.func == "avg":
            return (self.aggs[f"{col}_sum"].astype(np.float64)
                    / np.maximum(self.count, 1))
        return self.aggs[f"{col}_{c.func}"]

    def eval(self, e) -> np.ndarray:
        """An expression over the groups: a group column or the
        expression a GROUP BY alias names, an aggregate call, or
        literals, NOT, negation, binary operators and CASE over them."""
        if isinstance(e, P.Call):   # no group expression holds a call
            return self.aggregate(e)
        if not isinstance(e, P.Lit) and repr(e) in self.by_expr:
            return self.by_expr[repr(e)]
        if isinstance(e, P.Col):
            return self.group_values(e)
        if isinstance(e, P.Lit):
            return np.asarray(e.value)
        if isinstance(e, P.Unary):
            v = self.eval(e.operand)
            return ~v.astype(bool) if e.op == "not" else -v
        if isinstance(e, P.Binary):
            return _np_binop(e.op, self.eval(e.left), self.eval(e.right))
        if isinstance(e, P.Case):
            out = (self.eval(e.default) if e.default is not None
                   else np.int64(0))
            out = np.broadcast_to(out, (self.g,)).copy()
            # the FIRST matching WHEN wins: apply the arms in reverse
            for cond, val in e.whens[::-1]:
                m = self.eval(cond).astype(bool)
                out = np.where(m, np.broadcast_to(self.eval(val),
                                                  (self.g,)), out)
            return out
        raise SqlError(f"unsupported grouped expression "
                       f"{type(e).__name__}")

    def select(self, sel: P.Select) -> tuple[dict, dict]:
        """HAVING applied and the select items named and built: (columns,
        dtype tags) of host arrays."""
        keep = np.ones(self.g, bool)
        if sel.having is not None:
            keep = np.broadcast_to(self.eval(sel.having).astype(bool),
                                   (self.g,))
        cols, tags = {}, {}
        for i, it in enumerate(sel.items):
            if it.expr == "*":
                raise SqlError("SELECT * with GROUP BY is not supported")
            name = it.alias or _auto_name(it.expr, i)
            v = np.broadcast_to(self.eval(it.expr), (self.g,))
            cols[name] = np.asarray(v)[keep]
            tags[name] = str(cols[name].dtype)
        return cols, tags


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
