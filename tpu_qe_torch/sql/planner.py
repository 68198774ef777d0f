"""The join planner: ``FROM a, b, c WHERE a.x = b.y AND ...`` as explicit
inner joins, the form in which TPC-H and SSB publish their queries.

The parser reads a comma list of tables as cross joins (``Join`` with
``how="cross"`` and no ON columns); the executor has no cross join.
``plan_query`` rewrites each such SELECT into the same SELECT written with
``JOIN ... ON``, so every path that takes explicit joins (in core,
virtual tables, ``mesh=``) takes the comma form with no change. The plan
is a pure function of the parsed SELECT and the tables' row counts and
column names:

- The WHERE is split into its top-level AND conjuncts. A conjunct
  ``x = y`` whose sides are bare columns of two different tables of the
  FROM list is a join edge. Every other conjunct stays in the WHERE, above
  the joins, in its written order; so does an edge the plan does not use
  (a second equality between two tables already joined).
- The plan starts from the table with the most rows. Then, over and
  over, it joins the table with the fewest rows among those that an edge
  connects to the tables already joined, on that table's first such edge
  in WHERE order. Ties go to the table written first in FROM.
- A table that no edge connects to the rest raises SqlError.

The planned joins carry only the columns the query names (select list,
WHERE, GROUP BY, HAVING, ORDER BY, join keys; every column under
``SELECT *``): ``Plan.keep``, which the in-core executor applies when it
binds the tables. Carrying every column of five SSB tables through four
joins of 120 M rows ran the card out of memory.

One-table conjuncts are not pushed below the joins: the WHERE runs once,
over the joined rows, as it does for ``JOIN ... ON``.
"""

from __future__ import annotations

import dataclasses

from tpu_qe_torch.sql import parser as P
from tpu_qe_torch.sql.parser import SqlError


@dataclasses.dataclass(frozen=True)
class Plan:
    """One planned SELECT: its tables' bindings in join order, the rows
    of the first, the edges used (one per join), and the columns to bind
    of each table (binding -> frozenset; None: every column)."""

    order: tuple
    start_rows: int
    joins: int
    keep: dict | None


def has_implicit_joins(q: P.Query) -> bool:
    return any(j.how == "cross" for s in q.selects for j in s.joins)


def conjuncts(e) -> list:
    """The top-level AND terms of `e`, in written order."""
    if isinstance(e, P.Binary) and e.op == "and":
        return conjuncts(e.left) + conjuncts(e.right)
    return [e]


def column_refs(node, out: set | None = None) -> set:
    """Every column reference under `node`, a parsed clause; those inside
    an IN (SELECT ...) are its subquery's own and are not listed."""
    out = set() if out is None else out
    if isinstance(node, P.Col):
        out.add(node)
    elif isinstance(node, P.InSelect):
        column_refs(node.operand, out)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            column_refs(getattr(node, f.name), out)
    elif isinstance(node, tuple):
        for x in node:
            column_refs(x, out)
    return out


def _and(terms: list):
    out = None
    for t in terms:
        out = t if out is None else P.Binary("and", out, t)
    return out


def plan_select(sel: P.Select, tables: dict,
                order_by: tuple = ()) -> tuple[P.Select, Plan]:
    """`sel` with its comma-joined tables as inner joins, and the plan.
    `tables`: lower-case table name -> (rows, column names); `order_by`:
    the query's ORDER BY items."""
    refs = [sel.table] + [j.table for j in sel.joins]
    bindings = [r.binding for r in refs]
    for b in bindings:
        if bindings.count(b) > 1:
            raise SqlError(f"table {b!r} appears twice in FROM: give each "
                           "an alias")
    schema = []
    for r in refs:
        if r.name.lower() not in tables:
            raise SqlError(f"unknown table {r.name!r}")
        schema.append(tables[r.name.lower()])

    def owner(c) -> int | None:
        """The FROM entry a column reference names, if exactly one."""
        if not isinstance(c, P.Col):
            return None
        if c.table is not None:
            hits = [i for i, b in enumerate(bindings) if b == c.table]
        else:
            hits = [i for i, (_, cols) in enumerate(schema) if c.name in cols]
        return hits[0] if len(hits) == 1 else None

    terms = conjuncts(sel.where) if sel.where is not None else []
    edges = []                       # (term index, table, table), in order
    for k, t in enumerate(terms):
        if isinstance(t, P.Binary) and t.op == "=":
            a, b = owner(t.left), owner(t.right)
            if a is not None and b is not None and a != b:
                edges.append((k, a, b))

    rows = [s[0] for s in schema]
    start = min(range(len(refs)), key=lambda i: (-rows[i], i))
    joined, used, joins = {start}, set(), []
    while len(joined) < len(refs):
        first_edge = {}              # table -> its first edge to `joined`
        for k, a, b in edges:
            if (a in joined) != (b in joined):
                first_edge.setdefault(b if a in joined else a, k)
        if not first_edge:
            lone = min(set(range(len(refs))) - joined)
            raise SqlError(f"no join condition connects {refs[lone].name}")
        new = min(first_edge, key=lambda i: (rows[i], i))
        k = first_edge[new]
        t = terms[k]
        left, right = ((t.left, t.right) if owner(t.right) == new
                       else (t.right, t.left))
        joins.append(P.Join("inner", refs[new], left, right))
        joined.add(new)
        used.add(k)
    order = (bindings[start],) + tuple(j.table.binding for j in joins)
    where = _and([t for k, t in enumerate(terms) if k not in used])
    sel = dataclasses.replace(sel, table=refs[start], joins=tuple(joins),
                              where=where)
    keep = None
    if all(it.expr != "*" for it in sel.items):
        named = column_refs(order_by, column_refs(sel))
        keep = {b: frozenset(c for c in cols if P.Col(c) in named
                             or P.Col(c, b) in named)
                for b, (_, cols) in zip(bindings, schema)}
    return sel, Plan(order, rows[start], len(joins), keep)


def plan_query(q: P.Query, tables: dict) -> tuple[P.Query, list]:
    """`q` with every SELECT that joins by commas planned, and each
    SELECT's plan (None for one written with JOIN ... ON or one table)."""
    selects, plans = [], []
    for s in q.selects:
        plan = None
        if any(j.how == "cross" for j in s.joins):
            s, plan = plan_select(s, tables, q.order_by)
        selects.append(s)
        plans.append(plan)
    return dataclasses.replace(q, selects=tuple(selects)), plans
