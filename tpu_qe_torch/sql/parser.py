"""SQL parser: a hand-written tokenizer + recursive-descent parser for
the engine's SQL subset, producing plain dataclass ASTs.

The reference has no query language (it is a sort harness,
/root/reference/src/main.rs); SURVEY.md §7 mandates query operators over
columnar tables, and SQL is the canonical front door to them. The
subset maps 1:1 onto the implemented operator families:

    SELECT [DISTINCT] exprs            projection (device elementwise)
    FROM t [JOIN u ON a = b]           ops/join.py inner/outer joins
    FROM t, u, ... WHERE a = b ...     the same inner joins, in the order
                                       sql/planner.py picks
    WHERE expr                         ops/filter.py compact
    GROUP BY cols [HAVING expr]        ops/aggregate.py (exact u64 sums)
    f(x) OVER (PARTITION BY ...)       ops/window.py
    ORDER BY cols [ASC|DESC], LIMIT    ops/orderby.py one lexicographic sort
    UNION / INTERSECT / EXCEPT [ALL]   ops/setops.py

Grammar (EBNF-ish; case-insensitive keywords):

    query      := select ( (UNION|INTERSECT|EXCEPT) [ALL|DISTINCT] select )*
                  [ORDER BY order_item ("," order_item)*] [LIMIT int]
    select     := SELECT [DISTINCT] item ("," item)*
                  FROM table_ref (join)* [WHERE expr]
                  (or FROM table_ref ("," table_ref)* [WHERE expr]:
                  implicit joins, cross joins in the tree; mixing the
                  two forms in one SELECT raises SqlError)
                  [GROUP BY col ("," col)* [HAVING expr]]
    item       := "*" | expr [[AS] name]
    table_ref  := name [[AS] name]
    join       := [INNER | LEFT [OUTER] | FULL [OUTER]] JOIN table_ref
                  ON col "=" col
    order_item := col_or_output_name [ASC | DESC]
    expr       := standard precedence: OR < AND < NOT < cmp < add < mul
                  < unary < atom; atoms are literals, column refs
                  (optionally qualified), function calls, CASE WHEN,
                  and parenthesised exprs; aggregate calls may carry
                  DISTINCT; any call may carry OVER (PARTITION BY col
                  ("," col)* [ORDER BY col]).
    in_select  := expr IN "(" SELECT item FROM ... [WHERE ...] [GROUP BY
                  ... [HAVING ...]] ")": a cmp; the subquery has one item
                  and names no column of the outer query (uncorrelated)

No NULLs in the data model (columns are dense u32/i32/f32/u64 arrays);
NULL appears only as outer-join fill, surfaced as the join's `matched`
mask — see executor.py.
"""

from __future__ import annotations

import dataclasses
import re


class SqlError(ValueError):
    """Parse or planning error with position context."""


MIXED_FROM = ("FROM mixes comma-separated tables with JOIN ... ON: write "
              "every join of one SELECT in one form")


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
  | (?P<str>'(?:[^']|'')*')
    """,
    re.VERBOSE,
)

KEYWORDS = frozenset(
    """select from where group by having order limit as and or not
    join inner left right full outer on distinct union intersect except
    all asc desc over partition case when then else end between in is
    null true false cast""".split()
# Context-sensitive words (WITHIN GROUP, ROWS BETWEEN frames): matched
# as plain name tokens only where the grammar expects them, so columns
# named "rows", "current", "within", ... keep parsing as identifiers.
)


@dataclasses.dataclass(frozen=True)
class Tok:
    kind: str       # "kw" | "name" | "int" | "float" | "str" | "op" | "eof"
    text: str
    pos: int


def tokenize(src: str) -> list[Tok]:
    toks, i = [], 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise SqlError(f"bad character {src[i]!r} at {i}: "
                           f"...{src[max(0, i - 20):i + 5]}...")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text.lower() in KEYWORDS:
            toks.append(Tok("kw", text.lower(), m.start()))
        elif kind == "str":
            toks.append(Tok("str", text[1:-1].replace("''", "'"), m.start()))
        else:
            toks.append(Tok(kind, text, m.start()))
    toks.append(Tok("eof", "", len(src)))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lit:
    value: int | float | str


@dataclasses.dataclass(frozen=True)
class Col:
    name: str
    table: str | None = None   # qualifier, if written

    @property
    def key(self) -> str:
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclasses.dataclass(frozen=True)
class Unary:
    op: str                    # "-" | "not"
    operand: object


@dataclasses.dataclass(frozen=True)
class Binary:
    op: str                    # + - * / % = <> < <= > >= and or
    left: object
    right: object


@dataclasses.dataclass(frozen=True)
class Between:
    operand: object
    lo: object
    hi: object
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList:
    operand: object
    items: tuple
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSelect:
    """expr IN (SELECT ...): a one-column subquery, uncorrelated (the
    executor checks that it names no column of the outer query)."""
    operand: object
    select: "Select"


@dataclasses.dataclass(frozen=True)
class Case:
    whens: tuple               # ((cond, value), ...)
    default: object | None


@dataclasses.dataclass(frozen=True)
class Call:
    func: str                  # lowercase function name
    args: tuple                # expr args; ("*",) for COUNT(*)
    distinct: bool = False     # COUNT(DISTINCT x)
    window: "WindowSpec | None" = None
    within_order: "Col | None" = None  # f(q) WITHIN GROUP (ORDER BY col)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    partition_by: tuple        # (Col, ...)
    order_by: "Col | None"
    # ROWS BETWEEN frame_rows PRECEDING AND {CURRENT ROW | frame_follow
    # FOLLOWING} (frame_rows None + frame_follow None = the default
    # running frame, UNBOUNDED PRECEDING .. CURRENT ROW; frame_rows
    # None + frame_follow set = UNBOUNDED PRECEDING .. k FOLLOWING)
    frame_rows: int | None = None
    frame_follow: int | None = None
    # RANGE BETWEEN {x | UNBOUNDED} PRECEDING AND CURRENT ROW: the
    # order-VALUE window bound — "unbounded" means the tie-aware
    # running frame (peers of the current row included)
    frame_range: object = None


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: object               # expr AST, or "*"
    alias: str | None


@dataclasses.dataclass(frozen=True)
class TableRef:
    name: str
    alias: str | None

    @property
    def binding(self) -> str:
        return self.alias or self.name


@dataclasses.dataclass(frozen=True)
class Join:
    how: str                   # "inner" | "left" | "full"
                               # or "cross": FROM a, b (ON columns None)
    table: TableRef
    left_col: Col
    right_col: Col


@dataclasses.dataclass(frozen=True)
class Select:
    items: tuple
    distinct: bool
    table: TableRef
    joins: tuple
    where: object | None
    group_by: tuple            # (Col, ...)
    having: object | None


@dataclasses.dataclass(frozen=True)
class OrderItem:
    col: Col
    desc: bool


@dataclasses.dataclass(frozen=True)
class Query:
    selects: tuple             # (Select, ...)
    set_ops: tuple             # between selects: ("union"|..., all: bool)
    order_by: tuple            # (OrderItem, ...)
    limit: int | None
    offset: int = 0            # LIMIT k OFFSET m (0 without OFFSET)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks = tokenize(src)
        self.i = 0

    # -- token helpers --
    @property
    def cur(self) -> Tok:
        return self.toks[self.i]

    def _err(self, what: str) -> SqlError:
        t = self.cur
        return SqlError(f"expected {what} at position {t.pos} "
                        f"(got {t.text!r}): ...{self.src[max(0, t.pos - 25):t.pos + 15]}...")

    def kw(self, *words: str) -> bool:
        """Consume keyword(s) if present."""
        j = self.i
        for w in words:
            if self.toks[j].kind != "kw" or self.toks[j].text != w:
                return False
            j += 1
        self.i = j
        return True

    def expect_kw(self, word: str):
        if not self.kw(word):
            raise self._err(word.upper())

    def ctx_kw(self, word: str) -> bool:
        """Consume a CONTEXTUAL keyword: a name token matching `word`
        case-insensitively (not reserved — see the KEYWORDS note)."""
        t = self.cur
        if t.kind == "name" and t.text.lower() == word:
            self.i += 1
            return True
        return False

    def expect_ctx(self, word: str):
        if not self.ctx_kw(word):
            raise self._err(word.upper())

    def op(self, text: str) -> bool:
        if self.cur.kind == "op" and self.cur.text == text:
            self.i += 1
            return True
        return False

    def expect_op(self, text: str):
        if not self.op(text):
            raise self._err(repr(text))

    def name(self) -> str:
        if self.cur.kind != "name":
            raise self._err("identifier")
        t = self.cur.text
        self.i += 1
        return t

    # -- grammar --
    def query(self) -> Query:
        selects = [self.select()]
        set_ops = []
        while True:
            got = None
            for w in ("union", "intersect", "except"):
                if self.kw(w):
                    got = w
                    break
            if got is None:
                break
            all_ = self.kw("all")
            if not all_:
                self.kw("distinct")
            set_ops.append((got, all_))
            selects.append(self.select())
        order_by: list[OrderItem] = []
        if self.kw("order"):
            self.expect_kw("by")
            while True:
                c = self.colref()
                desc = False
                if self.kw("desc"):
                    desc = True
                else:
                    self.kw("asc")
                order_by.append(OrderItem(c, desc))
                if not self.op(","):
                    break
        limit = None
        offset = 0
        if self.kw("limit"):
            if self.cur.kind != "int":
                raise self._err("integer LIMIT")
            limit = int(self.cur.text)
            self.i += 1
            if self.ctx_kw("offset"):
                if self.cur.kind != "int":
                    raise self._err("integer OFFSET")
                offset = int(self.cur.text)
                self.i += 1
        if self.cur.kind != "eof":
            raise self._err("end of query")
        return Query(tuple(selects), tuple(set_ops), tuple(order_by),
                     limit, offset)

    def select(self) -> Select:
        self.expect_kw("select")
        distinct = self.kw("distinct")
        self.kw("all")
        items = [self.select_item()]
        while self.op(","):
            items.append(self.select_item())
        self.expect_kw("from")
        table = self.table_ref()
        joins = []
        while self.op(","):
            joins.append(Join("cross", self.table_ref(), None, None))
        while True:
            how = None
            if self.kw("inner", "join") or self.kw("join"):
                how = "inner"
            elif self.kw("left", "outer", "join") or self.kw("left", "join"):
                how = "left"
            elif self.kw("full", "outer", "join") or self.kw("full", "join"):
                how = "full"
            if how is None:
                break
            if joins and joins[0].how == "cross":
                raise SqlError(MIXED_FROM)
            t = self.table_ref()
            self.expect_kw("on")
            a = self.colref()
            self.expect_op("=")
            b = self.colref()
            joins.append(Join(how, t, a, b))
        if joins and joins[0].how != "cross" and self.op(","):
            raise SqlError(MIXED_FROM)
        where = None
        if self.kw("where"):
            where = self.expr()
        group_by: list[Col] = []
        having = None
        if self.kw("group"):
            self.expect_kw("by")
            group_by.append(self.colref())
            while self.op(","):
                group_by.append(self.colref())
            if self.kw("having"):
                having = self.expr()
        return Select(tuple(items), distinct, table, tuple(joins),
                      where, tuple(group_by), having)

    def select_item(self) -> SelectItem:
        if self.op("*"):
            return SelectItem("*", None)
        e = self.expr()
        alias = None
        if self.kw("as"):
            alias = self.name()
        elif self.cur.kind == "name":
            alias = self.name()
        return SelectItem(e, alias)

    def table_ref(self) -> TableRef:
        nm = self.name()
        alias = None
        if self.kw("as"):
            alias = self.name()
        elif self.cur.kind == "name":
            alias = self.name()
        return TableRef(nm, alias)

    def colref(self) -> Col:
        nm = self.name()
        if self.op("."):
            return Col(self.name(), table=nm)
        return Col(nm)

    # -- expressions (precedence climbing) --
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.kw("or"):
            e = Binary("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.kw("and"):
            e = Binary("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.kw("not"):
            return Unary("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        e = self.add_expr()
        negated = self.kw("not")
        if self.kw("between"):
            lo = self.add_expr()
            self.expect_kw("and")
            hi = self.add_expr()
            return Between(e, lo, hi, negated)
        if self.kw("in"):
            self.expect_op("(")
            if self.cur.kind == "kw" and self.cur.text == "select":
                return self.in_select(e, negated)
            items = [self.add_expr()]
            while self.op(","):
                items.append(self.add_expr())
            self.expect_op(")")
            return InList(e, tuple(items), negated)
        if negated:
            raise self._err("BETWEEN or IN after NOT")
        for sym in ("<>", "!=", "<=", ">=", "=", "<", ">"):
            if self.op(sym):
                op = "<>" if sym == "!=" else sym
                return Binary(op, e, self.add_expr())
        return e

    def in_select(self, operand, negated: bool) -> InSelect:
        if negated:
            raise SqlError("NOT IN (SELECT ...) is not supported: its NULL "
                           "rules are not implemented")
        sub = self.select()
        self.expect_op(")")
        if len(sub.items) != 1 or sub.items[0].expr == "*":
            raise SqlError("IN (SELECT ...) takes a subquery of exactly one "
                           "select item, not * or a list")
        return InSelect(operand, sub)

    def add_expr(self):
        e = self.mul_expr()
        while True:
            if self.op("+"):
                e = Binary("+", e, self.mul_expr())
            elif self.op("-"):
                e = Binary("-", e, self.mul_expr())
            else:
                return e

    def mul_expr(self):
        e = self.unary_expr()
        while True:
            if self.op("*"):
                e = Binary("*", e, self.unary_expr())
            elif self.op("/"):
                e = Binary("/", e, self.unary_expr())
            elif self.op("%"):
                e = Binary("%", e, self.unary_expr())
            else:
                return e

    def unary_expr(self):
        if self.op("-"):
            return Unary("-", self.unary_expr())
        if self.op("+"):
            return self.unary_expr()
        return self.atom()

    def atom(self):
        t = self.cur
        if t.kind == "int":
            self.i += 1
            return Lit(int(t.text))
        if t.kind == "float":
            self.i += 1
            return Lit(float(t.text))
        if t.kind == "str":
            self.i += 1
            return Lit(t.text)
        if self.op("("):
            e = self.expr()
            self.expect_op(")")
            return e
        if self.kw("case"):
            return self.case_expr()
        if t.kind == "name":
            # function call or column ref
            if (self.toks[self.i + 1].kind == "op"
                    and self.toks[self.i + 1].text == "("):
                return self.call()
            return self.colref()
        raise self._err("expression")

    def case_expr(self) -> Case:
        whens = []
        while self.kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        if not whens:
            raise self._err("WHEN")
        default = None
        if self.kw("else"):
            default = self.expr()
        self.expect_kw("end")
        return Case(tuple(whens), default)

    def call(self) -> Call:
        fname = self.name().lower()
        self.expect_op("(")
        distinct = False
        args: tuple
        if self.op("*"):
            args = ("*",)
        elif self.op(")"):
            c = Call(fname, ())
            return self._maybe_over(c)
        else:
            distinct = self.kw("distinct")
            lst = [self.expr()]
            while self.op(","):
                lst.append(self.expr())
            args = tuple(lst)
        self.expect_op(")")
        return self._maybe_over(self._maybe_within(
            Call(fname, args, distinct)))

    def _maybe_within(self, c: Call) -> Call:
        # ordered-set aggregate: f(q) WITHIN GROUP (ORDER BY col)
        if not self.ctx_kw("within"):
            return c
        self.expect_kw("group")
        self.expect_op("(")
        self.expect_kw("order")
        self.expect_kw("by")
        col = self.colref()
        self.expect_op(")")
        return dataclasses.replace(c, within_order=col)

    def _maybe_over(self, c: Call) -> Call:
        if not self.kw("over"):
            return c
        self.expect_op("(")
        part: list[Col] = []
        order: Col | None = None
        if self.kw("partition"):
            self.expect_kw("by")
            part.append(self.colref())
            while self.op(","):
                part.append(self.colref())
        if self.kw("order"):
            self.expect_kw("by")
            order = self.colref()
        frame = follow = frange = None
        if self.ctx_kw("rows"):
            self.expect_kw("between")
            if self.ctx_kw("unbounded"):
                self.expect_ctx("preceding")  # the default running frame
            elif self.ctx_kw("current"):
                self.expect_ctx("row")
                frame = 0
            else:
                if self.cur.kind != "int":
                    raise self._err("integer, CURRENT ROW or UNBOUNDED")
                frame = int(self.cur.text)
                self.i += 1
                self.expect_ctx("preceding")
            self.expect_kw("and")
            if self.ctx_kw("current"):
                self.expect_ctx("row")
            else:
                if self.cur.kind != "int":
                    raise self._err("integer or CURRENT ROW")
                follow = int(self.cur.text)
                self.i += 1
                self.expect_ctx("following")
                if follow < 1:
                    raise self._err("a FOLLOWING bound >= 1")
        elif self.ctx_kw("range"):
            self.expect_kw("between")
            if self.ctx_kw("unbounded"):
                self.expect_ctx("preceding")
                frange = "unbounded"
            else:
                if self.cur.kind not in ("int", "float"):
                    raise self._err("numeric bound or UNBOUNDED")
                frange = (float(self.cur.text)
                          if self.cur.kind == "float"
                          else int(self.cur.text))
                self.i += 1
                self.expect_ctx("preceding")
            self.expect_kw("and")
            self.expect_ctx("current")
            self.expect_ctx("row")
        self.expect_op(")")
        return dataclasses.replace(
            c, window=WindowSpec(tuple(part), order, frame, follow,
                                 frange))


def in_selects(node) -> list:
    """The IN (SELECT ...) nodes under `node`, a parsed clause, in written
    order; those inside a subquery are its own and are not listed."""
    out = []

    def walk(x):
        if isinstance(x, InSelect):
            out.append(x)
            walk(x.operand)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for y in x:
                walk(y)
    walk(node)
    return out


def parse(src: str) -> Query:
    """Parse one SQL query of the supported subset into a Query AST."""
    return _Parser(src).query()
