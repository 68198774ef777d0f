"""tpu_qe_torch.sql.parser against tpu_qe.sql.parser: the port's copy is
the reference's with lines added for the comma FROM, and `parse` gives
equal trees, field by field, or the same SqlError, for every literal
query that the SQL tests (tests/test_sql*.py) hand to `parse` or to
`Database.sql`, and for malformed queries of each clause."""

import ast
import dataclasses
import difflib
import glob
import os

import pytest

from tpu_qe.sql import parser as jp
from tpu_qe_torch.sql import parser as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _literal_queries():
    """(query, where) of every string literal given to parse(...) or
    .sql(...) in the SQL tests, first place of each."""
    found = {}
    for path in sorted(glob.glob(os.path.join(REPO, "tests",
                                              "test_sql*.py"))):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name in ("parse", "sql"):
                found.setdefault(node.args[0].value,
                                 f"{os.path.basename(path)}:{node.lineno}")
    return sorted(found.items(), key=lambda qw: qw[1])


QUERIES = _literal_queries()
MALFORMED = [
    "SELECT FROM t", "SELECT a FROM", "SELECT a FROM t WHERE",
    "SELECT a, FROM t", "SELECT a FROM t GROUP BY", "SELECT a FROM t "
    "ORDER BY", "SELECT a FROM t LIMIT x", "SELECT a FROM t LIMIT 1 "
    "OFFSET y", "SELECT $ FROM t", "SELECT a FROM t JOIN u", "SELECT a "
    "FROM t JOIN u ON a", "SELECT CASE a END FROM t", "SELECT a NOT 1 "
    "FROM t", "SELECT (a FROM t", "SELECT a FROM t UNION", "SELECT "
    "SUM(v) OVER (ORDER BY o ROWS BETWEEN x PRECEDING AND CURRENT ROW) "
    "FROM t", "SELECT SUM(v) OVER (ORDER BY o ROWS BETWEEN 1 PRECEDING "
    "AND 0 FOLLOWING) FROM t", "SELECT a FROM t extra tokens", "",
]


def _tree(x):
    """A node as nested plain values: class name and fields, in order."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, tuple(
            (f.name, _tree(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_tree(i) for i in x))
    return x


def _parsed(mod, q):
    try:
        return "tree", _tree(mod.parse(q))
    except Exception as e:      # noqa: BLE001 - the error is the result
        return type(e).__name__, str(e)


def test_parser_is_a_byte_identical_copy():
    # the port's copy is the reference's byte for byte, with lines added
    # and none changed or removed: the comma FROM (implicit joins), which
    # the reference does not parse
    def read(*parts):
        with open(os.path.join(REPO, *parts), "rb") as f:
            return f.read().decode().splitlines(keepends=True)
    ours = read("tpu_qe_torch", "sql", "parser.py")
    theirs = read("tpu_qe", "sql", "parser.py")
    ops = difflib.SequenceMatcher(None, theirs, ours,
                                  autojunk=False).get_opcodes()
    assert {op for op, *_ in ops} <= {"equal", "insert"}
    added = "".join(line for op, _, _, j0, j1 in ops if op == "insert"
                    for line in ours[j0:j1])
    assert 'Join("cross"' in added and "MIXED_FROM" in added


def test_the_sql_tests_give_enough_queries():
    # both parse(...) calls of tests/test_sql.py and the Database.sql
    # literals of every SQL test file
    assert len(QUERIES) >= 60
    assert {w.split(":")[0] for _, w in QUERIES} >= {
        "test_sql.py", "test_sql_big.py", "test_sql_vvjoin.py"}


@pytest.mark.parametrize("query", [q for q, _ in QUERIES],
                         ids=[w for _, w in QUERIES])
def test_parse_gives_the_reference_s_tree(query):
    got, want = _parsed(tp, query), _parsed(jp, query)
    assert got == want


@pytest.mark.parametrize("query", MALFORMED, ids=range(len(MALFORMED)))
def test_parse_raises_the_reference_s_error(query):
    got, want = _parsed(tp, query), _parsed(jp, query)
    assert want[0] == "SqlError" and got == want


def test_package_exports_parse():
    import tpu_qe_torch.sql as sql
    from tpu_qe_torch.sql import executor
    assert sql.parse is tp.parse
    assert sql.__all__ == ["Database", "SqlError", "parse"]
    assert sql.Database is executor.Database and sql.SqlError is tp.SqlError
