"""SQL front end of the port: the parser (parser.py, a byte-identical
copy of tpu_qe/sql/parser.py, so both packages keep one grammar).

    from tpu_qe_torch.sql import parse
    q = parse("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")

The executor over the device operators, with `Database` and `SqlError`
(the parser's error class, re-exported there as in the reference), is
not ported yet: ROADMAP Queue A item 8.
"""

from tpu_qe_torch.sql.parser import parse

__all__ = ["parse"]
