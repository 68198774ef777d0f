"""SQL front end of the port: the parser (parser.py, a byte-identical
copy of tpu_qe/sql/parser.py, so both packages keep one grammar) and the
in-core executor over the device operators (executor.py) and the
out-of-core executor over virtual tables (bigexec.py).

    from tpu_qe_torch.sql import Database
    db = Database()                      # the card; Database("cpu") too
    db.register("t", {"k": k, "v": v})  # numpy columns
    out = db.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")

    db.register_virtual("big", n, {"k": fn})   # out-of-core (bigexec.py)

Virtual tables run through the out-of-core executor (bigexec.py); the
distributed `mesh=` path is not ported yet (ROADMAP Queue A item 10): it
raises SqlError.
"""

from tpu_qe_torch.sql.executor import Database, SqlError
from tpu_qe_torch.sql.parser import parse

__all__ = ["Database", "SqlError", "parse"]
