"""SQL front end of the port: the parser (parser.py, a byte-identical
copy of tpu_qe/sql/parser.py, so both packages keep one grammar) and the
in-core executor over the device operators (executor.py) and the
out-of-core executor over virtual tables (bigexec.py).

    from tpu_qe_torch.sql import Database
    db = Database()                      # the card; Database("cpu") too
    db.register("t", {"k": k, "v": v})  # numpy columns
    out = db.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")

    db.register_virtual("big", n, {"k": fn})   # out-of-core (bigexec.py)

    out = db.sql(q, mesh=LocalMesh(8, "cuda"))   # over a mesh of shards

Virtual tables run through the out-of-core executor (bigexec.py); with
`mesh=` (exchange.LocalMesh or GroupMesh) the recognized query shapes run
through the distributed operators of exchange/, and the rest raise.
"""

from tpu_qe_torch.sql.executor import Database, SqlError
from tpu_qe_torch.sql.parser import parse

__all__ = ["Database", "SqlError", "parse"]
