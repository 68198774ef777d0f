"""Rows a filter keeps of those it gathers, %: 100 x the sum of rows_kept
over the sum of rows_in of the ops.compact spans of the traced queries
(the WHERE's compact and the read of its kept count). ops/filter.compact
gathers every row of every column; the rest of the gather is wasted."""

from qe_bench.common import spans


def read(ctx):
    counts = [s["counts"] for q in spans.requests("sql.query")
              for s in spans.named(q, "ops.compact")
              if "rows_kept" in s["counts"]]
    rows_in = sum(c["rows_in"] for c in counts)
    if not rows_in:
        return None
    return 100.0 * sum(c["rows_kept"] for c in counts) / rows_in
