"""Share of GROUP BY's count and integer-sum aggregates that the program's
reduce-by-key kernel computed, %: 100 x the sum of sum_cols_kernel over
the sum of sum_cols of the traced queries' ops.group spans. None where the
program keeps no such counts."""

from qe_bench.common import spans


def read(ctx):
    counts = [s["counts"] for q in spans.requests("sql.query")
              for s in spans.named(q, "ops.group")
              if "sum_cols" in s["counts"]]
    asked = sum(c["sum_cols"] for c in counts)
    if not asked:
        return None
    return 100.0 * sum(c["sum_cols_kernel"] for c in counts) / asked
