"""Share of the inner joins whose left columns passed through, %: 100 x
the sum of passthrough over the traced queries' ops.join spans that carry
the count (1 where every left row matched exactly one right row, so the
output is the left rows in order, uncopied, beside the gathered right
columns; 0 where the slots were emitted and both sides gathered). None
where the program keeps no such count."""

from qe_bench.common import spans


def read(ctx):
    counts = [s["counts"]["passthrough"] for q in spans.requests("sql.query")
              for s in spans.named(q, "ops.join")
              if "passthrough" in s["counts"]]
    if not counts:
        return None
    return 100.0 * sum(counts) / len(counts)
