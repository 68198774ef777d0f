"""Device time a query of its row expressions, ms: the sql.expr spans (the
WHERE, each select item and each aggregate argument), timed by CUDA events
on the stream around each. The median over the traced queries; none on
the CPU."""

from qe_bench.common import spans


def read(ctx):
    return spans.median([spans.device_ms(q, "sql.expr")
                         for q in spans.requests("sql.query")])
