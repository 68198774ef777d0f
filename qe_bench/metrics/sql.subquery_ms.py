"""Device time a query of its subqueries, ms: the sql.subquery spans (each
IN (SELECT ...) run once, its GROUP BY, HAVING and the lift of its column
included), timed by CUDA events on the stream around each and summed over
the query's. The median over the traced queries; none on the CPU, or
where the program keeps no such spans."""

from qe_bench.common import spans


def read(ctx):
    return spans.median([spans.device_ms(q, "sql.subquery")
                         for q in spans.requests("sql.query")])
