"""Device time a query of its joins, ms: the ops.join spans (each join's
key lift aside: the right side's sort, the searches, the expansion of the
match ranges and the gathers of both sides' columns, with the read of
the output count), timed by CUDA events on the stream around each and
summed over the query's joins. The median over the traced queries; none
on the CPU, or where the program keeps no such spans."""

from qe_bench.common import spans


def read(ctx):
    return spans.median([spans.device_ms(q, "ops.join")
                         for q in spans.requests("sql.query")])
