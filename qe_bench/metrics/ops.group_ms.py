"""Device time a query of its GROUP BY, ms: the ops.group spans
(group_aggregate and group_aggregate_multi, the key sort included), timed
by CUDA events on the stream around each. The median over the traced
queries; none on the CPU."""

from qe_bench.common import spans


def read(ctx):
    return spans.median([spans.device_ms(q, "ops.group")
                         for q in spans.requests("sql.query")])
