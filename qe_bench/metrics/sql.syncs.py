"""Synchronisations a query: the program's sql.sync spans, one around each
read of a device value on the host (and each copy from pageable memory),
each of which waits for the device. A count, the mean over the traced
queries."""

from qe_bench.common import spans


def read(ctx):
    return spans.mean([len(spans.named(q, "sql.sync"))
                       for q in spans.requests("sql.query")])
