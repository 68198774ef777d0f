"""Rows of grouped answers read to the host a query: the groups_read counts
of the sql.grouped spans, summed over the query's (0 for an answer that an
IN consumes on the device; every group where the host frame reads them
all). The mean over the traced queries; none where the program keeps no
such spans."""

from qe_bench.common import spans


def read(ctx):
    return spans.mean([
        sum(s["counts"].get("groups_read", 0)
            for s in spans.named(q, "sql.grouped"))
        for q in spans.requests("sql.query")
        if spans.named(q, "sql.grouped")])
