"""Join work per fact row: the rows_out of a query's ops.join spans,
summed, over the start_rows of its sql.plan span (the rows of the table
the planned joins start from). The mean over the traced queries. With
every filter above the joins a chain of k foreign-key joins reads k;
filters pushed below them would bring it down. None where the program
plans no comma join or keeps no such counts."""

from qe_bench.common import spans


def read(ctx):
    ratios = []
    for q in spans.requests("sql.query"):
        start = sum(s["counts"].get("start_rows", 0)
                    for s in spans.named(q, "sql.plan"))
        if start:
            ratios.append(sum(s["counts"].get("rows_out", 0)
                              for s in spans.named(q, "ops.join")) / start)
    return spans.mean(ratios)
