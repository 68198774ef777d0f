"""Host time a query outside its waits for the device, ms: the sql.query
span's host time less that of its sql.sync spans (parse, plan, enqueueing
the operators, the numpy frame). The median over the traced queries."""

from qe_bench.common import spans


def read(ctx):
    return spans.median([
        spans.host_ms(q["spans"][0])
        - sum(spans.host_ms(s) for s in spans.named(q, "sql.sync"))
        for q in spans.requests("sql.query")])
