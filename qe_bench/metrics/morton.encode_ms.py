"""Device time per frame outside the radix kernels B1-B3 (the vertex
update, the quantization and the encode, and the sort's copies), ms."""

from qe_bench.common.trace import RADIX


def read(ctx):
    cats = ctx["by_category_ms"]
    ms = ctx["busy_ms"] - sum(cats.get(c, 0.0) for c in RADIX)
    return ms / ctx["requests"] if ms > 0 else None
