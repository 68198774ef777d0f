"""Device time per request of the radix kernels B1 histogram, B2 scan
and B3 rank + scatter, ms."""

from qe_bench.common.trace import RADIX


def read(ctx):
    ms = sum(ctx["by_category_ms"].get(c, 0.0) for c in RADIX)
    return ms / ctx["requests"] if ms > 0 else None
