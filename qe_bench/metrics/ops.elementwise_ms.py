"""Device time per request of the kernels in no other category
(expressions, masks, widening), ms."""


def read(ctx):
    ms = ctx["by_category_ms"].get("elementwise/other", 0.0)
    return ms / ctx["requests"] if ms > 0 else None
