"""Device time per request of gathers and scatters (index kernels), ms."""


def read(ctx):
    ms = ctx["by_category_ms"].get("gathers, scatters", 0.0)
    return ms / ctx["requests"] if ms > 0 else None
