"""Share of the traced slice in which no kernel or copy ran on the
device, %: 1 - kernel time / wall of the same slice."""


def read(ctx):
    if ctx["busy_ms"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_ms"] / ctx["wall_ms"])
