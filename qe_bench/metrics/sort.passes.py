"""LSD radix passes per request, as the program's sort driver records
them (sort.driver.RADIX_PASSES over the traced requests). A count."""


def read(ctx):
    passes = sum(ctx["radix_passes"].values())
    return passes / ctx["requests"] if ctx["requests"] else None
