"""Device-to-host copy time per query (result and host-value read-backs),
ms: the trace's "Memcpy DtoH" operations over the requests traced."""


def read(ctx):
    ms = sum(v for k, v in ctx["by_kernel_ms"].items()
             if k.startswith("Memcpy DtoH"))
    return ms / ctx["requests"] if ms > 0 else None
