"""Times the caching allocator had to free its cache and retry a
cudaMalloc over the window (torch.cuda.memory_stats num_alloc_retries):
allocator stalls that make tail spikes. A count."""


def read(ctx):
    return ctx["alloc_retries"]
