"""Tracing: named ranges around pipeline stages and a profiler session.

``marker(name)`` is a torch.profiler.record_function range, plus an NVTX
range when CUDA is available, so stage names ("compute morton code",
"radix sort", and per pass "radix sort histogram/scan/scatter pass i")
show in profiler timelines. ``trace_session(trace_dir)`` profiles the CPU
and, when available, the GPU, and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

log = logging.getLogger("tpu_qe_torch")


@contextlib.contextmanager
def marker(name: str):
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace_session(trace_dir: str | None):
    """Profile the enclosed block into trace_dir/trace.json; no-op if None."""
    if not trace_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
