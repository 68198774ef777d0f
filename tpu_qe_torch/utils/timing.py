"""Device timing with CUDA events.

Warm-up calls run first and are synchronised, so the kernel build and the
first launch stay out of the timed window. Events are recorded on the
current stream around `iters` back-to-back calls and the mean per call is
returned.
"""

from __future__ import annotations

from typing import Callable

import torch


def cuda_time(fn: Callable[[], object], iters: int = 10,
              warmup: int = 2) -> float:
    """Mean seconds per call of fn() on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
