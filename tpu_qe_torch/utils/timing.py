"""Device timing with CUDA events.

Warm-up calls run first and are synchronised, so the kernel build and the
first launch stay out of the timed window. Events are recorded on the
current stream around `iters` back-to-back calls and the mean per call is
returned. A kernel of a few microseconds ends before the host has enqueued
the next one, so such a loop times the host; `ahead_ms` first puts a device
sleep of about that long on the stream, the host enqueues the whole loop
behind it, and the events then bracket device time alone.
"""

from __future__ import annotations

from typing import Callable

import torch


SLEEP_CYCLES_PER_MS = 1_700_000   # an H100's SM clock is about 1.7 GHz


def cuda_time(fn: Callable[[], object], iters: int = 10,
              warmup: int = 2, ahead_ms: float = 0.0) -> float:
    """Mean seconds per call of fn() on the current CUDA device; with
    `ahead_ms`, of calls queued behind a device sleep of about that long
    (choose it longer than the host needs to enqueue `iters` calls)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead_ms:
        torch.cuda._sleep(int(ahead_ms * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
