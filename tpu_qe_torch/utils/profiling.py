"""Tracing: named ranges around pipeline stages and a profiler session.

``marker(name)`` is a torch.profiler.record_function range, plus an NVTX
range when CUDA is available, so stage names ("compute morton code",
"radix sort", and per pass "radix sort histogram/scan/scatter pass i")
show in profiler timelines. ``trace_session(trace_dir)`` profiles the CPU
and, when available, the GPU, and writes a Chrome trace.
``profile_kernel`` times one kernel with CUDA events and reports its
achieved bandwidth against the card's HBM speed of light (``KernelStats``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Callable

import torch

from tpu_qe_torch.bench.sol import hbm_peak_bytes_per_s
from tpu_qe_torch.utils.timing import cuda_time

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
def trace_session(trace_dir: str | None, name: str = "trace.json"):
    """Profile the enclosed block into trace_dir/name; no-op if None."""
    if not trace_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(trace_dir, name)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@dataclasses.dataclass(frozen=True)
class KernelStats:
    """Achieved bandwidth of one kernel against the card's HBM peak."""

    name: str
    seconds: float
    bytes_moved: int
    elements: int

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def sol_fraction(self) -> float:
        peak = hbm_peak_bytes_per_s()
        return (self.bytes_moved / peak) / self.seconds if self.seconds else 0.0

    @property
    def elements_per_s(self) -> float:
        return self.elements / self.seconds if self.seconds else 0.0

    def row(self) -> str:
        return (f"{self.name:<32} {self.seconds * 1e3:8.4f} ms "
                f"{self.achieved_gbps:8.1f} GB/s  "
                f"{self.sol_fraction * 100:5.1f}% SOL  "
                f"{self.elements_per_s / 1e6:8.0f} Melem/s")


def profile_kernel(name: str, fn: Callable[[], object], bytes_moved: int,
                   elements: int, iters: int = 10) -> KernelStats:
    """Time fn() (one kernel call) with CUDA events and report bandwidth.

    The JAX package times kernels by chained differential runs and puts an
    optimization barrier between iterations; both exist for the TPU's
    remote dispatch latency and XLA's fusion across the chain. CUDA events
    recorded on the stream around back-to-back launches need neither:
    eager PyTorch fuses nothing, and the events bracket device time only.
    """
    stats = KernelStats(name=name, seconds=cuda_time(fn, iters=iters),
                        bytes_moved=bytes_moved, elements=elements)
    log.info("%s", stats.row())
    return stats
