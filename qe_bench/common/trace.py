"""Reading a torch.profiler trace: device time by kernel category, the
idle share, and the longest idle gaps with what the host did meanwhile.

CATEGORIES and device_time are frozen copies of tpu_qe_torch/bench/
matrix.py's, so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import bisect
from collections import Counter

import torch

# Device-time categories of a profiled run: substrings of kernel names,
# the first match wins; every other kernel is "elementwise/other". The
# port's own kernels live in an anonymous namespace.
CATEGORIES = (
    ("B1 histogram", ("namespace)::histogram_kernel",
                      "namespace)::histogram_group_kernel")),
    ("B2 scan", ("namespace)::scan_kernel",)),   # its memset: "copies"
    ("B3 rank+scatter", ("namespace)::rank_kernel",
                         "namespace)::rank_wide_kernel",
                         "namespace)::scatter_wide_kernel")),
    ("sort (torch)", ("RadixSort", "radixSort", "sort", "Sort")),
    ("scans (cumsum, cummax)", ("Scan", "scan", "cummax", "cumsum")),
    ("gathers, scatters", ("index_elementwise_kernel", "index_put",
                           "gather", "scatter")),
    ("copies", ("Memcpy", "Memset")),
)

RADIX = ("B1 histogram", "B2 scan", "B3 rank+scatter")


def _category(kernel: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in kernel for k in keys):
            return cat
    return "elementwise/other"


def device_time(prof, wall_ms: float) -> dict:
    """Kernel time of a CUDA profile over a run of `wall_ms`: the summed
    kernel time, the device's idle share (1 - kernel time / wall) and the
    kernel time by category (CATEGORIES) and for the largest kernels."""
    events = prof.events()
    # a trace range shows on the device too, under its host-side name
    ranges = {e.name for e in events
              if e.device_type != torch.autograd.DeviceType.CUDA}
    by_cat, by_kernel = Counter(), Counter()
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in ranges):
            ms = e.time_range.elapsed_us() / 1e3
            by_cat[_category(e.name)] += ms
            by_kernel[e.name[:80]] += ms
    busy = sum(by_cat.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "by_category_ms": dict(by_cat.most_common()),
            "top_kernels_ms": dict(by_kernel.most_common(6))}


def device_ops(prof) -> tuple[Counter, list, list]:
    """(milliseconds by full kernel name, device intervals, host events)
    of a profile: the intervals are (start, end) microseconds of every
    kernel and copy, the host events (start, end, name) of every host-side
    operation and range, both sorted by start."""
    events = prof.events()
    ranges = {e.name for e in events
              if e.device_type != torch.autograd.DeviceType.CUDA}
    by_name, dev, host = Counter(), [], []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in ranges:
                by_name[e.name] += tr.elapsed_us() / 1e3
                dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    host.sort()
    return by_name, dev, host


def short_name(kernel: str) -> str:
    """A kernel's name without its namespaces, at most 80 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(noise, "")
    return kernel[:80]


def idle_gaps(dev: list, host: list, top: int = 10) -> list:
    """The `top` longest stretches between device operations, each as
    [what the host was doing, seconds]: the innermost host operation that
    spans the gap's start (the one that began last), or "host" where none
    does."""
    gaps, reach = [], None
    for start, end in dev:
        if reach is not None and start > reach:
            gaps.append((start - reach, reach))
        reach = end if reach is None else max(reach, end)
    gaps.sort(reverse=True)
    starts = [h[0] for h in host]
    out = []
    for length, at in gaps[:top]:
        name = "host"
        for j in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if host[j][1] >= at:
                name = host[j][2]
                break
        out.append([name[:80], length / 1e6])
    return out
