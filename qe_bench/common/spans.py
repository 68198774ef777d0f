"""The program's own spans and counts of a traced run: the request records
that tpu_qe_torch.utils.profiling keeps while a profiler runs. In a
traced run they are the requests of both traced slices. A program that
keeps no records reads as having none, so the metrics read from them fall
silent there and do not fail.

Counts are read as means over the requests, times as medians, so that the
few requests of the host slice, which the profiler slows, move no time.
"""

from __future__ import annotations

import statistics


def requests(root: str) -> list[dict]:
    """The records of the traced requests whose root span is `root`."""
    try:
        from tpu_qe_torch.utils import profiling
    except ImportError:
        return []
    records = getattr(profiling, "records", None)
    if records is None:
        return []
    return [r for r in records() if r["name"] == root]


def named(request: dict, name: str) -> list[dict]:
    """The spans of one request called `name`."""
    return [s for s in request["spans"] if s["name"] == name]


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def device_ms(request: dict, name: str) -> float | None:
    """The device time of a request's spans called `name`, ms, from their
    CUDA events; None where any of them has none (a CPU run)."""
    times = [s["device_ms"] for s in named(request, name)]
    if not times or any(t is None for t in times):
        return None
    return sum(times)


def mean(values: list) -> float | None:
    return statistics.fmean(values) if values else None


def median(values: list) -> float | None:
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)
