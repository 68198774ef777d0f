"""Tracing: one span API, off by default, and a profiler session.

``span(name, device=None, **counts)`` names a stretch of the program's
work, ``<layer>.<what>`` (``sql.query``, ``ops.compact``, ``sort.radix``,
...).

- **Off by default.** A span then costs one check of a flag: no
  ``record_function``, no NVTX range, no record.
- **On** while a ``torch.profiler`` session runs (torch sets
  ``torch.autograd.profiler._is_profiler_enabled`` on every start, whatever
  its activities), and inside ``tracing()``.
- **A span that is on** is a ``record_function`` range plus an NVTX range
  (with CUDA), so it lands in the profiler's trace beside the kernels, on
  the profiler's clock. It is also kept in memory: its name, its parent,
  host start and end (``perf_counter_ns``) and its counts (the keywords,
  and ``Span.count(k=v)`` after entry). With ``device`` a CUDA device it
  also records two CUDA events on that device's current stream; their
  elapsed time is read once they have completed, when a later request is
  filed or by ``records()``.
- **Requests.** A span opened while no span is open is a request's root.
  Its close files one request record in a ring of the last ``RING``.
  Entering ``tracing()`` empties the ring, so it then holds the requests
  traced inside it. A profiler session empties nothing: torch gives no
  hook at its start, and a process that profiles twice in a row (a device
  slice, then a host slice) reads both. The ring keeps tuples of plain
  values, which the cyclic collector stops walking (a client that
  collects after each request would otherwise walk every record kept);
  ``records()`` returns them as plain dicts, with request ids that tell
  sessions apart. No tensors, closures or frames are kept. The
  profiler's Chrome trace is the export.

Spans nest per process: open and close them on one thread.

``trace_session(trace_dir)`` profiles the CPU and, when available, the
GPU, and writes a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger("tpu_qe_torch")

RING = 256      # request records kept


class _Off:
    """The span of tracing that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Tracer:
    """The process's open spans and the ring of request records."""

    def __init__(self):
        self.forced = 0          # depth of tracing() blocks
        self.nvtx = None         # whether NVTX ranges can be pushed
        self.stack = []          # open spans, innermost last
        self.spans = []          # the open request's spans, in entry order
        self.seq = 0             # request ids
        self.ring = collections.deque(maxlen=RING)
        self.pending = []        # (device times, span index, start, end)


_TRACER = _Tracer()


class Span:
    """A span that is on (see the module's docstring)."""

    __slots__ = ("name", "counts", "device", "index", "parent", "start_ns",
                 "end_ns", "events", "_range")

    def __init__(self, name: str, device, counts: dict):
        self.name, self.counts, self.device = name, counts, device
        self.events = None

    def count(self, **counts) -> None:
        """Add numbers to the span's counts."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        tr = _TRACER
        if not tr.stack:
            tr.spans = []
        self.parent = tr.stack[-1].index if tr.stack else None
        self.index = len(tr.spans)
        tr.spans.append(self)
        tr.stack.append(self)
        if tr.nvtx is None:
            tr.nvtx = torch.cuda.is_available()
        if tr.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        tr = _TRACER
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self._range.__exit__(*exc)
        self._range = None
        if tr.nvtx:
            torch.cuda.nvtx.range_pop()
        tr.stack.pop()
        if not tr.stack:
            _file_request(tr)
        return False


def _read_events(tr: _Tracer, wait: bool) -> None:
    """Move the elapsed time of completed events into their records; with
    `wait`, wait for all of them."""
    keep = []
    for times, index, start, end in tr.pending:
        if wait:
            end.synchronize()
        if wait or end.query():
            times[index] = start.elapsed_time(end)
        else:
            keep.append((times, index, start, end))
    tr.pending = keep


def _file_request(tr: _Tracer) -> None:
    """Turn the closed request's spans into its record in the ring:
    (id, spans, device times by span index), each span (name, parent
    index, start ns, end ns, counts as (key, value) pairs)."""
    _read_events(tr, wait=False)
    tr.seq += 1
    times = {}
    for s in tr.spans:
        if s.events is not None:
            tr.pending.append((times, s.index) + s.events)
    tr.ring.append((tr.seq, tuple(
        (s.name, s.parent, s.start_ns, s.end_ns, tuple(s.counts.items()))
        for s in tr.spans), times))
    tr.spans = []


def enabled() -> bool:
    """Whether spans are on: a profiler session runs or tracing() is
    held."""
    return bool(_autograd_profiler._is_profiler_enabled or _TRACER.forced)


def span(name: str, device: torch.device | None = None, **counts):
    """A context manager that traces the enclosed work as `name` while
    tracing is on; `device`, when a CUDA device, times it with events."""
    if not (_autograd_profiler._is_profiler_enabled or _TRACER.forced):
        return _OFF
    return Span(name, device, counts)


@contextlib.contextmanager
def tracing():
    """Turn tracing on for the enclosed block, without a profiler; the
    outermost block starts the ring anew."""
    if not _TRACER.forced:
        _TRACER.ring.clear()
        _TRACER.pending = []
    _TRACER.forced += 1
    try:
        yield
    finally:
        _TRACER.forced -= 1


def records() -> list[dict]:
    """The request records in the ring, oldest first, as plain dicts:
    {"id", "name" (the root's), "spans": [{"name", "parent" (the parent's
    index in the list, None for the root), "request", "start_ns",
    "end_ns", "counts", "device_ms"}]}. Reading the event-timed spans'
    device time waits for their events."""
    _read_events(_TRACER, wait=True)
    return [{"id": rid, "name": spans[0][0], "spans": [
        {"name": name, "parent": parent, "request": rid, "start_ns": start,
         "end_ns": end, "counts": dict(counts), "device_ms": times.get(i)}
        for i, (name, parent, start, end, counts) in enumerate(spans)]}
        for rid, spans, times in _TRACER.ring]


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
