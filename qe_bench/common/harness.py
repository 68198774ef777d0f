"""One run of one cell: set-up, a closed-loop window, the check.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in BENCHMARK.json:

    configs/<config>.json      sizes and guarantees; its "kind" names
    kinds/<kind>.py            make_data, setup, serve, fact_rows, answer_of
    traffic/<traffic>.json     the mix, read by common/traffic.py
    reference/<traffic>.py     the plain reference: answer(data, params)
    metrics/<metric>.py        read(ctx) -> number or None

The window is a closed loop with one client: the next request is issued
when the last one's answer is in hand (read back, or the frame
synchronised). Every answer of the window, or a sample of them drawn from
the seed where the mix says so, is held and compared with the reference
once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from collections import Counter

import numpy as np
import torch

from qe_bench.common import compare, sol, trace, traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
WARMUP = 2                 # untimed requests after set-up
TRACE_SLICE_S = 6.0        # the traced slice: at most this long ...
TRACE_SLICE_REQUESTS = 48  # ... and this many requests
HOST_SLICE_REQUESTS = 4    # the slice that also records the host
OUT_DIR = os.path.join(ROOT, "qe_bench_out")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_qe")


def load_module(path: str):
    """The Python file at `path` as a module of its own."""
    name = "qe_bench_" + "".join(ch if ch.isalnum() else "_"
                                 for ch in os.path.relpath(path, BENCH))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    kind: object
    reference: object
    end_to_end: list
    per_layer: list


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named `workload` with every file it names loaded."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)

    def of(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]

    return Cell(workload, w["chips"], cfg, mix,
                load_module(os.path.join(BENCH, "kinds", cfg["kind"] + ".py")),
                load_module(os.path.join(BENCH, "reference",
                                         w["traffic"] + ".py")),
                of(bench["end_to_end"]), of(bench["per_layer"]))


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Held:
    """The answers kept for the check: all of them, or a reservoir of
    `sample` drawn from the seed."""

    def __init__(self, sample: int | None, seed: int):
        self.sample, self.items, self.seen = sample, [], 0
        self.rng = np.random.default_rng([seed, 1])

    def add(self, params: dict, answer) -> None:
        self.seen += 1
        if self.sample is None or len(self.items) < self.sample:
            self.items.append((params, answer))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.sample:
            self.items[j] = (params, answer)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: str | torch.device, t0: float, control: bool = False) -> dict:
    """One run of `cell`; returns the result line's object. `t0` is the
    process's start on the host clock. With `control` the reference in
    lower precision serves in the program's place."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    kind = cell.kind
    from tpu_qe_torch.sort import driver

    phases = {"start": time.perf_counter() - t0}
    data = kind.make_data(cell.cfg, seed, device)
    _sync(device)
    phases["data"] = time.perf_counter() - t0
    state = kind.setup(data, device)
    serve, answer_of = kind.serve, kind.answer_of
    if control:
        def serve(state, mix, params):
            return cell.reference.answer(data, params, lower=True)

        def answer_of(out):
            return out
    reqs = traffic.requests(cell.mix, seed)
    for _ in range(WARMUP):
        serve(state, cell.mix, next(reqs))
    _sync(device)
    phases["warm_up"] = time.perf_counter() - t0
    # The program leaves reference cycles that hold n-row device tensors
    # after a query, which only the cyclic collector frees: the client
    # collects after every request, inside the window. Freezing what
    # set-up made keeps each collection to the objects made since.
    tracer = _Tracer(cell.name, device, driver) if traced else None
    if tracer is not None:
        tracer.warm()
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        retries0 = torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
    rows = kind.fact_rows(data)
    held = _Held(cell.mix.get("check_sample"), seed)
    lat, failed, errors = [], 0, []
    if tracer is not None:
        tracer.start()
    t_win = time.perf_counter()
    setup_s = t_win - t0
    t_last = t_win
    while True:
        t_issue = time.perf_counter()
        if t_issue - t_win >= seconds and (tracer is None or tracer.done):
            break
        params = next(reqs)
        try:
            with torch.profiler.record_function("request"):
                out = serve(state, cell.mix, params)
                _sync(device)
        except Exception as e:  # a request that fails is counted, not fatal
            failed += 1
            errors.append(f"{type(e).__name__}: {e}"[:300])
            out = None
        t_last = time.perf_counter()
        lat.append(t_last - t_issue)
        if out is not None:
            held.add(params, answer_of(out))
        del out
        gc.collect()
        if tracer is not None:
            tracer.after(t_last)
    window_s = t_last - t_win
    attempted = len(lat)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    retries = (torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
               - retries0) if cuda else 0
    del state
    if cuda:
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": attempted, "failed": failed}
    if traced:
        metrics, dev_extra, breakdown = tracer.result(cell, retries)
    else:
        metrics, dev_extra, breakdown = _end_to_end(
            cell, rows * (attempted - failed), window_s, setup_s,
            peak), {}, None
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak, **dev_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown

    mismatched, checked, memo = 0, 0, {}
    for params, answer in held.items:
        key = json.dumps(params, sort_keys=True)
        if key not in memo:
            memo[key] = cell.reference.answer(data, params)
        mismatched += compare.mismatches(answer, memo[key])
        checked += 1
    result["correct"] = failed == 0 and mismatched == 0 and checked > 0
    result["setup_phases_s"] = phases
    result["errors"] = errors[:5]
    result["checks"] = {
        "mismatched_values": {"value": mismatched, "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
        "answers_checked": {"value": checked, "least": 1}}
    return result


def _end_to_end(cell: Cell, rows: int, window_s: float, setup_s: float,
                peak) -> dict:
    """`rows`: the fact rows of every request completed in the window."""
    values = {
        "rows_per_s": rows / window_s if rows and window_s else None,
        "rows_per_s_hostpaced": rows / window_s if rows and window_s
        else None,
        "peak_mem_gib": peak / 2 ** 30 if peak is not None else None,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


class _Tracer:
    """The traced run's two slices at the start of the window.

    The first profiles the device alone over TRACE_SLICE_REQUESTS
    requests or TRACE_SLICE_S seconds: the per-layer metrics, busy and
    window seconds and the device operations come from it. Recording the
    host's operations slows the host several times over (and every
    collection after a request), so only the second, of HOST_SLICE_REQUESTS
    requests, records them too: it names what the host did in the longest
    idle gaps; the window runs on until it has ended. Each slice is read,
    written out and dropped as soon as it ends, so the rest of the window
    runs untraced.
    """

    def __init__(self, name: str, device: torch.device, driver):
        self.name, self.device, self.driver = name, device, driver
        self.cuda = device.type == "cuda"
        self.phase, self.prof, self.ctx, self.gaps = "device", None, None, []

    def _profile(self, host: bool):
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda else []
        if host or not self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0, self.n = time.perf_counter(), 0

    def warm(self) -> None:
        """Start and stop both kinds of profile once, in set-up: the first
        start loads some hundred thousand objects that every collection
        after a request would otherwise walk."""
        for host in (False, True):
            self._profile(host)
            self.prof.stop()
        self.prof = None

    def start(self) -> None:
        self.driver.RADIX_PASSES.clear()
        self._profile(host=False)

    def _export(self, suffix: str) -> None:
        os.makedirs(OUT_DIR, exist_ok=True)
        self.prof.export_chrome_trace(
            os.path.join(OUT_DIR, f"{self.name}{suffix}.json.gz"))

    def after(self, t_done: float) -> None:
        """Call after each request of the window, with its end."""
        self.n += 1
        if self.phase == "device" and (
                t_done - self.t0 >= TRACE_SLICE_S
                or self.n >= TRACE_SLICE_REQUESTS):
            self._end_device(t_done)
            self.phase = "host"
            self._profile(host=True)
        elif self.phase == "host" and self.n >= HOST_SLICE_REQUESTS:
            self._end_host()

    @property
    def done(self) -> bool:
        """Whether the host slice has ended: the window runs on until it
        has, in a traced run."""
        return self.phase == "done"

    def _end_device(self, t_done: float) -> None:
        self.prof.stop()
        wall_ms = (t_done - self.t0) * 1e3
        by_name, _, _ = trace.device_ops(self.prof)
        cats = trace.device_time(self.prof, wall_ms) if self.cuda else {
            "device_busy_ms": 0.0, "by_category_ms": {}}
        self.ctx = {
            "requests": max(self.n, 1), "wall_ms": wall_ms,
            "busy_ms": cats["device_busy_ms"],
            "by_category_ms": cats["by_category_ms"],
            "by_kernel_ms": by_name,
            "radix_passes": Counter(self.driver.RADIX_PASSES),
            "hbm_peak": (sol.hbm_peak_bytes_per_s(torch.cuda.get_device_name(
                self.device)) if self.cuda else None)}
        self._export("")
        self.prof = None
        gc.collect()

    def _end_host(self) -> None:
        self.prof.stop()
        _, dev, host = trace.device_ops(self.prof)
        self.gaps = trace.idle_gaps(dev, host)
        self._export(".host")
        self.prof, self.phase = None, "done"
        gc.collect()

    def result(self, cell: Cell, retries: int):
        """(per-layer metrics, busy and window seconds, breakdown)."""
        ctx = dict(self.ctx, alloc_retries=retries)
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(os.path.join(BENCH, "metrics",
                                              m["name"] + ".py"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": ctx["busy_ms"] / 1e3,
                     "window_s": ctx["wall_ms"] / 1e3}
        breakdown = {
            "device_ops": [[trace.short_name(k), v / 1e3]
                           for k, v in ctx["by_kernel_ms"].most_common(10)],
            "idle_gaps": self.gaps}
        return metrics, dev_extra, breakdown
