"""The traced slice: the device's timeline from ``torch.profiler`` (CUDA
activity alone) beside the benchmark's own host spans, reduced to the
device's busy time, the port's kernel time, the busiest device operations and
the longest idle gaps.

Host spans (``bench:request``, ``bench:forward``, ..., and
``bench:kernel:<wrapper>`` around each kernel call of the port) are taken by
this code on the system clock in nanoseconds, the clock the profiler reports
device and launch times on.  Recording the host's operators as well would
make a 24-qubit training step 7x slower, the device's timeline alone 3x
(PERF.md), so the profiler records no host operator.

The slice's window runs from the first ``bench:request`` span's start to the
last one's end.  The device is busy where any kernel, copy or set ran: the
union of their intervals inside the window (the method of the program's
``chip_smoke.py``).  A kernel is the port's when the runtime call that
launched it (matched by the profiler's correlation id) lies inside a
``bench:kernel:*`` span.  Each idle gap is named by the innermost host span
at its middle.
"""

from __future__ import annotations

import bisect
import json
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def trace_path(cell: str) -> Path:
    """Where a traced run of ``cell`` writes its reduced trace: under the
    run's temporary directory, one file a cell, overwritten by the next."""
    d = Path(tempfile.gettempdir()) / "benchmark_traces"
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{cell}.json"


class Spans:
    """Host spans ``(name, start_us, end_us)`` on the profiler's clock."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, float, float]] = []

    @contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start / 1e3, time.time_ns() / 1e3))


class NoSpans:
    """Spans outside a traced slice: nothing is taken."""

    @contextmanager
    def span(self, name: str):
        yield


NO_SPANS = NoSpans()


class Tracer:
    """Profiles the device over the enclosed block; ``events`` holds the
    device operations and the runtime's launch calls afterwards, read in
    memory (a 30 s window's Chrome trace would take 2 GB of disk)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # Without a card (the CPU tests) the profiler records the host alone
        # and the slice finds no device operation.
        cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.start()
        return self

    def __exit__(self, *exc) -> None:
        self.prof.stop()
        self.events = [ev for ev in map(_event, self.prof.profiler.kineto_results.events())
                       if ev is not None]
        del self.prof


def _event(e) -> Optional[dict]:
    """A device operation, or the host's runtime call (``launch``) that
    started one; None for anything else."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
    elif name.startswith("cu"):
        cat = "launch"
    else:
        return None
    return {"cat": cat, "name": name, "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
            "corr": e.correlation_id()}


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The merged intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(spans: List[Tuple[str, float, float]], t: float) -> Optional[str]:
    """The latest-starting span that covers ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else None


def reduce_trace(events: List[dict], spans: List[Tuple[str, float, float]]) -> Optional[dict]:
    """The traced slice's numbers (seconds), or None without a
    ``bench:request`` span or a device operation in it."""
    requests = [(s, e) for name, s, e in spans if name == "bench:request"]
    if not requests:
        return None
    lo, hi = min(s for s, _ in requests), max(e for _, e in requests)
    device = [e for e in events if e["cat"] in DEVICE_CATS
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if not device:
        return None
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device], lo, hi)
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    kernels = [e for e in device if e["cat"] == "kernel"]

    calls = sorted((s, e) for name, s, e in spans if name.startswith("bench:kernel"))
    launched = {e["corr"]: e["ts"] for e in events if e["cat"] == "launch"}
    port = []
    for k in kernels:
        t = launched.get(k["corr"])
        i = -1 if t is None else bisect.bisect_right(calls, (t, float("inf"))) - 1
        if i >= 0 and calls[i][0] <= t <= calls[i][1]:
            port.append(k)

    gaps, cursor = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > cursor:
            gaps.append((s - cursor, cursor, s))
        cursor = max(cursor, e)
    gaps.sort(reverse=True)
    idle_gaps = [[_innermost(spans, (s + e) / 2) or "outside bench spans", length / 1e6]
                 for length, s, e in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": sum(e["dur"] for e in kernels) / 1e6,
        "port_kernel_s": sum(e["dur"] for e in port) / 1e6,
        "port_kernel_names": sorted({e["name"][:120] for e in port}),
        "device_ops": [[n[:200], s] for n, s in top],
        "idle_gaps": idle_gaps,
    }


def write_summary(summary: dict, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
