"""The measured window and the traced slice.

:class:`Window` holds the device's peak memory and the program's launch
counters over the measured loop.  :class:`TracedSlice`, entered after the
window in a ``--trace 1`` run, profiles a fixed number of further requests at
the same load with the host spans and kernel-call spans of
:mod:`benchmark.lib.trace` and :mod:`benchmark.lib.spy`: tracing slows the
host 3x, so the window's own numbers (rates, launches, model flops) are taken
untraced and the slice gives what only a trace can."""

from __future__ import annotations

from contextlib import ExitStack

import torch

from benchmark.lib import program
from benchmark.lib.spy import KernelSpy
from benchmark.lib.trace import Spans, Tracer, reduce_trace, trace_path, write_summary


class Window:
    """``with Window(device) as w:`` around the measured loop; afterwards
    ``w.setup_peak``, ``w.peak`` (bytes) and ``w.launches`` (the window's
    launches by kernel)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device

    def __enter__(self):
        program.sync(self.device)
        self.setup_peak = program.peak_bytes(self.device)
        program.reset_peak(self.device)
        self._before = program.launches()
        return self

    def __exit__(self, *exc) -> None:
        program.sync(self.device)
        self.peak = program.peak_bytes(self.device)
        self.launches = program.launch_diff(program.launches(), self._before)


class TracedSlice:
    """``with TracedSlice(cell, device) as t:`` around requests issued with
    ``t.spans``; afterwards ``t.summary`` (None without a device operation),
    also written to :func:`benchmark.lib.trace.trace_path`."""

    def __init__(self, cell: str, device: torch.device) -> None:
        self.cell, self.device = cell, device
        self.spans = Spans()
        self.summary = None

    def __enter__(self):
        program.sync(self.device)
        self._stack = ExitStack()
        self.spy = self._stack.enter_context(KernelSpy(program.kernels_module(), self.spans))
        self.tracer = self._stack.enter_context(Tracer())
        return self

    def __exit__(self, *exc) -> None:
        program.sync(self.device)
        self._stack.close()
        if exc[0] is None:
            self.summary = reduce_trace(self.tracer.events, self.spans.spans)
            del self.tracer.events
            if self.summary is not None:
                self.summary["least_s"] = self.spy.least_s
                self.summary["spied_calls"] = dict(self.spy.calls)
                write_summary(self.summary, trace_path(self.cell))
