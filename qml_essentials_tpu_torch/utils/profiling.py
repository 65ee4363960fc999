"""Profiling utilities: profiler traces, program spans, steady-state
timing, memory stats.

``xla_trace`` keeps the JAX package's name for parity; here it records a
``torch.profiler`` trace (CPU and, on a card, CUDA activity) and writes it
as a Chrome trace that Perfetto or ``chrome://tracing`` opens, with the
program's spans beside the profiler's events.  ``timed`` synchronizes the
result's device where the JAX package blocks on the result.

*Program spans.*  While a ``torch.profiler`` session is active (any
activities, ``xla_trace`` or the caller's own), the port records a host span
at each layer boundary of a request:

==================== ========================================================
``model.forward``    ``Model.forward``, the whole call: one request
``script.record``    the circuit's recording (a batch: the batched tape and
                     the check of its last element)
``plan.prepare``     plan key, plan-cache slot, chunk size and route decision
``plan.materialize`` the payloads of one element, chunk or single tape
``plan.build``       the planner's structural build, on a plan-cache miss
                     only (inside ``plan.prepare`` or ``plan.materialize``)
``run.forward``      the engine's run of a plan and the readout, for one
                     element or one vectorised batch
``run.backward``     the saved or adjoint executor's reverse walk, on
                     autograd's thread, with its forward's request
==================== ========================================================

``script.record``, ``plan.prepare``, ``plan.materialize``, ``run.forward``
and ``run.backward`` never nest in one another, so their host times add up.
No span is taken per plan step or per kernel launch.  Each span is a
:class:`Span` with start and end in microseconds of the system clock
(``time.time_ns() / 1e3``), the clock the profiler reports device and launch
times on, so a span lines up with the kernels it launched.  Outside a
profiler session a span costs a call and one check of the profiler's state
(no allocation: the same inert object every time).
:func:`spans` reads the bounded buffer, :func:`clear_spans` empties it.

Counterpart of ``qml_essentials_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Deque, Iterator, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"

# ---------------------------------------------------------------------------
# Program spans
# ---------------------------------------------------------------------------

# Spans kept; past it the oldest are dropped.
SPAN_CAPACITY = 1 << 16


class Span(NamedTuple):
    """One recorded span: ``name``, ``start_us`` and ``end_us`` on the
    system clock; ``parent``, the ``id`` of the span that enclosed it on the
    same thread (None at a thread's top); ``request``, the ``id`` of the
    ``model.forward`` span its work belongs to (None outside a request);
    its own ``id`` (in opening order) and ``thread`` (the OS thread id)."""

    name: str
    start_us: float
    end_us: float
    parent: Optional[int]
    request: Optional[int]
    id: int
    thread: int


# Appends and reads of a deque are atomic under the interpreter lock, so
# autograd's threads append without a lock.
_SPANS: Deque[Span] = collections.deque(maxlen=SPAN_CAPACITY)
_IDS = itertools.count()
_OPEN = threading.local()  # .stack: [(id, request)] of the thread's open spans
_profiling = torch.autograd._profiler_enabled


class _Unrecorded:
    """The span taken outside a profiler session: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_UNRECORDED = _Unrecorded()


class _Recorded:
    __slots__ = ("name", "opens_request", "request", "id", "parent", "start", "stack")

    def __init__(self, name: str, opens_request: bool, request: Optional[int]) -> None:
        self.name, self.opens_request, self.request = name, opens_request, request

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        self.parent, request = stack[-1] if stack else (None, None)
        if self.request is None:
            self.request = self.id if request is None and self.opens_request else request
        self.stack = stack
        stack.append((self.id, self.request))
        self.start = time.time_ns()
        return None

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.stack.pop()
        _SPANS.append(Span(self.name, self.start / 1e3, end / 1e3, self.parent, self.request,
                           self.id, threading.get_native_id()))
        return None


def span(name: str, *, opens_request: bool = False, request: Optional[int] = None):
    """``with span(name):`` records the enclosed block while a profiler
    session is active on this thread (autograd's threads see the session of
    the thread that called ``backward``).  The span's request is *request*
    when given, else the enclosing span's; ``opens_request``: the span is a
    request (``model.forward``), its own ``id`` its request unless an
    enclosing span already has one."""
    if not _profiling():
        return _UNRECORDED
    return _Recorded(name, opens_request, request)


def current_request() -> Optional[int]:
    """The request of this thread's innermost recorded open span (None
    outside a profiler or a request): what a forward hands its backward,
    which runs on another thread, as :func:`span`'s *request*."""
    if not _profiling():
        return None
    stack = getattr(_OPEN, "stack", None)
    return stack[-1][1] if stack else None


def spans() -> List[Span]:
    """The recorded spans in opening order (the last ``SPAN_CAPACITY``)."""
    return sorted(_SPANS, key=lambda s: s.id)


def clear_spans() -> None:
    """Empty the span buffer."""
    _SPANS.clear()


def _chrome_events(recorded: List[Span], base_us: float) -> List[dict]:
    """Chrome trace events of *recorded*, one track a thread beside the
    profiler's, on a trace whose timestamps count from *base_us*."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": f"program spans {s.thread}", "ts": s.start_us - base_us,
             "dur": s.end_us - s.start_us,
             "args": {"id": s.id, "parent": s.parent, "request": s.request}}
            for s in recorded]


def _add_spans(path: str, recorded: List[Span]) -> None:
    """Write *recorded* into the Chrome trace at *path*: its timestamps are
    microseconds after ``baseTimeNanoseconds`` where the trace gives one,
    else on the system clock itself."""
    with open(path) as f:
        trace = json.load(f)
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    trace.setdefault("traceEvents", []).extend(_chrome_events(recorded, base_us))
    with open(path, "w") as f:
        json.dump(trace, f)


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "qml_torch_trace")


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Record a torch profiler trace of the enclosed block into *log_dir*
    (``<TMPDIR>/qml_torch_trace`` by default) as ``trace.json``, a Chrome
    trace; yields the directory.  CUDA activity is recorded when CUDA is
    available, and the program's spans of the block (:func:`span`) on
    tracks of their own.  Usage::

        with xla_trace("build/trace") as d:
            model(inputs=0.3)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = _default_log_dir() if log_dir is None else log_dir
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    first = next(_IDS)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        _add_spans(path, [s for s in spans() if s.id > first])


def _sync(out) -> None:
    """Wait for the devices that *out*'s tensors live on."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)


def timed(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 1,
    **kwargs,
) -> dict:
    """First-call + steady-state timing of a callable.

    Returns ``{"compile_s", "mean_s", "result"}``: ``compile_s`` is the
    first call (a kernel build included, when it is the process's first
    launch), ``mean_s`` the mean over *iters* calls after *warmup* calls in
    all; every measurement waits for the result's device, so asynchronous
    launches cannot skew it.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    compile_s = time.perf_counter() - t0

    for _ in range(max(0, warmup - 1)):
        _sync(fn(*args, **kwargs))

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    mean_s = (time.perf_counter() - t0) / iters
    return {"compile_s": compile_s, "mean_s": mean_s, "result": out}


def device_memory_stats(device: Optional[object] = None) -> dict:
    """``torch.cuda.memory_stats`` of a card (the current one by default);
    an empty dict for the CPU, as the JAX package gives on CPU backends."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
