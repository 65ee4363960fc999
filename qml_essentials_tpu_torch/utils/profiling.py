"""Profiling utilities: profiler traces, steady-state timing, memory stats.

``xla_trace`` keeps the JAX package's name for parity; here it records a
``torch.profiler`` trace (CPU and, on a card, CUDA activity) and writes it
as a Chrome trace that Perfetto or ``chrome://tracing`` opens.  ``timed``
synchronizes the result's device where the JAX package blocks on the
result.

Counterpart of ``qml_essentials_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "qml_torch_trace")


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Record a torch profiler trace of the enclosed block into *log_dir*
    (``<TMPDIR>/qml_torch_trace`` by default) as ``trace.json``, a Chrome
    trace; yields the directory.  CUDA activity is recorded when CUDA is
    available.  Usage::

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
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
