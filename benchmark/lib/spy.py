"""Kernel-call ranges for the traced run.

While entered, every outermost call of the port's kernel wrappers
(``ops/cuda_kernels.py``) runs inside a ``bench:kernel:<wrapper>`` host span
(:class:`benchmark.lib.trace.Spans`), and its least time (:func:`benchmark.lib.work.least_seconds` of the
shapes it was called at) is summed.  Calls a wrapper makes of another wrapper
(a float64 state run as a batch of one) count once, with the outer call.  Only
the traced slice enters it: the spans cost the host a few microseconds a call.
"""

from __future__ import annotations

import inspect
import threading
from typing import Dict

from benchmark.lib import work
from benchmark.lib.trace import Spans


class KernelSpy:
    def __init__(self, module, spans: Spans) -> None:
        self.module, self.spans = module, spans
        self.names = [n for n in work.WRAPPERS if hasattr(module, n)]
        self.least_s = 0.0
        self.calls: Dict[str, int] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    def _wrap(self, name: str, fn):
        signature = inspect.signature(fn)

        def spy(*args, **kwargs):
            if getattr(self._local, "inside", False):
                return fn(*args, **kwargs)
            self._local.inside = True
            try:
                with self.spans.span(f"bench:kernel:{name}"):
                    out = fn(*args, **kwargs)
            finally:
                self._local.inside = False
            ordered = tuple(signature.bind(*args, **kwargs).arguments.values())
            least = work.least_seconds(*work.call_work(name, ordered, out))
            with self._lock:
                self.least_s += least
                self.calls[name] = self.calls.get(name, 0) + 1
            return out

        return spy

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc) -> None:
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)
