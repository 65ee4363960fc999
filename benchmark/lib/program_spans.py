"""The program's own spans, read after a traced run: the spans that
``qml_essentials_tpu_torch.utils.profiling`` records at its layer boundaries
while a profiler session is active, which in a run is the traced slice alone.

Each span has ``name``, ``start_us`` and ``end_us`` on the system clock (the
clock of :mod:`benchmark.lib.trace`'s spans and of the profiler's device and
launch times), ``request`` (the ``id`` of the ``model.forward`` span its work
belongs to) and ``id``.  A ``model.forward`` span whose ``request`` is its own
``id`` is one request: a serving request, or a training step's forward.

The slice's first request runs outside the benchmark's spans (the profiler's
first launches), so the per-request numbers count from the start of the
second request and divide by the requests from there: a training step's
backward, which runs after its forward, counts with its step.

The host times are read under the profiler, which slows the host about 3x:
like ``idle_share.*`` they compare versions of the program run the same way,
and are not the untraced window's time.  A program that records no spans
gives None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def recorded() -> list:
    """The program's recorded spans; empty where the program records none."""
    try:
        from qml_essentials_tpu_torch.utils import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    return list(spans()) if callable(spans) else []


def requests(run: dict, spans: Optional[list] = None) -> Optional[Tuple[List, int]]:
    """The spans from the second profiled request on and the number of
    requests they hold; None without a trace or two requests."""
    if run.get("trace") is None:
        return None
    spans = recorded() if spans is None else spans
    starts = sorted(s.start_us for s in spans
                    if s.name == "model.forward" and s.request == s.id)
    if len(starts) < 2:
        return None
    return [s for s in spans if s.start_us >= starts[1]], len(starts) - 1


def host_ms(run: dict, names: Iterable[str]) -> Optional[float]:
    """Milliseconds a request in the spans of ``names`` (their summed
    durations over the requests); None where none was recorded."""
    got = requests(run)
    if got is None:
        return None
    kept, n = got
    names = set(names)
    times = [s.end_us - s.start_us for s in kept if s.name in names]
    return sum(times) / 1e3 / n if times else None


def per_request(run: dict, name: str) -> Optional[float]:
    """Spans of ``name`` a request (a count: 0 where there were none)."""
    got = requests(run)
    if got is None:
        return None
    kept, n = got
    return sum(1 for s in kept if s.name == name) / n
