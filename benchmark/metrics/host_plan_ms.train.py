"""Per-layer: the program's ``plan.prepare`` and ``plan.materialize`` spans,
milliseconds a request (plan key, cache slot, chunk size, route, payloads).
Read under the profiler, which slows the host about 3x: a comparison
between versions of the program, as ``idle_share.*`` is, not the untraced
window's time (:mod:`benchmark.lib.program_spans`)."""

from benchmark.lib import program_spans


def read(run: dict):
    return program_spans.host_ms(run, ("plan.prepare", "plan.materialize"))
