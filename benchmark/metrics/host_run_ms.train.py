"""Per-layer: the program's ``run.forward`` spans, milliseconds a request
(the engine's run of each plan with its launches, and the readout).
Read under the profiler, which slows the host about 3x: a comparison
between versions of the program, as ``idle_share.*`` is, not the untraced
window's time (:mod:`benchmark.lib.program_spans`)."""

from benchmark.lib import program_spans


def read(run: dict):
    return program_spans.host_ms(run, ("run.forward",))
