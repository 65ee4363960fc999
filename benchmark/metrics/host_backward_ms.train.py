"""Per-layer: the program's ``run.backward`` spans, milliseconds a step
(the saved or adjoint executor's reverse walk, on autograd's thread).
Read under the profiler, which slows the host about 3x: a comparison
between versions of the program, as ``idle_share.*`` is, not the untraced
window's time (:mod:`benchmark.lib.program_spans`)."""

from benchmark.lib import program_spans


def read(run: dict):
    return program_spans.host_ms(run, ("run.backward",))
