"""Per-layer: the program's ``plan.materialize`` spans a training step, a
count: one a chunk where a batch's payloads are composed once for the
chunk, one an element where each element composes its own
(:mod:`benchmark.lib.program_spans`)."""

from benchmark.lib import program_spans


def read(run: dict):
    return program_spans.per_request(run, "plan.materialize")
