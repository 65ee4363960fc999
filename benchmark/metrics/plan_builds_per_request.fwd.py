"""Per-layer: the program's ``plan.build`` spans a request, a count: the
planner's structural builds on plan-cache misses, 0 in a steady state
(:mod:`benchmark.lib.program_spans`)."""

from benchmark.lib import program_spans


def read(run: dict):
    return program_spans.per_request(run, "plan.build")
