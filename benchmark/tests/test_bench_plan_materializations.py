"""``plan_materializations_per_request.train`` on fabricated span buffers:
the ``plan.materialize`` spans a request, the profiler's first request
dropped; None without a trace."""

from collections import namedtuple

import pytest

from benchmark.lib import cells, program_spans

S = namedtuple("S", "name start_us end_us parent request id")
TRACED = {"trace": {"window_s": 1.0, "busy_s": 0.5}}
NAME = "plan_materializations_per_request.train"


def _buffer(per_request: int) -> list:
    """Three steps of a batch of 8 from 0, 20 and 40 ms, each with
    *per_request* materializations (8: one an element; 1: one a chunk)."""
    spans = []
    for r, t0 in enumerate((0.0, 20000.0, 40000.0)):
        rid = 100 * r
        spans.append(S("model.forward", t0, t0 + 9000, None, rid, rid))
        spans += [S("plan.materialize", t0 + 1000 * i, t0 + 1000 * i + 500, rid, rid,
                    rid + 1 + i) for i in range(per_request)]
    return spans


@pytest.mark.parametrize("per_request", [8, 1], ids=["each_element", "once_a_chunk"])
def test_materializations_a_request(per_request, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: _buffer(per_request))
    assert cells.reader(NAME)(TRACED) == per_request
    assert cells.reader(NAME)({"trace": None}) is None


def test_none_without_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    assert cells.reader(NAME)(TRACED) is None
