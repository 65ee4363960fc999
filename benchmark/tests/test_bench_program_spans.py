"""The readers of the program's spans on a fabricated span buffer (the
profiler's first request dropped, None without a trace or without spans),
and the program's spans on the benchmark's clock."""

from collections import namedtuple

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import cells, program_spans, trace

S = namedtuple("S", "name start_us end_us parent request id")
TRACED = {"trace": {"window_s": 1.0, "busy_s": 0.5}}
FWD = ("host_record_ms.fwd", "host_plan_ms.fwd", "plan_builds_per_request.fwd",
       "host_run_ms.fwd")
TRAIN = tuple(n.replace(".fwd", ".train") for n in FWD) + ("host_backward_ms.train",)


def _request(rid: int, t0: float, build: bool = False) -> list:
    """One request from ``t0`` (µs): record 1 ms, prepare 0.5 ms, two
    elements of materialize 0.25 ms and run 2 ms, then the backward of
    each element, 3 ms, after the forward; ``build`` adds a plan build."""
    spans = [S("model.forward", t0, t0 + 6000, None, rid, rid),
             S("script.record", t0, t0 + 1000, rid, rid, rid + 1),
             S("plan.prepare", t0 + 1000, t0 + 1500, rid, rid, rid + 2)]
    t = t0 + 1500
    for i in range(2):
        spans += [S("plan.materialize", t, t + 250, rid, rid, rid + 3 + 2 * i),
                  S("run.forward", t + 250, t + 2250, rid, rid, rid + 4 + 2 * i)]
        t += 2250
    spans += [S("run.backward", t0 + 7000 + 3000 * i, t0 + 10000 + 3000 * i, None, rid,
                rid + 7 + i) for i in range(2)]
    if build:
        spans.append(S("plan.build", t0 + 1100, t0 + 1400, rid + 2, rid, rid + 9))
    return spans


@pytest.fixture
def buffer(monkeypatch):
    """Three requests; the first, the profiler's, slow and with a build."""
    spans = (_request(0, 0.0, build=True) + _request(10, 20000.0)
             + _request(20, 40000.0, build=True))
    spans[1] = spans[1]._replace(end_us=5000.0)  # the first request's slow record
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    return spans


def test_each_reader_on_a_span_buffer(buffer):
    want = {"host_record_ms": 1.0, "host_plan_ms": 0.5 + 2 * 0.25,
            "plan_builds_per_request": 0.5, "host_run_ms": 4.0, "host_backward_ms": 6.0}
    for name in FWD + TRAIN:
        got = cells.reader(name)(TRACED)
        assert got == pytest.approx(want[name.split(".")[0]]), name


def test_the_profilers_first_request_is_dropped(buffer):
    kept, n = program_spans.requests(TRACED)
    assert n == 2 and min(s.start_us for s in kept) == 20000.0
    assert all(s.request in (10, 20) for s in kept)


def test_none_without_a_trace_or_spans(buffer, monkeypatch):
    for name in FWD + TRAIN:
        assert cells.reader(name)({"trace": None}) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: buffer[:9])  # one request
    for name in FWD + TRAIN:
        assert cells.reader(name)(TRACED) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [])  # a program without spans
    for name in FWD + TRAIN:
        assert cells.reader(name)(TRACED) is None


def test_a_count_reads_zero_and_a_time_none_without_its_spans(buffer, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: [s for s in buffer if s.name not in ("plan.build",
                                                                     "run.backward")])
    assert cells.reader("plan_builds_per_request.train")(TRACED) == 0.0
    assert cells.reader("host_backward_ms.train")(TRACED) is None


def test_program_spans_nest_in_the_benchmarks_on_one_clock():
    """A request under the profiler, inside a benchmark span: the program's
    spans fall within it, and ``reduce_trace`` names a gap inside a program
    span by that span."""
    from qml_essentials_tpu_torch import Model
    from qml_essentials_tpu_torch.utils import profiling

    model = Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19", device="cpu")
    model(inputs=0.1)
    profiling.clear_spans()
    bench = trace.Spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with bench.span("bench:request"):
            with bench.span("bench:forward"):
                model(inputs=torch.tensor([0.2, 0.3]))
    ours = program_spans.recorded()
    profiling.clear_spans()
    (_, lo, hi), = [s for s in bench.spans if s[0] == "bench:forward"]
    assert {s.name for s in ours} >= {"model.forward", "script.record", "run.forward"}
    assert all(lo <= s.start_us <= s.end_us <= hi for s in ours)

    run = next(s for s in ours if s.name == "run.forward")
    spans = bench.spans + [(s.name, s.start_us, s.end_us) for s in ours]
    events = [{"cat": "kernel", "name": "k", "ts": lo, "dur": run.start_us - lo, "corr": 1},
              {"cat": "kernel", "name": "k", "ts": run.end_us, "dur": hi - run.end_us,
               "corr": 2}]
    t = trace.reduce_trace(events, spans)
    assert t["idle_gaps"][0][0] == "run.forward"
