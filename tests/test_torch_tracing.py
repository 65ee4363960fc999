"""The port's program spans (``utils/profiling.py``): recorded only under a
profiler, at the model, record, plan, run and backward boundaries, each with
its request and parent; none nested in another of the timed five; the plan
built once; the executors' backwards carrying their forward's request; a
bounded buffer; the spans in ``xla_trace``'s Chrome trace."""

import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.utils import profiling
from qml_essentials_tpu_torch.utils.profiling import TRACE_FILE, xla_trace

# The spans whose host times add up: none may enclose another.
TIMED = ("script.record", "plan.prepare", "plan.materialize", "run.forward", "run.backward")
# What every request records, whatever its route.
CHILDREN = ("script.record", "plan.prepare", "plan.materialize", "run.forward")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _model(n=4, noise_params=None):
    model = Model(n_qubits=n, n_layers=1, circuit_type="Circuit_19", device="cpu")
    model.noise_params = noise_params
    return model


def _by_id():
    return {s.id: s for s in profiling.spans()}


def _requests():
    return [s for s in profiling.spans() if s.name == "model.forward" and s.request == s.id]


@pytest.mark.unittest
def test_no_span_without_a_profiler():
    model = _model()
    model(inputs=0.3)
    model(inputs=torch.linspace(-1, 1, 3))
    assert not torch.autograd._profiler_enabled()
    with profiling.span("plan.prepare"):
        pass
    assert profiling.spans() == []


@pytest.mark.unittest
@pytest.mark.parametrize("inputs", [0.3, torch.linspace(-1, 1, 3)], ids=["single", "batched"])
def test_a_request_records_its_children(inputs):
    model = _model()
    _profiled(lambda: model(inputs=inputs))
    (req,) = _requests()
    spans = profiling.spans()
    assert req.parent is None
    names = [s.name for s in spans if s is not req]
    for name in CHILDREN:
        assert name in names
    for s in spans:
        assert s.request == req.id
        if s.name in CHILDREN:
            assert s.parent == req.id, s
        assert req.start_us <= s.start_us <= s.end_us <= req.end_us
    # A batched call records the batch once and checks its last element
    # within the same span; a batch below the large-state line runs once.
    assert names.count("script.record") == 1
    assert names.count("run.forward") == 1


@pytest.mark.unittest
def test_per_element_runs_span_each_element(monkeypatch):
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", 4)
    model = _model()
    _profiled(lambda: model(inputs=torch.linspace(-1, 1, 3)))
    names = [s.name for s in profiling.spans()]
    assert names.count("plan.materialize") == 1 and names.count("run.forward") == 3
    assert names.count("plan.prepare") == 1


@pytest.mark.unittest
def test_the_timed_spans_never_nest():
    model = _model(5, noise_params={"Depolarizing": 0.01})
    model.params.requires_grad_(True)

    def step():
        model(inputs=torch.linspace(-1, 1, 2), force_mean=True).sum().backward()
        model(inputs=0.2)

    _profiled(step)
    by_id = _by_id()
    for s in by_id.values():
        if s.name not in TIMED:
            continue
        p = s.parent
        while p is not None:
            assert by_id[p].name not in TIMED, (s.name, by_id[p].name)
            p = by_id[p].parent


@pytest.mark.unittest
@pytest.mark.parametrize("noise", [None, {"Depolarizing": 0.01}], ids=["pure", "density"])
@pytest.mark.parametrize("inputs", [0.3, torch.linspace(-1, 1, 3)], ids=["single", "batched"])
def test_the_plan_is_built_on_the_first_call_only(noise, inputs):
    model = _model(noise_params=noise)
    _profiled(lambda: model(inputs=inputs))
    builds = [s for s in profiling.spans() if s.name == "plan.build"]
    assert builds
    by_id = _by_id()
    for b in builds:  # inside the plan's preparation or a materialization
        assert by_id[b.parent].name in ("plan.prepare", "plan.materialize")
    profiling.clear_spans()
    _profiled(lambda: model(inputs=inputs))
    names = [s.name for s in profiling.spans()]
    assert "model.forward" in names and "plan.build" not in names


@pytest.mark.unittest
@pytest.mark.parametrize("mode", ["auto", "adjoint"], ids=["saved", "adjoint"])
def test_the_executor_backward_carries_its_request(monkeypatch, mode):
    """From ``LARGE_STATE_MIN_N`` qubits a gradient runs the saved executor
    (or, forced, the adjoint one) element by element: one ``run.backward`` a
    forward, each with the request of the ``model.forward`` that ran it."""
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", 4)
    monkeypatch.setattr(tsim, "BACKWARD_MODE", mode)
    model = _model()
    model.params.requires_grad_(True)

    def steps():
        for x in (0.3, -0.5):
            model(inputs=x, force_mean=True).sum().backward()

    _profiled(steps)
    reqs = _requests()
    backs = [s for s in profiling.spans() if s.name == "run.backward"]
    assert len(reqs) == 2 and len(backs) == 2
    for req, back in zip(reqs, backs):
        assert back.request == req.id
        assert back.start_us >= req.end_us  # after its forward, outside it
    assert model.params.grad is not None


@pytest.mark.unittest
def test_a_span_takes_a_given_request_on_another_thread():
    """A span on another thread (a backward's) has no enclosing span; it
    takes the request its forward handed it, and records while the session
    is visible there."""
    got = {}

    def work():
        with profiling.span("run.backward", request=got["request"]):
            pass

    def traced():
        with profiling.span("model.forward", opens_request=True):
            with profiling.span("run.forward"):
                got["request"] = profiling.current_request()
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    _profiled(traced)
    (req,) = _requests()
    assert got["request"] == req.id
    assert profiling.current_request() is None  # outside a profiler
    # A plain thread does not see the session (autograd's threads do).
    assert [s.name for s in profiling.spans()] == ["model.forward", "run.forward"]
    profiling.clear_spans()
    _profiled(work)
    (back,) = profiling.spans()
    assert back.request == req.id and back.parent is None


@pytest.mark.unittest
def test_the_buffer_is_bounded():
    extra = 10

    def many():
        for _ in range(profiling.SPAN_CAPACITY + extra):
            with profiling.span("plan.prepare"):
                pass

    _profiled(many)
    spans = profiling.spans()
    assert len(spans) == profiling.SPAN_CAPACITY
    ids = [s.id for s in spans]
    assert ids == sorted(ids) and ids[-1] - ids[0] == profiling.SPAN_CAPACITY - 1
    profiling.clear_spans()
    assert profiling.spans() == []


@pytest.mark.unittest
def test_threads_append_without_losing_spans(monkeypatch):
    """More threads than cores record nested spans at once (as autograd's
    threads append beside the caller's): no span is lost, every id is
    unique, and each parent is the enclosing span of the same thread."""
    import sys

    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    threads, per = 4 * (os.cpu_count() or 1), 200

    def work():
        for _ in range(per):
            with profiling.span("model.forward", opens_request=True):
                with profiling.span("run.forward"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = profiling.spans()
    assert len(spans) == 2 * threads * per
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "run.forward":
            parent = by_id[s.parent]
            assert parent.name == "model.forward" and parent.thread == s.thread
            assert s.request == parent.id and parent.start_us <= s.start_us


@pytest.mark.unittest
def test_xla_trace_holds_the_program_spans(tmp_path):
    model = _model()
    model(inputs=0.1)
    with xla_trace(str(tmp_path / "trace")) as log_dir:
        model(inputs=0.3)
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    theirs = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program_span"]
    assert {e["name"] for e in ours} >= {"model.forward", *CHILDREN}
    (req,) = [e for e in ours if e["name"] == "model.forward"]
    # On the trace's own time base: the profiler's operators of the request
    # fall inside the request's span.
    inside = [e for e in theirs if req["ts"] <= e["ts"] <= req["ts"] + req["dur"]]
    assert inside
    assert all(e["args"]["request"] == req["args"]["id"] for e in ours)
