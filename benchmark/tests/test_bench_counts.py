"""The yardstick's counts at known shapes, the window and tail arithmetic,
and the trace reduction on a synthetic trace."""

import math

import numpy as np
import pytest
import torch

from benchmark.lib import stats, trace, work
from benchmark.reference import circuit19


def _cfg(n, noise=None):
    return {"circuit": "Circuit_19", "n_qubits": n, "n_layers": 2, "noise": noise}


def test_model_flops_24q():
    """3 x (48 one-qubit gates x 0.268 + 24 CRX x 0.537) + 48 encodings x
    0.268 GFLOP: 90.2 GFLOP a 24-qubit forward."""
    got = work.model_flops(**circuit19.flop_inputs(_cfg(24)))
    one, two = 16 * 2**24, 32 * 2**24
    assert got == 3 * (48 * one + 24 * two) + 48 * one
    assert math.isclose(got / 1e9, 90.2, rel_tol=2e-3)


def test_model_flops_density():
    """13 qubits: 104 one-qubit gates and 39 CRX, U rho U^dag on 4^13
    entries, and 182 depolarizing channels of 4 Kraus operators."""
    inputs = circuit19.flop_inputs(_cfg(13, {"Depolarizing": 0.01}))
    assert inputs["density"] and inputs["kraus"] == 4
    got = work.model_flops(**inputs)
    e = 4**13
    gates = 104 * 2 * 8 * 2 * e + 39 * 2 * 8 * 4 * e
    channels = (104 + 2 * 39) * 4 * 2 * 8 * 2 * e
    assert got == gates + channels


def test_element_gap():
    """The widest element gap over the elements the gradient floor keeps."""
    ref, g = np.array([0.1, -0.1, 0.1, 0.1]), np.array([1.0, -2.0, 3.0, 0.05])
    flipped = np.array([0.1, 0.1, 0.1, -0.1])
    assert stats.element_gap([flipped], [ref], [g], 0.1) == pytest.approx(0.2)
    assert stats.element_gap([np.array([0.1, -0.1, 0.1, -0.1])], [ref], [g], 0.1) == 0.0
    assert stats.element_gap([np.array([0.1, -0.1, 0.1, -0.1])], [ref], [g], 1e-3) == 0.2
    # a leaf gated out by a negligible gradient does not count
    assert stats.element_gap([ref, -ref], [ref, ref], [g, g * 1e-6], 0.1) == 0.0


def test_call_work_window():
    """A forward window of K = 32 on a 24-qubit state: 8K flops an
    amplitude; the state read and written once, the window read once."""
    x = torch.empty((2, 2**24), dtype=torch.float32, device="meta")
    w = torch.empty((2, 32, 32), dtype=torch.float32, device="meta")
    flops, nbytes = work.call_work("window_apply", (x, w, 3, 5, 24), x)
    assert flops == 8 * 32 * 2**24
    assert nbytes == 2 * 8 * 2**24 + 8 * 32 * 32
    assert work.least_seconds(flops, nbytes) == nbytes / work.PEAK_HBM


def test_call_work_backward_and_adjoint():
    x = torch.empty((2, 8, 2**10), dtype=torch.float32, device="meta")
    g = torch.empty((2, 8, 2**10), dtype=torch.bfloat16, device="meta")
    w = torch.empty((2, 1024, 1024), dtype=torch.float32, device="meta")
    flops, _ = work.call_work("window_apply_bwd", (w, g, x, 0, 10, 10, torch.float32), (x, w))
    assert flops == 16 * 1024 * 8 * 2**10
    flops, _ = work.call_work("adjoint_step", (w, x, x, 0, 10, 10, torch.float32), (x, x, w))
    assert flops == 24 * 1024 * 8 * 2**10 + 8 * 1024**3
    flops, nbytes = work.call_work("rotate", (x, 3, 10), x)
    assert flops == 0 and nbytes == 2 * 4 * 2 * 8 * 2**10
    # a compute-bound window: its least time is its flops over the peak
    assert work.least_seconds(8 * 1024 * 2**26, 16 * 2**26) == 8 * 1024 * 2**26 / work.PEAK_TF32


def test_p95_nearest_rank():
    assert stats.p95(list(range(1, 101))) == 95
    assert stats.p95([5.0]) == 5.0
    assert stats.p95(list(range(1, 21))) == 19
    with pytest.raises(ValueError):
        stats.p95([])


def test_closed_loop_window_end():
    """The window ends when the request running at the deadline completes:
    requests of 4.7 s in a 10 s window make three, and the window is 14.1 s."""
    now = [100.0]

    def clock():
        return now[0]

    def issue():
        now[0] += 4.7

    loop = stats.closed_loop(issue, 10.0, clock)
    assert len(loop["latencies"]) == 3
    assert math.isclose(loop["t_end"] - loop["t0"], 14.1)
    # a request longer than the window still completes and counts
    now[0] = 0.0
    loop = stats.closed_loop(lambda: now.__setitem__(0, now[0] + 30.0), 10.0, clock)
    assert len(loop["latencies"]) == 1 and loop["t_end"] == 30.0


def test_norm_gaps():
    ref = [np.array([3.0, 4.0]), np.array([1.0, 0.0]), np.array([0.0, 2.0])]
    prog = [np.array([3.0, 4.1]), ref[1], ref[2]]
    got = stats.norm_gaps(prog, ref)
    assert math.isclose(got, (math.hypot(3, 4.1) - 5) / 5)
    # a leaf gated out by a negligible reference gradient does not count
    gate = [ref[0], ref[1] * 1e-6, ref[2]]
    assert stats.norm_gaps([ref[0], ref[1] * 5, ref[2]], ref, gate=gate) == 0.0
    # nor does an element whose gradient is under 1e-3 of its leaf's median
    leaf, g = np.array([1.0, 1.0, 1.0, 0.1]), np.array([1.0, 2.0, 3.0, 1e-5])
    assert stats.norm_gaps([np.array([1.0, 1.0, 1.0, 0.7])], [leaf], gate=[g]) == 0.0
    assert stats.norm_gaps([np.array([1.0, 1.0, 1.1, 0.1])], [leaf], gate=[g]) > 0.0


def _dev(cat, name, ts, dur, corr):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "corr": corr}


def test_reduce_trace():
    spans = [("bench:request", 0.0, 100.0), ("bench:forward", 0.0, 60.0),
             ("bench:kernel:window_apply", 10.0, 15.0), ("bench:readout", 60.0, 100.0)]
    events = [
        _dev("launch", "cudaLaunchKernel", 12, 1, 1),  # inside the kernel call's span
        _dev("launch", "cudaLaunchKernel", 40, 1, 2),
        _dev("kernel", "qml_window", 20, 10, 1),
        _dev("kernel", "at_copy", 25, 15, 2),
        _dev("gpu_memcpy", "Memcpy DtoH", 95, 10, 3),
        _dev("kernel", "ncclDevKernel_SendRecv", 200, 50, 4),  # outside the window
    ]
    t = trace.reduce_trace(events, spans)
    assert t["window_s"] == 100e-6
    assert t["busy_s"] == pytest.approx((40 - 20 + 100 - 95) * 1e-6)
    assert t["kernel_s"] == pytest.approx(25e-6)
    assert t["port_kernel_s"] == pytest.approx(10e-6)
    assert t["port_kernel_names"] == ["qml_window"]
    assert t["device_ops"][0] == ["at_copy", 15e-6]
    assert t["idle_gaps"][0] == ["bench:readout", pytest.approx(55e-6)]
    assert t["idle_gaps"][1] == ["bench:kernel:window_apply", pytest.approx(20e-6)]
    assert trace.reduce_trace(events, []) is None
    assert trace.reduce_trace([], spans) is None


def test_spans_and_kernel_spy():
    """The spy times each outermost wrapper call as a host span, counts its
    least time, and restores the module."""

    class Module:
        @staticmethod
        def window_apply(psi2, w2, a, k, n):
            return Module.window_apply(psi2, w2, a, k, n) if a < 0 else psi2 + 0

    from benchmark.lib.spy import KernelSpy

    spans = trace.Spans()
    x, w = torch.zeros((2, 2**10)), torch.zeros((2, 4, 4))
    original = Module.window_apply
    with KernelSpy(Module, spans) as spy:
        Module.window_apply(x, w, 0, 2, 10)
        Module.window_apply(x, w, a=1, k=2, n=10)
    assert Module.window_apply is original
    assert [s[0] for s in spans.spans] == ["bench:kernel:window_apply"] * 2
    assert spy.calls == {"window_apply": 2}
    flops, nbytes = work.call_work("window_apply", (x, w, 0, 2, 10), x)
    assert spy.least_s == pytest.approx(2 * work.least_seconds(flops, nbytes))
