"""Serving: one client in a closed loop, one input a request, the model's
parameters fixed for the window (a trained model being evaluated).

A request is ``model(inputs=x)`` under ``torch.inference_mode()`` with its
answer, ``<Z_q>`` of every qubit, copied to the host.  The traffic file gives
the input range, the pool of inputs drawn from the seed (float32 values, so
that the program and the reference read the same numbers), the warm-up
requests, how many finished requests the check compares and how many
requests a traced run's slice profiles after the window.

The check draws that many of the window's finished requests from the seed
and runs the float64 reference on each input: ``expval_gap`` is the widest gap
between a served ``<Z_q>`` and the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import cells, program, stats, work
from benchmark.lib.measure import TracedSlice, Window
from benchmark.lib.trace import NO_SPANS


def inputs(traffic: dict, seed: int, size: int, stream: int = 0) -> np.ndarray:
    """``size`` inputs of the traffic's range from the seed's ``stream``, as
    float32 values."""
    rng = np.random.default_rng([seed, stream])
    return rng.uniform(traffic["input_low"], traffic["input_high"], size).astype(np.float32)


def setup(cell: dict, seed: int, device: torch.device) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    ref = cells.reference(cfg)
    params = program.parameters(cfg, ref.params_shape(cfg), program.generator(seed, device),
                                device)
    return {"model": program.model(cfg, params, device), "params": params.detach().cpu(),
            "inputs": inputs(traffic, seed, traffic["pool"]), "outputs": [], "failed": 0}


def request(state: dict, x: float, spans=NO_SPANS) -> None:
    """One request, its answer kept on the host."""
    try:
        with spans.span("bench:request"):
            with spans.span("bench:forward"):
                z = state["model"](inputs=x)
            with spans.span("bench:readout"):
                z = z.cpu()
        state["outputs"].append(z.numpy())
    except Exception as e:  # a failed request is counted and has no answer
        state["failed"] += 1
        state["outputs"].append(None)
        state.setdefault("errors", []).append(repr(e))


def expval_gap(cell: dict, params: torch.Tensor, xs: np.ndarray, answers,
               device: torch.device, precision: str = "float64") -> float:
    """The widest gap between the answers and the reference's ``<Z_q>``,
    one input at a time (a 13-qubit density matrix is 1 GB in complex128)."""
    sim = cells.reference(cell["config"]).simulator(cell["config"], precision, device)
    gap = 0.0
    for x, z in zip(xs, answers):
        if z is None:
            return float("inf")
        rdt = sim.rdtype
        want = sim.forward(params.to(device=device, dtype=rdt),
                           torch.tensor([float(x)], dtype=rdt, device=device))
        gap = max(gap, float(np.max(np.abs(np.asarray(z, np.float64)
                                           - want[0].double().cpu().numpy()))))
    return gap


def check_sample(cell: dict, seed: int, done: int) -> np.ndarray:
    """Which finished requests the check compares, drawn from the seed."""
    k = min(int(cell["traffic"]["check_requests"]), done)
    return np.sort(np.random.default_rng([seed, 1]).choice(done, size=k, replace=False))


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> dict:
    traffic = cell["traffic"]
    state = setup(cell, seed, device)
    program.stage("model built", t_start)
    pool = state["inputs"]
    with torch.inference_mode():
        for x in inputs(traffic, seed, traffic["warmup"], stream=2):
            request(state, float(x))
            program.stage("warm-up request", t_start)
        if state["failed"]:
            raise RuntimeError(f"warm-up request failed: {state['errors'][0]}")
        state["outputs"].clear()
        with Window(device) as w:
            setup_s = time.perf_counter() - t_start
            loop = stats.closed_loop(
                lambda: request(state, float(pool[len(state["outputs"]) % len(pool)])),
                seconds, time.perf_counter)
        done, failed_window = len(state["outputs"]), state["failed"]
        summary = None
        if trace:
            with TracedSlice(cell["name"], device) as t:
                request(state, float(pool[done % len(pool)]))  # the profiler's first launches
                for j in range(int(traffic["traced"])):
                    request(state, float(pool[(done + 1 + j) % len(pool)]), t.spans)
            summary = t.summary
    outputs, failed, params = state["outputs"], state["failed"], state["params"]
    del state
    program.free(device)

    pick = check_sample(cell, seed, done)
    t_check = time.perf_counter()
    gap = expval_gap(cell, params, pool[pick % len(pool)], [outputs[i] for i in pick], device)
    program.stage(f"reference took {time.perf_counter() - t_check:.3f} s; done", t_start)
    cfg = cell["config"]
    per_circuit = work.model_flops(**cells.reference(cfg).flop_inputs(cfg))
    return {
        "setup_s": setup_s,
        "window_s": loop["t_end"] - loop["t0"],
        "attempted": len(outputs),
        "failed": failed,
        "circuits": done - failed_window,
        "latencies_s": loop["latencies"],
        "steps": None,
        "peak_bytes": w.peak,
        "process_peak_bytes": max(w.peak, w.setup_peak),
        "launches": w.launches,
        "flops": (done - failed_window) * per_circuit,
        "trace": summary,
        "readings": {"expval_gap": gap},
        "chips": cell["chips"],
    }
