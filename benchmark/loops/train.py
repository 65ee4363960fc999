"""Training: closed-loop steps on fresh batches, as ``docs/training.md``
trains the model.

A step takes the next ``batch`` inputs (uniform in the traffic's range, drawn
from the seed on the device) with targets ``sin(pi x)``, runs
``model(inputs=x, force_mean=True)``, the MSE loss, ``loss.backward()``,
``torch.optim.Adam(lr)`` and reads the loss on the host.

A traced run profiles ``traced`` further steps after the window.

Set-up builds the model and its optimizer once and drives them through the
first ``check_steps`` steps with the window's own step function, on rows no
later step sees; those steps warm every shape the window uses, and the same
objects then run the window.  The float64 reference takes the first step
from the same parameters and batch, and each later checked step's loss at
the parameters the program held before that step (read back after the
step before); the check compares

* ``loss_gap``: the first step's ``|loss - ref| / ref``;
* ``later_loss_gap``: the same for each later checked step, the widest: those
  steps run on the program's cached plan at the parameters Adam has moved;
* ``grad_gap``: the first gradient as Adam got it (its first moment after one
  step over ``1 - beta1``), by the worst leaf's gap of norms;
* ``change_gap``: the parameters' change made by the first step, likewise;
* ``step_gap``: that change element by element, the widest gap over the
  learning rate (a step in the wrong direction reads 2).

``grad_gap`` and ``change_gap`` leave out the elements whose reference
gradient is under 1e-3 of the median element's, ``step_gap`` those under
``STEP_FLOOR`` of it: the program's first gradient (a bf16 cotangent) errs by
up to a few thousandths of the median element, which decides the sign of a
smaller element (:mod:`benchmark.lib.stats`).
"""

from __future__ import annotations

import math
import time
from typing import List, Tuple

import numpy as np
import torch

from benchmark.lib import cells, program, stats, work
from benchmark.lib.measure import TracedSlice, Window
from benchmark.lib.trace import NO_SPANS


# The least reference gradient element, over the median element, whose step
# direction ``step_gap`` compares.
STEP_FLOOR = 0.1


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def setup(cell: dict, seed: int, device: torch.device) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    ref = cells.reference(cfg)
    gen = program.generator(seed, device)
    params = program.parameters(cfg, ref.params_shape(cfg), gen, device)
    model = program.model(cfg, params, device)
    xs = torch.rand((traffic["pool"], traffic["batch"]), generator=gen, device=device,
                    dtype=model.params.dtype)
    xs = xs * (traffic["input_high"] - traffic["input_low"]) + traffic["input_low"]
    opt = torch.optim.Adam([model.params], lr=traffic["lr"])
    return {"model": model, "opt": opt, "params0": params.detach().cpu(), "xs": xs,
            "ys": torch.sin(math.pi * xs), "losses": [], "failed": 0}


def step(state: dict, i: int, spans=NO_SPANS) -> None:
    """Training step ``i`` on batch ``i % pool``, its loss kept on the host."""
    model, opt = state["model"], state["opt"]
    x, y = state["xs"][i % len(state["xs"])], state["ys"][i % len(state["ys"])]
    try:
        with spans.span("bench:request"):
            with spans.span("bench:forward"):
                loss = mse(model(inputs=x, force_mean=True), y)
            with spans.span("bench:backward"):
                opt.zero_grad(set_to_none=True)
                loss.backward()
            with spans.span("bench:optimizer"):
                opt.step()
            with spans.span("bench:readout"):
                state["losses"].append(loss.item())
    except Exception as e:  # a failed step is counted
        state["failed"] += 1
        state["losses"].append(None)
        state.setdefault("errors", []).append(repr(e))


def _leaves(t: torch.Tensor) -> List[np.ndarray]:
    return [t.detach().double().cpu().numpy().reshape(-1)]


def reference_steps(cell: dict, params0: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    device: torch.device, precision: str = "float64", half_batch: bool = False,
                    negated: bool = False, stale: bool = False) -> dict:
    """The reference put in the program's place for ``len(xs)`` steps from
    ``params0``: each step's loss, the first gradient as Adam got it and the
    change after each step, as :func:`first_steps` reads the program's.
    Faults, for the upper readings: ``half_batch`` takes each loss over the
    first half of its batch, ``negated`` gives Adam the gradient's negative,
    ``stale`` computes every step at ``params0`` (a plan that kept the first
    step's parameters)."""
    cfg, traffic = cell["config"], cell["traffic"]
    sim = cells.reference(cfg).simulator(cfg, precision, device)
    rdt = sim.rdtype
    start = params0.to(device=device, dtype=rdt)
    p, opt = start.clone(), cells.reference(cfg).Adam(traffic["lr"])
    losses, g1, changes = [], None, []
    for x, y in zip(xs, ys):
        x, y = x.to(device=device, dtype=rdt), y.to(device=device, dtype=rdt)
        if half_batch:
            x, y = x[: len(x) // 2], y[: len(y) // 2]
        loss, grad = sim.mse_and_grad(start if stale else p, x, y)
        if negated:
            grad = -grad
        losses.append(loss)
        if g1 is None:
            g1 = grad.cpu()
        p = opt.step(p, grad)
        changes.append((p - start).cpu())
    return {"losses": losses, "grad": g1, "changes": changes}


def _leaves(t: torch.Tensor) -> List[np.ndarray]:
    return [t.detach().double().cpu().numpy().reshape(-1)]


def _rel(a, b: float) -> float:
    return float("inf") if a is None else abs(a - b) / abs(b)


def judge(cell: dict, prog: dict, params0: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
          device: torch.device) -> Tuple[dict, dict]:
    """The compared numbers of the program's (or a stand-in's) checked steps
    ``prog`` against the float64 reference, and what the look at them reads
    (printed, not compared): the widest gap of a first-gradient element over
    the median element."""
    cfg, lr = cell["config"], cell["traffic"]["lr"]
    sim = cells.reference(cfg).simulator(cfg, "float64", device)
    rdt = sim.rdtype
    p0 = params0.to(device=device, dtype=rdt)
    batch = [(x.to(device=device, dtype=rdt), y.to(device=device, dtype=rdt))
             for x, y in zip(xs, ys)]
    loss, grad = sim.mse_and_grad(p0, *batch[0])
    change = (cells.reference(cfg).Adam(lr).step(p0, grad) - p0).cpu()
    later = [sim.mse(p0 + c.to(device=device, dtype=rdt), *b)
             for c, b in zip(prog["changes"], batch[1:])]
    gate = _leaves(grad)
    readings = {
        "loss_gap": _rel(prog["losses"][0], loss),
        "later_loss_gap": max(_rel(a, b) for a, b in zip(prog["losses"][1:], later)),
        "grad_gap": stats.norm_gaps(_leaves(prog["grad"]), gate),
        "change_gap": stats.norm_gaps(_leaves(prog["changes"][0]), _leaves(change), gate=gate),
        "step_gap": stats.element_gap(_leaves(prog["changes"][0]), _leaves(change), gate,
                                      STEP_FLOOR) / lr,
    }
    median = float(np.median(np.abs(gate[0])))
    look = {"grad_element_gap": float(np.max(np.abs(_leaves(prog["grad"])[0] - gate[0]))) / median}
    return readings, look


def first_steps(state: dict, count: int, t_start: float) -> dict:
    """The program's checked steps: run through :func:`step`, read back."""
    opt, p = state["opt"], state["model"].params
    changes = []
    for i in range(count):
        step(state, i)
        program.stage(f"checked step {i + 1}", t_start)
        if i == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            m = opt.state.get(p, {}).get("exp_avg")
            grad = (m / (1 - beta1)).detach().cpu() if m is not None else torch.zeros_like(p)
        changes.append((p.detach().cpu() - state["params0"][None])[0])
    return {"losses": list(state["losses"][:count]), "grad": grad[0], "changes": changes}


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> dict:
    traffic = cell["traffic"]
    count = int(traffic["check_steps"])
    state = setup(cell, seed, device)
    program.stage("model built", t_start)
    prog = first_steps(state, count, t_start)
    if state["failed"]:
        raise RuntimeError(f"a checked step failed: {state['errors'][0]}")
    state["losses"].clear()
    with Window(device) as w:
        setup_s = time.perf_counter() - t_start
        loop = stats.closed_loop(lambda: step(state, count + len(state["losses"])),
                                 seconds, time.perf_counter)
    steps, failed_window = len(state["losses"]), state["failed"]
    summary = None
    if trace:
        with TracedSlice(cell["name"], device) as t:
            step(state, count + steps)  # outside the slice's spans: the profiler's first launches
            for j in range(int(traffic["traced"])):
                step(state, count + steps + 1 + j, t.spans)
        summary = t.summary
    attempted, failed = len(state["losses"]), state["failed"]
    params0 = state["params0"]
    xs, ys = state["xs"][:count].cpu(), state["ys"][:count].cpu()
    del state
    program.free(device)

    t_check = time.perf_counter()
    readings, look = judge(cell, prog, params0, xs, ys, device)
    program.stage(f"reference took {time.perf_counter() - t_check:.3f} s; done", t_start)
    per_circuit = work.model_flops(**cells.reference(cell["config"]).flop_inputs(cell["config"]))
    done = (steps - failed_window) * traffic["batch"]
    return {
        "setup_s": setup_s,
        "window_s": loop["t_end"] - loop["t0"],
        "attempted": attempted,
        "failed": failed,
        "circuits": done,
        "latencies_s": loop["latencies"],
        "steps": steps - failed_window,
        "peak_bytes": w.peak,
        "process_peak_bytes": max(w.peak, w.setup_peak),
        "launches": w.launches,
        "flops": 3 * done * per_circuit,
        "trace": summary,
        "readings": readings,
        "diagnostics": look,
        "chips": cell["chips"],
    }
