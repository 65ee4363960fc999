#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``Model(n_qubits, n_layers=2,
circuit_type="Circuit_19", device="cuda")`` answering forward requests at 22
and 24 qubits — and checks it phase by phase:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: the CUDA kernels compile from ``qml_essentials_tpu_torch/csrc``;
3. kernel parity: each kernel against its plain PyTorch version run in
   float64 on the card, at the main path's shapes and at edge shapes
   (window kernels: max|err| / max|ref| <= 1e-5; rotation: bit-exact);
4. the slice: 3 single requests and one batch of 3 per width, with launch
   counts reset just before and read just after; every kernel must have
   launched.  One request per width is held against the port's plain CPU
   path in float64 (max |delta <Z>| <= 1e-4), and single and batched answers
   must agree;
5. times: ms per forward request, and each kernel's time on one forward's
   shapes beside its plain version's (CUDA events, best of 3 after warm-up).

Any failed phase exits non-zero.  The line before the last is a JSON object
with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WIDTHS = (22, 24)
N_LAYERS = 2
SEED = 7
DEVICE = "cuda"
REQUESTS = (0.37, -0.81, 1.42)
TOL_WINDOW = 1e-5  # max|kernel - plain64| / max|plain64|, fp32 accumulation over K <= 1024
TOL_EXPVAL = 1e-4  # max|<Z> card fp32 - <Z> CPU fp64| over 13-19 fused steps
TOL_BATCH = 1e-6  # single vs batched request: same kernels on the same inputs

KERNELS = {
    "window_apply": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:247",
    ),
    "window_apply_top": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:511",
    ),
    "rotate": dict(
        source="qml_essentials_tpu_torch/csrc/rotate.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:763",
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Shapes of the main path
# ---------------------------------------------------------------------------


def plan_shapes(n: int) -> dict:
    """Kernel calls of one forward of the n-qubit Circuit_19 model, read off
    the port's scheduled plan: window (a, k), top-window k, rotation r."""
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import simulation
    from qml_essentials_tpu_torch.ops.tape import recording

    model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19", random_seed=SEED)
    with recording() as tape, torch.no_grad():
        model._variational(model.params[0], torch.tensor([REQUESTS[0]]))
    plan, _ = simulation.scheduled_plan(tape, n)
    shapes = {"window_apply": [], "window_apply_top": [], "rotate": []}
    for kind, payload, wires in plan:
        if kind == "rot":
            shapes["rotate"].append(int(payload))
        elif kind == "mat":
            a, k = min(wires), len(wires)
            if a + k == n:
                shapes["window_apply_top"].append(k)
            else:
                shapes["window_apply"].append((a, k))
        else:
            raise AssertionError(f"unexpected plan step {kind!r} at {n} qubits")
    return shapes


# ---------------------------------------------------------------------------
# Phase 3: kernel parity
# ---------------------------------------------------------------------------


def _state(n: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn((2, 2**n), generator=gen, device=DEVICE, dtype=torch.float32)
    return x / x.norm()


def _unitary(k: int, rng: np.random.Generator) -> torch.Tensor:
    K = 2**k
    q, _ = np.linalg.qr(rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K)))
    return torch.as_tensor(np.stack([q.real, q.imag]), dtype=torch.float32, device=DEVICE)


def check_windows(ck, kn, cases, top: bool, gen, rng) -> float:
    """Window kernel vs its plain version in float64; returns the max abs error."""
    worst = 0.0
    for n, a, k in cases:
        x, w = _state(n, gen), _unitary(k, rng)
        if top:
            y = ck.window_apply_top(x, w, k, n)
            ref = kn.window_apply_top_plain(x.double(), w.double(), k, n)
        else:
            y = ck.window_apply(x, w, a, k, n)
            ref = kn.window_apply_plain(x.double(), w.double(), a, k, n)
        torch.cuda.synchronize()
        err = (y.double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        name = "window_apply_top" if top else "window_apply"
        log(f"  {name:16s} n={n:2d} a={a:2d} k={k:2d}  max|err|={err:.3e}  rel={rel:.3e}")
        if not rel <= TOL_WINDOW:
            raise AssertionError(f"{name} n={n} a={a} k={k}: rel err {rel:.3e} > {TOL_WINDOW}")
        worst = max(worst, err)
    return worst


def check_rotations(ck, kn, cases, gen) -> float:
    for n, r in cases:
        x = _state(n, gen)
        y = ck.rotate(x, r, n)
        ref = kn.rotate_plain(x, r, n)
        torch.cuda.synchronize()
        exact = torch.equal(y, ref) and torch.equal(y.double(), kn.rotate_plain(x.double(), r, n))
        log(f"  rotate           n={n:2d} r={r:2d}  bit-exact={exact}")
        if not exact:
            raise AssertionError(f"rotate n={n} r={r} is not bit-exact")
    return 0.0


def phase_parity(shapes: dict) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    n = WIDTHS[-1]
    main_windows = sorted({(n, a, k) for a, k in shapes[n]["window_apply"]})
    edge_windows = [(14, 3, 1), (14, 0, 2), (14, 12, 1), (14, 11, 2), (10, 1, 5), (9, 2, 3)]
    main_top = [(m, m - k, k) for m in (22, 23, 25) for k in (6, 7, 8)]
    edge_top = [(12, 11, 1), (12, 10, 2), (6, 0, 6), (11, 6, 5)]
    main_rot = sorted({(n, r) for r in shapes[n]["rotate"]})
    edge_rot = [(24, 1), (24, 23), (13, 1), (13, 12), (5, 2), (11, 4)]

    log("phase 3: kernel parity against the plain versions in float64 on the card")
    errs = {
        "window_apply": check_windows(ck, kn, main_windows, False, gen, rng),
        "window_apply_top": check_windows(ck, kn, main_top, True, gen, rng),
        "rotate": check_rotations(ck, kn, main_rot, gen),
    }
    log("  edge shapes:")
    check_windows(ck, kn, edge_windows, False, gen, rng)
    check_windows(ck, kn, edge_top, True, gen, rng)
    check_rotations(ck, kn, edge_rot, gen)
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


def phase_slice() -> tuple:
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    log("phase 4: Circuit_19 forward requests on the card")
    models = {
        n: Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19",
                 random_seed=SEED, device=DEVICE)
        for n in WIDTHS
    }
    answers = {}
    per_width = {}
    ck.reset_launch_counts()
    with torch.inference_mode():
        for n, model in models.items():
            before = ck.launch_counts()
            singles = [model(inputs=x) for x in REQUESTS]
            batched = model(inputs=list(REQUESTS))
            torch.cuda.synchronize()
            after = ck.launch_counts()
            per_width[n] = {k: after[k] - before[k] for k in after}
            answers[n] = (torch.stack(singles), batched)
    launches = ck.launch_counts()

    for n, (singles, batched) in answers.items():
        if tuple(singles.shape) != (3, n) or tuple(batched.shape) != (3, n):
            raise AssertionError(f"{n}q: shapes {tuple(singles.shape)} / {tuple(batched.shape)}")
        if not (torch.isfinite(singles).all() and torch.isfinite(batched).all()):
            raise AssertionError(f"{n}q: non-finite expectation values")
        d_batch = (singles - batched).abs().max().item()
        log(f"  {n}q launches {per_width[n]}  single vs batched max|delta|={d_batch:.3e}")
        if not d_batch <= TOL_BATCH:
            raise AssertionError(f"{n}q: single vs batched differ by {d_batch:.3e}")

        ref_model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19",
                          dtype=torch.float64)
        ref_model.load_numpy(models[n].params.detach().cpu().numpy())
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = ref_model(inputs=REQUESTS[0])
        d_ref = (singles[0].double().cpu() - ref).abs().max().item()
        log(f"  {n}q card fp32 vs CPU fp64 plain path: max|delta <Z>|={d_ref:.3e} "
            f"(CPU reference took {time.perf_counter() - t0:.1f} s)")
        if not d_ref <= TOL_EXPVAL:
            raise AssertionError(f"{n}q: card vs CPU reference differ by {d_ref:.3e}")

    if per_width[WIDTHS[0]]["window_apply_top"] == 0:
        raise AssertionError(f"{WIDTHS[0]}q forward did not reach window_apply_top")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    log(f"  launches over the run: {launches}")
    return models, launches


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


def _events_ms(fn, reps: int = 10, trials: int = 3) -> float:
    """Best-of-trials mean device time of fn() in ms (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _host_ms(fn) -> tuple:
    """Best of 3 host-clock ms of fn() ending in a synchronise; returns
    (ms, last result)."""
    best, out = float("inf"), None
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def _log_breakdown(model, n: int) -> None:
    """Where one request's time goes: recording the tape (gate matrices on
    the card), planning (window composition, layout DP, re-fusion) and
    running the plan (the kernels) plus the readout."""
    from qml_essentials_tpu_torch.ops import kernels, simulation

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)
    rec_ms, tape = _host_ms(lambda: model.script._record(model.params, inputs, model.enc_params))
    plan_ms, (plan, start) = _host_ms(lambda: simulation.scheduled_plan(tape, n, device=DEVICE))

    def run():
        psi2 = start if start is not None else kernels.zero_state_ri(n, device=DEVICE)
        for kind, payload, wires in plan:
            psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n)
        return simulation.measure_state_ri(psi2, n, meas_type, obs)

    run_ms, _ = _host_ms(run)
    log(f"    breakdown {n}q: record {rec_ms:.3f} ms, plan {plan_ms:.3f} ms, "
        f"run {len(plan)} steps + readout {run_ms:.3f} ms")


def phase_times(models: dict, shapes: dict) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    log("phase 5: times (CUDA events, best of 3 after warm-up)")
    with torch.inference_mode():
        for n, model in models.items():
            model(inputs=REQUESTS[0])
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                model(inputs=REQUESTS[0])
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            log(f"  forward {n}q Circuit_19 L={N_LAYERS}: {best * 1e3:.3f} ms per request")
            _log_breakdown(model, n)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    totals = {name: [0.0, 0.0] for name in KERNELS}

    def add(name, label, kern, plain):
        t_k, t_p = _events_ms(kern), _events_ms(plain)
        totals[name][0] += t_k
        totals[name][1] += t_p
        log(f"  {name:16s} {label:18s} kernel {t_k * 1e3:9.1f} us   plain {t_p * 1e3:9.1f} us")

    with torch.inference_mode():
        n = WIDTHS[-1]
        x = _state(n, gen)
        for a, k in shapes[n]["window_apply"]:
            w = _unitary(k, rng)
            add("window_apply", f"n={n} a={a} k={k}",
                lambda: ck.window_apply(x, w, a, k, n),
                lambda: kn.window_apply_plain(x, w, a, k, n))
        for r in shapes[n]["rotate"]:
            add("rotate", f"n={n} r={r}",
                lambda: ck.rotate(x, r, n), lambda: kn.rotate_plain(x, r, n))
        m = WIDTHS[0]
        xm = _state(m, gen)
        for k in shapes[m]["window_apply_top"]:
            w = _unitary(k, rng)
            add("window_apply_top", f"n={m} k={k}",
                lambda: ck.window_apply_top(xm, w, k, m),
                lambda: kn.window_apply_top_plain(xm, w, k, m))
    log(f"  (per kernel: summed over one forward's calls — window_apply and rotate "
        f"at {WIDTHS[-1]}q, window_apply_top at {WIDTHS[0]}q)")
    return totals


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from qml_essentials_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: device {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {smi}")

    path, seconds = ck.build()
    log(f"phase 2: built {path.relative_to(ROOT)} in {seconds:.1f} s")

    shapes = {n: plan_shapes(n) for n in WIDTHS}
    for n in WIDTHS:
        log(f"  {n}q plan: windows {shapes[n]['window_apply']}  "
            f"top {shapes[n]['window_apply_top']}  rotations {shapes[n]['rotate']}")
    errs = phase_parity(shapes)
    models, launches = phase_slice()
    totals = phase_times(models, shapes)

    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=launches[name], max_abs_err=errs[name],
             ms=totals[name][0], plain_ms=totals[name][1], **KERNELS[name])
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
