#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``Model(n_qubits, n_layers=2,
circuit_type="Circuit_19", device="cuda")`` answering forward requests and
computing the gradient of the mean <Z> with respect to ``params`` at 22 and
24 qubits through the saved-residual executor, and through the adjoint-state
executor at 22, 24 and 26 qubits — and checks it phase by phase:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: the CUDA kernels compile from ``qml_essentials_tpu_torch/csrc``
   (one nvcc per source, in parallel), with ptxas's register and
   shared-memory use;
3. kernel parity: each kernel against its plain PyTorch version run in
   float64 on the card, at the main path's shapes and at edge shapes
   (window kernels: max|err| / max|ref| <= 1e-5; the backward kernels' state
   cotangent 1e-5 in float32 and one bf16 ulp in bfloat16, their matrix
   cotangent 1e-4 (an fp32 sum over up to 2^16 columns); the adjoint steps
   the same, with the rebuilt state at 1e-5, at the 24q and 26q window
   shapes and the 22q top window; rotation and paired rotation, float32 and
   bfloat16: bit-exact);
4. the forward slice: 3 single requests and one batch of 3 per width, with
   launch counts reset just before and read just after; every forward
   kernel must have launched.  One request per width is held against the
   port's plain CPU path in float64 (max |delta <Z>| <= 1e-4), and single
   and batched answers must agree;
5. the gradient slice: ``loss = model(inputs=...).mean(); loss.backward()``
   for one input and for the batch of 3, with the bfloat16 and the float32
   cotangent (lambda) of the saved executor, launch counts reset before and
   read after (the backward kernels must have launched: 24q runs one
   window_apply_bwd per window of the plan, 22q reaches
   window_apply_top_bwd).  22q: the card's gradient against the port's CPU
   float64 path (f32 lambda <= 1e-4 absolute, bf16 <= 5e-4).  24q: the
   f32-lambda saved executor against the per-kernel autograd loop (<= 1e-6),
   bf16 against f32 lambda (<= 5e-4), a central finite difference of the
   card's forward along g/|g| (eps 1e-2, within 2 % of |g| + 2e-4), the
   forward value under autograd against inference mode (<= 1e-6), a batch
   against its single requests, and three plain SGD steps;
5b. the adjoint slice: gradients through the adjoint-state executor, forced
   (``BACKWARD_MODE = "adjoint"``) or chosen by the residual rule, with
   launch counts reset before the phase and read after each run (one
   adjoint_step per window, one adjoint_step_top per top window, rotate_pair
   at least once per rotation, no window backward kernel).  22q forced:
   against the CPU float64 gradient (f32 lambda <= 1e-4, bf16 <= 5e-4).  24q
   forced: against the saved executor (f32 lambda, <= 1e-4 max|g| + 1e-6:
   the adjoint rebuilds the state through 13 fp32 windows) and bf16 against
   f32 lambda (<= 5e-4).  24q, a batch of 16 inputs under ``"auto"``: the
   rule picks the adjoint for every element (208 adjoint_step launches),
   the gradient matches the saved executor on the same batch, and three SGD
   steps give finite losses.  24q, a batch of 10 just under the rule's line
   under ``"auto"``: free memory is read once and every element takes the
   saved executor (130 window_apply_bwd launches, no adjoint kernel), where
   a rule re-reading free memory per element would flip part-way (checked
   from the memory free after the forward).  26q: the executor ``"auto"`` picks, forced
   adjoint against forced saved, bf16 against f32 lambda, and a central
   finite difference;
6. times: ms per forward request and per forward + gradient request (best
   of 3 after warm-up, and the median of 10), where a gradient request's
   time goes (record, plan, forward run, backward run), the same for the
   24q forced adjoint, 26q adjoint and saved, the 24q batch of 16 under
   ``"auto"``, and each kernel's time on one request's shapes beside its
   plain version's (CUDA events, best of 3 after warm-up).

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
WIDE = 26  # the reference bench's second width: the adjoint phase only
N_LAYERS = 2
SEED = 7
DEVICE = "cuda"
REQUESTS = (0.37, -0.81, 1.42)
TOL_WINDOW = 1e-5  # max|kernel - plain64| / max|plain64|, fp32 accumulation over K <= 1024
TOL_EXPVAL = 1e-4  # max|<Z> card fp32 - <Z> CPU fp64| over 13-19 fused steps
TOL_BATCH = 1e-6  # single vs batched request: same kernels on the same inputs
TOL_GRAM = 1e-4  # backward kernels' gw: fp32 sum over up to 2^16 columns, in chunks
TOL_GRAD_F32 = 1e-4  # 22q card gradient (f32 lambda) vs CPU fp64, absolute
TOL_GRAD_BF16 = 5e-4  # bf16-lambda budget of the JAX package (docs/performance.md)
TOL_GRAD_LOOP = 1e-6  # saved executor (f32 lambda) vs per-kernel loop: same products
FD_EPS = 1e-2
FD_REL, FD_ABS = 0.02, 2e-4  # |fd - g.v| <= 2 % of |g| + 2e-4 (fp32 forward, O(eps^2))
SGD_LR = 1.0
TOL_ADJ_REL, TOL_ADJ_ABS = 1e-4, 1e-6  # adjoint vs saved: <= 1e-4 max|g| + 1e-6
BATCH16 = [float(x) for x in np.linspace(-1, 1, 16)]  # bench.py's input range
BATCH_UNDER = 10  # 24q: 10 x 2.55 GB of residuals, just under 0.35 of an 80 GB card

KERNELS = {
    "window_apply": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:247",
    ),
    "window_apply_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:301",
    ),
    "window_apply_top": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:511",
    ),
    "window_apply_top_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:547",
    ),
    "rotate": dict(
        source="qml_essentials_tpu_torch/csrc/rotate.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:763",
    ),
    "adjoint_step": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_step.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:403",
    ),
    "adjoint_step_top": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_step_top.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:635",
    ),
    "rotate_pair": dict(
        source="qml_essentials_tpu_torch/csrc/rotate_pair.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:724",
    ),
}
ADJOINT_KERNELS = ("adjoint_step", "adjoint_step_top", "rotate_pair")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Shapes of the main path
# ---------------------------------------------------------------------------


def plan_shapes(n: int) -> dict:
    """Kernel calls of one forward of the n-qubit Circuit_19 model, read off
    the port's scheduled plan: window (a, k), top-window k, rotation r, and
    the steps in plan order (the backward walks them in reverse)."""
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import simulation
    from qml_essentials_tpu_torch.ops.tape import recording

    model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19", random_seed=SEED)
    with recording() as tape, torch.no_grad():
        model._variational(model.params[0], torch.tensor([REQUESTS[0]]))
    plan, _ = simulation.scheduled_plan(tape, n)
    shapes = {"window_apply": [], "window_apply_top": [], "rotate": [], "steps": []}
    for kind, payload, wires in plan:
        if kind == "rot":
            shapes["rotate"].append(int(payload))
            shapes["steps"].append(("rot", int(payload)))
        elif kind == "mat":
            a, k = min(wires), len(wires)
            if sorted(wires) != list(range(a, a + k)):
                raise AssertionError(f"window on scattered wires {wires} at {n} qubits")
            if a + k == n:
                shapes["window_apply_top"].append(k)
                shapes["steps"].append(("top", (a, k)))
            else:
                shapes["window_apply"].append((a, k))
                shapes["steps"].append(("win", (a, k)))
        else:
            raise AssertionError(f"unexpected plan step {kind!r} at {n} qubits")
    return shapes


def backward_calls(steps: list) -> list:
    """The backward kernel calls of either plan-level executor for a plan
    with a bfloat16 cotangent: (kind, shape, g dtype, out dtype) in the order
    they run (the adjoint runs the same sequence of lambda dtypes)."""
    n_payload = sum(kind != "rot" for kind, _ in steps)
    calls, lam, slot = [], torch.float32, n_payload
    for kind, shape in reversed(steps):
        if kind == "rot":
            calls.append((kind, shape, lam, lam))
            continue
        slot -= 1
        out = torch.bfloat16 if slot > 0 else torch.float32
        calls.append((kind, shape, lam, out))
        lam = out
    return calls


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
        log(f"  {name:20s} n={n:2d} a={a:2d} k={k:2d}  max|err|={err:.3e}  rel={rel:.3e}")
        if not rel <= TOL_WINDOW:
            raise AssertionError(f"{name} n={n} a={a} k={k}: rel err {rel:.3e} > {TOL_WINDOW}")
        worst = max(worst, err)
    return worst


_BWD_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp of each element: 2^-8 of the top of its binade."""
    _, e = torch.frexp(t)
    return torch.ldexp(torch.ones_like(t), e - 8)


def check_bwd(ck, kn, cases, top: bool, gen, rng) -> float:
    """Backward kernel vs its plain version in float64, for float32 and
    bfloat16 cotangents in and out; returns the max abs error."""
    name = "window_apply_top_bwd" if top else "window_apply_bwd"
    worst = 0.0
    for n, a, k in cases:
        x, w, g32 = _state(n, gen), _unitary(k, rng), _state(n, gen)
        for g_dt, out_dt in _BWD_DTYPES:
            g = g32.to(g_dt)
            if top:
                gp, gw = ck.window_apply_top_bwd(w, g, x, k, n, out_dt)
                rp, rw = kn.window_apply_top_bwd_plain(
                    w.double(), g.double(), x.double(), k, n, torch.float64)
            else:
                gp, gw = ck.window_apply_bwd(w, g, x, a, k, n, out_dt)
                rp, rw = kn.window_apply_bwd_plain(
                    w.double(), g.double(), x.double(), a, k, n, torch.float64)
            torch.cuda.synchronize()
            if gp.dtype != out_dt or gw.dtype != torch.float32:
                raise AssertionError(f"{name}: output dtypes {gp.dtype}, {gw.dtype}")
            e_p = (gp.double() - rp).abs()
            floor = TOL_WINDOW * rp.abs().max()
            if out_dt == torch.bfloat16:
                ok_p = bool((e_p <= _bf16_ulp(rp) + floor).all())
            else:
                ok_p = bool(e_p.max() <= floor)
            e_w = (gw.double() - rw).abs().max().item()
            rel_p = e_p.max().item() / rp.abs().max().item()
            rel_w = e_w / rw.abs().max().item()
            log(f"  {name:20s} n={n:2d} a={a:2d} k={k:2d} g={str(g_dt)[6:]:8s} "
                f"out={str(out_dt)[6:]:8s} gp rel={rel_p:.3e} gw rel={rel_w:.3e}")
            if not (ok_p and rel_w <= TOL_GRAM):
                raise AssertionError(
                    f"{name} n={n} a={a} k={k} g={g_dt} out={out_dt}: gp rel {rel_p:.3e}, "
                    f"gw rel {rel_w:.3e}")
            worst = max(worst, e_w, e_p.max().item() if out_dt == torch.float32 else 0.0)
    return worst


def check_adjoint(ck, kn, cases, top: bool, gen, rng) -> float:
    """Adjoint step kernel vs its plain version in float64, for float32 and
    bfloat16 cotangents in and out; returns the max abs error."""
    name = "adjoint_step_top" if top else "adjoint_step"
    worst = 0.0
    for n, a, k in cases:
        psi, w, lam32 = _state(n, gen), _unitary(k, rng), _state(n, gen)
        for l_dt, out_dt in _BWD_DTYPES:
            lam = lam32.to(l_dt)
            if top:
                pp, lp, gw = ck.adjoint_step_top(w, psi, lam, k, n, out_dt)
                rp, rl, rw = kn.adjoint_step_top_plain(
                    w.double(), psi.double(), lam.double(), k, n, torch.float64)
            else:
                pp, lp, gw = ck.adjoint_step(w, psi, lam, a, k, n, out_dt)
                rp, rl, rw = kn.adjoint_step_plain(
                    w.double(), psi.double(), lam.double(), a, k, n, torch.float64)
            torch.cuda.synchronize()
            if pp.dtype != torch.float32 or lp.dtype != out_dt or gw.dtype != torch.float32:
                raise AssertionError(f"{name}: output dtypes {pp.dtype}, {lp.dtype}, {gw.dtype}")
            e_s = (pp.double() - rp).abs().max().item()
            rel_s = e_s / rp.abs().max().item()
            e_l = (lp.double() - rl).abs()
            floor = TOL_WINDOW * rl.abs().max()
            if out_dt == torch.bfloat16:
                ok_l = bool((e_l <= _bf16_ulp(rl) + floor).all())
            else:
                ok_l = bool(e_l.max() <= floor)
            rel_l = e_l.max().item() / rl.abs().max().item()
            e_w = (gw.double() - rw).abs().max().item()
            rel_w = e_w / rw.abs().max().item()
            del pp, lp, rp, rl, e_l
            log(f"  {name:20s} n={n:2d} a={a:2d} k={k:2d} lam={str(l_dt)[6:]:8s} "
                f"out={str(out_dt)[6:]:8s} psi rel={rel_s:.3e} lam rel={rel_l:.3e} "
                f"gw rel={rel_w:.3e}")
            if not (rel_s <= TOL_WINDOW and ok_l and rel_w <= TOL_GRAM):
                raise AssertionError(
                    f"{name} n={n} a={a} k={k} lam={l_dt} out={out_dt}: psi rel {rel_s:.3e}, "
                    f"lam rel {rel_l:.3e}, gw rel {rel_w:.3e}")
            worst = max(worst, e_s, e_w)
    return worst


def check_rotate_pair(ck, kn, cases, gen) -> float:
    for n, r in cases:
        psi = _state(n, gen)
        for l_dt in (torch.float32, torch.bfloat16):
            lam = _state(n, gen).to(l_dt)
            yp, yl = ck.rotate_pair(psi, lam, r, n)
            torch.cuda.synchronize()
            exact = (yp.dtype == torch.float32 and yl.dtype == l_dt
                     and torch.equal(yp, kn.rotate_plain(psi, r, n))
                     and torch.equal(yl, kn.rotate_plain(lam, r, n)))
            log(f"  rotate_pair f32+{str(l_dt)[6:]:8s} n={n:2d} r={r:2d}  bit-exact={exact}")
            if not exact:
                raise AssertionError(f"rotate_pair {l_dt} n={n} r={r} is not bit-exact")
    return 0.0


def check_rotations(ck, kn, cases, gen, dtype=torch.float32) -> float:
    for n, r in cases:
        x = _state(n, gen).to(dtype)
        y = ck.rotate(x, r, n)
        ref = kn.rotate_plain(x, r, n)
        torch.cuda.synchronize()
        exact = y.dtype == dtype and torch.equal(y, ref) and torch.equal(
            y.double(), kn.rotate_plain(x.double(), r, n))
        log(f"  rotate {str(dtype)[6:]:8s}      n={n:2d} r={r:2d}  bit-exact={exact}")
        if not exact:
            raise AssertionError(f"rotate {dtype} n={n} r={r} is not bit-exact")
    return 0.0


def phase_parity(shapes: dict) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    n, m = WIDTHS[-1], WIDTHS[0]
    main_windows = sorted({(n, a, k) for a, k in shapes[n]["window_apply"]})
    edge_windows = [(14, 3, 1), (14, 0, 2), (14, 12, 1), (14, 11, 2), (10, 1, 5), (9, 2, 3)]
    main_top = [(w, w - k, k) for w in (22, 23, 25) for k in (6, 7, 8)]
    edge_top = [(12, 11, 1), (12, 10, 2), (6, 0, 6), (11, 6, 5)]
    grad_top = sorted({(m, m - k, k) for k in shapes[m]["window_apply_top"]})
    main_rot = sorted({(n, r) for r in shapes[n]["rotate"]})
    edge_rot = [(24, 1), (24, 23), (13, 1), (13, 12), (5, 2), (11, 4)]

    log("phase 3: kernel parity against the plain versions in float64 on the card")
    errs = {
        "window_apply": check_windows(ck, kn, main_windows, False, gen, rng),
        "window_apply_top": check_windows(ck, kn, main_top, True, gen, rng),
        "rotate": check_rotations(ck, kn, main_rot, gen),
        "window_apply_bwd": check_bwd(ck, kn, main_windows, False, gen, rng),
        "window_apply_top_bwd": check_bwd(ck, kn, grad_top, True, gen, rng),
    }
    check_rotations(ck, kn, main_rot, gen, torch.bfloat16)
    log("  edge shapes:")
    check_windows(ck, kn, edge_windows, False, gen, rng)
    check_windows(ck, kn, edge_top, True, gen, rng)
    check_rotations(ck, kn, edge_rot, gen)
    check_rotations(ck, kn, edge_rot, gen, torch.bfloat16)
    check_bwd(ck, kn, [(14, 3, 1), (14, 0, 2), (14, 12, 1), (12, 0, 4)], False, gen, rng)
    check_bwd(ck, kn, [(12, 11, 1), (12, 10, 2), (6, 0, 6), (11, 6, 5)], True, gen, rng)

    log("  adjoint kernels (main-path shapes at 24q and 26q, the 22q top window, edges):")
    adj_windows = main_windows + sorted({(WIDE, a, k) for a, k in shapes[WIDE]["window_apply"]})
    adj_rot = main_rot + sorted({(WIDE, r) for r in shapes[WIDE]["rotate"]})
    errs["adjoint_step"] = check_adjoint(ck, kn, adj_windows, False, gen, rng)
    errs["adjoint_step_top"] = check_adjoint(ck, kn, grad_top, True, gen, rng)
    errs["rotate_pair"] = check_rotate_pair(ck, kn, adj_rot, gen)
    check_adjoint(ck, kn, [(14, 3, 1), (14, 0, 2), (14, 12, 1), (12, 0, 4)], False, gen, rng)
    check_adjoint(ck, kn, [(12, 11, 1), (16, 10, 6), (6, 0, 6), (11, 6, 5)], True, gen, rng)
    check_rotate_pair(ck, kn, [(24, 1), (24, 23), (13, 1), (13, 12), (5, 2)], gen)
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the forward slice
# ---------------------------------------------------------------------------


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


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
            per_width[n] = _diff(ck.launch_counts(), before)
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

        ref_model = _cpu_f64_model(models[n], n)
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
    for name in ("window_apply", "window_apply_top", "rotate"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on the forward path")
    log(f"  launches over the forward run: {launches}")
    return models, launches


def _cpu_f64_model(model, n: int):
    from qml_essentials_tpu_torch.models.model import Model

    ref_model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19",
                      dtype=torch.float64)
    ref_model.load_numpy(model.params.detach().cpu().numpy())
    return ref_model


# ---------------------------------------------------------------------------
# Phase 5: the gradient slice
# ---------------------------------------------------------------------------


def _grad_request(model, inputs) -> tuple:
    """loss = mean <Z>; loss.backward(); returns (loss, d loss / d params)."""
    model.params.grad = None
    loss = model(inputs=inputs).mean()
    loss.backward()
    return loss.detach(), model.params.grad.detach().clone()


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_grad(models: dict, shapes: dict) -> tuple:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved

    log("phase 5: gradient of the mean <Z> w.r.t. params on the card (saved executor)")
    res, per_width, per_single = {}, {}, {}
    ck.reset_launch_counts()
    for n, model in models.items():
        before = ck.launch_counts()
        for mode in ("bf16", "f32"):
            saved.set_lambda_mode(mode)
            b1 = ck.launch_counts()
            single = _grad_request(model, REQUESTS[0])
            torch.cuda.synchronize()
            per_single[(n, mode)] = _diff(ck.launch_counts(), b1)
            batch = _grad_request(model, list(REQUESTS))
            res[(n, mode)] = (single, batch)
        torch.cuda.synchronize()
        per_width[n] = _diff(ck.launch_counts(), before)
    launches = ck.launch_counts()
    saved.set_lambda_mode("bf16")

    for (n, mode), ((loss, g), (bloss, bg)) in res.items():
        _check(tuple(g.shape) == tuple(models[n].params.shape) and g.shape == bg.shape,
               f"{n}q {mode}: gradient shapes {tuple(g.shape)} / {tuple(bg.shape)}")
        _check(bool(torch.isfinite(g).all() and torch.isfinite(bg).all()
                    and torch.isfinite(loss) and torch.isfinite(bloss)),
               f"{n}q {mode}: non-finite loss or gradient")
        log(f"  {n}q lambda={mode}: loss {loss.item():.6f}, |g| {g.norm().item():.6f}, "
            f"batch loss {bloss.item():.6f}; one request launched {per_single[(n, mode)]}")
    for n in WIDTHS:
        log(f"  {n}q launches over its gradient run: {per_width[n]}")
    for mode in ("bf16", "f32"):
        n, m = WIDTHS[-1], WIDTHS[0]
        want = len(shapes[n]["window_apply"])
        got = per_single[(n, mode)]["window_apply_bwd"]
        _check(got == want and want > 0,
               f"{n}q {mode}: window_apply_bwd launched {got} times, the plan has {want} windows")
        _check(per_single[(m, mode)]["window_apply_top_bwd"]
               == len(shapes[m]["window_apply_top"]) > 0,
               f"{m}q {mode}: window_apply_top_bwd did not launch once per top window")

    # Batch against its single requests (f32 lambda): loss is the mean of
    # the three requests' means.
    saved.set_lambda_mode("f32")
    for n, model in models.items():
        singles = [_grad_request(model, x)[1] for x in REQUESTS]
        d = _maxdiff(res[(n, "f32")][1][1], sum(singles) / len(singles))
        log(f"  {n}q batch of 3 vs mean of single gradients: max|delta|={d:.3e}")
        _check(d <= TOL_BATCH, f"{n}q: batch vs single gradients differ by {d:.3e}")

    # 22q: the card against the port's CPU path in float64.
    m = WIDTHS[0]
    ref_model = _cpu_f64_model(models[m], m)
    t0 = time.perf_counter()
    _, g64 = _grad_request(ref_model, REQUESTS[0])
    for mode, tol in (("f32", TOL_GRAD_F32), ("bf16", TOL_GRAD_BF16)):
        d = _maxdiff(res[(m, mode)][0][1], g64)
        log(f"  {m}q card (lambda={mode}) vs CPU fp64: max|delta g|={d:.3e} "
            f"(max|g|={g64.abs().max().item():.3e}, tol {tol})")
        _check(d <= tol, f"{m}q lambda={mode}: gradient differs from CPU fp64 by {d:.3e}")
    log(f"  (CPU fp64 gradient took {time.perf_counter() - t0:.1f} s)")

    # 24q: the saved executor against the per-kernel autograd loop, bf16
    # against f32 lambda, a finite difference, and the forward value.
    n = WIDTHS[-1]
    model = models[n]
    (loss, g), (loss16, g16) = res[(n, "f32")][0], res[(n, "bf16")][0]
    saved.set_saved_executor(False)
    try:
        b1 = ck.launch_counts()
        loss_loop, g_loop = _grad_request(model, REQUESTS[0])
        torch.cuda.synchronize()
        loop_counts = _diff(ck.launch_counts(), b1)
    finally:
        saved.set_saved_executor(True)
    d = _maxdiff(g, g_loop)
    log(f"  {n}q saved (f32 lambda) vs per-kernel loop: max|delta g|={d:.3e} "
        f"(loop launched {loop_counts})")
    _check(d <= TOL_GRAD_LOOP and loop_counts["window_apply_bwd"] > 0,
           f"{n}q: saved vs per-kernel loop differ by {d:.3e}")
    d = _maxdiff(g16, g)
    log(f"  {n}q bf16 vs f32 lambda: max|delta g|={d:.3e}")
    _check(d <= TOL_GRAD_BF16, f"{n}q: bf16 vs f32 lambda differ by {d:.3e}")

    with torch.inference_mode():
        v_inf = model(inputs=REQUESTS[0]).mean().item()
    d = abs(loss.item() - v_inf)
    log(f"  {n}q forward under autograd vs inference mode: |delta|={d:.3e}")
    _check(d <= TOL_BATCH, f"{n}q: forward under autograd differs by {d:.3e}")

    _finite_difference(model, g, REQUESTS[0], f"{n}q")

    saved.set_lambda_mode("bf16")
    p0 = model.params.detach().clone()
    losses = []
    for step in range(3):
        loss, grad = _grad_request(model, REQUESTS[0])
        with torch.no_grad():
            model.params.sub_(SGD_LR * grad)
        losses.append(loss.item())
        log(f"  {n}q SGD step {step}: loss {loss.item():.6f}")
    model.params.data = p0
    _check(all(np.isfinite(losses)), f"{n}q: non-finite SGD losses {losses}")
    return launches, g64


# ---------------------------------------------------------------------------
# Phase 5b: the adjoint slice
# ---------------------------------------------------------------------------


def _adjoint_grad(model, inputs, mode: str, lam: str) -> tuple:
    """One gradient request under BACKWARD_MODE = mode and lambda mode lam;
    returns (loss, grad, launches of this request)."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    simulation.set_backward_mode(mode)
    saved.set_lambda_mode(lam)
    before = ck.launch_counts()
    loss, g = _grad_request(model, inputs)
    torch.cuda.synchronize()
    return loss, g, _diff(ck.launch_counts(), before)


def _check_adjoint_counts(counts: dict, shape: dict, what: str, requests: int = 1) -> None:
    """One adjoint_step per window, one adjoint_step_top per top window,
    rotate_pair at least once per rotation, and no window backward kernel."""
    want = {"adjoint_step": requests * len(shape["window_apply"]),
            "adjoint_step_top": requests * len(shape["window_apply_top"])}
    ok = (all(counts[k] == v for k, v in want.items())
          and counts["rotate_pair"] >= requests * len(shape["rotate"])
          and counts["window_apply_bwd"] == 0 and counts["window_apply_top_bwd"] == 0)
    log(f"  {what} launched {counts}")
    _check(ok, f"{what}: launches {counts}, want {want}, rotate_pair >= "
               f"{requests * len(shape['rotate'])} and no window backward kernel")


def _within(g, ref, what: str, rel: float = TOL_ADJ_REL, abs_: float = TOL_ADJ_ABS) -> None:
    d = _maxdiff(g, ref)
    tol = rel * ref.abs().max().item() + abs_
    log(f"  {what}: max|delta g|={d:.3e} (max|g|={ref.abs().max().item():.3e}, tol {tol:.3e})")
    _check(d <= tol, f"{what}: gradients differ by {d:.3e} > {tol:.3e}")


def _finite_difference(model, g, inputs, what: str) -> None:
    """Central difference of the card's forward along g/|g| against |g|."""
    gnorm = g.norm().item()
    v = (g / gnorm).to(model.params.device)
    p0 = model.params.detach().clone()
    f_pm = []
    try:
        for p in (p0 + FD_EPS * v, p0 - FD_EPS * v):
            model.params.data = p
            with torch.inference_mode():
                f_pm.append(model(inputs=inputs).mean().item())
    finally:
        model.params.data = p0
    fd = (f_pm[0] - f_pm[1]) / (2 * FD_EPS)
    tol = FD_REL * gnorm + FD_ABS
    log(f"  {what} central difference along g/|g| (eps {FD_EPS}): {fd:.6f} vs |g| {gnorm:.6f} "
        f"(|delta|={abs(fd - gnorm):.3e}, tol {tol:.3e})")
    _check(abs(fd - gnorm) <= tol, f"{what}: finite difference {fd} vs |g| {gnorm}")


def _batch_under_the_line(model, shape: dict, n: int) -> None:
    """A batch whose residuals fit under the 0.35 line before it starts, but
    not in what is free once most of them are held: one decision sends every
    element to the saved executor, and free memory is read once.  (A rule
    that re-read free memory per element would flip to the adjoint part-way
    through; the memory read after the forward shows that it would.)"""
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    batch = [float(x) for x in np.linspace(-1, 1, BATCH_UNDER)]
    frac = simulation._RESIDUAL_MEM_FRACTION
    need = BATCH_UNDER * len(shape["steps"]) * 8 * 2**n
    real = memory.available_memory_bytes
    reads = []

    def counted(device=None):
        reads.append(real(device))
        return reads[-1]

    simulation.set_backward_mode("auto")
    saved.set_lambda_mode("bf16")
    before = ck.launch_counts()
    memory.available_memory_bytes = counted
    try:
        model.params.grad = None
        loss = model(inputs=batch).mean()
        held = real(DEVICE)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        memory.available_memory_bytes = real
    c = _diff(ck.launch_counts(), before)
    _check(len(reads) == 1, f"{n}q batch of {BATCH_UNDER}: free memory read {len(reads)} times")
    # What the last element would have read: all but one element's residuals held.
    last = reads[0] - (BATCH_UNDER - 1) / BATCH_UNDER * (reads[0] - held)
    log(f"  {n}q batch of {BATCH_UNDER}: residuals {need / 1e9:.2f} GB against 0.35 x free "
        f"{frac * reads[0] / 1e9:.2f} GB before the batch; a per-element re-read would see "
        f"{frac * last / 1e9:.2f} GB at the last element")
    _check(need <= frac * reads[0], f"{n}q batch of {BATCH_UNDER} is not under the line")
    _check(need > frac * last, f"{n}q batch of {BATCH_UNDER}: a per-element rule would not "
                               "flip, so the check cannot tell one decision from many")
    want = BATCH_UNDER * len(shape["window_apply"])
    log(f"  {n}q batch of {BATCH_UNDER} under auto launched {c}")
    _check(c["window_apply_bwd"] == want and c["adjoint_step"] == 0 and c["rotate_pair"] == 0,
           f"{n}q batch of {BATCH_UNDER}: launches {c}, want {want} window_apply_bwd and "
           "no adjoint kernel")
    _check(bool(torch.isfinite(model.params.grad).all()) and bool(torch.isfinite(loss)),
           f"{n}q batch of {BATCH_UNDER}: non-finite loss or gradient")


def phase_adjoint(models: dict, shapes: dict, g64: torch.Tensor) -> tuple:
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    log("phase 5b: gradients through the adjoint-state executor (B12, B13, B16)")
    ck.reset_launch_counts()
    m, n = WIDTHS
    x0 = REQUESTS[0]

    # 22q, forced: reaches the top window (B13); against the CPU float64 path.
    for lam, tol in (("f32", TOL_GRAD_F32), ("bf16", TOL_GRAD_BF16)):
        loss, g, c = _adjoint_grad(models[m], x0, "adjoint", lam)
        _check_adjoint_counts(c, shapes[m], f"{m}q adjoint (lambda={lam})")
        _check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(loss)),
               f"{m}q adjoint: non-finite loss or gradient")
        _within(g, g64, f"{m}q adjoint (lambda={lam}) vs CPU fp64", 0.0, tol)

    # 24q, forced, one input: against the saved executor, and bf16 vs f32 lambda.
    model = models[n]
    _, g_adj, c = _adjoint_grad(model, x0, "adjoint", "f32")
    _check_adjoint_counts(c, shapes[n], f"{n}q adjoint (lambda=f32)")
    _, g_sav, c = _adjoint_grad(model, x0, "autodiff", "f32")
    _check(c["adjoint_step"] == 0 and c["window_apply_bwd"] > 0,
           f"{n}q autodiff did not run the saved executor: {c}")
    _within(g_adj, g_sav, f"{n}q adjoint vs saved (lambda=f32)")
    _, g_adj16, c = _adjoint_grad(model, x0, "adjoint", "bf16")
    _check_adjoint_counts(c, shapes[n], f"{n}q adjoint (lambda=bf16)")
    _within(g_adj16, g_adj, f"{n}q adjoint bf16 vs f32 lambda", 0.0, TOL_GRAD_BF16)

    # 24q, a batch of 16 under "auto": 16 x 2.55 GB of residuals is over the
    # rule's line, so every element takes the adjoint (one decision).
    residuals = len(BATCH16) * len(shapes[n]["steps"]) * 8 * 2**n
    line = simulation._RESIDUAL_MEM_FRACTION * memory.available_memory_bytes(DEVICE)
    log(f"  {n}q batch of {len(BATCH16)}: residuals {residuals / 1e9:.1f} GB against "
        f"0.35 x free {line / 1e9:.1f} GB")
    _, gb_adj, c = _adjoint_grad(model, BATCH16, "auto", "f32")
    _check_adjoint_counts(c, shapes[n], f"{n}q batch of {len(BATCH16)} under auto",
                          len(BATCH16))
    torch.cuda.reset_peak_memory_stats()
    _, gb_sav, c = _adjoint_grad(model, BATCH16, "autodiff", "f32")
    log(f"  {n}q batch under forced autodiff: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    _check(c["adjoint_step"] == 0, f"{n}q batch under autodiff ran the adjoint: {c}")
    _within(gb_adj, gb_sav, f"{n}q batch of {len(BATCH16)}: auto (adjoint) vs saved")
    p0 = model.params.detach().clone()
    losses = []
    for step in range(3):
        loss, grad, c = _adjoint_grad(model, BATCH16, "auto", "bf16")
        _check(c["adjoint_step"] == len(BATCH16) * len(shapes[n]["window_apply"]),
               f"{n}q batch SGD step {step}: launches {c}")
        with torch.no_grad():
            model.params.sub_(SGD_LR * grad)
        losses.append(loss.item())
        log(f"  {n}q batch of {len(BATCH16)} SGD step {step} (auto, bf16 lambda): "
            f"loss {loss.item():.6f}")
    model.params.data = p0
    _check(all(np.isfinite(losses)), f"{n}q batch: non-finite SGD losses {losses}")
    _batch_under_the_line(model, shapes[n], n)

    # 26q, one input.
    model26 = Model(n_qubits=WIDE, n_layers=N_LAYERS, circuit_type="Circuit_19",
                    random_seed=SEED, device=DEVICE)
    _, _, c = _adjoint_grad(model26, x0, "auto", "bf16")
    picked = "adjoint" if c["adjoint_step"] else "saved"
    log(f"  {WIDE}q auto picks the {picked} executor (residuals "
        f"{len(shapes[WIDE]['steps']) * 8 * 2**WIDE / 1e9:.2f} GB per input)")
    _, g_adj, c = _adjoint_grad(model26, x0, "adjoint", "f32")
    _check_adjoint_counts(c, shapes[WIDE], f"{WIDE}q adjoint (lambda=f32)")
    _, g_sav, c = _adjoint_grad(model26, x0, "autodiff", "f32")
    _check(c["adjoint_step"] == 0, f"{WIDE}q autodiff ran the adjoint: {c}")
    _within(g_adj, g_sav, f"{WIDE}q adjoint vs saved (lambda=f32)")
    _, g_adj16, _ = _adjoint_grad(model26, x0, "adjoint", "bf16")
    _within(g_adj16, g_adj, f"{WIDE}q adjoint bf16 vs f32 lambda", 0.0, TOL_GRAD_BF16)
    simulation.set_backward_mode("auto")
    saved.set_lambda_mode("bf16")
    _finite_difference(model26, g_adj, x0, f"{WIDE}q adjoint (f32 lambda)")

    launches = ck.launch_counts()
    log(f"  launches over the adjoint phase: {launches}")
    for name in ADJOINT_KERNELS:
        _check(launches[name] > 0, f"kernel {name} was never launched on the adjoint path")
    return model26, launches


# ---------------------------------------------------------------------------
# Phase 6: times
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


def _host_ms(fn, reps: int = 3) -> tuple:
    """Host-clock ms of fn() ending in a synchronise, over reps runs; returns
    (best, median, last result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), float(np.median(times)), out


def _log_breakdown(model, n: int) -> None:
    """Where one forward request's time goes: recording the tape (gate
    matrices on the card), planning (window composition, layout DP,
    re-fusion) and running the plan (the kernels) plus the readout."""
    from qml_essentials_tpu_torch.ops import kernels, simulation

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)
    rec_ms, _, tape = _host_ms(lambda: model.script._record(model.params, inputs, model.enc_params))
    plan_ms, _, (plan, start) = _host_ms(lambda: simulation.scheduled_plan(tape, n, device=DEVICE))

    def run():
        psi2 = start if start is not None else kernels.zero_state_ri(n, device=DEVICE)
        for kind, payload, wires in plan:
            psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n)
        return simulation.measure_state_ri(psi2, n, meas_type, obs)

    run_ms, _, _ = _host_ms(run)
    log(f"    forward breakdown {n}q: record {rec_ms:.3f} ms, plan {plan_ms:.3f} ms, "
        f"run {len(plan)} steps + readout {run_ms:.3f} ms")


def _log_grad_breakdown(model, n: int, executor: str = "saved") -> None:
    """Where one forward + gradient request's time goes: record, plan, the
    executor's forward run (``"saved"`` or ``"adjoint"``) plus the readout,
    and the backward run (the executor's reverse walk and autograd back
    through the window composition and the outer-product start to the
    parameters)."""
    from qml_essentials_tpu_torch.ops import adjoint, kernels, saved, simulation

    run_plan = {"saved": saved.execute_plan_saved_ri, "adjoint": adjoint.execute_plan_ri}[executor]

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)
    parts = {"record": [], "plan": [], "forward run": [], "backward run": []}
    for _ in range(4):
        model.params.grad = None
        t = [time.perf_counter()]
        tape = model.script._record(model.params, inputs, model.enc_params)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        plan, start = simulation.scheduled_plan(tape, n, device=DEVICE)
        static, payloads = adjoint.normalize_plan(plan, n)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if start is None:
            start = kernels.zero_state_ri(n, device=DEVICE)
        psi2 = run_plan(start, payloads, static, n)
        loss = simulation.measure_state_ri(psi2, n, meas_type, obs).mean()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for (name, acc), t0, t1 in zip(parts.items(), t, t[1:]):
            acc.append((t1 - t0) * 1e3)
    best = {name: min(v[1:]) for name, v in parts.items()}  # first run is the warm-up
    log(f"    fwd+grad breakdown {n}q, {executor} executor (best of 3): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in best.items())
        + f"; {len(plan)} steps")


def _grad_times(model, inputs, what: str, median: bool = False) -> None:
    """fwd+grad ms of one request or batch: warm-up, best of 3 (and the
    median of 10)."""
    _grad_request(model, inputs)
    torch.cuda.synchronize()
    best, _, _ = _host_ms(lambda: _grad_request(model, inputs))
    extra = ""
    if median:
        _, med, _ = _host_ms(lambda: _grad_request(model, inputs), reps=10)
        extra = f" (median of 10: {med:.3f} ms)"
    log(f"  forward + gradient {what}: {best:.3f} ms{extra}")


def _adjoint_times(models: dict, model26) -> None:
    from qml_essentials_tpu_torch.ops import saved, simulation

    n = WIDTHS[-1]
    saved.set_lambda_mode("bf16")
    simulation.set_backward_mode("adjoint")
    _grad_times(models[n], REQUESTS[0],
                f"{n}q Circuit_19 L={N_LAYERS}, adjoint forced (bf16 lambda), per request",
                median=True)
    _log_grad_breakdown(models[n], n, "adjoint")
    for mode, label in (("adjoint", "adjoint forced"), ("autodiff", "saved forced")):
        simulation.set_backward_mode(mode)
        _grad_times(model26, REQUESTS[0],
                    f"{WIDE}q Circuit_19 L={N_LAYERS}, {label} (bf16 lambda), per request")
    simulation.set_backward_mode("auto")
    _grad_times(models[n], BATCH16,
                f"{n}q Circuit_19 L={N_LAYERS}, a batch of {len(BATCH16)} under auto (adjoint, "
                f"bf16 lambda), per batch")


def phase_times(models: dict, model26, shapes: dict) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    log("phase 6: times (host clock ending in a synchronise: best of 3 after a warm-up, "
        "and the median of 10; kernels: CUDA events, best of 3 after warm-up)")
    for n, model in models.items():
        with torch.inference_mode():
            model(inputs=REQUESTS[0])
            torch.cuda.synchronize()
            best, _, _ = _host_ms(lambda: model(inputs=REQUESTS[0]))
            _, med, _ = _host_ms(lambda: model(inputs=REQUESTS[0]), reps=10)
        log(f"  forward {n}q Circuit_19 L={N_LAYERS}: {best:.3f} ms per request "
            f"(median of 10: {med:.3f} ms)")
        _log_breakdown(model, n)
    for n, model in models.items():
        _grad_request(model, REQUESTS[0])
        torch.cuda.synchronize()
        best, _, _ = _host_ms(lambda: _grad_request(model, REQUESTS[0]))
        _, med, _ = _host_ms(lambda: _grad_request(model, REQUESTS[0]), reps=10)
        log(f"  forward + gradient {n}q Circuit_19 L={N_LAYERS} (bf16 lambda): {best:.3f} ms "
            f"per request (median of 10: {med:.3f} ms)")
        _log_grad_breakdown(model, n)
    _adjoint_times(models, model26)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    totals = {name: [0.0, 0.0] for name in KERNELS}

    def add(name, label, kern, plain, flops=None):
        t_k, t_p = _events_ms(kern), _events_ms(plain)
        totals[name][0] += t_k
        totals[name][1] += t_p
        rate = f"  {flops / t_k / 1e9:6.1f} TFLOP/s" if flops else ""
        log(f"  {name:20s} {label:34s} kernel {t_k * 1e3:9.1f} us   plain {t_p * 1e3:9.1f} us"
            f"{rate}")

    def dt(t):
        return str(t)[6:]

    with torch.inference_mode():
        n, m = WIDTHS[-1], WIDTHS[0]
        x = _state(n, gen)
        for a, k in shapes[n]["window_apply"]:
            w = _unitary(k, rng)
            add("window_apply", f"n={n} a={a} k={k}",
                lambda: ck.window_apply(x, w, a, k, n),
                lambda: kn.window_apply_plain(x, w, a, k, n), 8 * 2**k * 2**n)
        for r in shapes[n]["rotate"]:
            add("rotate", f"n={n} r={r} float32",
                lambda: ck.rotate(x, r, n), lambda: kn.rotate_plain(x, r, n))
        xm = _state(m, gen)
        for k in shapes[m]["window_apply_top"]:
            w = _unitary(k, rng)
            add("window_apply_top", f"n={m} k={k}",
                lambda: ck.window_apply_top(xm, w, k, m),
                lambda: kn.window_apply_top_plain(xm, w, k, m), 8 * 2**k * 2**m)
        g = _state(n, gen)
        for kind, shape, g_dt, out_dt in backward_calls(shapes[n]["steps"]):
            gg = g.to(g_dt)
            if kind == "rot":
                add("rotate", f"n={n} r={(n - shape) % n} {dt(g_dt)} (bwd)",
                    lambda: ck.rotate(gg, (n - shape) % n, n),
                    lambda: kn.rotate_plain(gg, (n - shape) % n, n))
                continue
            a, k = shape
            w = _unitary(k, rng)
            add("window_apply_bwd", f"n={n} a={a} k={k} g={dt(g_dt)} out={dt(out_dt)}",
                lambda: ck.window_apply_bwd(w, gg, x, a, k, n, out_dt),
                lambda: kn.window_apply_bwd_plain(w, gg, x, a, k, n, out_dt),
                16 * 2**k * 2**n)
        gm = _state(m, gen)
        for kind, shape, g_dt, out_dt in backward_calls(shapes[m]["steps"]):
            if kind != "top":
                continue
            a, k = shape
            w, gg = _unitary(k, rng), gm.to(g_dt)
            add("window_apply_top_bwd", f"n={m} k={k} g={dt(g_dt)} out={dt(out_dt)}",
                lambda: ck.window_apply_top_bwd(w, gg, xm, k, m, out_dt),
                lambda: kn.window_apply_top_bwd_plain(w, gg, xm, k, m, out_dt),
                16 * 2**k * 2**m)
        # The adjoint backward of one request: the same lambda dtypes, on
        # the step's output state.
        for kind, shape, g_dt, out_dt in backward_calls(shapes[n]["steps"]):
            gg = g.to(g_dt)
            if kind == "rot":
                r = (n - shape) % n
                add("rotate_pair", f"n={n} r={r} f32+{dt(g_dt)}",
                    lambda: ck.rotate_pair(x, gg, r, n), lambda: kn.rotate_pair_plain(x, gg, r, n))
                continue
            a, k = shape
            w = _unitary(k, rng)
            add("adjoint_step", f"n={n} a={a} k={k} lam={dt(g_dt)} out={dt(out_dt)}",
                lambda: ck.adjoint_step(w, x, gg, a, k, n, out_dt),
                lambda: kn.adjoint_step_plain(w, x, gg, a, k, n, out_dt), 24 * 2**k * 2**n)
        for kind, shape, g_dt, out_dt in backward_calls(shapes[m]["steps"]):
            if kind != "top":
                continue
            a, k = shape
            w, gg = _unitary(k, rng), gm.to(g_dt)
            add("adjoint_step_top", f"n={m} k={k} lam={dt(g_dt)} out={dt(out_dt)}",
                lambda: ck.adjoint_step_top(w, xm, gg, k, m, out_dt),
                lambda: kn.adjoint_step_top_plain(w, xm, gg, k, m, out_dt), 24 * 2**k * 2**m)
    log(f"  (per kernel, summed over one request's calls: window_apply per {WIDTHS[-1]}q "
        f"forward, window_apply_bwd / adjoint_step per {WIDTHS[-1]}q gradient, rotate per "
        f"{WIDTHS[-1]}q forward + gradient, rotate_pair per {WIDTHS[-1]}q adjoint gradient, "
        f"window_apply_top / window_apply_top_bwd / adjoint_step_top per {WIDTHS[0]}q "
        f"forward / gradient)")
    for name, (t_k, t_p) in totals.items():
        log(f"  total {name:20s} kernel {t_k:.3f} ms   plain {t_p:.3f} ms")
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
    for line in ck.BUILD_LOG.splitlines():
        if "Compiling entry function" in line or "Used" in line:
            log(f"  {line.strip()}")

    shapes = {n: plan_shapes(n) for n in (*WIDTHS, WIDE)}
    for n in (*WIDTHS, WIDE):
        log(f"  {n}q plan: windows {shapes[n]['window_apply']}  "
            f"top {shapes[n]['window_apply_top']}  rotations {shapes[n]['rotate']}")
    errs = phase_parity(shapes)
    models, fwd_launches = phase_slice()
    grad_launches, g64 = phase_grad(models, shapes)
    model26, adj_launches = phase_adjoint(models, shapes, g64)
    launches = {k: fwd_launches[k] + grad_launches[k] for k in KERNELS}
    for k in ADJOINT_KERNELS:
        launches[k] = adj_launches[k]
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    totals = phase_times(models, model26, shapes)

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
