"""Saved-residual plan executor with bfloat16 cotangent storage.

In the large-state regime (``n >= simulation.LARGE_STATE_MIN_N``) the
gradient runs through one plan-level ``torch.autograd.Function``: its
forward runs the plan on the same kernels as the per-step loop and keeps
each payload step's input state (the forward's own intermediates, no extra
writes); its backward walks the plan in reverse, three state passes per
step (read the cotangent λ, read the saved input x, write λ').

* a rotation step rotates λ back (the rotation kernel by ``(n - r) % n``,
  on a bfloat16 or float32 λ);
* a window on a contiguous support runs the window backward kernel
  (``window_apply_bwd``, or ``window_apply_top_bwd`` when the window ends at
  the top of the register), which writes ``λ' = W^† λ`` and the matrix
  cotangent ``gw = Σ λ x^†`` in one call, for any ``K >= 2``;
* a fused rotation step runs its backward kernel (``rotmat_apply_bwd``,
  ``rotwin_apply_bwd`` or ``matrot_apply_bwd``), the same two outputs with
  the rotation folded into the loads and stores;
* any other step (a scattered support, a diagonal) differentiates its own
  forward with ``torch.autograd.grad``, in the working dtype.

The cotangent only ever feeds *parameter* gradients, one further trace
reduction away, so λ is stored in bfloat16 between steps by default
(``LAMBDA_MODE = "bf16"``): the backward kernels read it and write it at
half width.  The incoming cotangent is never rounded, and the earliest
payload step writes the boundary cotangent in the working dtype (float32 on
the card).  :func:`set_lambda_mode` ("f32") keeps full precision for
oracle-grade comparisons.

Counterpart of ``qml_essentials_tpu/ops/saved.py`` (a ``jax.custom_vjp``
there).  On the CPU the same executor runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from qml_essentials_tpu_torch.ops import cuda_kernels, kernels
from qml_essentials_tpu_torch.utils import profiling

# Escape hatch: route large-state gradients through the per-kernel autograd
# Functions instead of the plan-level executor.
ENABLED: bool = True

# Storage dtype of the inter-step cotangent λ in the large-state backward:
#   "bf16" — bfloat16 λ between steps (default; see the module docstring)
#   "f32"  — full-precision λ (the per-kernel loop's numbers, up to the
#            order of kernel launches)
LAMBDA_MODE: str = "bf16"


def set_lambda_mode(mode: str) -> None:
    """Select the backward cotangent storage dtype ("bf16" | "f32")."""
    global LAMBDA_MODE
    if mode not in ("bf16", "f32"):
        raise ValueError(f"Unknown lambda mode {mode!r}")
    LAMBDA_MODE = mode


def set_saved_executor(enabled: bool) -> None:
    """Enable/disable the plan-level saved-residual executor."""
    global ENABLED
    ENABLED = bool(enabled)


def usable(plan: Sequence[tuple], n: int) -> bool:
    """True when the plan-level executor should take *plan* (raw or
    normalised) of an *n*-qubit simulation: the large-state regime, on any
    device, and no chain step (a chain's gradient runs the adjoint's chain
    kernel, or the per-step loop over its expansion)."""
    from qml_essentials_tpu_torch.ops import simulation

    return n >= simulation.LARGE_STATE_MIN_N and all(s[0] != "chain" for s in plan)


def _one_step(psi2: torch.Tensor, w2: torch.Tensor, step: tuple, n: int) -> torch.Tensor:
    """Forward-apply one payload-bearing normalised plan step."""
    kind = step[0]
    if kind in ("rotmat", "matrot"):
        return kernels.apply_fused_pair_ri(psi2, w2, kind, step[1], len(step[2]), n)
    if kind == "mat":
        return kernels.apply_matrix_pair_ri(psi2, w2, list(step[1]), n)
    return kernels.apply_diagonal_pair_ri(psi2, w2, list(step[1]), n)


def _forward_saving(
    psi2: torch.Tensor, payloads: Sequence[torch.Tensor], static: tuple, n: int
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run the plan, recording each payload step's input state."""
    saves: List[torch.Tensor] = []
    i = 0
    for step in static:
        if step[0] == "rot":
            psi2 = kernels._rotate_qubits_ri(psi2, step[1], n)
            continue
        saves.append(psi2)
        psi2 = _one_step(psi2, payloads[i], step, n)
        i += 1
    return psi2, saves


def _contiguous_window(step: tuple) -> Optional[Tuple[int, int]]:
    """``(a, k)`` of a ``mat`` step on a contiguous support, else None."""
    if step[0] != "mat":
        return None
    srt = [int(w) for w in step[1]]
    k = len(srt)
    if srt != list(range(srt[0], srt[0] + k)):
        return None
    return srt[0], k


def _step_bwd(step: tuple, w2: torch.Tensor, lam: torch.Tensor, x: torch.Tensor, n: int,
              out_dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One backward step: ``(λ', gw)`` for ``y = step(x, w)`` given the output
    cotangent ``lam`` and the saved input ``x``.

    A contiguous window and a fused rotation step run their backward kernels
    (``λ'`` written in *out_dt*); anything else differentiates the step's
    own forward with ``torch.autograd.grad`` (exact, in the working dtype —
    later steps take a float32 λ as well as a bfloat16 one)."""
    kind = step[0]
    if kind == "matrot":
        return cuda_kernels.matrot_apply_bwd(w2, lam, x, step[1], n, out_dt)
    if kind == "rotmat":
        r, k = step[1], len(step[2])
        if k == r:
            return cuda_kernels.rotmat_apply_bwd(w2, lam, x, r, n, out_dt)
        return cuda_kernels.rotwin_apply_bwd(w2, lam, x, r, k, n, out_dt)
    win = _contiguous_window(step)
    if win is not None:
        a, k = win
        if a + k == n:
            return cuda_kernels.window_apply_top_bwd(w2, lam, x, k, n, out_dt)
        return cuda_kernels.window_apply_bwd(w2, lam, x, a, k, n, out_dt)

    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        ww = w2.detach().requires_grad_()
        y = _one_step(xx, ww, step, n)
        return torch.autograd.grad(y, (xx, ww), lam.to(x.dtype))


def _bwd(static: tuple, n: int, saves: Sequence[torch.Tensor],
         payloads: Sequence[torch.Tensor], g: torch.Tensor):
    """Reverse walk of the plan: returns (boundary cotangent, payload grads)."""
    use16 = LAMBDA_MODE == "bf16"
    steps = []
    i = 0
    for step in static:
        if step[0] == "rot":
            steps.append((step, None))
        else:
            steps.append((step, i))
            i += 1

    # The incoming cotangent keeps its dtype: rounding the seed would feed
    # its error into every step's gram.
    lam = g
    grads: List[Optional[torch.Tensor]] = [None] * len(payloads)
    for step, slot in reversed(steps):
        if slot is None:
            lam = kernels._rotate_qubits_ri(lam, (n - step[1]) % n, n)
            continue
        # The earliest payload step writes the boundary cotangent in the
        # working dtype (rotation steps before it keep the dtype).
        out_dt = torch.bfloat16 if (use16 and slot > 0) else g.dtype
        lam, gw = _step_bwd(step, payloads[slot], lam, saves[slot], n, out_dt)
        grads[slot] = gw
    return lam.to(g.dtype), grads


class _SavedPlan(torch.autograd.Function):
    """``(psi2, *payloads) -> final state`` with the saved-residual backward,
    a ``run.backward`` span under a profiler, with its forward's request."""

    @staticmethod
    def forward(ctx, psi2, static, n, *payloads):
        out, saves = _forward_saving(psi2, payloads, static, n)
        ctx.static, ctx.n, ctx.n_saves = static, n, len(saves)
        ctx.request = profiling.current_request()
        ctx.save_for_backward(*saves, *payloads)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with profiling.span("run.backward", request=ctx.request):
            tensors = ctx.saved_tensors
            saves, payloads = tensors[: ctx.n_saves], tensors[ctx.n_saves:]
            lam, grads = _bwd(ctx.static, ctx.n, saves, payloads, g.contiguous())
        return (lam, None, None, *grads)


def execute_plan_saved_ri(
    psi2: torch.Tensor, payloads: Sequence[torch.Tensor], static: tuple, n: int
) -> torch.Tensor:
    """Run a normalised plan with the saved-residual, bf16-λ backward.

    Payloads are moved to the state's device and dtype first (fixed gates
    keep their matrices as CPU constants)."""
    payloads = [p.to(device=psi2.device, dtype=psi2.dtype).contiguous() for p in payloads]
    return _SavedPlan.apply(psi2, static, n, *payloads)
