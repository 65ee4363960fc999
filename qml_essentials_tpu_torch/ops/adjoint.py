"""Adjoint-state differentiation of the pure-state contraction plan.

Reverse-mode autodiff through a depth-``D`` statevector simulation keeps
every intermediate state for the backward: O(D·2**n) device memory (the
saved-residual executor, :mod:`qml_essentials_tpu_torch.ops.saved`).
Quantum circuits are unitary, so the residuals are not needed: the backward
walk rebuilds each step's input by applying the inverse step to its output:

    ψ_{j-1} = U_j† ψ_j            (undo: unitarity)
    gw_j    = λ_j ψ_{j-1}†        (window-matrix cotangent)
    λ_{j-1} = U_j† λ_j            (cotangent pullback)

The forward keeps the *final* state only (and the payloads).

:func:`normalize_plan` turns a contraction plan into a static step list
(hashable metadata) plus a tuple of real-split payload tensors — window
matrices as ``(2, K, K)`` (Re, Im) pairs and diagonals as ``(2, 2**k)``
pairs, both pre-permuted to sorted wire order.  Keeping payloads real
sidesteps complex-cotangent conventions: autograd through
``torch.stack([m.real, m.imag])`` carries the payload gradients back to the
gate parameters through the window composition.  Both plan-level executors
run on it.

:func:`execute_plan_ri` is one ``torch.autograd.Function`` whose backward
walks the plan in reverse on the hand-written kernels of
:mod:`~qml_essentials_tpu_torch.ops.cuda_kernels`:

* a rotation step rotates both ψ and λ back by ``(n - r) mod n`` in one
  ``rotate_pair`` launch;
* a window on a contiguous support is one ``adjoint_step`` (or
  ``adjoint_step_top`` when it ends at the top of the register), for any
  ``K >= 2``;
* a ring-wrap support rotates both arrays to make it contiguous
  (``rotate_pair``), runs ``adjoint_step`` with the permuted payload, and
  rotates back;
* a scattered window and a diagonal step take λ to the working dtype and
  undo and reduce with the plain forward gate application and torch
  products (the reference's einsum branches);
* a fused ``matrot`` step, and a ``rotmat`` step whose window is the
  rotated-in wires, is one ``adjoint_matrot`` / ``adjoint_rotmat`` launch
  (the undo of window and rotation on ψ and λ, and the gram); a ``rotmat``
  step with a wider window (rotwin) has no fused adjoint kernel, as in the
  reference: ``adjoint_step`` on ``[0, k)``, then ``rotate_pair`` back;
* a chain step (:mod:`~qml_essentials_tpu_torch.ops.chains`, one payload
  per descriptor) is one ``adjoint_chain`` launch: its descriptors undone in
  reverse on ψ and λ, with one cotangent per descriptor.  λ enters it in the
  working dtype and leaves it so.

λ travels in bfloat16 between payload steps when ``saved.LAMBDA_MODE ==
"bf16"`` and ``n >= simulation.LARGE_STATE_MIN_N`` (the kernels read and
write it at half width); the incoming cotangent is never rounded, the
earliest payload step writes λ in the working dtype, and ψ is always in the
working dtype.  On the CPU the same executor runs the kernels' plain
versions.

The adjoint never runs a density plan: a superoperator is not undone by
its dagger, so noisy tapes take the saved executor
(:func:`~qml_essentials_tpu_torch.ops.simulation._simulate_interleaved_ri`).

Counterpart of ``qml_essentials_tpu/ops/adjoint.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from qml_essentials_tpu_torch.ops import chains, cuda_kernels, kernels, saved
from qml_essentials_tpu_torch.ops.operations import (
    DiagonalQubitUnitary,
    KrausChannel,
    Operation,
)
from qml_essentials_tpu_torch.utils import profiling

# Session flag (the reference's switch).  ``BACKWARD_MODE`` alone picks the
# executor; with the flag off, a gradient that a forced mode or the residual
# rule sends to the adjoint raises instead of running (it never falls back
# to the saved executor, whose residuals the rule found too large).
ENABLED: bool = True


def set_adjoint(enabled: bool) -> None:
    """Allow (default) or forbid adjoint-state differentiation of
    pure-state plans."""
    global ENABLED
    ENABLED = bool(enabled)


def _pair(x: torch.Tensor) -> torch.Tensor:
    """Stack a tensor into its (Re, Im) pair (real inputs get zero Im)."""
    if x.is_complex():
        return torch.stack([x.real, x.imag])
    return torch.stack([x, torch.zeros_like(x)])


def normalize_plan(
    plan: List[Tuple[str, object, List[int]]], n: int
) -> Tuple[tuple, tuple]:
    """Normalise a contraction plan for the plan-level executors.

    Accepts both raw :func:`~qml_essentials_tpu_torch.ops.simulation.plan_contractions`
    output (kinds ``mat``/``op``), scheduled plans (kinds
    ``mat``/``diag``/``rot``, and ``rotmat``/``matrot`` with
    ``FUSE_LAYOUT_ROT`` on) and chain plans.  Returns ``(static, payloads)``:
    ``static`` is a tuple of steps ``("mat", wires)``, ``("diag", wires)``,
    ``("rot", r)``, ``(kind, r, wires)`` with wires sorted, and ``("chain",
    geom, descs)`` with one payload per descriptor (a chain the kernels do
    not take is expanded into ``mat``/``diag`` steps), and ``payloads`` the
    matching tuple of real-split tensors.  A noise channel raises
    ``TypeError`` (the reference returns ``None``): noisy tapes run the
    density engines, whose lowered plans hold none.
    """
    static: list = []
    payloads: list = []
    for kind, payload, wires in plan:
        if kind == "rot":
            static.append(("rot", int(payload)))
            continue
        if kind == "chain":
            geom, descs, pays = payload
            if chains.chain_usable(geom, descs, n):
                static.append(("chain", geom, descs))
            else:
                static.extend(chains.expand_chain_step(geom, descs, n))
            payloads.extend(_pair(p) for p in pays)
            continue
        if kind in ("rotmat", "matrot"):
            r, mat = payload
            static.append((kind, int(r), tuple(int(w) for w in wires)))
            payloads.append(_pair(mat))
            continue
        if kind == "diag":
            d, w = payload, list(wires)
        elif kind == "mat":
            d, w = None, list(wires)
            mat = payload
        else:  # "op"
            op = payload
            if isinstance(op, KrausChannel):
                raise TypeError(f"{op.name} is a noise channel: run it on a density engine")
            cls = op.__class__
            if cls.apply_to_state_ri is not Operation.apply_to_state_ri:
                if isinstance(op, DiagonalQubitUnitary):
                    d, w = op.diag, list(op.wires)
                else:
                    continue  # no-op override (Id, Barrier)
            else:
                d, w = None, list(op.wires)
                mat = op.matrix

        k = len(w)
        srt = sorted(int(x) for x in w)
        if d is not None:
            if w != srt:
                order = [w.index(x) for x in srt]
                d = d.reshape((2,) * k).permute(*order).reshape(-1)
            static.append(("diag", tuple(srt)))
            payloads.append(_pair(d))
        else:
            if w != srt:
                rank = {x: i for i, x in enumerate(srt)}
                mat = kernels.permute_gate_qubits(mat, [rank[x] for x in w], k)
            static.append(("mat", tuple(srt)))
            payloads.append(_pair(mat))
    return tuple(static), tuple(payloads)


# Bytes of each array a support's cotangent reads at once: its plain
# products make temporaries of a piece of the state, not of the whole (a
# rank of a 32-qubit register on four cards holds 8.6 GB shards).
COTANGENT_PIECE_BYTES: int = 1 << 28


def _support_pieces(lam2: torch.Tensor, x2: torch.Tensor, srt: Sequence[int]):
    """Both ``(2, 2**n)`` arrays as ``(2, A, 2**k, B)`` blocks of the
    support, at most ``COTANGENT_PIECE_BYTES`` of each at a time.  Arrays
    that fit in one piece: one block, views of the support (a scattered
    one's wires pulled to the front of whole copies first, ``A = 1``).
    Larger ones: views of a contiguous support cut over ``A`` and ``B``
    (the qubits above and below it), and for a scattered one the support's
    qubits (sorted) pulled to the front of each copied piece (``A = 1``)."""
    n = int(x2.shape[-1]).bit_length() - 1
    srt = [int(w) for w in srt]
    k = len(srt)
    unit = 2 * 2**k * x2.element_size()
    if x2.numel() * x2.element_size() <= COTANGENT_PIECE_BYTES and not kernels._contiguous(srt):
        pulls, _ = kernels._gather_plan(tuple(srt))
        for p in pulls:
            lam2 = kernels._move_axis_front_ri(lam2, p)
            x2 = kernels._move_axis_front_ri(x2, p)
        srt = list(range(k))
    if kernels._contiguous(srt):
        lv = lam2.reshape(2, 2 ** srt[0], 2**k, -1)
        xv = x2.reshape(2, 2 ** srt[0], 2**k, -1)
        for cut in kernels.pieces([lv.shape[1], lv.shape[3]], unit, COTANGENT_PIECE_BYTES):
            a, b = cut + (slice(None),) * (2 - len(cut))
            yield lv[:, a, :, b], xv[:, a, :, b]
        return
    runs, dims = kernels.bit_runs(n, srt)
    rest = [1 + i for i in range(len(runs)) if i not in dims]
    perm = [0] + [1 + i for i in dims] + rest
    lv = lam2.reshape((2,) + runs).permute(*perm)
    xv = x2.reshape((2,) + runs).permute(*perm)
    for cut in kernels.pieces([runs[i - 1] for i in rest], unit, COTANGENT_PIECE_BYTES):
        part = (slice(None),) * (1 + k) + cut
        yield lv[part].reshape(2, 1, 2**k, -1), xv[part].reshape(2, 1, 2**k, -1)


def _window_cotangent(lam2: torch.Tensor, x2: torch.Tensor, srt: Sequence[int]) -> torch.Tensor:
    """Matrix cotangent ``gw = λ conj(x)^T`` restricted to the window, from
    the step-output cotangent ``lam2`` and the rebuilt step input ``x2``;
    the ``(2, K, K)`` (Re, Im) pair."""
    gw = None
    for lv, xv in _support_pieces(lam2, x2, srt):
        K = lv.shape[2]
        lc = lv.transpose(1, 2).reshape(2, K, -1)
        xc = xv.transpose(1, 2).reshape(2, K, -1)
        part = torch.stack([lc[0] @ xc[0].T + lc[1] @ xc[1].T, lc[1] @ xc[0].T - lc[0] @ xc[1].T])
        gw = part if gw is None else gw + part
    return gw


def _diag_cotangent(lam2: torch.Tensor, x2: torch.Tensor, srt: Sequence[int]) -> torch.Tensor:
    """Diagonal cotangent ``gd[j] = sum_{a,b} λ[a,j,b] conj(x)[a,j,b]``."""
    gd = None
    for lv, xv in _support_pieces(lam2, x2, srt):
        part = torch.stack([(lv[0] * xv[0] + lv[1] * xv[1]).sum(dim=(0, 2)),
                            (lv[1] * xv[0] - lv[0] * xv[1]).sum(dim=(0, 2))])
        gd = part if gd is None else gd + part
    return gd


# ---------------------------------------------------------------------------
# Forward and the reverse walk
# ---------------------------------------------------------------------------


def _adjoint_step_contiguous(
    psi2: torch.Tensor, lam2: torch.Tensor, w2: torch.Tensor, srt: Sequence[int], n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One adjoint step on a contiguous support: the top-window kernel when
    it ends at the register top, the window kernel otherwise (any K >= 2)."""
    a, k = srt[0], len(srt)
    if a + k == n:
        return cuda_kernels.adjoint_step_top(w2, psi2, lam2, k, n, lam_dtype)
    return cuda_kernels.adjoint_step(w2, psi2, lam2, a, k, n, lam_dtype)


def _forward(psi2: torch.Tensor, payloads: Sequence[torch.Tensor], static: tuple, n: int
             ) -> torch.Tensor:
    """Run the plan on the forward kernels, keeping nothing."""
    i = 0
    for step in static:
        if step[0] == "rot":
            psi2 = kernels._rotate_qubits_ri(psi2, step[1], n)
            continue
        if step[0] == "chain":
            geom, descs = step[1], step[2]
            psi2 = cuda_kernels.chain_apply(psi2, payloads[i:i + len(descs)], geom, descs, n)
            i += len(descs)
            continue
        psi2 = saved._one_step(psi2, payloads[i], step, n)
        i += 1
    return psi2


def _bwd(static: tuple, n: int, psi2: torch.Tensor, payloads: Sequence[torch.Tensor],
         g: torch.Tensor):
    """Reverse walk from the final state: returns (boundary cotangent,
    payload grads)."""
    _, lam2, grads = walk_back(static, n, psi2, payloads, g)
    return lam2.to(g.dtype), grads


def walk_back(static: tuple, n: int, psi2: torch.Tensor, payloads: Sequence[torch.Tensor],
              g: torch.Tensor):
    """Undo a normalised plan from its output ``psi2`` and cotangent ``g``:
    returns the plan's input, the cotangent there (in the working dtype, or
    in ``g``'s when the plan has no payload step) and the payload grads.
    The sharded simulator walks its plan back segment by segment with it,
    between the exchanges."""
    from qml_essentials_tpu_torch.ops import simulation

    use16 = saved.LAMBDA_MODE == "bf16" and n >= simulation.LARGE_STATE_MIN_N
    work = psi2.dtype
    # Payload slot of each step; a chain step owns one consecutive slot per
    # descriptor, and its slot is the first of them.
    slots: List[Optional[int]] = []
    i = 0
    for step in static:
        if step[0] == "rot":
            slots.append(None)
        else:
            slots.append(i)
            i += len(step[2]) if step[0] == "chain" else 1

    def lam_dt(slot: int) -> torch.dtype:
        """λ out of a kernel step: bfloat16 mid-plan, the working dtype out
        of the earliest payload step (the boundary cotangent)."""
        return torch.bfloat16 if (use16 and slot > 0) else work

    # The incoming cotangent keeps its dtype: rounding the seed would feed
    # its error into every step's gram.
    lam2 = g
    grads: List[Optional[torch.Tensor]] = [None] * len(payloads)
    for step, slot in zip(reversed(static), reversed(slots)):
        kind = step[0]
        if kind == "rot":
            psi2, lam2 = cuda_kernels.rotate_pair(psi2, lam2, n - step[1], n)
            continue
        if kind == "chain":
            geom, descs = step[1], step[2]
            psi2, lam2, gws = cuda_kernels.adjoint_chain(
                psi2, lam2.to(work), payloads[slot:slot + len(descs)], geom, descs, n)
            grads[slot:slot + len(descs)] = gws
            continue
        w2 = payloads[slot]
        if kind == "matrot":
            psi2, lam2, grads[slot] = cuda_kernels.adjoint_matrot(
                w2, psi2, lam2, step[1], n, lam_dt(slot))
            continue
        if kind == "rotmat":
            r, srt = step[1], list(step[2])
            if len(srt) == r:
                psi2, lam2, grads[slot] = cuda_kernels.adjoint_rotmat(
                    w2, psi2, lam2, r, n, lam_dt(slot))
                continue
            # rotwin (k > r): no fused adjoint kernel, as in the reference —
            # the window's adjoint step on [0, k), then both arrays rotated back.
            psi2, lam2, grads[slot] = _adjoint_step_contiguous(
                psi2, lam2, w2, srt, n, lam_dt(slot))
            psi2, lam2 = cuda_kernels.rotate_pair(psi2, lam2, n - r, n)
            continue
        srt = list(step[1])
        k = len(srt)
        if kind == "mat" and kernels._contiguous(srt):
            psi2, lam2, grads[slot] = _adjoint_step_contiguous(
                psi2, lam2, w2, srt, n, lam_dt(slot))
            continue
        r = kernels._cyclic_run(srt, n) if kind == "mat" else None
        if r is not None:
            # Ring-wrap support: one rotation of both arrays makes it
            # contiguous (cheaper than the scattered gather's axis moves).
            psi2, lam2 = cuda_kernels.rotate_pair(psi2, lam2, r, n)
            mapped = [(w + r) % n for w in srt]
            msrt = sorted(mapped)
            rank = {w: j for j, w in enumerate(msrt)}
            perm = [rank[m] for m in mapped]
            w2r = torch.stack([kernels.permute_gate_qubits(w2[0], perm, k),
                               kernels.permute_gate_qubits(w2[1], perm, k)]).contiguous()
            psi2, lam2, gw_r = _adjoint_step_contiguous(
                psi2, lam2, w2r, msrt, n, lam_dt(slot))
            inv = [int(j) for j in np.argsort(perm)]
            grads[slot] = torch.stack([kernels.permute_gate_qubits(gw_r[0], inv, k),
                                       kernels.permute_gate_qubits(gw_r[1], inv, k)])
            psi2, lam2 = cuda_kernels.rotate_pair(psi2, lam2, n - r, n)
            continue
        # A scattered window or a diagonal: λ in the working dtype, undone
        # by the conjugate gate and reduced with plain products (the
        # reference's einsum branches).
        lam2 = lam2.to(work)
        if kind == "mat":
            wh = kernels.conj_pair_mat(w2)
            psi2 = kernels.apply_matrix_pair_ri(psi2, wh, srt, n)
            grads[slot] = _window_cotangent(lam2, psi2, srt)
            lam2 = kernels.apply_matrix_pair_ri(lam2, wh, srt, n)
        else:
            dh = torch.stack([w2[0], -w2[1]])
            psi2 = kernels.apply_diagonal_pair_ri(psi2, dh, srt, n)
            grads[slot] = _diag_cotangent(lam2, psi2, srt)
            lam2 = kernels.apply_diagonal_pair_ri(lam2, dh, srt, n)
    return psi2, lam2, grads


class _AdjointPlan(torch.autograd.Function):
    """``(psi2, *payloads) -> final state`` with the adjoint-state backward,
    a ``run.backward`` span under a profiler, with its forward's request."""

    @staticmethod
    def forward(ctx, psi2, static, n, *payloads):
        out = _forward(psi2, payloads, static, n)
        ctx.static, ctx.n = static, n
        ctx.request = profiling.current_request()
        ctx.save_for_backward(out, *payloads)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with profiling.span("run.backward", request=ctx.request):
            out, *payloads = ctx.saved_tensors
            lam, grads = _bwd(ctx.static, ctx.n, out, payloads, g.contiguous())
        return (lam, None, None, *grads)


def execute_plan_ri(
    psi2: torch.Tensor, payloads: Sequence[torch.Tensor], static: tuple, n: int
) -> torch.Tensor:
    """Run a normalised plan with the adjoint-state backward (residual
    footprint: the final state).  Payloads are moved to the state's device
    and dtype first (fixed gates keep their matrices as CPU constants)."""
    payloads = [p.to(device=psi2.device, dtype=psi2.dtype).contiguous() for p in payloads]
    return _AdjointPlan.apply(psi2, static, n, *payloads)
