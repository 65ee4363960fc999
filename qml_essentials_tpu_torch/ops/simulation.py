"""Statevector simulation and measurement.

Stateless functions: take a recorded tape (list of
:class:`~qml_essentials_tpu_torch.ops.operations.Operation`) plus
measurement parameters and return torch tensors.

*Gate fusion.*  Every gate reads and writes the full ``2**n`` state, so
:func:`plan_contractions` greedily composes consecutive gates whose combined
support fits in ``FUSE_MAX_WIDTH`` qubits (8 in the large-state regime) into
one ``(2**w, 2**w)`` window on a contiguous range.

*Large-state regime* (``n >= LARGE_STATE_MIN_N``).  The leading disjoint
windows collapse into an outer-product start (:func:`_zero_state_prefix`);
:func:`schedule_layout` places shared cyclic rotations by dynamic
programming so ring-wrap entanglers become contiguous, and
:func:`refuse_windows` merges neighbouring windows up to 10 qubits.  Each
resulting step is one pass of a hand-written kernel on the flat real-split
``(2, 2**n)`` state.  The planner is the JAX package's, step for step —
including the DP's prices, which were set on the TPU — so both packages run
the same plan for the same tape.

*Diagonal observables.*  Z-type expectation values fold the probability
vector (:func:`_expval_from_probs`); no dense observable is built.

*Gradients.*  :func:`simulate_pure_ri` chooses the backward: the
saved-residual executor (:mod:`~qml_essentials_tpu_torch.ops.saved`) in the
large-state regime, the kernels' own autograd backwards below it, and the
adjoint-state backward (not ported yet: it raises) when the residuals would
not fit in memory or ``BACKWARD_MODE = "adjoint"``.

Counterpart of ``qml_essentials_tpu/ops/simulation.py`` (the statevector
part; density simulation, shots and the adjoint executor come later).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.core import memory
from qml_essentials_tpu_torch.ops import adjoint, kernels, saved
from qml_essentials_tpu_torch.ops.dtypes import cdtype
from qml_essentials_tpu_torch.ops.operations import (
    Barrier,
    DiagonalQubitUnitary,
    Id,
    Operation,
)

# Maximum combined support (in qubits) of a fused gate block below the
# large-state regime.  Set to 0/1 to disable fusion.
FUSE_MAX_WIDTH: int = 5

# Fusion width floor in the large-state regime (window K = 2**w).
LARGE_FUSE_WIDTH: int = 8

# Windows are only fused when ``n_qubits >= window_width + FUSE_MIN_EXCESS``.
FUSE_MIN_EXCESS: int = 3

# Qubit count from which plans use the large-state regime (wide windows,
# outer-product start, scheduled rotations).  This is the reference's
# PALLAS_MIN_N, kept so both packages plan alike; to be re-tuned on the card.
LARGE_STATE_MIN_N: int = 22

# Fuse (rotation, window) pairs into single-pass "rotmat"/"matrot" steps.
# Off until the fused rotation kernels (reference rotmat/matrot/rotwin) are
# ported; with it on, such steps run on the CPU only.
FUSE_LAYOUT_ROT: bool = False


def infer_n_qubits(ops: List[Operation], obs: List[Operation]) -> int:
    """Smallest qubit count covering all wires of *ops* and *obs* (min 1)."""
    all_wires: set = set()
    for op in list(ops) + list(obs):
        all_wires.update(op.wires)
    return max(all_wires) + 1 if all_wires else 1


def uses_density(tape: List[Operation], type: str) -> bool:
    """Density-matrix simulation is needed for type='density' (noise channels
    come with the density slice)."""
    return type == "density"


# ---------------------------------------------------------------------------
# Fusion planner
# ---------------------------------------------------------------------------


def _compose_window(
    group: List[Operation], lo: int, hi: int, dtype: torch.dtype, device
) -> Tuple[torch.Tensor, List[int]]:
    """Compose a run of gates into one matrix on the contiguous range [lo, hi).

    Each gate is applied to the columns of the growing unitary through the
    flat rank-3 contraction (the column index acts as ``w`` extra qubits).
    """
    w = hi - lo
    U = torch.eye(2**w, dtype=dtype, device=device).reshape(-1)
    for op in group:
        local = [wi - lo for wi in op.wires]
        U = kernels.apply_matrix_flat(U, op.matrix, local, 2 * w)
    return U.reshape(2**w, 2**w), list(range(lo, hi))


def plan_contractions(
    tape: List[Operation],
    max_width: Optional[int] = None,
    n_qubits: Optional[int] = None,
    *,
    dtype: torch.dtype = torch.complex64,
    device=None,
) -> List[Tuple[str, object, List[int]]]:
    """Greedy fusion of the tape into contiguous-window contraction steps.

    Gates merge while their combined wire span fits a contiguous window of
    at most ``max_width`` qubits; each flushed window becomes one
    ``(2**w, 2**w)`` matrix (complex *dtype*, on *device*) on ``[lo, hi)``.

    Returns steps ``("op", operation, wires)`` (applied through the
    operation's own method) and ``("mat", matrix, wires)`` (a fused window).
    """
    width = FUSE_MAX_WIDTH if max_width is None else max_width
    if n_qubits is not None and max_width is None:
        width = min(width, max(n_qubits - FUSE_MIN_EXCESS, 1))
        if n_qubits >= LARGE_STATE_MIN_N:
            width = max(width, LARGE_FUSE_WIDTH)

    steps: List[Tuple[str, object, List[int]]] = []
    # Open windows: [group, lo, hi, support_set], pairwise-disjoint supports
    # (so their emission order is free; ops stay ordered within a window).
    windows: List[list] = []

    def emit(group: List[Operation], lo: int, hi: int) -> None:
        if len(group) == 1:
            op = group[0]
            srt = sorted(op.wires)
            if srt == list(range(srt[0], srt[-1] + 1)) or isinstance(
                op, DiagonalQubitUnitary
            ):
                steps.append(("op", op, list(op.wires)))
                return
        mat, wires = _compose_window(group, lo, hi, dtype, device)
        steps.append(("mat", mat, wires))

    def flush(idxs: Optional[List[int]] = None) -> None:
        if idxs is None:
            idxs = list(range(len(windows)))
        for i in sorted(idxs, reverse=True):
            group, lo, hi, _ = windows.pop(i)
            emit(group, lo, hi)

    for op in tape:
        if isinstance(op, Barrier):
            continue
        if isinstance(op, Id) and op._matrix is Id._matrix:
            continue

        op_support = set(op.wires)
        op_lo, op_hi = min(op.wires), max(op.wires) + 1

        if width <= 1 or op_hi - op_lo > width:
            touching = [i for i, w in enumerate(windows) if w[3] & op_support]
            flush(touching)
            steps.append(("op", op, list(op.wires)))
            continue

        touching = [i for i, w in enumerate(windows) if w[3] & op_support]

        if len(touching) > 1:
            merged_lo = min(op_lo, *(windows[i][1] for i in touching))
            merged_hi = max(op_hi, *(windows[i][2] for i in touching))
            if merged_hi - merged_lo <= width:
                merged_group: List[Operation] = []
                merged_support: set = set()
                for i in touching:
                    merged_group.extend(windows[i][0])
                    merged_support |= windows[i][3]
                for i in sorted(touching, reverse=True):
                    windows.pop(i)
                merged_group.append(op)
                merged_support |= op_support
                windows.append([merged_group, merged_lo, merged_hi, merged_support])
            else:
                flush(touching)
                windows.append([[op], op_lo, op_hi, set(op_support)])
            continue

        if len(touching) == 1:
            i = touching[0]
            group, lo, hi, support = windows[i]
            new_lo, new_hi = min(lo, op_lo), max(hi, op_hi)
            if new_hi - new_lo <= width:
                group.append(op)
                windows[i] = [group, new_lo, new_hi, support | op_support]
            else:
                flush([i])
                windows.append([[op], op_lo, op_hi, set(op_support)])
            continue

        placed = False
        for i, (group, lo, hi, support) in enumerate(windows):
            new_lo, new_hi = min(lo, op_lo), max(hi, op_hi)
            if new_hi - new_lo <= width:
                group.append(op)
                windows[i] = [group, new_lo, new_hi, support | op_support]
                placed = True
                break
        if not placed:
            windows.append([[op], op_lo, op_hi, set(op_support)])

    flush()
    return steps


# ---------------------------------------------------------------------------
# Layout scheduling (qubit-rotation sharing, large-state regime only)
# ---------------------------------------------------------------------------


def _step_rot_cost(wires: List[int], offset: int, n: int) -> int:
    """Extra passes this support costs under cyclic layout *offset* (qubit q
    stored at position ``(q + offset) % n``).  The reference's TPU prices,
    kept unchanged so the two packages schedule alike."""
    srt = sorted((w + offset) % n for w in wires)
    k = len(srt)
    if srt == list(range(srt[0], srt[0] + k)):
        if srt[0] + k == n and 2**k <= 256:
            return 2
        if srt[0] + k > n - 7 and kernels._recenter_rotation(srt[0], k, n) is not None:
            return 6
        return 0
    if kernels._cyclic_run(srt, n) is not None:
        return 7
    return 30


# One explicit rotation step: 1 forward pass + 2 backward passes.
_ROT_STEP_COST = 3

# Price of a rotation that a fused (rotation, window) step would absorb.
_FUSED_ROT_COST = 1


def rot_fusable(r: int, k: int, n: int) -> bool:
    """Shape eligibility of a (rotation, window) fusion: the window exactly on
    the rotated-in wires (k == r) or on the rotation's minor axis
    (k == n - r), K in {256, 512}.  Reference: pallas_kernels.rot_fusable."""
    if k != r and k != n - r:
        return False
    return 2**k in (256, 512) and min(r, n - r) >= 7


def rot_prefix_fusable(r: int, k: int, n: int) -> bool:
    """Shape eligibility of (rotation r, window on [0, k)) with k >= r.
    Reference: pallas_kernels.rot_prefix_fusable."""
    if k == r:
        return rot_fusable(r, r, n)
    e = k - r
    return 1 <= e <= 2 and r >= 7 and 2**k <= 1024 and 2 ** (n - k) >= 128


def schedule_layout(
    steps: List[Tuple[str, object, List[int]]], n: int
) -> List[Tuple[str, object, List[int]]]:
    """Insert shared cyclic-rotation steps into a pure-state plan.

    The offset sequence is chosen exactly by dynamic programming over all
    ``n`` cyclic offsets with per-step costs from :func:`_step_rot_cost` and
    a price per explicit rotation.  The DP prices a rotation that a fused
    (rotation, window) step could absorb at ``_FUSED_ROT_COST`` whether or
    not ``FUSE_LAYOUT_ROT`` is on, as the reference does.

    Returns steps with kinds ``"rot"`` (payload = rotation amount), ``"mat"``
    and ``"diag"``, wires remapped to the active layout.
    """
    if n < 14:
        return steps

    norm: List[Tuple[str, object, List[int]]] = []
    for kind, payload, wires in steps:
        if kind in ("mat", "diag"):
            norm.append((kind, payload, wires))
            continue
        op = payload
        if isinstance(op, DiagonalQubitUnitary):
            norm.append(("diag", op.diag, list(op.wires)))
        elif op.__class__.apply_to_state_ri is not Operation.apply_to_state_ri:
            continue  # custom application == no-op (Id/Barrier)
        else:
            norm.append(("mat", op.matrix, list(op.wires)))

    S = len(norm)
    if S == 0:
        return []
    INF = 10**9
    cost = [
        [_step_rot_cost(w, off, n) if (k_ == "mat" and w) else 0 for off in range(n)]
        for (k_, _, w) in norm
    ]

    def _delta_ok(frm: int, to: int) -> bool:
        r = (to - frm) % n
        return 7 <= r <= n - 7

    span: List[Optional[Tuple[int, int]]] = []
    for k_, _, w in norm:
        ws = sorted(w)
        if k_ == "mat" and ws and ws == list(range(ws[0], ws[0] + len(ws))):
            span.append((ws[0], len(ws)))
        else:
            span.append(None)

    def _trans_cost(prev_off: int, off: int, i: int) -> int:
        r = (off - prev_off) % n
        if i < S and span[i] is not None:
            lo, k = span[i]
            if k >= r and (lo + off) % n == 0 and rot_prefix_fusable(r, k, n):
                return _FUSED_ROT_COST
        if i > 0 and span[i - 1] is not None:
            lo, k = span[i - 1]
            if k == n - r and (lo + prev_off) % n == 0 and rot_fusable(r, k, n):
                return _FUSED_ROT_COST
        return _ROT_STEP_COST

    dp = [
        (0 if off == 0 else (_trans_cost(0, off, 0) if _delta_ok(0, off) else INF))
        + cost[0][off]
        for off in range(n)
    ]
    parent: List[List[int]] = [[0] * n]
    for i in range(1, S):
        ndp = [INF] * n
        par = [0] * n
        for off in range(n):
            best_c, best_p = dp[off], off  # staying wins ties
            for p in range(n):
                if p == off or not _delta_ok(p, off):
                    continue
                c = dp[p] + _trans_cost(p, off, i)
                if c < best_c:
                    best_c, best_p = c, p
            ndp[off] = best_c + cost[i][off]
            par[off] = best_p
        dp = ndp
        parent.append(par)

    end = min(
        range(n),
        key=lambda o: (
            dp[o] + (0 if o == 0 else (_trans_cost(o, 0, S) if _delta_ok(o, 0) else INF)),
            o != 0,
            o,
        ),
    )
    offsets = [0] * S
    offsets[S - 1] = end
    for i in range(S - 1, 0, -1):
        offsets[i - 1] = parent[i][offsets[i]]

    out: List[Tuple[str, object, List[int]]] = []
    offset = 0
    for i, (kind, payload, wires) in enumerate(norm):
        if offsets[i] != offset:
            out.append(("rot", (offsets[i] - offset) % n, []))
            offset = offsets[i]
        out.append((kind, payload, [(w + offset) % n for w in wires]))
    if offset != 0:
        out.append(("rot", (n - offset) % n, []))
    out = refuse_windows(out, n)
    if FUSE_LAYOUT_ROT:
        out = fuse_layout_rotations(out, n)
    return out


def fuse_layout_rotations(
    steps: List[Tuple[str, object, List[int]]], n: int
) -> List[Tuple[str, object, List[int]]]:
    """Peephole fusion of layout rotations into adjacent window steps.

    ``("rot", r)`` then ``("mat", W, [0..k))`` with k >= r becomes one
    ``"rotmat"`` step (payload ``(r, W)``); ``("mat", W, [0..n-r))`` then
    ``("rot", r)`` becomes one ``"matrot"`` step.  Only used when
    ``FUSE_LAYOUT_ROT`` is on; the card has no kernel for these steps yet.
    """
    out: List[Tuple[str, object, List[int]]] = []
    i = 0
    while i < len(steps):
        kind, payload, wires = steps[i]
        if kind == "rot" and i + 1 < len(steps):
            r = int(payload)
            k2, p2, w2 = steps[i + 1]
            if (
                k2 == "mat"
                and list(w2) == list(range(0, len(w2)))
                and len(w2) >= r
                and rot_prefix_fusable(r, len(w2), n)
            ):
                out.append(("rotmat", (r, p2), list(w2)))
                i += 2
                continue
        if kind == "mat" and i + 1 < len(steps):
            k2, p2, _ = steps[i + 1]
            if k2 == "rot":
                r = int(p2)
                if list(wires) == list(range(0, n - r)) and rot_fusable(r, n - r, n):
                    out.append(("matrot", (r, payload), list(wires)))
                    i += 2
                    continue
        out.append(steps[i])
        i += 1
    return out


# Widest window the re-fusion pass may build (K = 1024).
REFUSE_MAX_WIDTH: int = 10


def _refusable_span(lo: int, span: int, n: int) -> bool:
    if span > REFUSE_MAX_WIDTH or 2**span > 1024:
        return False
    if lo + span == n:
        return 2**span <= 256
    return 2 ** (n - lo - span) >= 128


def refuse_windows(
    steps: List[Tuple[str, object, List[int]]], n: int
) -> List[Tuple[str, object, List[int]]]:
    """Post-layout window re-fusion.

    After :func:`schedule_layout` remaps wires, ring-wrap entanglers become
    contiguous neighbours of the layer windows; merging such neighbours
    removes a whole state pass per merge.  A step may hop backwards over
    steps with disjoint supports; rotations are barriers.
    """
    out: List[Tuple[str, object, List[int]]] = []
    for step in steps:
        kind, payload, wires = step
        if kind != "mat" or not wires:
            out.append(step)
            continue
        sup = set(wires)
        lo2, hi2 = min(wires), max(wires) + 1
        merged = False
        for j in range(len(out) - 1, -1, -1):
            kj, pj, wj = out[j]
            if kj == "rot":
                break
            if kj == "mat" and wj:
                lo = min(min(wj), lo2)
                hi = max(max(wj) + 1, hi2)
                if _refusable_span(lo, hi - lo, n):
                    span = hi - lo
                    U = torch.eye(2**span, dtype=pj.dtype, device=pj.device).reshape(-1)
                    U = kernels.apply_matrix_flat(U, pj, [w - lo for w in wj], 2 * span)
                    U = kernels.apply_matrix_flat(
                        U, payload, [w - lo for w in wires], 2 * span
                    )
                    out[j] = ("mat", U.reshape(2**span, 2**span), list(range(lo, hi)))
                    merged = True
                    break
            if set(wj) & sup:
                break
        if not merged:
            out.append(step)
    return out


# ---------------------------------------------------------------------------
# Simulation loop
# ---------------------------------------------------------------------------


def _zero_state_prefix(plan: list, n: int) -> Tuple[list, Optional[torch.Tensor]]:
    """Peel leading ``mat`` windows with pairwise-disjoint contiguous supports.

    Applied to the zero state each contributes only its first column, so the
    pre-loop state is an outer product of ``2**k``-sized vectors: the first
    full-state pass writes two planes instead of running one pass per
    window.  Returns ``(peeled_indices, psi2)`` or ``([], None)``.
    """
    factors = {}
    used: set = set()
    blocked: set = set()
    peeled: list = []
    for idx, (kind, payload, wires) in enumerate(plan):
        support = set(int(w) for w in wires)
        if kind == "mat":
            ws = sorted(support)
            lo, hi = ws[0], ws[-1] + 1
            if ws == list(range(lo, hi)) and not (support & used) and not (support & blocked):
                factors[lo] = (hi, payload)
                used |= support
                peeled.append(idx)
                continue
        blocked |= support
        if len(blocked) >= n:
            break
    if len(peeled) < 2:
        return [], None

    ref = factors[min(factors)][1]
    cols = []
    w = 0
    e0 = None
    while w < n:
        if w in factors:
            hi, mat = factors[w]
            cols.append(mat[:, 0])
            w = hi
        else:
            if e0 is None:
                e0 = torch.zeros(2, dtype=ref.dtype, device=ref.device)
                e0[0] = 1.0
            cols.append(e0)
            w += 1

    # Group the kron into (head, tail) so every complex intermediate stays far
    # below state size; the full-size product is written in real-split form.
    cap = 2 ** (n // 2)
    head = cols[0]
    i = 1
    while i < len(cols) and head.shape[0] * cols[i].shape[0] <= cap:
        head = torch.kron(head, cols[i])
        i += 1
    if i == len(cols):
        return peeled, torch.stack([head.real, head.imag]).contiguous()
    tail = cols[i]
    for c in cols[i + 1:]:
        tail = torch.kron(tail, c)
    hr, hi_ = head.real, head.imag
    tr, ti = tail.real, tail.imag
    pr = torch.outer(hr, tr) - torch.outer(hi_, ti)
    pi = torch.outer(hr, ti) + torch.outer(hi_, tr)
    return peeled, torch.stack([pr.reshape(-1), pi.reshape(-1)])


def _drop_indices(plan: list, indices: list) -> list:
    drop = set(indices)
    return [s for i, s in enumerate(plan) if i not in drop]


def scheduled_plan(
    tape: List[Operation], n_qubits: int, dtype: torch.dtype = torch.float32, device=None
) -> Tuple[list, Optional[torch.Tensor]]:
    """The plan :func:`simulate_pure_ri` runs, and its outer-product start
    (``None`` when it starts from |0...0>)."""
    plan = plan_contractions(tape, n_qubits=n_qubits, dtype=cdtype(dtype), device=device)
    if n_qubits < LARGE_STATE_MIN_N:
        return plan, None
    peeled, psi2 = _zero_state_prefix(plan, n_qubits)
    return schedule_layout(_drop_indices(plan, peeled), n_qubits), psi2


# Backward-pass strategy: "auto" keeps per-step residuals (the saved
# executor, 3 state passes per backward step) while they fit in device
# memory and sends gradients to the residual-free adjoint-state backward
# beyond that.  "adjoint" / "autodiff" force one side.  The adjoint backward
# is not ported yet: a gradient sent there raises NotImplementedError.
BACKWARD_MODE: str = "auto"

# Fraction of currently-available device memory the residual stack may
# occupy before "auto" switches to the adjoint backward.
_RESIDUAL_MEM_FRACTION: float = 0.35


def set_backward_mode(mode: str) -> None:
    """Select the gradient strategy: ``"auto"`` (default), ``"adjoint"``,
    or ``"autodiff"``."""
    global BACKWARD_MODE
    if mode not in ("auto", "adjoint", "autodiff"):
        raise ValueError(f"unknown backward mode: {mode!r}")
    BACKWARD_MODE = mode


def _adjoint_pays_off(plan: list, n_qubits: int, batch: int = 1, device=None) -> bool:
    """True when the adjoint-state backward should handle gradients."""
    if BACKWARD_MODE == "adjoint":
        return True
    if BACKWARD_MODE == "autodiff":
        return False
    # Residual stack: one (2, 2**n) float32 pair per plan step, per element
    # of the batch (the executor keeps every element's residuals alive until
    # the backward).
    residual_bytes = len(plan) * 8 * (2**n_qubits) * batch
    return residual_bytes > _RESIDUAL_MEM_FRACTION * memory.available_memory_bytes(device)


def _payload_tensors(kind: str, payload) -> list:
    if kind in ("mat", "diag"):
        return [payload]
    if kind in ("rotmat", "matrot"):
        return [payload[1]]
    if kind == "op" and payload._matrix is not None:
        return [payload._matrix]  # a diagonal op's matrix is built from its diagonal
    return []


def _needs_grad(plan: list, psi2: torch.Tensor) -> bool:
    """Whether autograd will ask for a gradient of this simulation."""
    if not torch.is_grad_enabled():
        return False
    return psi2.requires_grad or any(
        t.requires_grad for kind, payload, _ in plan for t in _payload_tensors(kind, payload)
    )


def simulate_pure_ri(
    tape: List[Operation], n_qubits: int, dtype: torch.dtype = torch.float32, device=None,
    batch: int = 1,
) -> torch.Tensor:
    """Real-split statevector simulation; returns the ``(2, 2**n)`` pair in
    real *dtype* on *device*.

    When autograd needs a gradient, the backward strategy is chosen here:
    the adjoint backward when ``_adjoint_pays_off`` (not ported: raises),
    else in the large-state regime the saved-residual executor
    (:mod:`~qml_essentials_tpu_torch.ops.saved`), else the per-step loop,
    whose kernels carry their own autograd backwards.  *batch* is the number
    of simulations whose residuals stay alive together (the executor's batch
    loop), for the memory estimate."""
    plan, psi2 = scheduled_plan(tape, n_qubits, dtype, device)
    if psi2 is None:
        psi2 = kernels.zero_state_ri(n_qubits, dtype, device)
    if _needs_grad(plan, psi2):
        if _adjoint_pays_off(plan, n_qubits, batch, psi2.device):
            raise NotImplementedError("the adjoint backward comes with its slice")
        if saved.ENABLED and saved.usable(n_qubits):
            static, payloads = adjoint.normalize_plan(plan, n_qubits)
            if payloads:
                return saved.execute_plan_saved_ri(psi2, payloads, static, n_qubits)
    for kind, payload, wires in plan:
        psi2 = _apply_step_ri(psi2, kind, payload, wires, n_qubits)
    return psi2


def _apply_step_ri(
    psi2: torch.Tensor, kind: str, payload, wires: List[int], n_qubits: int
) -> torch.Tensor:
    """Execute one scheduled plan step on a flat real-split state."""
    if kind == "mat":
        return kernels.apply_matrix_flat_ri(psi2, payload, wires, n_qubits)
    if kind == "rot":
        return kernels._rotate_qubits_ri(psi2, payload, n_qubits)
    if kind == "diag":
        return kernels.apply_diagonal_flat_ri(psi2, payload, wires, n_qubits)
    if kind in ("rotmat", "matrot"):
        if psi2.device.type != "cpu":
            raise NotImplementedError(
                f"plan step {kind!r}: its fused kernel is not ported yet "
                "(run with FUSE_LAYOUT_ROT = False)"
            )
        # Plain two-pass form on the CPU.
        r, mat = payload
        if kind == "rotmat":
            psi2 = kernels._rotate_qubits_ri(psi2, r, n_qubits)
            return kernels.apply_matrix_flat_ri(psi2, mat, wires, n_qubits)
        psi2 = kernels.apply_matrix_flat_ri(psi2, mat, wires, n_qubits)
        return kernels._rotate_qubits_ri(psi2, r, n_qubits)
    return payload.apply_to_state_ri(psi2, n_qubits)


def simulate_and_measure(
    tape: List[Operation],
    n_qubits: int,
    type: str,
    obs: List[Operation],
    use_density: bool = False,
    *,
    dtype: torch.dtype = torch.float32,
    device=None,
    batch: int = 1,
) -> torch.Tensor:
    """Simulate the tape and measure ``expval`` / ``probs`` / ``state``
    (density simulation and shot sampling are not ported yet).  *batch*: see
    :func:`simulate_pure_ri`."""
    if use_density:
        raise NotImplementedError("density simulation comes with the density slice")
    psi2 = simulate_pure_ri(tape, n_qubits, dtype, device, batch)
    return measure_state_ri(psi2, n_qubits, type, obs)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _diagonal_real(obs: Operation) -> Optional[np.ndarray]:
    """Concrete real diagonal of an observable if it is Z-type, else None."""
    label = getattr(obs, "_pauli_label", None)
    if label is not None and set(label) <= {"I", "Z"}:
        diag = np.ones(1)
        for ch in label:
            diag = np.kron(diag, np.array([1.0, 1.0]) if ch == "I" else np.array([1.0, -1.0]))
        return diag
    m = obs._matrix
    if m is None:
        return None
    m_np = m.detach().cpu().numpy()
    if m_np.shape[0] != 2 ** len(obs.wires):
        return None
    if np.allclose(m_np, np.diag(np.diag(m_np))) and np.allclose(np.imag(np.diag(m_np)), 0.0):
        return np.real(np.diag(m_np))
    return None


def _expval_from_probs(
    probs: torch.Tensor, n_qubits: int, obs: List[Operation], diags: List[np.ndarray]
) -> torch.Tensor:
    """Expectation values of diagonal observables from the probability vector.

    Per-qubit-factorisable observables use the halving fold; with several
    observables each inside one half of the register, two reductions to the
    half-register marginals replace one fold of the full vector per
    observable.  Other diagonal observables marginalise onto their support.
    """
    h = (n_qubits + 1) // 2
    low = n_qubits - h
    row_marg = col_marg = None
    use_halves = n_qubits >= 8 and len(obs) >= 2

    results = []
    for ob, d in zip(obs, diags):
        wires = list(ob.wires)
        label = getattr(ob, "_pauli_label", None)

        weights: List = [None] * n_qubits
        factorised = False
        if len(wires) == 1:
            weights[wires[0]] = (float(d[0]), float(d[1]))
            factorised = True
        elif label is not None and set(label) <= {"I", "Z"}:
            for ch, w in zip(label, wires):
                weights[w] = (1.0, -1.0) if ch == "Z" else (1.0, 1.0)
            factorised = True

        if factorised:
            if use_halves and wires and max(wires) < h:
                if row_marg is None:
                    row_marg = probs.reshape(2**h, 2**low).sum(dim=1)
                results.append(kernels.reduce_diagonal_expectation(row_marg, weights[:h]))
            elif use_halves and wires and min(wires) >= h:
                if col_marg is None:
                    col_marg = probs.reshape(2**h, 2**low).sum(dim=0)
                results.append(kernels.reduce_diagonal_expectation(col_marg, weights[h:]))
            else:
                results.append(kernels.reduce_diagonal_expectation(probs, weights))
            continue

        srt = sorted(wires)
        marg = kernels.marginal_probs_on(probs, srt, n_qubits)
        k = len(wires)
        order = [wires.index(w) for w in srt]
        d_sorted = np.transpose(np.asarray(d).reshape((2,) * k), order).reshape(-1)
        results.append(marg @ torch.as_tensor(d_sorted, dtype=marg.dtype, device=marg.device))
    return torch.stack(results)


def measure_state(
    state: torch.Tensor, n_qubits: int, type: str, obs: List[Operation]
) -> torch.Tensor:
    """Measure a complex statevector: ``state`` / ``probs`` / ``expval``."""
    if type == "state":
        return state
    if type == "probs":
        return state.abs() ** 2
    if type == "expval":
        diags = [_diagonal_real(ob) for ob in obs]
        if obs and all(d is not None for d in diags):
            return _expval_from_probs(state.abs() ** 2, n_qubits, obs, diags)
        obs_mats = torch.stack(
            [ob.lifted_matrix(n_qubits).to(device=state.device, dtype=state.dtype) for ob in obs]
        )
        O_states = torch.einsum("oij,j->oi", obs_mats, state)
        return torch.einsum("i,oi->o", state.conj(), O_states).real
    raise ValueError(f"Unknown measurement type: {type!r}")


def measure_state_ri(
    psi2: torch.Tensor, n_qubits: int, type: str, obs: List[Operation]
) -> torch.Tensor:
    """Measure a real-split pure state; complex only at the boundary."""
    if type == "state":
        return kernels.from_ri(psi2)
    probs = psi2[0] ** 2 + psi2[1] ** 2
    if type == "probs":
        return probs
    if type == "expval":
        diags = [_diagonal_real(ob) for ob in obs]
        if obs and all(d is not None for d in diags):
            return _expval_from_probs(probs, n_qubits, obs, diags)
        return measure_state(kernels.from_ri(psi2), n_qubits, type, obs)
    raise ValueError(f"Unknown measurement type: {type!r}")

