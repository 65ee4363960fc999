"""Statevector and density simulation, measurement and shot sampling.

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
programming so ring-wrap entanglers become contiguous,
:func:`refuse_windows` merges neighbouring windows up to 10 qubits, and
:func:`fuse_layout_rotations` folds rotations into adjacent windows.  Each
resulting step is one pass of a hand-written kernel on the flat real-split
``(2, 2**n)`` state.  The planner is the JAX package's, step for step —
including the DP's prices, which were set on the TPU — so both packages run
the same plan for the same tape.

*Diagonal observables.*  Z-type expectation values fold the probability
vector (:func:`_expval_from_probs`); no dense observable is built.

*Gradients.*  :func:`simulate_pure_ri` chooses the backward: the
adjoint-state backward (:mod:`~qml_essentials_tpu_torch.ops.adjoint`, the
final state as its only residual) when the residuals would not fit in memory
or ``BACKWARD_MODE = "adjoint"``, at any width; else the saved-residual
executor (:mod:`~qml_essentials_tpu_torch.ops.saved`) in the large-state
regime, and the kernels' own autograd backwards below it.  A batch takes one
decision for all its elements (:class:`BackwardChoice`).

*Density.*  A noisy n-qubit tape (Kraus channels) runs as a pure state of
2n doubled wires.  The preferred engine lowers it to the **interleaved**
layout (:func:`_lower_interleaved_tape`: data wire w owns doubled wires 2w,
ket, and 2w+1, bra; a gate U becomes U ⊗ conj(U), a channel its
superoperator Σ K ⊗ conj(K)), so every operator is contiguous and the tape
runs the statevector planner, scheduler and kernels
(:func:`_simulate_interleaved_ri`) — never the chain plan, and never the
adjoint backward (a superoperator is not undone by its dagger): a gradient
takes the saved executor.  A tape with no contiguous doubled form (a channel
on more than 3 wires) runs the ket-then-bra engine
(:func:`simulate_mixed_ri`: ket wires 0..n-1, bra wires n..2n-1).  A
noise-free tape asked for ``"density"`` runs the statevector and takes one
outer product.  The readout reads the interleaved diagonal with one gather
(:func:`_pair_diag`) and de-interleaves the full matrix only for
``"density"`` and non-diagonal observables.

*Shots.*  :func:`sample_shots` draws from the exact probabilities with
``torch.multinomial`` on an explicit ``torch.Generator`` on their device.

*Batches and the plan cache.*  The planner computes every payload through
:func:`~qml_essentials_tpu_torch.ops.recipes.lazy`, so planning a tape's
proxy yields a skeleton that a :class:`PlanSlot` keeps and materializes
against each tape recorded with the same structure.  A batched tape (gate
matrices ``(Bt, K, K)``) runs vectorised below the large-state regime: one
kernel launch per step on the ``(2, Bt, 2**n)`` state; from it (or when its
gradient goes to the adjoint executor) its elements run one by one on the
rows of the plan's payloads, composed once for the chunk (:func:`batch_route`,
:meth:`PlanSlot.each`).

Counterpart of ``qml_essentials_tpu/ops/simulation.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.core import memory
from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from qml_essentials_tpu_torch.ops import adjoint, chains, cuda_kernels, kernels, recipes, saved
from qml_essentials_tpu_torch.ops.dtypes import DEFAULT_RDTYPE, cdtype
from qml_essentials_tpu_torch.ops.recipes import lazy
from qml_essentials_tpu_torch.ops.operations import (
    Barrier,
    DiagonalQubitUnitary,
    Id,
    KrausChannel,
    Operation,
)
from qml_essentials_tpu_torch.utils import profiling, safe_random_split

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

# Fuse (rotation, window) pairs into single-pass "rotmat"/"matrot" steps
# (the rotmat, rotwin and matrot kernels), as the reference does by default.
FUSE_LAYOUT_ROT: bool = True

# Prefer chain plans (:mod:`~qml_essentials_tpu_torch.ops.chains`: one
# kernel launch per whole-region gate group) over the scheduled window plan
# in the large-state regime, when the tape allows one.  Off by default, as in
# the reference, where it was measured slower than the scheduled plan.
USE_CHAINS: bool = False


def set_fusion(max_width: int, min_excess: Optional[int] = None) -> None:
    """Set the gate-fusion window width (0/1 disables) and n-vs-w threshold."""
    global FUSE_MAX_WIDTH, FUSE_MIN_EXCESS
    FUSE_MAX_WIDTH = int(max_width)
    if min_excess is not None:
        FUSE_MIN_EXCESS = int(min_excess)


def infer_n_qubits(ops: List[Operation], obs: List[Operation]) -> int:
    """Smallest qubit count covering all wires of *ops* and *obs* (min 1)."""
    all_wires: set = set()
    for op in list(ops) + list(obs):
        all_wires.update(op.wires)
    return max(all_wires) + 1 if all_wires else 1


def uses_density(tape: List[Operation], type: str) -> bool:
    """Density-matrix simulation is needed for noise channels or type='density'."""
    return type == "density" or any(isinstance(op, KrausChannel) for op in tape)


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
    mats = [op.matrix for op in group]
    local = [[wi - lo for wi in op.wires] for op in group]
    return lazy(_compose, mats, local, w, dtype, device), list(range(lo, hi))


def _compose(mats: List[torch.Tensor], local: List[List[int]], w: int, dtype, device
             ) -> torch.Tensor:
    """The product of *mats* on their *local* wires of a ``w``-qubit window
    (per element of a batch when a matrix is batched)."""
    U = torch.eye(2**w, dtype=dtype, device=device).reshape(-1)
    for m, wires in zip(mats, local):
        U = kernels.apply_matrix_flat(U, m, wires, 2 * w)
    return U.reshape(U.shape[:-1] + (2**w, 2**w))


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
    operation's own method; every Kraus channel is one, and flushes the open
    windows) and ``("mat", matrix, wires)`` (a fused window).
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
        if isinstance(op, KrausChannel):
            flush()
            steps.append(("op", op, list(op.wires)))
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
        if isinstance(op, KrausChannel):
            return steps  # channels never reach the pure-state path
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
    ``FUSE_LAYOUT_ROT`` is on.  The shape rules (:func:`rot_fusable`,
    :func:`rot_prefix_fusable`) are the reference's TPU ones, kept for plan
    parity; the kernels take any shape.
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


def _merge_windows(pj: torch.Tensor, wj: List[int], payload: torch.Tensor,
                   wires: List[int], span: int) -> torch.Tensor:
    """Window *pj* on local wires *wj*, then *payload* on *wires*, composed
    into one ``span``-qubit window."""
    return _compose([pj, payload], [wj, wires], span, pj.dtype, pj.device)


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
                    U = lazy(_merge_windows, pj, [w - lo for w in wj], payload,
                             [w - lo for w in wires], span)
                    out[j] = ("mat", U, list(range(lo, hi)))
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

    layout = []  # each factor's first wire, or None for a |0> wire
    mats = []
    w = 0
    while w < n:
        if w in factors:
            hi, mat = factors[w]
            layout.append(w)
            mats.append(mat)
            w = hi
        else:
            layout.append(None)
            w += 1
    return peeled, recipes.per_element(_outer_start, mats, layout, n)


def _outer_start(mats: List[torch.Tensor], layout: list, n: int) -> torch.Tensor:
    """The outer-product start of :func:`_zero_state_prefix`: each peeled
    window's first column (``layout`` entries not None, in order) or |0>
    (``None``), kron'ed into the ``(2, 2**n)`` pair."""
    ref = mats[0]
    it = iter(mats)
    cols = []
    e0 = None
    for item in layout:
        if item is not None:
            cols.append(next(it)[:, 0])
        else:
            if e0 is None:
                e0 = torch.zeros(2, dtype=ref.dtype, device=ref.device)
                e0[0] = 1.0
            cols.append(e0)

    # Group the kron into (head, tail) so every complex intermediate stays far
    # below state size; the full-size product is written in real-split form.
    cap = 2 ** (n // 2)
    head = cols[0]
    i = 1
    while i < len(cols) and head.shape[0] * cols[i].shape[0] <= cap:
        head = torch.kron(head, cols[i])
        i += 1
    if i == len(cols):
        return torch.stack([head.real, head.imag]).contiguous()
    tail = cols[i]
    for c in cols[i + 1:]:
        tail = torch.kron(tail, c)
    hr, hi_ = head.real, head.imag
    tr, ti = tail.real, tail.imag
    pr = torch.outer(hr, tr) - torch.outer(hi_, ti)
    pi = torch.outer(hr, ti) + torch.outer(hi_, tr)
    return torch.stack([pr.reshape(-1), pi.reshape(-1)])


def _drop_indices(plan: list, indices: list) -> list:
    drop = set(indices)
    return [s for i, s in enumerate(plan) if i not in drop]


def scheduled_plan(
    tape: List[Operation], n_qubits: int, dtype: torch.dtype = torch.float32, device=None
) -> Tuple[list, Optional[torch.Tensor]]:
    """The plan :func:`simulate_pure_ri` runs, and its outer-product start
    (``None`` when it starts from |0...0>).

    In the large-state regime with ``USE_CHAINS`` on, the chain plan replaces
    the scheduled one when it has steps and fewer of them than the
    unscheduled window plan; it starts from |0...0>."""
    plan = plan_contractions(tape, n_qubits=n_qubits, dtype=cdtype(dtype), device=device)
    if USE_CHAINS and n_qubits >= LARGE_STATE_MIN_N:
        cplan = chains.plan_chains(tape, n_qubits, cdtype(dtype), device)
        if cplan is not None and 0 < len(cplan) < len(plan):
            return cplan, None
    return _scheduled(plan, n_qubits)


def _scheduled(plan: list, n: int) -> Tuple[list, Optional[torch.Tensor]]:
    """A window plan as it runs: in the large-state regime, its outer-product
    start peeled off and the rest layout-scheduled."""
    if n < LARGE_STATE_MIN_N:
        return plan, None
    peeled, psi2 = _zero_state_prefix(plan, n)
    return schedule_layout(_drop_indices(plan, peeled), n), psi2


# Backward-pass strategy: "auto" keeps per-step residuals (the saved
# executor, 3 state passes per backward step) while they fit in device
# memory and sends gradients to the residual-free adjoint-state backward
# (4 state passes per step, the final state as its only residual) beyond
# that.  "adjoint" / "autodiff" force one side.
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


def _adjoint_pays_off(plan: list, n_qubits: int, batch: int = 1, device=None,
                      free: Optional[int] = None) -> bool:
    """True when the adjoint-state backward should handle gradients."""
    if BACKWARD_MODE == "adjoint":
        return True
    if BACKWARD_MODE == "autodiff":
        return False
    # Residual stack: one (2, 2**n) float32 pair per plan step, per element
    # of the batch (the executor keeps every element's residuals alive until
    # the backward).
    residual_bytes = len(plan) * 8 * (2**n_qubits) * batch
    if free is None:
        free = memory.available_memory_bytes(device)
    return residual_bytes > _RESIDUAL_MEM_FRACTION * free


class BackwardChoice:
    """One backward decision for the elements of a batch.

    The first element that needs a gradient decides with
    :func:`_adjoint_pays_off` (its plan, the whole batch's residuals, the
    memory free before any of them is held); every later element takes the
    same executor without reading free memory again (the JAX package decides
    once per vmapped trace).  *free*: the bytes free before the batch when
    the caller has read them already (the executor's chunk sizing), so the
    batch reads free memory once."""

    def __init__(self, free: Optional[int] = None) -> None:
        self.adjoint: Optional[bool] = None
        self.free = free

    def use_adjoint(self, plan: list, n_qubits: int, batch: int, device) -> bool:
        if self.adjoint is None:
            self.adjoint = _adjoint_pays_off(plan, n_qubits, batch, device, self.free)
        return self.adjoint


def _payload_tensors(kind: str, payload) -> list:
    if kind in ("mat", "diag"):
        return [payload]
    if kind == "chain":
        return list(payload[2])
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


class PlanSlot:
    """The plan skeletons of one tape structure, by engine (``"pure"``,
    ``"interleaved"``, ``"mixed"``): an entry of the executor's plan cache
    (:class:`~qml_essentials_tpu_torch.core.executor.Script`), or a
    throwaway one for a direct call.  A skeleton is built once, by the
    planner on the tape's proxy (:func:`~qml_essentials_tpu_torch.ops.recipes.proxy_tape`),
    and materialized against every tape recorded for it."""

    def __init__(self) -> None:
        self.skeletons: Dict[str, object] = {}

    def skeleton(self, kind: str, build, tape: List[Operation]):
        if kind not in self.skeletons:
            with profiling.span("plan.build"):
                self.skeletons[kind] = build(recipes.proxy_tape(tape))
        return self.skeletons[kind]

    def get(self, kind: str, build, tape: List[Operation], rows=None):
        """The engine's plan for *tape* (its rows *rows* of a batch): a
        ``plan.materialize`` span under a profiler."""
        with profiling.span("plan.materialize"):
            return recipes.materialize(self.skeleton(kind, build, tape), tape, rows)

    def each(self, kind: str, build, tape: List[Operation], rows=None) -> recipes.RowPlans:
        """The engine's plans for the elements of *rows* of a batched tape,
        composed once for them (:class:`~qml_essentials_tpu_torch.ops.recipes.RowPlans`):
        one ``plan.materialize`` span under a profiler."""
        with profiling.span("plan.materialize"):
            return recipes.RowPlans(self.skeleton(kind, build, tape), tape, rows)


def _elements(tape: List[Operation], rows) -> Optional[int]:
    """Batch size of the state that simulating *rows* of *tape* runs: None
    for a tape with no batched gate or a single row (an int)."""
    full = recipes.batch_of(tape)
    if full is None or isinstance(rows, int):
        return None
    return len(range(full)[rows]) if rows is not None else full


def _pure_build(n_qubits: int, dtype, device):
    return lambda t: scheduled_plan(t, n_qubits, dtype, device)


def simulate_pure_ri(
    tape: List[Operation], n_qubits: int, dtype: torch.dtype = torch.float32, device=None,
    batch: int = 1, choice: Optional[BackwardChoice] = None,
    plans: Optional[PlanSlot] = None, rows=None,
) -> torch.Tensor:
    """Real-split statevector simulation; returns the ``(2, 2**n)`` pair in
    real *dtype* on *device*, or ``(2, Bt, 2**n)`` for a batched tape (its
    gates' matrices with a leading batch dimension), which runs every step
    once for the whole batch.

    When autograd needs a gradient, the backward strategy is chosen here:
    the adjoint-state executor (:mod:`~qml_essentials_tpu_torch.ops.adjoint`)
    when ``_adjoint_pays_off``, else in the large-state regime the
    saved-residual executor (:mod:`~qml_essentials_tpu_torch.ops.saved`;
    it refuses chain plans), else the per-step loop, whose kernels carry
    their own autograd backwards.  *batch* is the number of simulations whose residuals stay
    alive together (the executor's batch), for the memory estimate;
    *choice* carries one decision across the elements of that batch (a new
    one is made for a single simulation).  *plans*: the plan slot (a
    throwaway one when None); *rows*: the element (int) or chunk (slice) of
    a batched tape to simulate."""
    slot = PlanSlot() if plans is None else plans
    plan, psi2 = slot.get("pure", _pure_build(n_qubits, dtype, device), tape, rows)
    return _run_pure(plan, psi2, n_qubits, dtype, device, batch, choice, _elements(tape, rows))


def simulate_pure(tape: List[Operation], n_qubits: int, dtype: torch.dtype = DEFAULT_RDTYPE,
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Statevector simulation from |0...0>; returns the complex ``(2**n,)``
    (``(Bt, 2**n)`` for a batched tape).  The same plan and kernels as
    :func:`simulate_pure_ri`, in the real *dtype* (float32 unless the caller
    asks for float64) on *device* (the card unless the caller asks for the
    CPU)."""
    return kernels.from_ri(simulate_pure_ri(tape, n_qubits, dtype, resolve_device(device)))


def _run_pure(plan: list, psi2: Optional[torch.Tensor], n_qubits: int, dtype, device,
              batch: int, choice: Optional[BackwardChoice], elements: Optional[int]
              ) -> torch.Tensor:
    if psi2 is None:
        psi2 = kernels.zero_state_ri(n_qubits, dtype, device, elements)
    if _needs_grad(plan, psi2):
        choice = BackwardChoice() if choice is None else choice
        if choice.use_adjoint(plan, n_qubits, batch, psi2.device):
            if not adjoint.ENABLED:
                raise RuntimeError(
                    "this gradient goes to the adjoint backward, which is disabled "
                    "(adjoint.set_adjoint(False)); set_backward_mode('autodiff') keeps "
                    "residuals instead"
                )
            if elements is not None:
                raise RuntimeError("the adjoint backward runs one element at a time")
            static, payloads = adjoint.normalize_plan(plan, n_qubits)
            if payloads:
                return adjoint.execute_plan_ri(psi2, payloads, static, n_qubits)
        elif saved.ENABLED and saved.usable(plan, n_qubits):
            if elements is not None:
                raise RuntimeError("the saved executor runs one element at a time")
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
        # One fused kernel: rotmat (window on the rotated-in wires), rotwin
        # (a wider window from 0), or matrot (window, then the rotation).
        r, mat = payload
        return kernels.apply_fused_pair_ri(
            psi2, kernels._pair_of(mat, psi2), kind, r, len(wires), n_qubits)
    if kind == "chain":
        return _apply_chain_ri(psi2, *payload, n_qubits)
    return payload.apply_to_state_ri(psi2, n_qubits)


def _apply_chain_ri(psi2: torch.Tensor, geom: tuple, descs: tuple, pays: tuple,
                    n_qubits: int) -> torch.Tensor:
    """A chain step: one ``chain_apply`` launch when no gradient flows
    through it; else its windows and diagonals one by one through their
    autograd Functions (the reference's expansion loop)."""
    if not (torch.is_grad_enabled()
            and (psi2.requires_grad or any(p.requires_grad for p in pays))):
        pairs = [kernels._pair_of(p, psi2, vector=p.dim() == 1).contiguous() for p in pays]
        return cuda_kernels.chain_apply(psi2, pairs, geom, descs, n_qubits)
    for (kind, wires), p in zip(chains.expand_chain_step(geom, descs, n_qubits), pays):
        if kind == "mat":
            psi2 = kernels.apply_matrix_flat_ri(psi2, p, list(wires), n_qubits)
        else:
            psi2 = kernels.apply_diagonal_flat_ri(psi2, p, list(wires), n_qubits)
    return psi2


# ---------------------------------------------------------------------------
# Density simulation: the ket-then-bra engine
# ---------------------------------------------------------------------------

# Widest channel (in data qubits) lowered to a one-pass superoperator on the
# doubled register (4**3 = 64-dim matrices).
_SUPEROP_MAX_WIRES: int = 3


def _channel_superop(op: KrausChannel) -> Optional[Tuple[torch.Tensor, List[int]]]:
    """``(Σ_k K ⊗ conj(K), wires)`` of a Kraus channel, or None when it is
    wider than ``_SUPEROP_MAX_WIRES``: ``vec(Σ K ρ K†) = (Σ K ⊗ conj(K))
    vec(ρ)`` with the ket wires before the bra wires."""
    if len(op.wires) > _SUPEROP_MAX_WIRES:
        return None
    s = None
    for K in op.kraus_matrices():
        term = torch.kron(K, torch.conj_physical(K))
        s = term if s is None else s + term
    return s, list(op.wires)


def _double_plan(
    plan: List[Tuple[str, object, List[int]]], n: int, large: bool
) -> List[Tuple[str, object, List[int]]]:
    """Map an n-qubit contraction plan onto the 2n-qubit doubled register in
    ket-then-bra wire order (ket wires 0..n-1, bra wires n..2n-1).

    A window becomes its ket application and its conjugate bra twin, a
    diagonal likewise.  A channel becomes one superoperator on its ket and
    bra wires below the large-state regime; in it (wires n apart) it keeps
    its own density application (``"dens_op"``), as do the no-op gates."""
    out: List[Tuple[str, object, List[int]]] = []
    for kind, payload, wires in plan:
        if kind == "mat":
            out.append(("mat", payload, list(wires)))
            out.append(("mat", lazy(torch.conj_physical, payload), [w + n for w in wires]))
            continue
        op = payload
        if isinstance(op, KrausChannel):
            lowered = None if large else _channel_superop(op)
            if lowered is None:
                out.append(("dens_op", op, list(wires)))
            else:
                s, kw = lowered
                out.append(("mat", s, kw + [w + n for w in kw]))
        elif isinstance(op, DiagonalQubitUnitary):
            out.append(("diag", op.diag, list(op.wires)))
            out.append(("diag", lazy(torch.conj_physical, op.diag), [w + n for w in op.wires]))
        elif op.__class__.apply_to_state_ri is not Operation.apply_to_state_ri:
            out.append(("dens_op", op, list(wires)))
        else:
            m = op.matrix
            out.append(("mat", m, list(wires)))
            out.append(("mat", lazy(torch.conj_physical, m), [w + n for w in wires]))
    return out


def _schedule_density_segments(
    plan: List[Tuple[str, object, List[int]]], n2: int
) -> List[Tuple[str, object, List[int]]]:
    """Layout-schedule the unitary stretches of a doubled plan; the
    ``dens_op`` steps between them address physical wires, and each stretch
    ends at offset 0 (:func:`schedule_layout`)."""
    out: List[Tuple[str, object, List[int]]] = []
    seg: List[Tuple[str, object, List[int]]] = []
    for step in plan:
        if step[0] == "dens_op":
            out.extend(schedule_layout(seg, n2))
            out.append(step)
            seg = []
        else:
            seg.append(step)
    out.extend(schedule_layout(seg, n2))
    return out


def mixed_plan(
    tape: List[Operation], n_qubits: int, dtype: torch.dtype = torch.float32, device=None
) -> list:
    """The doubled plan :func:`simulate_mixed_ri` runs (ket wires 0..n-1,
    bra wires n..2n-1): the tape's window plan doubled
    (:func:`_double_plan`); in the large-state regime its windows span one
    side of the register (at most ``LARGE_FUSE_WIDTH`` data qubits) and each
    stretch between channels is layout-scheduled."""
    n2 = 2 * n_qubits
    large = n2 >= LARGE_STATE_MIN_N
    cd = cdtype(dtype)
    if large:
        base = plan_contractions(tape, max_width=min(n_qubits, LARGE_FUSE_WIDTH),
                                 dtype=cd, device=device)
    else:
        base = plan_contractions(tape, n_qubits=n_qubits, dtype=cd, device=device)
    plan = _double_plan(base, n_qubits, large)
    if large:
        plan = _schedule_density_segments(plan, n2)
    return plan


def simulate_mixed_ri(
    tape: List[Operation], n_qubits: int, dtype: torch.dtype = torch.float32, device=None,
    plans: Optional[PlanSlot] = None, rows=None,
) -> torch.Tensor:
    """Ket-then-bra density simulation from |0><0|; returns the ``(2, 4**n)``
    pair (row index = ket bits, column index = bra bits), ``(2, Bt, 4**n)``
    for a batched tape.

    The plan (:func:`mixed_plan`) runs through the same kernels as the
    statevector path, one step at a time; every channel applies its Kraus
    operators in turn.  The interleaved engine is preferred; this one takes
    what it cannot lower.
    """
    slot = PlanSlot() if plans is None else plans
    plan = slot.get("mixed", _mixed_build(n_qubits, dtype, device), tape, rows)
    return _run_mixed(plan, n_qubits, dtype, device, _elements(tape, rows))


def _mixed_build(n_qubits: int, dtype, device):
    return lambda t: mixed_plan(t, n_qubits, dtype, device)


def _run_mixed(plan: list, n_qubits: int, dtype, device, elements: Optional[int]
               ) -> torch.Tensor:
    n2 = 2 * n_qubits
    rho2 = kernels.zero_density_ri(n_qubits, dtype, device, elements)
    for kind, payload, wires in plan:
        if kind == "dens_op":
            rho2 = payload.apply_to_density_ri(rho2, n_qubits)
        else:
            rho2 = _apply_step_ri(rho2, kind, payload, wires, n2)
    return rho2


def simulate_mixed(tape: List[Operation], n_qubits: int, dtype: torch.dtype = DEFAULT_RDTYPE,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
    """Density-matrix simulation from |0><0| on the ket-then-bra engine
    (:func:`simulate_mixed_ri`); returns the complex ``(2**n, 2**n)``
    matrix (``(Bt, 2**n, 2**n)`` for a batched tape), in the real *dtype*
    on *device*, as :func:`simulate_pure`."""
    dim = 2**n_qubits
    rho2 = simulate_mixed_ri(tape, n_qubits, dtype, resolve_device(device))
    return kernels.from_ri(rho2).reshape(rho2.shape[1:-1] + (dim, dim))


# ---------------------------------------------------------------------------
# Density simulation: the interleaved engine
# ---------------------------------------------------------------------------

# Widest data-gate support doubled into a dense U ⊗ conj(U) window (5 wires:
# a 1024-dim operator, the re-fusion ceiling).
_DOUBLE_MAX_WIRES: int = 5
# Widest diagonal gate doubled into an interleaved diagonal (4**m entries).
_DOUBLE_DIAG_MAX_WIRES: int = 8


def _interleaved_wires(wires: Sequence[int]) -> List[int]:
    """Doubled wires of a data-wire support under the interleaved layout:
    the ket wires, then the bra wires (the operator's qubit order)."""
    return [2 * w for w in wires] + [2 * w + 1 for w in wires]


def _interleave_diag(d: torch.Tensor, m: int) -> torch.Tensor:
    """``d ⊗ conj(d)`` with its bits shuffled to (k0, b0, k1, b1, ...), per
    element of a batched ``(Bt, 2**m)`` diagonal."""
    lead = tuple(d.shape[:-1])
    o = len(lead)
    dd = kernels.bouter(d, torch.conj_physical(d)).reshape(lead + (2,) * (2 * m))
    order = [o + ax for i in range(m) for ax in (i, m + i)]
    return dd.permute(*range(o), *order).reshape(lead + (-1,))


def _doubled(u: torch.Tensor) -> torch.Tensor:
    """``U ⊗ conj(U)`` (per element of a batched gate)."""
    return kernels.bkron(u, torch.conj_physical(u))


def _lower_interleaved_tape(
    tape: List[Operation], n_qubits: int
) -> Optional[List[Operation]]:
    """Lower an n-qubit tape to a 2n-qubit pure-state tape in the
    interleaved layout, or ``None`` when an operation has no contiguous
    doubled form (a channel wider than ``_SUPEROP_MAX_WIRES``, a gate wider
    than ``_DOUBLE_MAX_WIRES``, a wide or scattered diagonal, a gate with
    its own application): callers then take the ket-then-bra engine."""
    out: List[Operation] = []
    for op in tape:
        if isinstance(op, Barrier) or (isinstance(op, Id) and op._matrix is Id._matrix):
            continue
        m = len(op.wires)
        if isinstance(op, KrausChannel):
            lowered = _channel_superop(op)
            if lowered is None:
                return None
            s, kw = lowered
            out.append(Operation(wires=_interleaved_wires(kw), matrix=s, record=False,
                                 name=f"S[{op.name}]"))
            continue
        if isinstance(op, DiagonalQubitUnitary):
            ws = sorted(op.wires)
            if m > _DOUBLE_DIAG_MAX_WIRES or ws != list(range(ws[0], ws[0] + m)):
                return None
            # Diagonal entries follow sorted wire order by construction.
            d = lazy(_interleave_diag, op.diag, m)
            out.append(recipes.derived(DiagonalQubitUnitary, "DiagU",
                                       list(range(2 * ws[0], 2 * (ws[0] + m))),
                                       _matrix=lazy(torch.diag_embed, d), diag=d))
            continue
        if op.__class__.apply_to_state_ri is not Operation.apply_to_state_ri:
            return None
        if m > _DOUBLE_MAX_WIRES:
            return None
        out.append(recipes.derived(Operation, f"D[{op.name}]", _interleaved_wires(op.wires),
                                   _matrix=lazy(_doubled, op.matrix)))
    return out


def interleaved_plan(
    dtape: List[Operation], n2: int, dtype: torch.dtype = torch.float32, device=None
) -> Tuple[list, Optional[torch.Tensor]]:
    """The plan :func:`_simulate_interleaved_ri` runs for a lowered tape on
    ``n2`` doubled wires, and its outer-product start (``None``: |0...0>):
    :func:`plan_contractions`, then in the large-state regime
    :func:`_zero_state_prefix` and :func:`schedule_layout`.  Never a chain
    plan, whatever ``USE_CHAINS`` says."""
    plan = plan_contractions(dtape, n_qubits=n2, dtype=cdtype(dtype), device=device)
    return _scheduled(plan, n2)


def _interleaved_build(n_qubits: int, dtype, device):
    """Planner of the interleaved engine: the lowered tape's plan, or None
    when the tape has no interleaved form."""
    def build(t):
        dtape = _lower_interleaved_tape(t, n_qubits)
        return None if dtape is None else interleaved_plan(dtape, 2 * n_qubits, dtype, device)
    return build


def _simulate_interleaved_ri(
    dtape: List[Operation], n2: int, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Pure-state simulation of a lowered doubled tape; returns the
    interleaved ``(2, 2**n2)`` density pair."""
    plan, psi2 = interleaved_plan(dtape, n2, dtype, device)
    return _run_interleaved(plan, psi2, n2, dtype, device, _elements(dtape, None))


def _run_interleaved(plan: list, psi2: Optional[torch.Tensor], n2: int, dtype, device,
                     elements: Optional[int]) -> torch.Tensor:
    """Run an interleaved plan (``(2, [Bt,] 2**n2)``).

    A gradient runs through the saved-residual executor in the large-state
    regime (its pullback ``W†λ`` needs no unitarity) and the kernels' own
    backwards below it; ``BACKWARD_MODE`` and the 0.35 residual rule do not
    apply, since the adjoint backward would undo a superoperator with its
    dagger.  A forward alone runs the per-step loop."""
    if psi2 is None:
        psi2 = kernels.zero_state_ri(n2, dtype, device, elements)
    if _needs_grad(plan, psi2) and saved.ENABLED and saved.usable(plan, n2):
        static, payloads = adjoint.normalize_plan(plan, n2)
        if payloads:
            return saved.execute_plan_saved_ri(psi2, payloads, static, n2)
    for kind, payload, wires in plan:
        psi2 = _apply_step_ri(psi2, kind, payload, wires, n2)
    return psi2


# ---------------------------------------------------------------------------
# Density readout
# ---------------------------------------------------------------------------

_INDEX_CACHE: Dict[tuple, torch.Tensor] = {}


def _cached_index(key: tuple, build) -> torch.Tensor:
    """An index tensor cached per (kind, n, device), built outside inference
    mode so that a later gradient may save it."""
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        with torch.inference_mode(False):
            idx = build()
        _INDEX_CACHE[key] = idx
    return idx


def _index_dtype(size: int) -> torch.dtype:
    return torch.int32 if size < 2**31 else torch.int64


def _pair_diag_index(n_qubits: int, device) -> torch.Tensor:
    """Positions of the diagonal in an interleaved flat plane: entry d sits
    where every (ket, bra) bit pair holds d's bit twice (00 or 11)."""

    def build():
        d = torch.arange(2**n_qubits, dtype=torch.int64, device=device)
        idx = torch.zeros_like(d)
        for i in range(n_qubits):
            idx |= ((d >> i) & 1) * 3 << (2 * i)
        return idx.to(_index_dtype(4**n_qubits))

    return _cached_index(("pair_diag", n_qubits, torch.device(device)), build)


def _pair_diag(x: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Diagonal of an interleaved flat density plane: one gather of its
    ``2**n`` entries (differentiable: ⟨Z⟩'s gradient flows back through it)."""
    return x.index_select(-1, _pair_diag_index(n_qubits, x.device))


def _deinterleave_index(n_qubits: int, device) -> torch.Tensor:
    """Gather indices from the interleaved flat order to the ket-then-bra
    one: ``target[j] = src[idx[j]]``, j with bits (k0..k_{n-1}, b0..b_{n-1})
    and the source interleaving (k0, b0, k1, b1, ...)."""

    def build():
        dim = 2**n_qubits
        j = torch.arange(4**n_qubits, dtype=torch.int64, device=device)
        ket, bra = j // dim, j % dim
        idx = torch.zeros_like(j)
        for i in range(n_qubits):
            idx |= ((ket >> i) & 1) << (2 * i + 1)
            idx |= ((bra >> i) & 1) << (2 * i)
        return idx.to(_index_dtype(4**n_qubits))

    return _cached_index(("deinterleave", n_qubits, torch.device(device)), build)


def _deinterleave_ri(rho2il: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Interleaved flat density pair -> ket-then-bra flat pair (one gather)."""
    return rho2il.index_select(-1, _deinterleave_index(n_qubits, rho2il.device))


def _measure_interleaved_ri(
    rho2il: torch.Tensor, n_qubits: int, type: str, obs: List[Operation]
) -> torch.Tensor:
    """Measurement from an interleaved density pair: ``probs`` and diagonal
    expvals off the pair diagonal; anything needing the full matrix
    de-interleaves it once."""
    if type in ("probs", "expval"):
        probs = _pair_diag(rho2il[0], n_qubits)
        if type == "probs":
            return probs
        diags = [_diagonal_real(ob) for ob in obs]
        if obs and all(d is not None for d in diags):
            return _expval_from_probs(probs, n_qubits, obs, diags)
    return measure_density_ri(_deinterleave_ri(rho2il, n_qubits), n_qubits, type, obs)


def _outer_ri(psi2: torch.Tensor) -> torch.Tensor:
    """Real-split outer product ``rho = |psi><psi|`` as a flat (2, 4**n)
    pair (``(2, Bt, 4**n)`` for a batched state)."""
    r, i = psi2[0], psi2[1]
    rho_r = kernels.bouter(r, r) + kernels.bouter(i, i)
    rho_i = kernels.bouter(i, r) - kernels.bouter(r, i)
    return torch.stack([rho_r, rho_i])


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def simulate_and_measure(
    tape: List[Operation],
    n_qubits: int,
    type: str,
    obs: List[Operation],
    use_density: bool = False,
    *,
    shots: Optional[int] = None,
    generator=None,
    dtype: torch.dtype = torch.float32,
    device=None,
    batch: int = 1,
    choice: Optional[BackwardChoice] = None,
    plans: Optional[PlanSlot] = None,
    rows=None,
) -> torch.Tensor:
    """Simulate the tape and measure ``expval`` / ``probs`` / ``state`` /
    ``density``.

    A noisy tape runs the interleaved density engine (the ket-then-bra one
    when it cannot be lowered); a noise-free ``density`` request runs the
    statevector and one outer product.  With *shots*, ``probs`` and
    ``expval`` are estimated from that many draws of the exact probabilities
    (:func:`sample_shots`, on *generator*); other types ignore them.
    *batch* and *choice*: see :func:`simulate_pure_ri`; *plans*: the plan
    slot (see :class:`PlanSlot`).

    A batched tape (its gates' matrices with a leading batch dimension,
    :func:`~qml_essentials_tpu_torch.ops.recipes.batch_of`) answers with a
    leading batch axis; *rows* picks a chunk (a slice) of it, and with shots
    *generator* is a list of one generator per element of the chunk.  Below
    the large-state regime the batch runs vectorised: each plan step once on
    the ``(2, Bt, 2**n)`` state (:func:`batch_route`).  From
    ``LARGE_STATE_MIN_N`` qubits (doubled wires for a density), or when its
    gradient goes to the adjoint executor, the plan built once for the batch
    runs element by element: its payloads composed once for the chunk, each
    element on their rows, handed out with its outer-product start before
    its ``run.forward`` span opens (:meth:`PlanSlot.each`)."""
    slot = PlanSlot() if plans is None else plans
    elements = _elements(tape, rows)
    if elements is None:
        return _simulate(tape, slot, rows, None, n_qubits, type, obs, use_density, shots,
                         generator, dtype, device, batch, choice)
    choice = BackwardChoice() if choice is None else choice
    gens = [None] * elements if generator is None else list(generator)
    if batch_route(tape, slot, n_qubits, type, use_density, dtype, device, batch, choice
                   ) == "vectorised":
        return _simulate(tape, slot, rows, elements, n_qubits, type, obs, use_density, shots,
                         gens, dtype, device, batch, choice)
    kind = _engine_kind(tape, slot, n_qubits, use_density, dtype, device)
    each = slot.each(*_planner(kind, n_qubits, dtype, device), tape, rows)
    return torch.stack([
        _simulate(tape, slot, each.first + i, None, n_qubits, type, obs, use_density, shots,
                  gens[i], dtype, device, batch, choice, (kind, each.element(each.first + i)))
        for i in range(elements)
    ])


def engine(tape: List[Operation], slot: PlanSlot, n_qubits: int, use_density: bool,
           dtype, device) -> Tuple[str, int]:
    """The engine a tape runs on and its register width: ``"pure"`` (n),
    ``"outer"`` (a noise-free density: the statevector, n), ``"interleaved"``
    or ``"mixed"`` (2n)."""
    if not use_density:
        return "pure", n_qubits
    if not any(isinstance(o, KrausChannel) for o in tape):
        return "outer", n_qubits
    if slot.skeleton("interleaved", _interleaved_build(n_qubits, dtype, device), tape) is None:
        return "mixed", 2 * n_qubits
    return "interleaved", 2 * n_qubits


def payload_bytes(slot: PlanSlot, tape: List[Operation], n_qubits: int, use_density: bool,
                  dtype, device) -> int:
    """Bytes of one element's payloads in the plan a batch of *tape* runs:
    each step's complex matrix (or diagonal) and its real-split pair, alive
    for the whole run (the executor's memory estimate adds them per
    element)."""
    eng, _ = engine(tape, slot, n_qubits, use_density, dtype, device)
    if eng in ("pure", "outer"):
        plan = slot.skeleton("pure", _pure_build(n_qubits, dtype, device), tape)[0]
    elif eng == "interleaved":
        plan = slot.skeleton("interleaved", _interleaved_build(n_qubits, dtype, device),
                             tape)[0]
    else:
        plan = slot.skeleton("mixed", _mixed_build(n_qubits, dtype, device), tape)
    per = 4 * torch.empty((), dtype=dtype).element_size()  # complex + real-split pair
    total = 0
    for kind, payload, wires in plan:
        if kind == "chain":  # its descriptors' windows and diagonals
            total += per * sum(4 ** (d[2] - d[1]) if d[0] == "win" else 2 ** len(d[1])
                               for d in payload[1])
        elif kind in ("rot", "dens_op") or not wires:
            continue
        elif kind == "diag" or isinstance(payload, DiagonalQubitUnitary):
            total += per * 2 ** len(wires)
        else:
            total += per * 4 ** len(wires)
    return total


def _tape_needs_grad(tape: List[Operation]) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for op in tape for v in op.__dict__.values())


def batch_route(tape: List[Operation], slot: PlanSlot, n_qubits: int, type: str,
                use_density: bool, dtype, device, batch: int,
                choice: BackwardChoice) -> str:
    """``"vectorised"`` or ``"per element: <reason>"`` for a batched tape:
    per element from ``LARGE_STATE_MIN_N`` wires of the register it runs on,
    and for a statevector gradient that the batch's one backward decision
    (*choice*, made here from the plan's length and *batch*) sends to the
    adjoint executor.  The executor logs what this returns, and
    :func:`simulate_and_measure` runs it."""
    kind, width = engine(tape, slot, n_qubits, use_density, dtype, device)
    if width >= LARGE_STATE_MIN_N:
        return f"per element: {width} wires, from LARGE_STATE_MIN_N = {LARGE_STATE_MIN_N}"
    if kind in ("pure", "outer") and _tape_needs_grad(tape):
        plan, _ = slot.skeleton("pure", _pure_build(n_qubits, dtype, device), tape)
        if choice.use_adjoint(plan, n_qubits, batch, device):
            return "per element: the adjoint backward"
    return "vectorised"


def _engine_kind(tape: List[Operation], slot: PlanSlot, n_qubits: int, use_density: bool,
                 dtype, device) -> str:
    """The engine a simulation runs on: :func:`engine`'s, ``"pure"`` without
    a density."""
    return engine(tape, slot, n_qubits, use_density, dtype, device)[0] if use_density else "pure"


def _planner(kind: str, n_qubits: int, dtype, device) -> tuple:
    """The slot key of engine *kind*'s skeleton, and its planner."""
    if kind == "interleaved":
        return kind, _interleaved_build(n_qubits, dtype, device)
    if kind == "mixed":
        return kind, _mixed_build(n_qubits, dtype, device)
    return "pure", _pure_build(n_qubits, dtype, device)


def _simulate(tape, slot, rows, elements, n_qubits, type, obs, use_density, shots, generator,
              dtype, device, batch, choice, planned: Optional[tuple] = None) -> torch.Tensor:
    """One simulation: a single tape, one row of a batched tape (*rows* an
    int), or a batch of *elements* rows run vectorised.  The plan is
    materialized first, unless *planned* brings it: the engine's kind and a
    row's plan, handed out by :meth:`PlanSlot.each`.  The run and the
    readout are one ``run.forward`` span under a profiler."""
    dim = 2**n_qubits
    sampled = shots is not None and type in ("probs", "expval")
    if planned is None:
        kind = _engine_kind(tape, slot, n_qubits, use_density, dtype, device)
        planned = slot.get(*_planner(kind, n_qubits, dtype, device), tape, rows)
    else:
        kind, planned = planned
    with profiling.span("run.forward"):
        plan, psi2 = (planned, None) if kind == "mixed" else planned
        if kind == "interleaved":
            rho2il = _run_interleaved(plan, psi2, 2 * n_qubits, dtype, device, elements)
            if sampled:
                exact = _pair_diag(rho2il[0], n_qubits)
                return sample_shots(exact, n_qubits, type, obs, shots, generator)
            return _measure_interleaved_ri(rho2il, n_qubits, type, obs)
        if kind == "mixed":
            rho2 = _run_mixed(plan, n_qubits, dtype, device, _elements(tape, rows))
        else:
            psi2 = _run_pure(plan, psi2, n_qubits, dtype, device, batch, choice,
                             _elements(tape, rows))
            if not use_density:
                if sampled:
                    exact = psi2[0] ** 2 + psi2[1] ** 2
                    return sample_shots(exact, n_qubits, type, obs, shots, generator)
                return measure_state_ri(psi2, n_qubits, type, obs)
            rho2 = _outer_ri(psi2)
        if sampled:
            exact = torch.diagonal(rho2[0].reshape(rho2.shape[1:-1] + (dim, dim)),
                                   dim1=-2, dim2=-1)
            return sample_shots(exact, n_qubits, type, obs, shots, generator)
        return measure_density_ri(rho2, n_qubits, type, obs)


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
    lead = tuple(probs.shape[:-1])
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
                    row_marg = probs.reshape(lead + (2**h, 2**low)).sum(dim=-1)
                results.append(kernels.reduce_diagonal_expectation(row_marg, weights[:h]))
            elif use_halves and wires and min(wires) >= h:
                if col_marg is None:
                    col_marg = probs.reshape(lead + (2**h, 2**low)).sum(dim=-2)
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
    return torch.stack(results, dim=-1)


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
        O_states = torch.einsum("oij,...j->...oi", obs_mats, state)
        return torch.einsum("...i,...oi->...o", state.conj(), O_states).real
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



def measure_density(
    rho: torch.Tensor, n_qubits: int, type: str, obs: List[Operation]
) -> torch.Tensor:
    """Measure a complex density matrix: ``density`` / ``probs`` / ``expval``."""
    if type == "density":
        return rho
    if type == "probs":
        return torch.diagonal(rho, dim1=-2, dim2=-1).real
    if type == "expval":
        diags = [_diagonal_real(ob) for ob in obs]
        if obs and all(d is not None for d in diags):
            probs = torch.diagonal(rho, dim1=-2, dim2=-1).real
            return _expval_from_probs(probs, n_qubits, obs, diags)
        obs_mats = torch.stack(
            [ob.lifted_matrix(n_qubits).to(device=rho.device, dtype=rho.dtype) for ob in obs]
        )
        return torch.einsum("oij,...ji->...o", obs_mats, rho).real
    raise ValueError(
        "Measurement type 'state' is not defined for mixed (noisy) circuits. "
        "Use 'density' instead."
    )


def measure_density_ri(
    rho2: torch.Tensor, n_qubits: int, type: str, obs: List[Operation]
) -> torch.Tensor:
    """Measure a real-split ket-then-bra density pair; complex only at the
    boundary."""
    dim = 2**n_qubits
    square = tuple(rho2.shape[1:-1]) + (dim, dim)
    if type == "density":
        return kernels.from_ri(rho2).reshape(square)
    probs = torch.diagonal(rho2[0].reshape(square), dim1=-2, dim2=-1)
    if type == "probs":
        return probs
    if type == "expval":
        diags = [_diagonal_real(ob) for ob in obs]
        if obs and all(d is not None for d in diags):
            return _expval_from_probs(probs, n_qubits, obs, diags)
        return measure_density(kernels.from_ri(rho2).reshape(square), n_qubits, type, obs)
    raise ValueError(
        "Measurement type 'state' is not defined for mixed (noisy) circuits. "
        "Use 'density' instead."
    )


# ---------------------------------------------------------------------------
# Shots
# ---------------------------------------------------------------------------


def sample_shots(
    probs: torch.Tensor,
    n_qubits: int,
    type: str,
    obs: List[Operation],
    shots: int,
    generator=None,
) -> torch.Tensor:
    """Finite-shot estimate from an exact probability vector.

    ``torch.multinomial`` with replacement draws the *shots* outcomes by
    inverse transform over the running sum of *probs*: one pass over the
    ``2**n`` probabilities and a search per shot (a Gumbel-max draw, the
    JAX package's, would make ``shots x 2**n`` uniforms).  The draw runs on
    *generator*, on the probabilities' device; a generator on another device
    (or ``None``: seed 0) seeds one there.  A batch ``(Bt, 2**n)`` of
    probabilities draws each row on its own generator (*generator* a list of
    ``Bt``), as the elements of a loop would.  Rounding leaves float32
    probabilities a hair below zero at times; they are clipped.  The
    estimate carries no gradient."""
    dim = 2**n_qubits
    if probs.dim() > 1:
        estimated = torch.stack([_draw(p, shots, g, dim) for p, g in zip(probs, generator)])
    else:
        estimated = _draw(probs, shots, generator, dim)
    estimated = estimated.to(probs.dtype)

    if type == "probs":
        return estimated
    if type == "expval":
        diags = [_diagonal_real(ob) for ob in obs]
        if obs and all(d is not None for d in diags):
            return _expval_from_probs(estimated, n_qubits, obs, diags)
        return torch.stack([
            estimated @ torch.diagonal(ob.lifted_matrix(n_qubits)).real.to(estimated)
            for ob in obs
        ], dim=-1)
    raise ValueError(
        f"Shot simulation is only supported for 'probs' and 'expval', got {type!r}."
    )


def _draw(probs: torch.Tensor, shots: int, generator, dim: int) -> torch.Tensor:
    """Outcome frequencies of *shots* draws from one probability vector."""
    p = probs.detach().reshape(-1).clamp_min(0)
    if generator is None:
        generator = torch.Generator(device=p.device).manual_seed(0)
    elif generator.device != p.device:
        generator = safe_random_split(generator, 1, device=p.device)[0]
    samples = torch.multinomial(p, shots, replacement=True, generator=generator)
    return torch.bincount(samples, minlength=dim).to(probs.dtype) / shots
