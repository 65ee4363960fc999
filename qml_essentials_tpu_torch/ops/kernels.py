"""Contraction kernels of the statevector simulator, and their plain versions.

The state stays **flat**: ``(2**n,)`` complex, or on the simulation hot path
the real-split pair ``psi2`` of shape ``(2, 2**n)`` (``psi2[0] = Re``,
``psi2[1] = Im``).  Every gate applies through a rank-3 view
``(2**a, 2**k, 2**b)`` with the gate support ``[a, a+k)`` on the middle axis:

* gates on a **contiguous** qubit range are one contraction on that view —
  the window kernel (``(2, A, K, B)``, B > 1) or the top-window kernel
  (support ``[n-k, n)``, B = 1);
* ring-wrap supports become contiguous under one cyclic qubit rotation (the
  rotation kernel), apply, and rotate back;
* scattered supports pull their wires to the front with axis moves, apply at
  ``[0, k)``, and move back;
* diagonal gates broadcast-multiply against the same view.

``window_apply_plain`` / ``window_apply_top_plain`` / ``rotate_plain`` and
the backward versions ``window_apply_bwd_plain`` /
``window_apply_top_bwd_plain`` are the plain PyTorch versions of the
hand-written CUDA kernels in
:mod:`qml_essentials_tpu_torch.ops.cuda_kernels`.  The kernel wrappers run
them for tensors on the CPU; on a CUDA tensor the wrappers launch the kernel
or raise.  Unlike the JAX package, no window is padded to a lane tile and
no support is recentred: any ``(2, A, K, B)`` view contracts directly.

Counterpart of ``qml_essentials_tpu/ops/kernels.py``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.ops import cuda_kernels

# ---------------------------------------------------------------------------
# Gate-side helpers (small matrices)
# ---------------------------------------------------------------------------


def permute_gate_qubits(mat: torch.Tensor, perm: Sequence[int], k: int) -> torch.Tensor:
    """Reorder the qubits of a ``(2**k, 2**k)`` gate so qubit i -> perm[i]."""
    perm = list(perm)
    if perm == list(range(k)):
        return mat
    t = mat.reshape((2,) * (2 * k))
    inv = [int(i) for i in np.argsort(perm)]
    t = t.permute(*inv, *[p + k for p in inv])
    return t.reshape(2**k, 2**k)


def lift_matrix(
    mat: torch.Tensor, op_wires: Sequence[int], all_wires: Sequence[int]
) -> torch.Tensor:
    """Embed a ``k``-qubit matrix into the space spanned by *all_wires*."""
    op_wires = list(op_wires)
    all_wires = list(all_wires)
    n = len(all_wires)
    if op_wires == all_wires:
        return mat
    missing = [w for w in all_wires if w not in op_wires]
    full = mat
    if missing:
        eye = torch.eye(2 ** len(missing), dtype=mat.dtype, device=mat.device)
        full = torch.kron(mat, eye)
    current = op_wires + missing
    if current == all_wires:
        return full
    dest = [all_wires.index(c) for c in current]
    return permute_gate_qubits(full, dest, n)


# ---------------------------------------------------------------------------
# Axis plumbing (flat-state rank-3 moves)
# ---------------------------------------------------------------------------


def _move_axis_front(flat: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """Move conceptual qubit axis *p* to the front of a flat state (one pass)."""
    if p == 0:
        return flat
    A = 2**p
    B = flat.numel() // (2 * A)
    return flat.reshape(A, 2, B).transpose(0, 1).reshape(-1)


def _move_front_to(flat: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_move_axis_front`: front axis back to position *p*."""
    if p == 0:
        return flat
    A = 2**p
    B = flat.numel() // (2 * A)
    return flat.reshape(2, A, B).transpose(0, 1).reshape(-1)


@lru_cache(maxsize=4096)
def _gather_plan(wires: Tuple[int, ...]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Sequence of single-axis pulls placing *wires* (sorted) at the front.

    Returns ``(pulls, restores)``: positions to pull front-ward in order, and
    the reverse sequence to undo.
    """
    order = list(range(max(wires) + 1 + 64))
    pulls = []
    for w in reversed(sorted(wires)):
        p = order.index(w)
        pulls.append(p)
        order.remove(w)
        order.insert(0, w)
    return tuple(pulls), tuple(reversed(pulls))


def _contiguous(srt: List[int]) -> bool:
    return srt == list(range(srt[0], srt[0] + len(srt)))


def apply_matrix_flat(
    psi: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Contract a complex ``(2**k, 2**k)`` gate against *wires* of a flat
    complex state (used to compose fused windows)."""
    mat = mat.to(device=psi.device, dtype=psi.dtype)
    wires = [int(w) for w in wires]
    k = len(wires)
    srt = sorted(wires)
    if wires != srt:
        rank = {w: i for i, w in enumerate(srt)}
        mat = permute_gate_qubits(mat, [rank[w] for w in wires], k)

    if _contiguous(srt):
        A = 2 ** srt[0]
        B = psi.numel() // (A * 2**k)
        out = torch.einsum("ij,ajb->aib", mat, psi.reshape(A, 2**k, B))
        return out.reshape(psi.shape)

    r = _cyclic_run(srt, n)
    if r is not None:
        rot = _rotate_qubits(psi, r, n)
        rot = apply_matrix_flat(rot, mat, [(w + r) % n for w in srt], n)
        return _rotate_qubits(rot, n - r, n)

    pulls, restores = _gather_plan(tuple(srt))
    for p in pulls:
        psi = _move_axis_front(psi, p, n)
    psi = (mat @ psi.reshape(2**k, -1)).reshape(-1)
    for p in restores:
        psi = _move_front_to(psi, p, n)
    return psi


# ---------------------------------------------------------------------------
# Real-split application (the simulation hot path)
# ---------------------------------------------------------------------------


def from_ri(psi2: torch.Tensor) -> torch.Tensor:
    """Stacked (2, ...) real pair -> complex vector."""
    return torch.complex(psi2[0], psi2[1])


def _pair_of(mat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Complex (or real) matrix -> stacked ``(2, ...)`` Re/Im pair in the
    dtype and on the device of the state *like*."""
    if mat.is_complex():
        pair = torch.stack([mat.real, mat.imag])
    else:
        pair = torch.stack([mat, torch.zeros_like(mat)])
    return pair.to(device=like.device, dtype=like.dtype)


def apply_matrix_flat_ri(
    psi2: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Real-split gate application of a complex matrix."""
    return apply_matrix_pair_ri(psi2, _pair_of(mat, psi2), wires, n)


def _contract(psi2: torch.Tensor, w2: torch.Tensor, a: int, k: int, n: int) -> torch.Tensor:
    """Contiguous window ``[a, a+k)``: the top-window kernel when the support
    ends at the register top (B = 1), the window kernel otherwise."""
    if a + k == n:
        return cuda_kernels.window_apply_top(psi2, w2, k, n)
    return cuda_kernels.window_apply(psi2, w2, a, k, n)


def apply_matrix_pair_ri(
    psi2: torch.Tensor, w2: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Gate application with the gate given as a stacked ``(2, K, K)``
    (Re, Im) pair on the flat real-split state."""
    w2 = w2.to(device=psi2.device, dtype=psi2.dtype)
    wires = [int(w) for w in wires]
    k = len(wires)
    srt = sorted(wires)
    if wires != srt:
        rank = {w: i for i, w in enumerate(srt)}
        perm = [rank[w] for w in wires]
        w2 = torch.stack(
            [permute_gate_qubits(w2[0], perm, k), permute_gate_qubits(w2[1], perm, k)]
        )
    w2 = w2.contiguous()

    if _contiguous(srt):
        return _contract(psi2, w2, srt[0], k, n)

    # Ring-wrap supports (one run on the qubit circle, e.g. {n-1, 0}): one
    # cyclic rotation makes the support contiguous.
    r = _cyclic_run(srt, n)
    if r is not None:
        rot = _rotate_qubits_ri(psi2, r, n)
        rot = apply_matrix_pair_ri(rot, w2, [(w + r) % n for w in srt], n)
        return _rotate_qubits_ri(rot, n - r, n)

    # Scattered support: pull wires to the front, apply at [0, k), push back.
    pulls, restores = _gather_plan(tuple(srt))
    for p in pulls:
        psi2 = _move_axis_front_ri(psi2, p)
    psi2 = _contract(psi2, w2, 0, k, n)
    for p in restores:
        psi2 = _move_front_to_ri(psi2, p)
    return psi2


def _real_window_product(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[a, i, b] = sum_j w[i, j] x[a, j, b]`` for real ``w`` and ``x``.

    Written as one matrix product over the flattened ``(a, b)`` columns so
    ``w`` is never broadcast over ``a``."""
    A, K, B = x.shape
    if A == 1:
        return (w @ x[0]).unsqueeze(0)
    cols = x.transpose(0, 1).reshape(K, A * B)
    return (w @ cols).reshape(K, A, B).transpose(0, 1)


def window_apply_plain(
    psi2: torch.Tensor, w2: torch.Tensor, a: int, k: int, n: int
) -> torch.Tensor:
    """Plain version of the window kernel: ``y[a,i,b] = sum_j W[i,j] x[a,j,b]``
    on the ``(2, A, K, B)`` view, four real matrix products."""
    K = 2**k
    A = 2**a
    x = psi2.reshape(2, A, K, -1)
    wr, wi = w2[0], w2[1]
    yr = _real_window_product(wr, x[0]) - _real_window_product(wi, x[1])
    yi = _real_window_product(wr, x[1]) + _real_window_product(wi, x[0])
    return torch.stack([yr, yi]).reshape(psi2.shape)


def window_apply_top_plain(
    psi2: torch.Tensor, w2: torch.Tensor, k: int, n: int
) -> torch.Tensor:
    """Plain version of the top-window kernel: support ``[n-k, n)``, so the
    window axis is the contiguous one and ``Y = X W^T`` on ``(2, A, K)``."""
    K = 2**k
    x = psi2.reshape(2, -1, K)
    wrT, wiT = w2[0].T, w2[1].T
    yr = x[0] @ wrT - x[1] @ wiT
    yi = x[0] @ wiT + x[1] @ wrT
    return torch.stack([yr, yi]).reshape(psi2.shape)


def window_apply_bwd_plain(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, a: int, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the window backward kernel: for ``y = W x`` on the
    ``(2, A, K, B)`` view, given the output cotangent ``g`` and the saved
    input ``x``, returns ``(gp, gw)``:

    * ``gp = W^† g`` (Re ``Wr^T gr + Wi^T gi``, Im ``Wr^T gi - Wi^T gr``),
      cast to *out_dtype*;
    * ``gw = g conj(x)^T`` summed over all ``A*B`` columns (Re ``gr xr^T +
      gi xi^T``, Im ``gi xr^T - gr xi^T``), in the working dtype of ``x``.

    ``g`` may be bfloat16; it is upcast to the working dtype first."""
    K = 2**k
    A = 2**a
    g = g.to(x.dtype)
    gv = g.reshape(2, A, K, -1)
    wrT, wiT = w2[0].T, w2[1].T
    gpr = _real_window_product(wrT, gv[0]) + _real_window_product(wiT, gv[1])
    gpi = _real_window_product(wrT, gv[1]) - _real_window_product(wiT, gv[0])
    gp = torch.stack([gpr, gpi]).reshape(x.shape).to(out_dtype)
    gc = gv.transpose(1, 2).reshape(2, K, -1)
    xc = x.reshape(2, A, K, -1).transpose(1, 2).reshape(2, K, -1)
    gwr = gc[0] @ xc[0].T + gc[1] @ xc[1].T
    gwi = gc[1] @ xc[0].T - gc[0] @ xc[1].T
    return gp, torch.stack([gwr, gwi])


def window_apply_top_bwd_plain(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the top-window backward kernel: for ``Y = X W^T`` on
    ``(2, A, K)``, returns ``gp = g conj(W)`` (in *out_dtype*) and
    ``gw[i, j] = sum_t g[t, i] conj(x[t, j])`` (in the working dtype)."""
    K = 2**k
    g = g.to(x.dtype)
    gv = g.reshape(2, -1, K)
    xv = x.reshape(2, -1, K)
    wr, wi = w2[0], w2[1]
    gpr = gv[0] @ wr + gv[1] @ wi
    gpi = gv[1] @ wr - gv[0] @ wi
    gp = torch.stack([gpr, gpi]).reshape(x.shape).to(out_dtype)
    gwr = gv[0].T @ xv[0] + gv[1].T @ xv[1]
    gwi = gv[1].T @ xv[0] - gv[0].T @ xv[1]
    return gp, torch.stack([gwr, gwi])


def rotate_plain(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Plain version of the rotation kernel: qubit q -> (q + r) mod n, the
    transpose ``(2, X, R) -> (2, R, X)`` with ``R = 2**r``, in any dtype."""
    R = 2 ** (r % n)
    return psi2.reshape(2, -1, R).transpose(1, 2).reshape(psi2.shape)


def _recenter_rotation(a: int, k: int, n: int) -> Optional[int]:
    """Rotation moving contiguous support ``[a, a+k)`` to a start ``a'`` with
    ``B' = 2**(n-a'-k) >= 128``, or ``None``.

    The port applies every window directly, so this only prices supports in
    the layout scheduler (its cost table is the reference's, kept so plans
    match step for step).
    """
    if n < 14:
        return None
    best = None
    best_score = -1
    for a_new in range(0, n - k - 6):
        if a_new == a:
            continue
        r = (a_new - a) % n
        if not (a + r + k <= n or a + r >= n):
            continue
        in_band = 7 <= r <= n - 7
        score = (2 if in_band else 0) + min(a_new, 7) / 8.0
        if score > best_score:
            best_score = score
            best = r
    return best


def _cyclic_run(srt: List[int], n: int) -> Optional[int]:
    """If *srt* is one contiguous run on the qubit circle, return a rotation
    ``r`` (7 <= r <= n-7) that makes it linearly contiguous; else ``None``."""
    k = len(srt)
    if n < 14 or k >= n:
        return None
    in_support = [False] * n
    for w in srt:
        in_support[w] = True
    starts = [i for i in range(n) if in_support[i] and not in_support[(i - 1) % n]]
    if len(starts) != 1:
        return None
    start = starts[0]
    for r in range(7, n - 6):
        if (start + r) % n + k <= n:
            return r
    return None


def _rotate_qubits(psi: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Cyclic qubit rotation on a flat complex state: q -> (q + r) mod n."""
    if r % n == 0:
        return psi
    R = 2 ** (r % n)
    return psi.reshape(-1, R).transpose(0, 1).reshape(psi.shape)


def _rotate_qubits_ri(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Cyclic qubit rotation of the real-split state: q -> (q + r) mod n."""
    if r % n == 0:
        return psi2
    return cuda_kernels.rotate(psi2, r % n, n)


def _move_axis_front_ri(psi2: torch.Tensor, p: int) -> torch.Tensor:
    """Move conceptual qubit axis *p* to the front, per component."""
    if p == 0:
        return psi2
    A = 2**p
    dim = psi2.shape[-1]
    return psi2.reshape(2, A, 2, dim // (2 * A)).transpose(1, 2).reshape(2, dim)


def _move_front_to_ri(psi2: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`_move_axis_front_ri`."""
    if p == 0:
        return psi2
    A = 2**p
    dim = psi2.shape[-1]
    return psi2.reshape(2, 2, A, dim // (2 * A)).transpose(1, 2).reshape(2, dim)


def apply_diagonal_flat_ri(
    psi2: torch.Tensor, diag: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Real-split diagonal gate: a broadcast complex multiply in real parts."""
    return apply_diagonal_pair_ri(psi2, _pair_of(diag, psi2), wires, n)


def apply_diagonal_pair_ri(
    psi2: torch.Tensor, d2: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Diagonal gate given as a stacked ``(2, 2**k)`` (Re, Im) pair."""
    d2 = d2.to(device=psi2.device, dtype=psi2.dtype)
    wires = [int(w) for w in wires]
    k = len(wires)
    srt = sorted(wires)
    if wires != srt:
        order = [0] + [1 + wires.index(w) for w in srt]
        d2 = d2.reshape((2,) + (2,) * k).permute(*order).reshape(2, -1)
    dr, di = d2[0], d2[1]

    def mul(t, dr_b, di_b):
        tr, ti = t[0], t[1]
        return torch.stack([tr * dr_b - ti * di_b, tr * di_b + ti * dr_b])

    dim = psi2.shape[-1]
    if _contiguous(srt):
        A = 2 ** srt[0]
        t = psi2.reshape(2, A, 2**k, dim // (A * 2**k))
        return mul(t, dr[None, :, None], di[None, :, None]).reshape(2, dim)

    pulls, restores = _gather_plan(tuple(srt))
    for p in pulls:
        psi2 = _move_axis_front_ri(psi2, p)
    psi2 = mul(psi2.reshape(2, 2**k, -1), dr[:, None], di[:, None]).reshape(2, dim)
    for p in restores:
        psi2 = _move_front_to_ri(psi2, p)
    return psi2


# ---------------------------------------------------------------------------
# State constructors & measurement reductions
# ---------------------------------------------------------------------------


def zero_state_ri(
    n_qubits: int, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """|0...0> as a stacked (2, 2**n) real pair."""
    psi2 = torch.zeros((2, 2**n_qubits), dtype=dtype, device=device)
    psi2[0, 0] = 1.0
    return psi2


def reduce_diagonal_expectation(
    probs: torch.Tensor, qubit_weights: Sequence[Optional[Tuple[float, float]]]
) -> torch.Tensor:
    """⟨⊗_q D_q⟩ for per-qubit diagonal factors from a probability vector.

    ``qubit_weights[q]`` is ``(d0, d1)`` for qubits in the observable's
    support and ``None`` (trace out) elsewhere.  A halving fold: one weighted
    pairwise reduction per qubit, total traffic ``~2 * 2**n``.
    """
    v = probs.reshape(-1)
    for q in reversed(range(len(qubit_weights))):
        v = v.reshape(-1, 2)
        w = qubit_weights[q]
        if w is None:
            v = v[:, 0] + v[:, 1]
        else:
            v = w[0] * v[:, 0] + w[1] * v[:, 1]
    return v.reshape(())


def marginal_probs_on(probs: torch.Tensor, keep: Sequence[int], n: int) -> torch.Tensor:
    """Marginal distribution over the *keep* qubits (sorted order)."""
    v = probs.reshape(-1)
    for q in sorted(set(range(n)) - set(int(k) for k in keep), reverse=True):
        A = 2**q
        v = v.reshape(A, 2, -1).sum(dim=1).reshape(-1)
    return v
