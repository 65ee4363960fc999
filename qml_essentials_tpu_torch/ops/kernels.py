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

A batch of states is ``(2, Bt, 2**n)`` (Re/Im outermost, the batch folded
into the view's A axis); its gates may carry a leading batch axis too
(``(Bt, K, K)``, a pair ``(Bt, 2, K, K)``), and every function here takes
both.

``window_apply_plain`` / ``window_apply_top_plain`` / ``rotate_plain``, the
backward versions ``window_apply_bwd_plain`` / ``window_apply_top_bwd_plain``
and the adjoint-state steps ``adjoint_step_plain`` /
``adjoint_step_top_plain`` / ``rotate_pair_plain``, and the fused
(rotation, window) steps ``rotmat`` / ``matrot`` / ``rotwin`` with their
backwards and the ``rotmat`` / ``matrot`` adjoint steps, are the plain PyTorch
versions of the hand-written CUDA kernels in
:mod:`qml_essentials_tpu_torch.ops.cuda_kernels`.  The kernel wrappers run
them for tensors on the CPU; on a CUDA tensor the wrappers launch the kernel
or raise.  Unlike the JAX package, no window is padded to a lane tile and
no support is recentred: any ``(2, A, K, B)`` view contracts directly.

Counterpart of ``qml_essentials_tpu/ops/kernels.py``.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from qml_essentials_tpu_torch.ops import cuda_kernels

# ---------------------------------------------------------------------------
# Gate-side helpers (small matrices)
# ---------------------------------------------------------------------------


def permute_gate_qubits(mat: torch.Tensor, perm: Sequence[int], k: int) -> torch.Tensor:
    """Reorder the qubits of a ``(..., 2**k, 2**k)`` gate so qubit i ->
    perm[i] (leading dimensions, such as a batch, are kept)."""
    perm = list(perm)
    if perm == list(range(k)):
        return mat
    lead = tuple(mat.shape[:-2])
    t = mat.reshape(lead + (2,) * (2 * k))
    o = len(lead)
    inv = [int(i) + o for i in np.argsort(perm)]
    t = t.permute(*range(o), *inv, *[p + k for p in inv])
    return t.reshape(lead + (2**k, 2**k))


def bkron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product of the last two dimensions of *a* and *b*, their
    leading (batch) dimensions broadcast; ``torch.kron`` when both are
    plain matrices."""
    if a.dim() == 2 and b.dim() == 2:
        return torch.kron(a, b)
    (m, p), (q, r) = a.shape[-2:], b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (m * q, p * r))


def bouter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Outer product of the last dimensions of *a* and *b*, flattened
    (``torch.kron`` of vectors), their leading dimensions broadcast."""
    if a.dim() == 1 and b.dim() == 1:
        return torch.kron(a, b)
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(out.shape[:-2] + (-1,))


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
        full = bkron(mat, eye)
    current = op_wires + missing
    if current == all_wires:
        return full
    dest = [all_wires.index(c) for c in current]
    return permute_gate_qubits(full, dest, n)


def permute_qubits_matrix(mat: torch.Tensor, perm: List[int], n_qubits: int) -> torch.Tensor:
    """Reorder qubits of a ``(2**n, 2**n)`` matrix: axis i of the result is
    qubit ``perm[i]`` of *mat* (the JAX package's ``jnp.transpose``)."""
    t = mat.reshape((2,) * (2 * n_qubits))
    t = t.permute(*perm, *[p + n_qubits for p in perm])
    return t.reshape(2**n_qubits, 2**n_qubits)


# ---------------------------------------------------------------------------
# Axis plumbing (flat-state rank-3 moves)
# ---------------------------------------------------------------------------


def _move_axis_front(flat: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """Move conceptual qubit axis *p* to the front of a flat state (one pass;
    leading dimensions are kept)."""
    if p == 0:
        return flat
    A = 2**p
    lead = tuple(flat.shape[:-1])
    return flat.reshape(lead + (A, 2, -1)).transpose(-3, -2).reshape(flat.shape)


def _move_front_to(flat: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_move_axis_front`: front axis back to position *p*."""
    if p == 0:
        return flat
    A = 2**p
    lead = tuple(flat.shape[:-1])
    return flat.reshape(lead + (2, A, -1)).transpose(-3, -2).reshape(flat.shape)


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


def pieces(dims: Sequence[int], unit: int, limit: int) -> List[tuple]:
    """Slices over the leading *dims* that cut a block of ``unit *
    prod(dims)`` bytes into equal pieces of at most *limit* bytes (one
    piece, ``()``, when the whole fits)."""
    size = unit * int(np.prod(dims, dtype=np.int64))
    axes = []
    for d in dims:
        if size <= limit:
            break
        c = min(d, -(-size // limit))
        while d % c:
            c += 1
        axes.append([slice(i, i + d // c) for i in range(0, d, d // c)])
        size //= c
    return list(itertools.product(*axes))


def bit_runs(n: int, picked: Sequence[int]) -> Tuple[Tuple[int, ...], List[int]]:
    """A ``2**n`` axis as few dims: one of 2 for each *picked* qubit
    position (0 the most significant), one for each run of the others.
    Returns the dims and each picked position's dim, in *picked*'s order."""
    runs, dim_of, start = [], {}, 0
    for v in sorted(picked):
        if v > start:
            runs.append(2 ** (v - start))
        dim_of[v] = len(runs)
        runs.append(2)
        start = v + 1
    if start < n:
        runs.append(2 ** (n - start))
    return tuple(runs), [dim_of[v] for v in picked]


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over broadcast leading dims, as one :func:`torch.bmm`: how
    the CPU composes windows, so that an element of a batch rounds, forward
    and backward, as it does alone (``matmul`` folds or expands by shape and
    by which operand needs a gradient, and ``einsum`` differs again).  A
    lone product runs as two entries, the second a copy: a one-entry
    ``bmm`` is a plain GEMM, which BLAS may split along the contraction
    across threads.  The card keeps ``einsum`` and ``matmul``: on an H100
    this form held 50 MB more and slowed a 13q density request's first call
    by about 4 s."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(lead + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    if a.shape[0] == 1:
        out = torch.bmm(a.expand(2, -1, -1), b.expand(2, -1, -1))[:1]
    else:
        out = torch.bmm(a, b)
    return out.reshape(lead + out.shape[-2:])


def apply_matrix_flat(
    psi: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Contract a complex ``(2**k, 2**k)`` gate against *wires* of a flat
    complex state (used to compose fused windows).

    A batch rides on leading dimensions: a ``(Bt, 2**n)`` state, a
    ``(Bt, 2**k, 2**k)`` gate, or both (a plain operand is broadcast; a
    batched gate on a plain state gives a batched state)."""
    mat = mat.to(device=psi.device, dtype=psi.dtype)
    wires = [int(w) for w in wires]
    k = len(wires)
    srt = sorted(wires)
    if wires != srt:
        rank = {w: i for i, w in enumerate(srt)}
        mat = permute_gate_qubits(mat, [rank[w] for w in wires], k)
    lead = tuple(psi.shape[:-1])
    dim = psi.shape[-1]
    matmul = _bmm if psi.device.type == "cpu" else torch.matmul

    if _contiguous(srt):
        A = 2 ** srt[0]
        x = psi.reshape(lead + (A, 2**k, dim // (A * 2**k)))
        if mat.dim() == 2 and not lead and matmul is torch.matmul:
            return torch.einsum("ij,ajb->aib", mat, x).reshape(psi.shape)
        out = matmul(mat[..., None, :, :], x)
        return out.reshape(out.shape[:-3] + (dim,))

    r = _cyclic_run(srt, n)
    if r is not None:
        rot = _rotate_qubits(psi, r, n)
        rot = apply_matrix_flat(rot, mat, [(w + r) % n for w in srt], n)
        return _rotate_qubits(rot, n - r, n)

    pulls, restores = _gather_plan(tuple(srt))
    for p in pulls:
        psi = _move_axis_front(psi, p, n)
    psi = matmul(mat, psi.reshape(lead + (2**k, -1)))
    psi = psi.reshape(psi.shape[:-2] + (dim,))
    for p in restores:
        psi = _move_front_to(psi, p, n)
    return psi


# ---------------------------------------------------------------------------
# Real-split application (the simulation hot path)
# ---------------------------------------------------------------------------


def set_matmul_precision(name: str) -> None:
    """Set the precision of PyTorch's own float32 matrix products.

    Takes the JAX package's names: ``"highest"`` / ``"float32"`` (full
    float32), ``"high"`` / ``"tensorfloat32"`` (TF32), ``"default"`` /
    ``"bfloat16"`` (PyTorch's ``"medium"``); an unknown name raises
    ``KeyError``.  It goes to ``torch.set_float32_matmul_precision``, which
    also sets ``torch.backends.cuda.matmul.allow_tf32``, so it only touches
    plain torch products such as the planner's payload composition.  The
    hand-written kernels do not read it: their products are float32-grade
    split TF32 whatever this switch says.
    """
    torch.set_float32_matmul_precision(_PRECISION_NAMES[name.lower()])


_PRECISION_NAMES = {
    "default": "medium",
    "bfloat16": "medium",
    "high": "high",
    "tensorfloat32": "high",
    "highest": "highest",
    "float32": "highest",
}


def to_ri(psi: torch.Tensor) -> torch.Tensor:
    """Complex tensor -> stacked (2, ...) real pair (a real tensor gets a
    zero imaginary part)."""
    if psi.is_complex():
        return torch.stack([psi.real, psi.imag])
    return torch.stack([psi, torch.zeros_like(psi)])


def from_ri(psi2: torch.Tensor) -> torch.Tensor:
    """Stacked (2, ...) real pair -> complex vector."""
    return torch.complex(psi2[0], psi2[1])


def _pair_of(mat: torch.Tensor, like: torch.Tensor, vector: bool = False) -> torch.Tensor:
    """Complex (or real) matrix -> stacked ``(2, K, K)`` Re/Im pair in the
    dtype and on the device of the state *like*; a batched ``(Bt, K, K)``
    matrix gives ``(Bt, 2, K, K)``, and with *vector* a ``(d,)`` or
    ``(Bt, d)`` diagonal gives ``(2, d)`` or ``(Bt, 2, d)``."""
    axis = -2 if vector else -3
    if mat.is_complex():
        pair = torch.stack([mat.real, mat.imag], dim=axis)
    else:
        pair = torch.stack([mat, torch.zeros_like(mat)], dim=axis)
    return pair.to(device=like.device, dtype=like.dtype)


def is_batched(psi2: torch.Tensor) -> bool:
    """Whether a real-split state carries a batch axis: ``(2, Bt, 2**n)``."""
    return psi2.dim() == 3


def apply_matrix_flat_ri(
    psi2: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Real-split gate application of a complex matrix."""
    return apply_matrix_pair_ri(psi2, _pair_of(mat, psi2), wires, n)


def _contract(psi2: torch.Tensor, w2: torch.Tensor, a: int, k: int, n: int) -> torch.Tensor:
    """Contiguous window ``[a, a+k)``: the top-window kernel when the support
    ends at the register top (B = 1), the window kernel otherwise.  A
    batched state ``(2, Bt, 2**n)`` takes the same wrappers, whose batch
    entries run one launch for the whole batch with a shared ``(2, K, K)``
    or a per-element ``(Bt, 2, K, K)`` window."""
    if a + k == n:
        return cuda_kernels.window_apply_top(psi2, w2, k, n)
    return cuda_kernels.window_apply(psi2, w2, a, k, n)


def apply_matrix_pair_ri(
    psi2: torch.Tensor, w2: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Gate application with the gate given as a stacked ``(2, K, K)``
    (Re, Im) pair on the flat real-split state; on a batched ``(2, Bt,
    2**n)`` state the gate may be per element, ``(Bt, 2, K, K)``."""
    w2 = w2.to(device=psi2.device, dtype=psi2.dtype)
    wires = [int(w) for w in wires]
    k = len(wires)
    srt = sorted(wires)
    if wires != srt:
        rank = {w: i for i, w in enumerate(srt)}
        w2 = permute_gate_qubits(w2, [rank[w] for w in wires], k)
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
    on the ``(2, A, K, B)`` view, four real matrix products.

    A batched state ``(2, Bt, 2**n)`` folds its batch into A with a shared
    ``(2, K, K)`` window, or takes a per-element ``(Bt, 2, K, K)`` one."""
    K = 2**k
    A = 2**a
    if is_batched(psi2) and w2.dim() == 4:
        x = psi2.reshape(2, psi2.shape[1], A, K, -1)
        wr, wi = w2[:, 0, None], w2[:, 1, None]
        yr = wr @ x[0] - wi @ x[1]
        yi = wr @ x[1] + wi @ x[0]
        return torch.stack([yr, yi]).reshape(psi2.shape)
    x = psi2.reshape(2, -1, K, 2 ** (n - a - k))
    wr, wi = w2[0], w2[1]
    yr = _real_window_product(wr, x[0]) - _real_window_product(wi, x[1])
    yi = _real_window_product(wr, x[1]) + _real_window_product(wi, x[0])
    return torch.stack([yr, yi]).reshape(psi2.shape)


def window_apply_top_plain(
    psi2: torch.Tensor, w2: torch.Tensor, k: int, n: int
) -> torch.Tensor:
    """Plain version of the top-window kernel: support ``[n-k, n)``, so the
    window axis is the contiguous one and ``Y = X W^T`` on ``(2, A, K)``
    (``(2, Bt, A, K)`` for a batched state, W shared or per element)."""
    K = 2**k
    x = psi2.reshape(2, -1, K) if w2.dim() == 3 else psi2.reshape(2, psi2.shape[1], -1, K)
    wrT, wiT = w2[..., 0, :, :].mT, w2[..., 1, :, :].mT
    yr = x[0] @ wrT - x[1] @ wiT
    yi = x[0] @ wiT + x[1] @ wrT
    return torch.stack([yr, yi]).reshape(psi2.shape)


def _columns(t: torch.Tensor, K: int, B: int, per_element: bool) -> torch.Tensor:
    """``(2, [Bt,] 2**n)`` -> the window's columns ``(2, K, C)``, or per
    element ``(2, Bt, K, C)``: column ``c = a*B + b`` of element e holds
    ``t[e, a, :, b]``."""
    if per_element:
        v = t.reshape(2, t.shape[1], -1, K, B).transpose(2, 3)
        return v.reshape(2, t.shape[1], K, -1)
    return t.reshape(2, -1, K, B).transpose(1, 2).reshape(2, K, -1)


def _gram(gc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """``gw = g conj(x)^T`` over the columns: Re ``gr xr^T + gi xi^T``, Im
    ``gi xr^T - gr xi^T``, stacked on the third dimension from the right."""
    gwr = gc[0] @ xc[0].mT + gc[1] @ xc[1].mT
    gwi = gc[1] @ xc[0].mT - gc[0] @ xc[1].mT
    return torch.stack([gwr, gwi], dim=-3)


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

    On a batched ``(2, Bt, 2**n)`` state a per-element ``(Bt, 2, K, K)``
    window gets one ``gw`` per element, and a shared one the sum of those
    over the batch.  ``g`` may be bfloat16; it is upcast to the working
    dtype first."""
    K = 2**k
    B = 2 ** (n - a - k)
    g = g.to(x.dtype)
    per_element = w2.dim() == 4
    gp = window_apply_plain(g, conj_pair_mat(w2), a, k, n).to(out_dtype)
    if is_batched(x):
        gw = _gram(_columns(g, K, B, True), _columns(x, K, B, True))
        return gp, gw if per_element else gw.sum(0)
    return gp, _gram(_columns(g, K, B, False), _columns(x, K, B, False))


def window_apply_top_bwd_plain(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the top-window backward kernel: for ``Y = X W^T`` on
    ``(2, A, K)``, returns ``gp = g conj(W)`` (in *out_dtype*) and
    ``gw[i, j] = sum_t g[t, i] conj(x[t, j])`` (in the working dtype); per
    element or summed over a batch as :func:`window_apply_bwd_plain`."""
    return window_apply_bwd_plain(w2, g, x, n - k, k, n, out_dtype)


def rotate_plain(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Plain version of the rotation kernel: qubit q -> (q + r) mod n, the
    transpose ``(2, X, R) -> (2, R, X)`` with ``R = 2**r``, in any dtype."""
    R = 2 ** (r % n)
    lead = tuple(psi2.shape[:-1])
    return psi2.reshape(lead + (-1, R)).transpose(-1, -2).reshape(psi2.shape)


def conj_pair_mat(w2: torch.Tensor) -> torch.Tensor:
    """Real-split conjugate transpose: (Re, Im) -> (Re^T, -Im^T), on the
    last three dimensions (a per-element ``(Bt, 2, K, K)`` window too)."""
    return torch.stack([w2[..., 0, :, :].mT, -w2[..., 1, :, :].mT], dim=-3)


def adjoint_step_plain(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, a: int, k: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the adjoint step kernel on ``[a, a+k)``, ``a + k <
    n``: from the step's output ``psi2`` and cotangent ``lam2`` returns
    ``psi_prev = W^† psi``, ``lam_prev = W^† lam`` (cast to *lam_dtype*) and
    ``gw = sum lam psi_prev^†`` in the working dtype of ``psi2``.  A
    bfloat16 ``lam2`` is upcast first: it is the window backward on the
    rebuilt input."""
    psi_prev = window_apply_plain(psi2, conj_pair_mat(w2), a, k, n)
    lam_prev, gw = window_apply_bwd_plain(w2, lam2, psi_prev, a, k, n, lam_dtype)
    return psi_prev, lam_prev, gw


def adjoint_step_top_plain(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, k: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the top-window adjoint step on ``[n-k, n)``:
    ``psi_prev = psi conj(W)``, ``lam_prev = lam conj(W)`` (cast to
    *lam_dtype*), ``gw[i, j] = sum_t lam[t, i] conj(psi_prev[t, j])``."""
    psi_prev = window_apply_top_plain(psi2, conj_pair_mat(w2), k, n)
    lam_prev, gw = window_apply_top_bwd_plain(w2, lam2, psi_prev, k, n, lam_dtype)
    return psi_prev, lam_prev, gw


def rotate_pair_plain(
    psi2: torch.Tensor, lam2: torch.Tensor, r: int, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the paired rotation kernel: both arrays rotated by
    ``q -> (q + r) mod n``, each in its own dtype."""
    return rotate_plain(psi2, r, n), rotate_plain(lam2, r, n)


# Fused (rotation, window) steps of the layout scheduler
# (``simulation.fuse_layout_rotations``): each plain version is the two-pass
# composition of the rotation and the window on ``[0, k)``.


def rotmat_apply_plain(psi2: torch.Tensor, w2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Plain version of the rotmat kernel: the rotation by ``r``, then the
    window on the rotated-in wires ``[0, r)``."""
    return window_apply_plain(rotate_plain(psi2, r, n), w2, 0, r, n)


def rotwin_apply_plain(
    psi2: torch.Tensor, w2: torch.Tensor, r: int, k: int, n: int
) -> torch.Tensor:
    """Plain version of the rotwin kernel: the rotation by ``r``, then the
    window on ``[0, k)``, ``k > r``."""
    return window_apply_plain(rotate_plain(psi2, r, n), w2, 0, k, n)


def matrot_apply_plain(psi2: torch.Tensor, w2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Plain version of the matrot kernel: the window on ``[0, n-r)``, then
    the rotation by ``r``."""
    return rotate_plain(window_apply_plain(psi2, w2, 0, n - r, n), r, n)


def rotmat_apply_bwd_plain(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, r: int, n: int, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`rotmat_apply_plain` from the saved pre-rotation
    input ``x``: ``gp`` (in *out_dtype*, pre-rotation layout) and ``gw``."""
    return rotwin_apply_bwd_plain(w2, g, x, r, r, n, out_dtype)


def rotwin_apply_bwd_plain(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, r: int, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`rotwin_apply_plain`: the window backward on the
    rotated input, and ``gp`` rotated back."""
    gp, gw = window_apply_bwd_plain(w2, g, rotate_plain(x, r, n), 0, k, n, out_dtype)
    return rotate_plain(gp, n - r, n), gw


def matrot_apply_bwd_plain(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, r: int, n: int, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`matrot_apply_plain`: ``g`` rotated back, then the
    window backward on ``x``."""
    return window_apply_bwd_plain(w2, rotate_plain(g, n - r, n), x, 0, n - r, n, out_dtype)


def adjoint_rotmat_plain(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, r: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the rotmat adjoint step: the window's adjoint step on
    ``[0, r)``, then both arrays rotated back by ``n - r``; returns
    ``(psi_in, lam_in, gw)``."""
    psi_mid, lam_mid, gw = adjoint_step_plain(w2, psi2, lam2, 0, r, n, lam_dtype)
    return (*rotate_pair_plain(psi_mid, lam_mid, n - r, n), gw)


def adjoint_matrot_plain(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, r: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the matrot adjoint step: both arrays rotated back by
    ``n - r``, then the window's adjoint step on ``[0, n-r)``."""
    psi_mid, lam_mid = rotate_pair_plain(psi2, lam2, n - r, n)
    return adjoint_step_plain(w2, psi_mid, lam_mid, 0, n - r, n, lam_dtype)


def apply_fused_pair_ri(
    psi2: torch.Tensor, w2: torch.Tensor, kind: str, r: int, k: int, n: int
) -> torch.Tensor:
    """One fused plan step with its window as a ``(2, K, K)`` pair:
    ``"matrot"`` (window on ``[0, k)``, ``k = n - r``, then the rotation),
    or ``"rotmat"`` (the rotation, then the window on ``[0, k)``; ``k == r``
    is the rotmat kernel, ``k > r`` the rotwin kernel)."""
    w2 = w2.to(device=psi2.device, dtype=psi2.dtype).contiguous()
    if kind == "matrot":
        return cuda_kernels.matrot_apply(psi2, w2, r, n)
    if k == r:
        return cuda_kernels.rotmat_apply(psi2, w2, r, n)
    return cuda_kernels.rotwin_apply(psi2, w2, r, k, n)


# Chain steps (``ops/chains.py``): a list of descriptors in bit coordinates
# applied in order, ``("win", lo, hi)`` the window on wires ``[n-hi, n-lo)``
# with a ``(2, K, K)`` payload, ``("diag", bits)`` the diagonal on wires
# ``n-1-b`` with a ``(2, 2**len(bits))`` payload indexed MSB first (payload
# index v = sum_i bit_i 2**(len-1-i)).


def _bit_axes(t: torch.Tensor, bits: Sequence[int], n: int) -> torch.Tensor:
    """``(2, 2**n)`` -> a view with one size-2 axis per bit (descending, so
    the bit axes come in payload order) between the other bits' runs."""
    shape, prev = [], n
    for b in bits:
        shape += [2 ** (prev - b - 1), 2]
        prev = b
    return t.reshape(2, *shape, 2**prev)


def _diag_view(d2: torch.Tensor, k: int) -> torch.Tensor:
    """A ``(2, 2**k)`` diagonal pair shaped to broadcast against
    :func:`_bit_axes`."""
    return d2.reshape(2, *[s for _ in range(k) for s in (1, 2)], 1)


def _complex_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]])


def chain_apply_plain(
    psi2: torch.Tensor, payloads: Sequence[torch.Tensor], geom: tuple, descs: tuple, n: int
) -> torch.Tensor:
    """Plain version of the chain kernel: the descriptors one after the
    other on the whole state (the geometry only shapes the kernel's blocks)."""
    for d, p in zip(descs, payloads):
        if d[0] == "win":
            lo, hi = d[1], d[2]
            psi2 = window_apply_plain(psi2, p, n - hi, hi - lo, n)
        else:
            bits = d[1]
            psi2 = _complex_mul(_diag_view(p, len(bits)), _bit_axes(psi2, bits, n))
            psi2 = psi2.reshape(2, 2**n)
    return psi2


def adjoint_chain_plain(
    psi2: torch.Tensor, lam2: torch.Tensor, payloads: Sequence[torch.Tensor], geom: tuple,
    descs: tuple, n: int,
) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Plain version of the chain adjoint kernel: from the step's output
    ``psi2`` and its cotangent ``lam2`` (taken to ``psi2``'s dtype), walks
    the descriptors in reverse and returns ``(psi_prev, lam_prev, grads)``
    with one cotangent per descriptor.  At each descriptor the gram is taken
    on the current (output-side) pair, then both are undone:

    * a window: ``G0 = sum lam psi^dag`` over the window axis' columns, undo
      with ``W^dag``, cotangent ``gw = G0 W``;
    * a diagonal: ``G0[v] = sum_{idx = v} lam conj(psi)``, undo with
      ``conj(d)``, cotangent ``gd = d G0``."""
    lam2 = lam2.to(psi2.dtype)
    grads: list = [None] * len(descs)
    for j in range(len(descs) - 1, -1, -1):
        d, p = descs[j], payloads[j]
        if d[0] == "win":
            lo, hi = d[1], d[2]
            a, k = n - hi, hi - lo
            K = 2**k
            lc = lam2.reshape(2, 2**a, K, -1).transpose(1, 2).reshape(2, K, -1)
            pc = psi2.reshape(2, 2**a, K, -1).transpose(1, 2).reshape(2, K, -1)
            g0 = torch.stack([lc[0] @ pc[0].T + lc[1] @ pc[1].T,
                              lc[1] @ pc[0].T - lc[0] @ pc[1].T])
            wh = conj_pair_mat(p)
            psi2 = window_apply_plain(psi2, wh, a, k, n)
            lam2 = window_apply_plain(lam2, wh, a, k, n)
            grads[j] = torch.stack([g0[0] @ p[0] - g0[1] @ p[1], g0[0] @ p[1] + g0[1] @ p[0]])
        else:
            bits = d[1]
            k = len(bits)
            pv, lv = _bit_axes(psi2, bits, n), _bit_axes(lam2, bits, n)
            rest = tuple(range(0, 2 * k + 1, 2))  # the other bits' runs
            g0 = torch.stack([(lv[0] * pv[0] + lv[1] * pv[1]).sum(dim=rest),
                              (lv[1] * pv[0] - lv[0] * pv[1]).sum(dim=rest)]).reshape(2, -1)
            dh = _diag_view(torch.stack([p[0], -p[1]]), k)
            psi2 = _complex_mul(dh, pv).reshape(2, 2**n)
            lam2 = _complex_mul(dh, lv).reshape(2, 2**n)
            grads[j] = _complex_mul(p, g0)
    return psi2, lam2, tuple(grads)


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
    lead = tuple(psi.shape[:-1])
    return psi.reshape(lead + (-1, R)).transpose(-1, -2).reshape(psi.shape)


def _rotate_qubits_ri(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Cyclic qubit rotation of the real-split state: q -> (q + r) mod n."""
    if r % n == 0:
        return psi2
    return cuda_kernels.rotate(psi2, r % n, n)


def _move_axis_front_ri(psi2: torch.Tensor, p: int) -> torch.Tensor:
    """Move conceptual qubit axis *p* to the front, per component (and per
    element of a batched state)."""
    return _move_axis_front(psi2, p, 0)


def _move_front_to_ri(psi2: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`_move_axis_front_ri`."""
    return _move_front_to(psi2, p, 0)


def apply_diagonal_flat_ri(
    psi2: torch.Tensor, diag: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Real-split diagonal gate: a broadcast complex multiply in real parts."""
    return apply_diagonal_pair_ri(psi2, _pair_of(diag, psi2, vector=True), wires, n)


def apply_diagonal_pair_ri(
    psi2: torch.Tensor, d2: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Diagonal gate given as a stacked ``(2, 2**k)`` (Re, Im) pair; on a
    batched ``(2, Bt, 2**n)`` state it may be per element, ``(Bt, 2, 2**k)``."""
    d2 = d2.to(device=psi2.device, dtype=psi2.dtype)
    wires = [int(w) for w in wires]
    k = len(wires)
    srt = sorted(wires)
    lead = tuple(d2.shape[:-2])
    if wires != srt:
        o = len(lead) + 1
        order = [o + wires.index(w) for w in srt]
        d2 = d2.reshape(lead + (2,) + (2,) * k).permute(*range(o), *order).reshape(d2.shape)
    if lead:
        d2 = d2.transpose(0, 1)  # (2, Bt, 2**k) against (2, Bt, ...) states
    dr, di = d2[0], d2[1]

    def mul(t, dr_b, di_b):
        tr, ti = t[0], t[1]
        return torch.stack([tr * dr_b - ti * di_b, tr * di_b + ti * dr_b])

    slead = tuple(psi2.shape[1:-1])
    dim = psi2.shape[-1]
    if _contiguous(srt):
        A = 2 ** srt[0]
        t = psi2.reshape((2,) + slead + (A, 2**k, dim // (A * 2**k)))
        return mul(t, dr[..., None, :, None], di[..., None, :, None]).reshape(psi2.shape)

    pulls, restores = _gather_plan(tuple(srt))
    for p in pulls:
        psi2 = _move_axis_front_ri(psi2, p)
    t = psi2.reshape((2,) + slead + (2**k, -1))
    psi2 = mul(t, dr[..., :, None], di[..., :, None]).reshape((2,) + slead + (dim,))
    for p in restores:
        psi2 = _move_front_to_ri(psi2, p)
    return psi2


# ---------------------------------------------------------------------------
# State constructors & measurement reductions
# ---------------------------------------------------------------------------


def zero_state_ri(
    n_qubits: int, dtype: torch.dtype = torch.float32, device=None,
    batch: Optional[int] = None,
) -> torch.Tensor:
    """|0...0> as a stacked (2, 2**n) real pair, or ``(2, batch, 2**n)``."""
    lead = () if batch is None else (batch,)
    psi2 = torch.zeros((2,) + lead + (2**n_qubits,), dtype=dtype, device=device)
    psi2[0, ..., 0] = 1.0
    return psi2


def zero_density_ri(
    n_qubits: int, dtype: torch.dtype = torch.float32, device=None,
    batch: Optional[int] = None,
) -> torch.Tensor:
    """|0><0| as a stacked (2, 4**n) real pair, or ``(2, batch, 4**n)``."""
    return zero_state_ri(2 * n_qubits, dtype, device, batch)


# ---------------------------------------------------------------------------
# Density-matrix application (rho flat over 2n conceptual qubits: ket wires
# 0..n-1, bra wires n..2n-1); plain tensor code in the JAX package too
# ---------------------------------------------------------------------------


def apply_unitary_to_density_flat_ri(
    rho2: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n_qubits: int
) -> torch.Tensor:
    """Real-split ``rho -> U rho U†`` over the flat 2n-qubit density state:
    U on the ket wires, conj(U) on the bra wires."""
    wires = list(wires)
    rho2 = apply_matrix_flat_ri(rho2, mat, wires, 2 * n_qubits)
    bra = [w + n_qubits for w in wires]
    return apply_matrix_flat_ri(rho2, torch.conj_physical(mat), bra, 2 * n_qubits)


def apply_kraus_to_density_flat_ri(
    rho2: torch.Tensor,
    kraus: Sequence[torch.Tensor],
    wires: Sequence[int],
    n_qubits: int,
) -> torch.Tensor:
    """Real-split ``rho -> sum_k K_k rho K_k†`` (per-operator loop)."""
    out = None
    for K in kraus:
        branch = apply_unitary_to_density_flat_ri(rho2, K, wires, n_qubits)
        out = branch if out is None else out + branch
    return out


# ---------------------------------------------------------------------------
# Complex-state entry points (the JAX package's API; the Operation methods,
# the sharded simulator's rank-n tensors).  Each one splits the state with
# to_ri, runs the real-split route above (on the card: the window,
# top-window and rotation kernels) and joins it with from_ri.
# ---------------------------------------------------------------------------


def apply_diagonal_flat(
    psi: torch.Tensor, diag: torch.Tensor, wires: Sequence[int], n: int
) -> torch.Tensor:
    """Diagonal gate on a flat complex state (a broadcast multiply)."""
    return from_ri(apply_diagonal_flat_ri(to_ri(psi), diag, wires, n))


def apply_matrix(tensor: torch.Tensor, mat: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Rank-n ``(2,)*n`` tensor entry point: the flat state in the tensor's
    axis order (``reshape(-1)``), one gate, the same shape back."""
    r = tensor.dim()
    flat = apply_matrix_flat_ri(to_ri(tensor.reshape(-1)), mat, list(axes), r)
    return from_ri(flat).reshape(tensor.shape)


def apply_diagonal(tensor: torch.Tensor, diag: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Rank-n diagonal entry point."""
    r = tensor.dim()
    return apply_diagonal_flat(tensor.reshape(-1), diag, list(axes), r).reshape(tensor.shape)


def apply_unitary_to_density_flat(
    rho_flat: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n_qubits: int
) -> torch.Tensor:
    """``rho -> U rho U†`` with rho flat over ``2n`` conceptual qubits (ket
    wires first, then bra wires)."""
    return from_ri(apply_unitary_to_density_flat_ri(to_ri(rho_flat), mat, wires, n_qubits))


def apply_unitary_to_density(
    rho_t: torch.Tensor, mat: torch.Tensor, wires: Sequence[int], n_qubits: int
) -> torch.Tensor:
    """Rank-2n tensor entry point for ``rho -> U rho U†``."""
    flat = apply_unitary_to_density_flat(rho_t.reshape(-1), mat, wires, n_qubits)
    return flat.reshape(rho_t.shape)


def apply_kraus_to_density_flat(
    rho_flat: torch.Tensor,
    kraus: Sequence[torch.Tensor],
    wires: Sequence[int],
    n_qubits: int,
) -> torch.Tensor:
    """``rho -> sum_k K_k rho K_k†`` on a flat density state."""
    return from_ri(apply_kraus_to_density_flat_ri(to_ri(rho_flat), kraus, wires, n_qubits))


def apply_kraus_to_density(
    rho_t: torch.Tensor,
    kraus: Sequence[torch.Tensor],
    wires: Sequence[int],
    n_qubits: int,
) -> torch.Tensor:
    """Rank-2n tensor entry point for the Kraus application."""
    flat = apply_kraus_to_density_flat(rho_t.reshape(-1), kraus, wires, n_qubits)
    return flat.reshape(rho_t.shape)


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype in (torch.complex128, torch.float64) else torch.float32


def zero_state(n_qubits: int, dtype: torch.dtype = torch.complex64,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """|0...0> as a flat complex vector (*dtype* complex or its real
    counterpart), on *device*: the card unless the caller asks for the CPU."""
    return from_ri(zero_state_ri(n_qubits, _real_of(dtype), resolve_device(device)))


def zero_state_tensor(n_qubits: int, dtype: torch.dtype = torch.complex64,
                      device=DEFAULT_DEVICE) -> torch.Tensor:
    """|0...0> as a rank-n tensor."""
    return zero_state(n_qubits, dtype, device).reshape((2,) * n_qubits)


def zero_density(n_qubits: int, dtype: torch.dtype = torch.complex64,
                 device=DEFAULT_DEVICE) -> torch.Tensor:
    """|0><0| as a flat vector over ``2n`` conceptual qubits."""
    return zero_state(2 * n_qubits, dtype, device)


def zero_density_tensor(n_qubits: int, dtype: torch.dtype = torch.complex64,
                        device=DEFAULT_DEVICE) -> torch.Tensor:
    """|0><0| as a rank-2n tensor."""
    return zero_density(n_qubits, dtype, device).reshape((2,) * (2 * n_qubits))


def reduce_diagonal_expectation(
    probs: torch.Tensor, qubit_weights: Sequence[Optional[Tuple[float, float]]]
) -> torch.Tensor:
    """⟨⊗_q D_q⟩ for per-qubit diagonal factors from a probability vector.

    ``qubit_weights[q]`` is ``(d0, d1)`` for qubits in the observable's
    support and ``None`` (trace out) elsewhere.  A halving fold: one weighted
    pairwise reduction per qubit, total traffic ``~2 * 2**n``.
    """
    lead = tuple(probs.shape[:-1]) if probs.dim() > 1 else ()
    v = probs
    for q in reversed(range(len(qubit_weights))):
        v = v.reshape(lead + (-1, 2))
        w = qubit_weights[q]
        if w is None:
            v = v[..., 0] + v[..., 1]
        else:
            v = w[0] * v[..., 0] + w[1] * v[..., 1]
    return v.reshape(lead)


def marginal_probs_on(probs: torch.Tensor, keep: Sequence[int], n: int) -> torch.Tensor:
    """Marginal distribution over the *keep* qubits (sorted order), per row
    of a ``(Bt, 2**n)`` batch."""
    lead = tuple(probs.shape[:-1])
    v = probs
    for q in sorted(set(range(n)) - set(int(k) for k in keep), reverse=True):
        A = 2**q
        v = v.reshape(lead + (A, 2, -1)).sum(dim=-2).reshape(lead + (-1,))
    return v


def marginal_qubit_probs(probs_t: torch.Tensor, qubit: int) -> torch.Tensor:
    """Marginal ``(p0, p1)`` of one qubit from a probability tensor/vector."""
    flat = probs_t.reshape(-1)
    A = 2**qubit
    return flat.reshape(A, 2, -1).sum(dim=(0, 2))
