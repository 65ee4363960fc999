"""Quantum-information math utilities: fidelity, distances, QFI.

Everything runs on the states' device through eigendecompositions
(``torch.linalg.eigh``; no ``sqrtm``); only :func:`logm_v` goes to the
host (scipy), since PyTorch has no matrix logarithm.

The quantum Fisher information and the Fubini-Study metric need the
Jacobian of the state with respect to the parameters.  The JAX package
takes it in forward mode (``jax.jacfwd``); the port's executors and kernels
are ``torch.autograd.Function`` objects with backwards only, so the
Jacobian here is taken in **reverse mode**: one backward through the
executor per real output row (the real and imaginary parts of each of the
``2^n`` amplitudes, or ``4^n`` density entries), each through the kernels'
own backwards on the card.  That is ``2·2^n`` backwards where forward mode
would take one pass per parameter: cheaper whenever ``2·2^n`` is below the
parameter count, and never more than a few dozen backwards at the 2-4
qubit widths the metric is used at.

Counterpart of ``qml_essentials_tpu/analysis/math.py``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.ops.dtypes import cdtype


def _as_complex(x) -> torch.Tensor:
    """A state as a complex tensor: tensors keep their precision and
    device, numpy arrays and lists become CPU tensors of theirs."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if not t.is_floating_point() and not t.is_complex():
        t = t.to(torch.float64)
    return t if t.is_complex() else t.to(cdtype(t.dtype))


def _pair(state0, state1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both states complex, in their common precision, on the first's device."""
    s0, s1 = _as_complex(state0), _as_complex(state1)
    cd = torch.promote_types(s0.dtype, s1.dtype)
    s0, s1 = s0.to(cd), s1.to(device=s0.device, dtype=cd)
    if s0.shape[-1] != s1.shape[-1]:
        raise ValueError("The two states must have the same number of wires.")
    return s0, s1


def _hermitian(m: torch.Tensor) -> torch.Tensor:
    """The Hermitian part of a (batch of) square matrices, as the JAX
    package's ``eigh`` symmetrises its input."""
    return (m + m.conj().transpose(-1, -2)) / 2


def logm_v(A, **kwargs) -> torch.Tensor:
    """Matrix logarithm, batched over an optional leading axis (host scipy);
    returns a complex tensor on *A*'s device."""
    from scipy.linalg import logm

    t = _as_complex(A)
    host = t.detach().cpu().numpy()
    if host.ndim == 2:
        out = logm(host, **kwargs)
    elif host.ndim == 3:
        out = np.stack([logm(a, **kwargs) for a in host])
    else:
        raise NotImplementedError("Unsupported shape of input matrix")
    return torch.as_tensor(np.asarray(out), device=t.device).to(t.dtype)


def _sqrt_matrix(density_matrix: torch.Tensor) -> torch.Tensor:
    """PSD matrix square root via eigendecomposition (batch-aware).

    Negative eigenvalues (numerical noise) are clamped to zero.
    """
    evs, vecs = torch.linalg.eigh(_hermitian(density_matrix))
    sqrt_evs = torch.sqrt(evs.clamp(min=0.0)).to(vecs.dtype)
    # V diag(sqrt) V† via broadcasting over the optional batch axis.
    scaled = vecs * sqrt_evs[..., None, :]
    return scaled @ vecs.conj().transpose(-1, -2)


def _fidelity_statevector(state0: torch.Tensor, state1: torch.Tensor) -> torch.Tensor:
    """``|<psi|phi>|^2`` with defensive normalisation; batch-aware."""
    norm0 = torch.linalg.vector_norm(state0, dim=-1, keepdim=True)
    norm1 = torch.linalg.vector_norm(state1, dim=-1, keepdim=True)
    state0 = state0 / torch.where(norm0 > 0, norm0, torch.ones_like(norm0))
    state1 = state1 / torch.where(norm1 > 0, norm1, torch.ones_like(norm1))
    overlap = torch.sum(state0.conj() * state1, dim=-1)
    return overlap.abs() ** 2


def _fidelity_dm(state0: torch.Tensor, state1: torch.Tensor) -> torch.Tensor:
    """Uhlmann fidelity ``(Tr sqrt(sqrt(r0) r1 sqrt(r0)))^2``; batch-aware."""
    sqrt0 = _sqrt_matrix(state0)
    product = sqrt0 @ state1 @ sqrt0
    evs = torch.linalg.eigvalsh(_hermitian(product)).clamp(min=0.0)
    return torch.sum(torch.sqrt(evs), dim=-1) ** 2


def _is_statevector(state: torch.Tensor) -> bool:
    return state.ndim <= 2 and (
        state.ndim == 1 or state.shape[-2] != state.shape[-1]
    )


def fidelity(state0, state1) -> torch.Tensor:
    """Fidelity of two states; dispatches on vectors vs density matrices."""
    state0, state1 = _pair(state0, state1)
    is_sv0 = _is_statevector(state0)
    is_sv1 = _is_statevector(state1)
    if is_sv0 != is_sv1:
        raise ValueError(
            "Both states must be of the same kind "
            "(both state vectors or both density matrices)."
        )
    return _fidelity_statevector(state0, state1) if is_sv0 else _fidelity_dm(
        state0, state1
    )


def trace_distance(state0, state1) -> torch.Tensor:
    """Trace distance ``0.5 * ||r0 - r1||_1`` of density matrices (batch-aware)."""
    state0, state1 = _pair(state0, state1)
    eigvals = torch.linalg.eigvalsh(_hermitian(state0 - state1)).abs()
    return torch.sum(eigvals, dim=-1) / 2


def phase_difference(state0, state1) -> torch.Tensor:
    """Relative phase ``angle(<psi0|psi1>)`` of two state vectors (batch-aware)."""
    state0, state1 = _pair(state0, state1)
    inner = torch.sum(state0.conj() * state1, dim=-1)
    return torch.angle(inner)


def _fubini_study_statevector(jac: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """``g_ij = Re[<d_i psi|d_j psi> - <d_i psi|psi><psi|d_j psi>]``."""
    jh = jac.conj().T
    A = jh @ jac
    v = jh @ state
    return (A - torch.outer(v, v.conj())).real


def _qfi_statevector(jac: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Pure-state QFI: four times the Fubini-Study metric."""
    return 4.0 * _fubini_study_statevector(jac, state)


def _qfi_density(
    jac: torch.Tensor, state: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """Mixed-state QFI via the symmetric logarithmic derivative eigen-sum."""
    evals, evecs = torch.linalg.eigh(_hermitian(state))
    evals = evals.clamp(min=0.0)

    drho = torch.movedim(jac, -1, 0)  # (P, d, d)
    M = evecs.conj().T @ drho @ evecs

    s = evals[:, None] + evals[None, :]
    safe = torch.where(s > eps, s, torch.ones_like(s))
    weights = torch.where(s > eps, 2.0 / safe, torch.zeros_like(s))

    F = torch.einsum("ikl,jkl->ij", M * weights[None], M.conj())
    return F.real


def _state_and_jacobian(state_fn: Callable, params) -> Tuple[torch.Tensor, torch.Tensor]:
    """State and its Jacobian at *params* (complex; the Jacobian's last
    axis runs over the flattened parameters), in reverse mode: one
    backward per real output row, each through the executors' backwards."""
    p = (params if isinstance(params, torch.Tensor) else torch.as_tensor(np.asarray(params)))
    p = p.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        state = _as_complex(state_fn(p))
        rows = torch.view_as_real(state).reshape(-1)
        grads = []
        for i in range(rows.numel()):
            (g,) = torch.autograd.grad(rows[i], p, retain_graph=i + 1 < rows.numel(),
                                       allow_unused=True)
            grads.append(torch.zeros_like(p) if g is None else g)
    real = torch.stack(grads).reshape(*state.shape, 2, p.numel()).to(state.real.dtype)
    jac = torch.complex(real[..., 0, :], real[..., 1, :]).to(state.device)
    return state.detach(), jac


def quantum_fisher_information(state_fn: Callable, params) -> torch.Tensor:
    """QFI matrix at *params*; dispatches pure (Fubini-Study) vs mixed (SLD).

    ``state_fn`` maps parameters to a state vector or density matrix, e.g.
    ``lambda p: model(params=p, inputs=x)`` with ``execution_type="state"``.
    """
    state, jac = _state_and_jacobian(state_fn, params)
    if state.ndim == 1:
        return _qfi_statevector(jac.reshape(state.shape[0], -1), state)
    if state.ndim == 2 and state.shape[-1] == state.shape[-2]:
        return _qfi_density(jac.reshape(state.shape[0], state.shape[1], -1), state)
    raise ValueError(
        "state_fn must return a state vector of shape (d,) or a density "
        f"matrix of shape (d, d), got shape {tuple(state.shape)}."
    )


def fubini_study_metric(state_fn: Callable, params) -> torch.Tensor:
    """Fubini-Study metric at *params* (pure states only): ``F = 4 g``."""
    state, jac = _state_and_jacobian(state_fn, params)
    if state.ndim != 1:
        raise ValueError(
            "The Fubini-Study metric is only defined for pure states; "
            f"state_fn must return a state vector of shape (d,), got shape "
            f"{tuple(state.shape)}."
        )
    return _fubini_study_statevector(jac.reshape(state.shape[0], -1), state)
