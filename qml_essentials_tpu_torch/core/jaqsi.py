"""Public circuit-building entry point (the "jaqsi" surface).

Exposes :class:`Script`, the :func:`Hamiltonian` factory and
quantum-information utilities (partial trace, probability marginalisation,
parity observables).

Counterpart of ``qml_essentials_tpu/core/jaqsi.py``.
"""

from __future__ import annotations

from functools import reduce
from typing import List, Tuple, Union

import torch

from qml_essentials_tpu_torch.core.executor import Script  # noqa: F401
from qml_essentials_tpu_torch.ops.operations import (  # noqa: F401
    Hermitian,
    ParametrizedHamiltonian,
    PauliZ,
)
from qml_essentials_tpu_torch.pulse.evolution import Evolution  # noqa: F401


def Hamiltonian(
    matrix,
    wires: Union[int, List[int]] = 0,
    record: bool = False,
) -> Hermitian:
    """Static Hamiltonian factory — a :class:`Hermitian` with ``record=False``.

    Multiply by a ``f(params, t)`` callable to obtain a time-dependent
    :class:`ParametrizedHamiltonian`; both expose ``.evolve()``.
    """
    return Hermitian(matrix, wires=wires, record=record)


def _partial_trace_single(rho: torch.Tensor, n_qubits: int, keep: List[int]) -> torch.Tensor:
    """Partial trace of one ``(2**n, 2**n)`` density matrix, one traced qubit
    at a time on a 6-axis view (no view needs more axes than that)."""
    n = n_qubits
    for q in sorted(set(range(n_qubits)) - set(keep), reverse=True):
        a, b = 2**q, 2 ** (n - q - 1)
        rho = torch.diagonal(rho.reshape(a, 2, b, a, 2, b), dim1=1, dim2=4).sum(-1)
        n -= 1
        rho = rho.reshape(2**n, 2**n)
    return rho


def partial_trace(rho: torch.Tensor, n_qubits: int, keep: List[int]) -> torch.Tensor:
    """Partial trace keeping only the *keep* qubits (in ascending wire
    order); supports a leading batch axis."""
    dim = 2**n_qubits
    if tuple(rho.shape) == (dim, dim):
        return _partial_trace_single(rho, n_qubits, keep)
    return torch.stack([_partial_trace_single(r, n_qubits, keep) for r in rho])


def marginalize_probs(
    probs: torch.Tensor, n_qubits: int, keep: Tuple[int, ...]
) -> torch.Tensor:
    """Marginalise probability vector(s) onto the *keep* qubits; returns
    ``(batch, 2**len(keep))`` (batch 1 for a single vector)."""
    dim = 2**n_qubits
    reduce_axes = tuple(q for q in range(n_qubits) if q not in keep)
    batch = probs.reshape(-1, dim)
    t = batch.reshape((batch.shape[0],) + (2,) * n_qubits)
    if reduce_axes:
        t = t.sum(dim=tuple(1 + q for q in reduce_axes))
    return t.reshape(batch.shape[0], -1)


def build_parity_observable(qubit_group: List[int]) -> Hermitian:
    """Multi-qubit Z-parity observable Z⊗...⊗Z on *qubit_group*, tagged with
    ``_pauli_label`` so the diagonal measurement never needs its matrix."""
    mat = reduce(torch.kron, [PauliZ._matrix] * len(qubit_group))
    obs = Hermitian(matrix=mat, wires=qubit_group, record=False)
    obs._pauli_label = "Z" * len(qubit_group)
    return obs
