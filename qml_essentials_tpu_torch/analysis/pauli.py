"""Pauli-Clifford circuit transform (canonical normal form).

Brings a recorded tape into the Nemkov et al. canonical form
(https://doi.org/10.1103/PhysRevA.108.032406): parameterised Pauli
rotations first, Clifford gates last, observables conjugated through the
Clifford tail.  All conjugation is symbolic
(:class:`~qml_essentials_tpu_torch.ops.operations.PauliWord` tableau
updates, O(n) per gate) — no state is simulated; this is host work.

Algorithm: a **single left-to-right sweep**.  Walking the tape in
application order, Clifford gates accumulate into a tail; every rotation
encountered behind a tail of ``k`` Cliffords has its generator conjugated
through those ``k`` gates once (newest first) and joins the rotation
prefix.  One pass, O(rotations × tail) symbolic updates — equivalent to,
but structurally unlike, pairwise bubbling.

Counterpart of ``qml_essentials_tpu/analysis/pauli.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.ops.operations import (
    RX,
    RY,
    RZ,
    Barrier,
    Hermitian,
    Operation,
    PauliRot,
    PauliWord,
)

_ROTATIONS = (RX, RY, RZ, PauliRot)
_IGNORED = (Barrier,)


def _decompose_to_primitives(tape: List[Operation]) -> List[Operation]:
    """Flatten the tape into Clifford + Pauli-rotation primitives."""
    prims: List[Operation] = []
    for gate in tape:
        if isinstance(gate, _IGNORED):
            continue
        if isinstance(gate, _ROTATIONS) or getattr(gate, "is_clifford", False):
            prims.append(gate)
            continue
        try:
            prims.extend(gate.decompose())
        except NotImplementedError:
            raise NotImplementedError(
                f"Gate {gate.name} cannot be decomposed into "
                "Pauli rotations and Clifford gates. Consider using a "
                "circuit ansatz that only uses RX, RY, RZ, PauliRot, "
                "Rot, and standard Clifford gates."
            )
    return prims


def _drag_rotation_left(
    rotation: Operation, tail: List[Operation], n_qubits: int
) -> Operation:
    """Move a rotation before the Clifford *tail* (newest Clifford first).

    Each hop ``C · R_P(φ) = R_{C P C†}(φ) · C`` is one tableau update;
    Cliffords disjoint from the current generator support are free.
    """
    word = PauliWord.from_operation(rotation, n_qubits)
    angle = rotation.parameters[0]
    for clifford in reversed(tail):
        if any(w in clifford.wires for w in _support(word)):
            word = word.conjugate_by_clifford(clifford, adjoint_left=False)
    label, phase = word.to_pauli_string_and_phase()
    # Conjugating a Hermitian Pauli generator keeps it Hermitian: phase ±1.
    sign = float(np.real(phase))
    label, wires = _drop_identities(label, list(range(n_qubits)))
    return PauliRot(angle * sign, label, wires)


def _support(word: PauliWord) -> List[int]:
    """Qubits on which the word acts non-trivially."""
    return [q for q in range(word.n_qubits) if word.x[q] or word.z[q]]


def _drop_identities(label: str, wires: List[int]) -> Tuple[str, List[int]]:
    """Remove 'I' factors from a Pauli label and its wire list."""
    kept = [(ch, w) for ch, w in zip(label, wires) if ch != "I"]
    if not kept:
        return "", []
    chars, ws = zip(*kept)
    return "".join(chars), list(ws)


def _word_as_observable(word: PauliWord) -> Operation:
    """Observable Operation carrying both a matrix and the symbolic word."""
    label, phase = word.to_pauli_string_and_phase()
    label, wires = _drop_identities(label, list(range(word.n_qubits)))

    if not label:
        obs = Hermitian(
            matrix=phase * torch.eye(2, dtype=torch.complex128), wires=[0], record=False
        )
        obs._pauli_label = "I"
    else:
        compact = PauliWord.from_pauli_string(
            label, list(range(len(label))), len(label)
        )
        obs = Hermitian(
            matrix=phase * compact.to_matrix(), wires=wires, record=False
        )
        obs._pauli_label = label
    obs._pauli_word = word
    return obs


class PauliCircuit:
    """Pauli-Clifford normal form: rotations first, Cliffords absorbed."""

    PAULI_ROTATION_GATES = _ROTATIONS
    SKIPPABLE_OPERATIONS = _IGNORED

    @staticmethod
    def from_parameterised_circuit(
        tape: List[Operation],
        observables: Optional[List[Operation]] = None,
        n_qubits: Optional[int] = None,
    ) -> Tuple[List[Operation], List[Operation]]:
        """Transform a tape into (Pauli rotations, evolved observables)."""
        prims = _decompose_to_primitives(tape)
        if n_qubits is None:
            wires = [
                w
                for g in list(prims) + list(observables or [])
                for w in (g.wires or [])
            ]
            n_qubits = max(wires) + 1 if wires else 1

        rotations, tail = PauliCircuit.commute_all_cliffords_to_the_end(
            prims, n_qubits
        )
        evolved = PauliCircuit.cliffords_in_observable(
            tail, observables or [], n_qubits
        )
        return rotations, evolved

    @staticmethod
    def commute_all_cliffords_to_the_end(
        operations: List[Operation], n_qubits: int
    ) -> Tuple[List[Operation], List[Operation]]:
        """Split a primitive tape into (Pauli rotations, Clifford tail).

        Single left-to-right sweep (see module docstring): Cliffords
        accumulate into a tail; each rotation met behind a tail is dragged
        before it with one symbolic conjugation per overlapping Clifford.
        """
        rotations: List[Operation] = []
        tail: List[Operation] = []
        for gate in operations:
            if isinstance(gate, _ROTATIONS):
                rotations.append(
                    _drag_rotation_left(gate, tail, n_qubits) if tail else gate
                )
            else:
                tail.append(gate)
        return rotations, tail

    @staticmethod
    def cliffords_in_observable(
        operations: List[Operation],
        original_obs: List[Operation],
        n_qubits: int,
    ) -> List[Operation]:
        """Absorb a Clifford sequence into observables (``O → C† O C`` per
        Clifford, applied newest first).  Each returned observable carries
        a matrix and the cached symbolic ``_pauli_word``.
        """
        evolved = []
        for ob in original_obs:
            word = PauliWord.from_operation(ob, n_qubits)
            for clifford in reversed(operations):
                word = word.conjugate_by_clifford(clifford, adjoint_left=True)
            evolved.append(_word_as_observable(word))
        return evolved

    @staticmethod
    def get_parameters(operations: List[Operation]) -> list:
        """Flatten the parameter values of a tape."""
        return [p for op in operations for p in op.parameters]

    # Compatibility aliases for the reference's public helpers.
    @staticmethod
    def get_clifford_pauli_gates(tape: List[Operation]) -> List[Operation]:
        """Express the tape in Clifford + Pauli-rotation primitives only."""
        return _decompose_to_primitives(tape)

    @staticmethod
    def _is_pauli_rotation(operation: Operation) -> bool:
        return isinstance(operation, _ROTATIONS)

    @staticmethod
    def _is_clifford(operation: Operation) -> bool:
        return getattr(operation, "is_clifford", False)
