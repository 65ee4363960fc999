"""Unitary gate frontend: static gate wrappers.

``UnitaryGates`` methods emit the operation onto the active tape.  In the
JAX package they also perturb angles with Gaussian ``GateError`` noise and
append Kraus channels; those need the density slice, so a non-empty
``noise_params`` raises ``NotImplementedError`` here.  Also hosts the Golomb
ruler construction used by the Golomb data encoding.

Counterpart of ``qml_essentials_tpu/models/unitary.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from qml_essentials_tpu_torch.ops import operations as op
from qml_essentials_tpu_torch.ops.operations import _param

Wires = Union[int, List[int]]

_GOLOMB_RULER_CACHE: Dict[int, Tuple[int, ...]] = {}


def _greedy_golomb(d: int) -> Tuple[int, ...]:
    """Greedy Golomb ruler: each new mark keeps all pairwise differences distinct."""
    marks: list = [0] if d > 0 else []
    seen_diffs: set = set()
    candidate = 0
    while len(marks) < d:
        candidate += 1
        fresh = {candidate - m for m in marks}
        if len(fresh) == len(marks) and fresh.isdisjoint(seen_diffs):
            marks.append(candidate)
            seen_diffs.update(fresh)
    return tuple(marks)


def golomb_ruler(d: int) -> Tuple[int, ...]:
    """Valid (greedy, cached) Golomb ruler of order *d* (Peters et al.,
    arXiv:2209.05523, App. C.4)."""
    if d <= 0:
        raise ValueError(f"Golomb ruler order must be positive, got {d}")
    if d not in _GOLOMB_RULER_CACHE:
        _GOLOMB_RULER_CACHE[d] = _greedy_golomb(d)
    return _GOLOMB_RULER_CACHE[d]


def _no_noise(noise_params: Optional[Dict]) -> None:
    if noise_params is not None:
        raise NotImplementedError(
            "gate noise (Kraus channels, GateError) comes with the density slice"
        )


class UnitaryGates:
    """Static unitary gate wrappers."""

    @staticmethod
    def Rot(phi, theta, omega, wires, noise_params=None, random_key=None) -> None:
        """General rotation."""
        _no_noise(noise_params)
        op.Rot(phi, theta, omega, wires=wires)

    @staticmethod
    def PauliRot(theta, pauli, wires, noise_params=None, random_key=None) -> None:
        """Multi-qubit Pauli rotation."""
        _no_noise(noise_params)
        op.PauliRot(theta, pauli, wires=wires)

    @staticmethod
    def GolombEncoding(w, wires, noise_params=None, random_key=None) -> None:
        """Diagonal encoding ``S(x) = exp(-i diag(golomb marks) x)`` on all wires."""
        _no_noise(noise_params)
        wires_list = [wires] if isinstance(wires, int) else list(wires)
        w = _param(w)
        marks = torch.tensor(
            golomb_ruler(2 ** len(wires_list)), dtype=w.dtype, device=w.device
        )
        op.DiagonalQubitUnitary(torch.exp(-1j * marks * w), wires=wires_list)


def _install_gate_wrappers() -> None:
    """Generate the uniform UnitaryGates wrappers from one table."""
    rotations = {
        "RX": op.RX, "RY": op.RY, "RZ": op.RZ,
        "CRX": op.CRX, "CRY": op.CRY, "CRZ": op.CRZ,
        "RXX": op.RXX, "RYY": op.RYY, "RZZ": op.RZZ, "RZX": op.RZX,
        "CPhase": op.ControlledPhaseShift,
    }
    fixed = {"CX": op.CX, "CY": op.CY, "CZ": op.CZ, "H": op.H}

    def rotation_wrapper(name, ctor):
        def gate(w, wires, noise_params=None, random_key=None):
            _no_noise(noise_params)
            ctor(w, wires=wires)

        gate.__name__ = name
        gate.__qualname__ = f"UnitaryGates.{name}"
        gate.__doc__ = f"{name} rotation."
        return staticmethod(gate)

    def fixed_wrapper(name, ctor):
        def gate(wires, noise_params=None, random_key=None):
            _no_noise(noise_params)
            ctor(wires=wires)

        gate.__name__ = name
        gate.__qualname__ = f"UnitaryGates.{name}"
        gate.__doc__ = f"{name} gate."
        return staticmethod(gate)

    for name, ctor in rotations.items():
        setattr(UnitaryGates, name, rotation_wrapper(name, ctor))
    for name, ctor in fixed.items():
        setattr(UnitaryGates, name, fixed_wrapper(name, ctor))


_install_gate_wrappers()
