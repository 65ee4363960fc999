"""Unitary gate frontend: noise-aware static gate wrappers.

``UnitaryGates`` methods (a) optionally perturb rotation angles with
Gaussian ``GateError`` noise drawn from an explicit ``torch.Generator``,
(b) emit the operation onto the active tape, and (c) append the configured
Kraus noise channels.  Also hosts the Golomb ruler construction used by the
Golomb data encoding.

The model hands every gate of one circuit layer the same generator; each
rotation draws its own sample from it (in the JAX package the gates of a
layer share a key, and so one sample).  ``batch_gate_error = False`` draws
every sample from a fresh generator seeded 0, the same for every gate and
every element of a batch, as the JAX package's fixed key does.

Counterpart of ``qml_essentials_tpu/models/unitary.py``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from qml_essentials_tpu_torch.ops import operations as op
from qml_essentials_tpu_torch.ops.operations import _param
from qml_essentials_tpu_torch.utils import GeneratorBatch

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


class UnitaryGates:
    """Static unitary gate wrappers with optional noise insertion."""

    # True: GateError draws an independent sample per batch element (each
    # element's own generator); False: one fixed sample broadcast across the
    # batch.
    batch_gate_error = True

    # ----------------------------------------------------------- noise glue
    @staticmethod
    def NQubitDepolarizingChannel(p: float, wires: List[int]) -> op.QubitChannel:
        """n-qubit depolarizing channel from the full Pauli basis (4^n Kraus ops)."""
        if not (0.0 <= p <= 1.0):
            raise ValueError(f"Probability p must be between 0 and 1, got {p}")
        n = len(wires)
        if n < 2:
            raise ValueError(f"Number of qubits must be >= 2, got {n}")
        paulis = [op.Id._matrix, op.PauliX._matrix, op.PauliY._matrix, op.PauliZ._matrix]
        dim = 2**n
        kraus = [float(np.sqrt(1 - p * (4**n - 1) / 4**n)) * torch.eye(dim, dtype=torch.complex128)]
        for idxs in itertools.product(range(4), repeat=n):
            if not any(idxs):
                continue  # the identity is K0
            P = paulis[idxs[0]]
            for i in idxs[1:]:
                P = torch.kron(P, paulis[i])
            kraus.append(float(np.sqrt(p / 4**n)) * P)
        return op.QubitChannel(kraus, wires=wires)

    @staticmethod
    def Noise(wires, noise_params: Optional[Dict[str, float]] = None) -> None:
        """Append the configured per-gate Kraus channels to the tape: BitFlip,
        PhaseFlip, Depolarizing on each wire, MultiQubitDepolarizing on a
        multi-qubit gate's wires; all default to 0."""
        if noise_params is None:
            return
        wires_list = [wires] if isinstance(wires, int) else list(wires)
        single = (
            ("BitFlip", op.BitFlip),
            ("PhaseFlip", op.PhaseFlip),
            ("Depolarizing", op.DepolarizingChannel),
        )
        for wire in wires_list:
            for knob, channel in single:
                prob = noise_params.get(knob, 0.0)
                if prob > 0:
                    channel(prob, wires=wire)
        mq = noise_params.get("MultiQubitDepolarizing", 0.0)
        if mq > 0 and len(wires_list) > 1:
            UnitaryGates.NQubitDepolarizingChannel(mq, wires_list)

    @staticmethod
    def GateError(
        w, noise_params: Optional[Dict[str, float]] = None,
        random_key: Optional[torch.Generator] = None,
    ):
        """Gaussian angle noise: returns ``(w + sigma * N(0, 1), random_key)``.

        The sample is drawn in float64 on the generator's device (the CPU
        for the model's generators) and cast to the angle's dtype and
        device, so one seed perturbs a float32 model on the card as it does a
        float64 one on the CPU.  A :class:`~qml_essentials_tpu_torch.utils.GeneratorBatch`
        (a batch recorded as one tape) draws each element's sample on its own
        generator, shaped as that element's angle."""
        sigma = (noise_params or {}).get("GateError")
        if sigma is None:
            return w, random_key
        if random_key is None:
            raise ValueError("A random_key (torch.Generator) must be provided when using GateError")
        w = _param(w)
        if isinstance(random_key, GeneratorBatch):
            own = w.shape[1:] if w.dim() and w.shape[0] == len(random_key) else w.shape
            if UnitaryGates.batch_gate_error:
                draw = random_key.randn(tuple(own), torch.float64)
            else:
                draw = torch.randn(tuple(own), generator=torch.Generator().manual_seed(0),
                                   dtype=torch.float64).expand((len(random_key),) + tuple(own))
        else:
            gen = random_key if UnitaryGates.batch_gate_error else torch.Generator().manual_seed(0)
            draw = torch.randn(w.shape, generator=gen, dtype=torch.float64, device=gen.device)
        return w + sigma * draw.to(device=w.device, dtype=w.dtype), random_key

    # --------------------------------------------------------------- gates
    @staticmethod
    def Rot(phi, theta, omega, wires, noise_params=None, random_key=None) -> None:
        """General rotation with optional GateError on each angle."""
        if noise_params is not None and "GateError" in noise_params:
            phi, theta, omega = (
                UnitaryGates.GateError(a, noise_params, random_key)[0] for a in (phi, theta, omega)
            )
        op.Rot(phi, theta, omega, wires=wires)
        UnitaryGates.Noise(wires, noise_params)

    @staticmethod
    def PauliRot(theta, pauli, wires, noise_params=None, random_key=None) -> None:
        """Multi-qubit Pauli rotation with optional GateError."""
        theta, _ = UnitaryGates.GateError(theta, noise_params, random_key)
        op.PauliRot(theta, pauli, wires=wires)
        UnitaryGates.Noise(wires, noise_params)

    @staticmethod
    def GolombEncoding(w, wires, noise_params=None, random_key=None) -> None:
        """Diagonal encoding ``S(x) = exp(-i diag(golomb marks) x)`` on all wires."""
        wires_list = [wires] if isinstance(wires, int) else list(wires)
        w, _ = UnitaryGates.GateError(w, noise_params, random_key)
        w = _param(w)
        marks = torch.tensor(
            golomb_ruler(2 ** len(wires_list)), dtype=w.dtype, device=w.device
        )
        op.DiagonalQubitUnitary(torch.exp(-1j * marks * w[..., None]), wires=wires_list)
        UnitaryGates.Noise(wires_list, noise_params)


def _install_gate_wrappers() -> None:
    """Generate the uniform UnitaryGates wrappers from one table: perturb the
    angle with GateError (rotations only), emit the operation, append the
    configured noise channels."""
    rotations = {
        "RX": op.RX, "RY": op.RY, "RZ": op.RZ,
        "CRX": op.CRX, "CRY": op.CRY, "CRZ": op.CRZ,
        "RXX": op.RXX, "RYY": op.RYY, "RZZ": op.RZZ, "RZX": op.RZX,
        "CPhase": op.ControlledPhaseShift,
    }
    fixed = {"CX": op.CX, "CY": op.CY, "CZ": op.CZ, "H": op.H}

    def rotation_wrapper(name, ctor):
        def gate(w, wires, noise_params=None, random_key=None):
            w, _ = UnitaryGates.GateError(w, noise_params, random_key)
            ctor(w, wires=wires)
            UnitaryGates.Noise(wires, noise_params)

        gate.__name__ = name
        gate.__qualname__ = f"UnitaryGates.{name}"
        gate.__doc__ = f"{name} rotation with optional GateError + noise."
        return staticmethod(gate)

    def fixed_wrapper(name, ctor):
        def gate(wires, noise_params=None, random_key=None):
            ctor(wires=wires)
            UnitaryGates.Noise(wires, noise_params)

        gate.__name__ = name
        gate.__qualname__ = f"UnitaryGates.{name}"
        gate.__doc__ = f"{name} gate with configured noise channels."
        return staticmethod(gate)

    for name, ctor in rotations.items():
        setattr(UnitaryGates, name, rotation_wrapper(name, ctor))
    for name, ctor in fixed.items():
        setattr(UnitaryGates, name, fixed_wrapper(name, ctor))


_install_gate_wrappers()
