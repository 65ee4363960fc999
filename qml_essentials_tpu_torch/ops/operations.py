"""Operation algebra: gates and observables.

An :class:`Operation` couples a matrix (a differentiable function of its
parameters, a complex torch tensor) with the wires it acts on and registers
itself on the active recording tape.  Application to a state delegates to
:mod:`qml_essentials_tpu_torch.ops.kernels`.

Matrices follow their parameters: a gate built from a float64 tensor has a
complex128 matrix on that tensor's device; parameter-free gates keep
complex128 class constants on the CPU (as do numpy-built Hermitians), so a
float64 model computes with them exactly and a float32 one rounds them once.
The simulator casts every matrix to the state's dtype and device where it is
applied.

Noise channels (:class:`KrausChannel` and its subclasses) carry their Kraus
operators as complex128 CPU tensors built from float64 host arithmetic
(``ThermalRelaxationError``'s Choi eigendecomposition included); they act on
real-split density states (:meth:`Operation.apply_to_density_ri`), and the
density engines of :mod:`~qml_essentials_tpu_torch.ops.simulation` lower
them to superoperators.

Counterpart of ``qml_essentials_tpu/ops/operations.py`` (Operation up to the
controlled rotations, and the Kraus channels).  Hamiltonians and
``PauliWord`` come with the pulse and analysis slices.
"""

from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from qml_essentials_tpu_torch.ops import kernels
from qml_essentials_tpu_torch.ops.dtypes import DEFAULT_RDTYPE, cdtype
from qml_essentials_tpu_torch.ops.tape import active_tape, recording  # noqa: F401

Wires = Union[int, List[int]]


def _as_wire_list(wires: Wires) -> List[int]:
    return list(wires) if isinstance(wires, (list, tuple)) else [wires]


def _const(values) -> torch.Tensor:
    """A complex128 class-level constant matrix (CPU); users cast it to
    their dtype (:func:`_placed`)."""
    return torch.tensor(values, dtype=torch.complex128)


_CONST_CACHE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _placed(t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """*t* on *device* in *dtype*.  Copies of constant matrices are cached
    (the entry holds *t* itself, so its id cannot be reused) and a gate on
    the card does not re-upload its fixed matrix every time.  The copy is
    made outside inference mode: a copy first made while serving under
    ``torch.inference_mode()`` must still serve a later gradient."""
    if t.device == device and t.dtype == dtype:
        return t
    key = (id(t), str(device), dtype)
    entry = _CONST_CACHE.get(key)
    if entry is None or entry[0] is not t:
        with torch.inference_mode(False):
            entry = (t, t.to(device=device, dtype=dtype))
        _CONST_CACHE[key] = entry
    return entry[1]


def _param(theta) -> torch.Tensor:
    """Gate parameter as a real tensor; Python and numpy scalars take the
    default float32 precision, tensors keep theirs."""
    if isinstance(theta, torch.Tensor):
        return theta if theta.is_floating_point() else theta.to(DEFAULT_RDTYPE)
    return torch.as_tensor(float(theta), dtype=DEFAULT_RDTYPE)


class Operation:
    """Base class for quantum gates and observables.

    Instantiating an operation inside a
    :func:`~qml_essentials_tpu_torch.ops.tape.recording` context appends it to
    the active tape.  Operations double as observables: their matrix feeds
    expectation-value measurement.

    Class attributes set by subclasses:
        _matrix: fixed unitary for non-parametrised gates.
        _num_wires: enforced wire count (``None`` = any).
        _param_names: attribute names of scalar gate parameters.
        is_controlled / is_clifford: structure flags.
    """

    is_controlled = False
    is_clifford = False

    _matrix: Optional[torch.Tensor] = None
    _num_wires: Optional[int] = None
    _param_names: Tuple[str, ...] = ()

    def __init__(
        self,
        wires: Wires = 0,
        matrix: Optional[torch.Tensor] = None,
        record: bool = True,
        name: Optional[str] = None,
    ) -> None:
        self.name = name or self.__class__.__name__
        self.wires = _as_wire_list(wires)

        if self._num_wires is not None and len(self.wires) != self._num_wires:
            raise ValueError(
                f"wire count mismatch for {self.name}: needs "
                f"{self._num_wires}, got {self.wires}"
            )
        if len(set(self.wires)) != len(self.wires):
            raise ValueError(f"duplicate wires passed to {self.name}: {self.wires}")

        if matrix is not None:
            self._matrix = matrix

        if record:
            tape = active_tape()
            if tape is not None:
                tape.append(self)

    # ------------------------------------------------------------------ API
    @property
    def parameters(self) -> list:
        """Numeric parameters in canonical (``_param_names``) order."""
        return [getattr(self, name) for name in self._param_names]

    def __repr__(self) -> str:
        params = self.parameters
        if params:
            parts = []
            for v in params:
                try:
                    parts.append(f"{float(v):.4f}")
                except (TypeError, ValueError, RuntimeError):
                    parts.append(str(v))
            return f"{self.name}({', '.join(parts)}, wires={self.wires})"
        return f"{self.name}(wires={self.wires})"

    @property
    def matrix(self) -> torch.Tensor:
        if self._matrix is None:
            raise NotImplementedError(
                f"{self.__class__.__name__} does not define a matrix."
            )
        return self._matrix

    @property
    def wires(self) -> List[int]:
        return self._wires

    @wires.setter
    def wires(self, wires: Wires) -> None:
        self._wires = _as_wire_list(wires)

    # --------------------------------------------------------------- algebra
    def _replace_on_tape(self, op: "Operation") -> None:
        """Swap self for *op* on the active tape (used by chained dagger/power)."""
        tape = active_tape()
        if tape is not None:
            if tape and tape[-1] is self:
                tape[-1] = op
            else:
                tape.append(op)

    def dagger(self) -> "Operation":
        """Conjugate transpose, replacing this op on the active tape."""
        op = Operation(wires=self.wires, matrix=self.matrix.conj().T, record=False)
        self._replace_on_tape(op)
        return op

    def power(self, power: int) -> "Operation":
        """Integer matrix power, replacing this op on the active tape."""
        op = Operation(
            wires=self.wires,
            matrix=torch.linalg.matrix_power(self.matrix, power),
            record=False,
        )
        self._replace_on_tape(op)
        return op

    def __mul__(self, other: Union[float, "Operation"]) -> "Operation":
        if isinstance(other, Operation):
            return self.__matmul__(other)
        op = Operation(wires=self.wires, matrix=other * self.matrix, record=False)
        self._replace_on_tape(op)
        return op

    __rmul__ = __mul__

    def __add__(self, other: "Operation") -> "Operation":
        if sorted(self.wires) != sorted(other.wires):
            raise ValueError(
                f"Can only add operations acting on the same set of wires, "
                f"got {self.wires} and {other.wires}"
            )
        return Operation(
            wires=self.wires, matrix=self.matrix + other.matrix, record=False
        )

    def prod(self, *ops: "Operation") -> "Operation":
        """Generalised product on the union wire set (kron if disjoint)."""
        if not ops:
            return self
        all_ops = (self,) + ops
        union: List[int] = []
        for o in all_ops:
            for w in o.wires:
                if w not in union:
                    union.append(w)
        mat = kernels.lift_matrix(all_ops[0].matrix, all_ops[0].wires, union)
        for o in all_ops[1:]:
            nxt = kernels.lift_matrix(o.matrix, o.wires, union)
            mat = mat @ nxt.to(device=mat.device, dtype=mat.dtype)
        names = "*".join(o.name for o in all_ops)
        return Operation(wires=union, matrix=mat, name=f"Prod({names})", record=False)

    def __matmul__(self, other: "Operation") -> "Operation":
        if not isinstance(other, Operation):
            return NotImplemented
        return self.prod(other)

    # ----------------------------------------------------------- application
    def lifted_matrix(self, n_qubits: int) -> torch.Tensor:
        """Full ``(2**n, 2**n)`` embedding via identity-kron + qubit permute."""
        return kernels.lift_matrix(self.matrix, self.wires, list(range(n_qubits)))

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        """Apply to a real-split ``(2, 2**n)`` state (simulation hot path)."""
        return kernels.apply_matrix_flat_ri(psi2, self.matrix, self.wires, n_qubits)

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        """Apply ``rho -> U rho U†`` to a real-split ``(2, 4**n)`` density
        state (ket wires ``0..n-1``, bra wires ``n..2n-1``)."""
        return kernels.apply_unitary_to_density_flat_ri(
            rho2, self.matrix, self.wires, n_qubits
        )


# ---------------------------------------------------------------------------
# Observables defined by data
# ---------------------------------------------------------------------------


def _as_complex(matrix) -> torch.Tensor:
    if isinstance(matrix, torch.Tensor):
        return matrix.to(cdtype(matrix.dtype)) if not matrix.is_complex() else matrix
    return torch.as_tensor(np.asarray(matrix), dtype=torch.complex128)


class Hermitian(Operation):
    """Generic Hermitian observable / gate defined by an explicit matrix."""

    def __init__(self, matrix, wires: Wires = 0, record: bool = True) -> None:
        super().__init__(wires=wires, matrix=_as_complex(matrix), record=record)


# ---------------------------------------------------------------------------
# Fixed gates
# ---------------------------------------------------------------------------


class Id(Operation):
    """Identity gate on an arbitrary number of wires."""

    _matrix = torch.eye(2, dtype=torch.complex128)
    _num_wires = None
    is_clifford = True

    def __init__(self, wires: Wires = 0, **kwargs) -> None:
        k = len(_as_wire_list(wires))
        if k > 1:
            kwargs["matrix"] = torch.eye(2**k, dtype=torch.complex128)
        super().__init__(wires=wires, **kwargs)

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return psi2

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return rho2


class PauliX(Operation):
    """Pauli-X gate / observable."""

    _matrix = _const([[0, 1], [1, 0]])
    _num_wires = 1
    is_clifford = True


class PauliY(Operation):
    """Pauli-Y gate / observable."""

    _matrix = _const([[0, -1j], [1j, 0]])
    _num_wires = 1
    is_clifford = True


class PauliZ(Operation):
    """Pauli-Z gate / observable."""

    _matrix = _const([[1, 0], [0, -1]])
    _num_wires = 1
    is_clifford = True


class H(Operation):
    """Hadamard gate."""

    _matrix = _const([[1, 1], [1, -1]]) / np.sqrt(2.0)
    _num_wires = 1
    is_clifford = True


class S(Operation):
    """S (phase) gate, sqrt(Z)."""

    _matrix = _const([[1, 0], [0, 1j]])
    _num_wires = 1
    is_clifford = True


class SWAP(Operation):
    """SWAP gate."""

    _matrix = _const([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    _num_wires = 2
    is_clifford = True


class DiagonalQubitUnitary(Operation):
    """Diagonal unitary ``U = diag(d_0, ..., d_{2^k-1})``.

    Used by the Golomb data encoding (Peters et al., arXiv:2209.05523).
    Application is a broadcast multiply (one state pass) on any wire subset.
    """

    _param_names = ()

    def __init__(self, diag: torch.Tensor, wires: Wires = 0, **kwargs) -> None:
        diag = _as_complex(diag)
        self.diag = diag
        wires_list = _as_wire_list(wires)
        expected = 2 ** len(wires_list)
        if tuple(diag.shape) != (expected,):
            raise ValueError(
                f"DiagonalQubitUnitary expects {expected} diagonal entries "
                f"for {len(wires_list)} wire(s), got shape {tuple(diag.shape)}"
            )
        kwargs.setdefault("name", "DiagU")
        super().__init__(wires=wires, matrix=torch.diag(diag), **kwargs)

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return kernels.apply_diagonal_flat_ri(psi2, self.diag, self.wires, n_qubits)

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        rho2 = kernels.apply_diagonal_flat_ri(rho2, self.diag, self.wires, 2 * n_qubits)
        bra = [w + n_qubits for w in self.wires]
        return kernels.apply_diagonal_flat_ri(
            rho2, torch.conj_physical(self.diag), bra, 2 * n_qubits
        )


class Barrier(Operation):
    """Visual separator; a no-op for every simulation path."""

    _matrix = None

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return psi2

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return rho2


_PAULI_LABELS = ["I", "X", "Y", "Z"]
_PAULI_CLASSES = [Id, PauliX, PauliY, PauliZ]
_PAULI_MATRICES = {
    label: cls._matrix for label, cls in zip(_PAULI_LABELS, _PAULI_CLASSES)
}


def _pauli_exponential(theta, P: torch.Tensor) -> torch.Tensor:
    """``exp(-i theta/2 P) = cos(theta/2) I - i sin(theta/2) P`` for P²=I."""
    theta = _param(theta)
    cd = cdtype(theta.dtype)
    dim = P.shape[0]
    eye = _placed(_eye(dim), theta.device, cd)
    P = _placed(P, theta.device, cd)
    half = theta / 2
    return torch.cos(half).to(cd) * eye - 1j * torch.sin(half).to(cd) * P


_EYES: Dict[int, torch.Tensor] = {}


def _eye(dim: int) -> torch.Tensor:
    if dim not in _EYES:
        _EYES[dim] = torch.eye(dim, dtype=torch.complex128)
    return _EYES[dim]


def _make_rotation_gate(pauli_class: type, name: str) -> type:
    """Single-qubit rotation factory for RX / RY / RZ."""
    pauli_mat = pauli_class._matrix

    class _Rotation(Operation):
        __doc__ = f"{name}(theta) = exp(-i theta/2 {name[1]})."
        _num_wires = 1
        _param_names = ("theta",)

        def __init__(self, theta, wires: Wires = 0, **kwargs) -> None:
            self.theta = theta
            super().__init__(
                wires=wires, matrix=_pauli_exponential(theta, pauli_mat), **kwargs
            )

    _Rotation.__name__ = name
    _Rotation.__qualname__ = name
    return _Rotation


RX = _make_rotation_gate(PauliX, "RX")
RY = _make_rotation_gate(PauliY, "RY")
RZ = _make_rotation_gate(PauliZ, "RZ")


_P0 = _const([[1, 0], [0, 0]])
_P1 = _const([[0, 0], [0, 1]])


def _make_controlled_gate(target_class: type, name: str) -> type:
    """Controlled-Pauli factory for CX / CY / CZ."""
    target_mat = target_class._matrix

    class _Controlled(Operation):
        __doc__ = f"Controlled-{target_class.__name__[5:]} gate."
        _matrix = torch.kron(_P0, Id._matrix) + torch.kron(_P1, target_mat)
        _num_wires = 2
        is_controlled = True
        is_clifford = True

        def __init__(self, wires: List[int] = [0, 1], **kwargs) -> None:
            super().__init__(wires=wires, **kwargs)

    _Controlled.__name__ = name
    _Controlled.__qualname__ = name
    return _Controlled


CX = _make_controlled_gate(PauliX, "CX")
CY = _make_controlled_gate(PauliY, "CY")
CZ = _make_controlled_gate(PauliZ, "CZ")


def _eye_with_block(dim: int, start: int, block: torch.Tensor) -> torch.Tensor:
    """Identity of size *dim* whose trailing block from *start* is *block*."""
    head = _placed(_eye(start), block.device, block.dtype)
    return torch.block_diag(head, block)


class CCX(Operation):
    """Toffoli gate."""

    _matrix = _eye_with_block(8, 6, PauliX._matrix)
    is_controlled = True
    _num_wires = 3

    def __init__(self, wires: List[int] = [0, 1, 2], **kwargs) -> None:
        super().__init__(wires=wires, **kwargs)


class CSWAP(Operation):
    """Fredkin gate; wires are ``[control, target0, target1]``."""

    _matrix = torch.block_diag(_eye(5), PauliX._matrix, _eye(1))
    is_controlled = True
    _num_wires = 3

    def __init__(self, wires: List[int] = [0, 1, 2], **kwargs) -> None:
        super().__init__(wires=wires, **kwargs)


class ControlledPhaseShift(Operation):
    """CPhase(phi) = diag(1, 1, 1, exp(i phi)); reduces to CZ at phi = pi."""

    _num_wires = 2
    _param_names = ("phi",)
    is_controlled = True

    def __init__(self, phi, wires: List[int] = [0, 1], **kwargs) -> None:
        self.phi = phi
        p = _param(phi)
        cd = cdtype(p.dtype)
        ones = torch.ones(3, dtype=cd, device=p.device)
        diag = torch.cat([ones, torch.exp(1j * p.to(cd)).reshape(1)])
        super().__init__(wires=wires, matrix=torch.diag(diag), **kwargs)


class Rot(Operation):
    """General SU(2) rotation ``Rot(phi, theta, omega) = RZ(omega) RY(theta) RZ(phi)``."""

    _num_wires = 1
    _param_names = ("phi", "theta", "omega")

    def __init__(self, phi, theta, omega, wires: Wires = 0, **kwargs) -> None:
        self.phi = phi
        self.theta = theta
        self.omega = omega
        mz = _pauli_exponential(omega, PauliZ._matrix)
        my = _pauli_exponential(theta, PauliY._matrix)
        mp = _pauli_exponential(phi, PauliZ._matrix)
        cd = torch.promote_types(torch.promote_types(mz.dtype, my.dtype), mp.dtype)
        mat = mz.to(cd) @ my.to(cd) @ mp.to(cd)
        super().__init__(wires=wires, matrix=mat, **kwargs)


_WORD_MATRICES: Dict[str, torch.Tensor] = {}


def _pauli_word_matrix(word: str) -> torch.Tensor:
    """Kronecker product of a Pauli word (cached: a constant of the word)."""
    if word not in _WORD_MATRICES:
        _WORD_MATRICES[word] = reduce(torch.kron, [_PAULI_MATRICES[c] for c in word])
    return _WORD_MATRICES[word]


class PauliRot(Operation):
    """Multi-qubit Pauli rotation ``exp(-i theta/2 P)`` for a Pauli word P."""

    _param_names = ("theta",)
    _PAULI_MAP = _PAULI_MATRICES

    def __init__(self, theta, pauli_word: str, wires: Wires = 0, **kwargs) -> None:
        self.theta = theta
        self.pauli_word = pauli_word
        P = _pauli_word_matrix(pauli_word)
        super().__init__(wires=wires, matrix=_pauli_exponential(theta, P), **kwargs)


def _make_pauli_rotation_subclass(name: str, word: str) -> type:
    """Two-qubit Pauli-rotation subclasses RXX/RYY/RZZ/RZX."""

    class _FixedWordRot(PauliRot):
        __doc__ = f"{name}(theta) = exp(-i theta/2 {' x '.join(word)})."
        _num_wires = len(word)

        def __init__(self, theta, wires: Wires = None, **kwargs) -> None:
            if wires is None:
                wires = list(range(len(word)))
            super().__init__(theta, word, wires=wires, **kwargs)

    _FixedWordRot.__name__ = name
    _FixedWordRot.__qualname__ = name
    return _FixedWordRot


RXX = _make_pauli_rotation_subclass("RXX", "XX")
RYY = _make_pauli_rotation_subclass("RYY", "YY")
RZZ = _make_pauli_rotation_subclass("RZZ", "ZZ")
RZX = _make_pauli_rotation_subclass("RZX", "ZX")


class ControlledPauliRot(Operation):
    """Multi-controlled multi-qubit Pauli rotation.

    Wire layout ``[controls..., targets...]``; the rotation acts on the
    targets conditioned on all controls being |1>.
    """

    _param_names = ("theta",)
    is_controlled = True

    def __init__(
        self,
        theta,
        pauli_word: str,
        wires: List[int],
        n_controls: int = 1,
        **kwargs,
    ) -> None:
        self.theta = theta
        self.pauli_word = pauli_word
        self.n_controls = n_controls

        wires_list = _as_wire_list(wires)
        n_targets = len(pauli_word)
        if len(wires_list) != n_controls + n_targets:
            raise ValueError(
                f"ControlledPauliRot expects {n_controls + n_targets} wires "
                f"({n_controls} control + {n_targets} target), got "
                f"{len(wires_list)}."
            )

        P = _pauli_word_matrix(pauli_word)
        R = _pauli_exponential(theta, P)
        d_t = P.shape[0]
        dim = 2**n_controls * d_t
        mat = _eye_with_block(dim, dim - d_t, R)
        super().__init__(wires=wires_list, matrix=mat, **kwargs)


def _make_controlled_rotation_subclass(name: str, axis: str) -> type:
    """Single-control rotation subclasses CRX / CRY / CRZ."""

    class _CRot(ControlledPauliRot):
        __doc__ = f"Controlled rotation around the {axis} axis."
        _num_wires = 2

        def __init__(self, theta, wires: List[int] = [0, 1], **kwargs) -> None:
            super().__init__(theta, axis, wires=wires, n_controls=1, **kwargs)

    _CRot.__name__ = name
    _CRot.__qualname__ = name
    return _CRot


CRX = _make_controlled_rotation_subclass("CRX", "X")
CRY = _make_controlled_rotation_subclass("CRY", "Y")
CRZ = _make_controlled_rotation_subclass("CRZ", "Z")


# ---------------------------------------------------------------------------
# Kraus channels
# ---------------------------------------------------------------------------


class KrausChannel(Operation):
    """Base class for noise channels ``rho -> sum_k K_k rho K_k†``.

    Channels have no single unitary matrix and cannot act on pure states;
    :meth:`apply_to_density_ri` applies the Kraus operators one by one.
    """

    def kraus_matrices(self) -> List[torch.Tensor]:
        raise NotImplementedError

    @property
    def matrix(self) -> torch.Tensor:
        raise TypeError(
            f"{self.__class__.__name__} is a noise channel and has no single "
            "unitary matrix. Use apply_to_density_ri() instead."
        )

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        raise TypeError(
            f"{self.__class__.__name__} is a noise channel and cannot be "
            "applied to a pure statevector. Use execute(type='density') instead."
        )

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return kernels.apply_kraus_to_density_flat_ri(
            rho2, self.kraus_matrices(), self.wires, n_qubits
        )


def _check_prob(p: float, name: str = "p") -> None:
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{name} must be in [0, 1].")


def _scaled(c: float, mat: torch.Tensor) -> torch.Tensor:
    """``sqrt(c) * mat`` in complex128 (host float64 arithmetic)."""
    return float(np.sqrt(c)) * mat


class BitFlip(KrausChannel):
    """Bit-flip channel: K0 = sqrt(1-p) I, K1 = sqrt(p) X."""

    _num_wires = 1
    _param_names = ("p",)

    def __init__(self, p: float, wires: Wires = 0) -> None:
        _check_prob(p)
        self.p = p
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        return [_scaled(1 - self.p, Id._matrix), _scaled(self.p, PauliX._matrix)]


class PhaseFlip(KrausChannel):
    """Phase-flip channel: K0 = sqrt(1-p) I, K1 = sqrt(p) Z."""

    _num_wires = 1
    _param_names = ("p",)

    def __init__(self, p: float, wires: Wires = 0) -> None:
        _check_prob(p)
        self.p = p
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        return [_scaled(1 - self.p, Id._matrix), _scaled(self.p, PauliZ._matrix)]


class DepolarizingChannel(KrausChannel):
    """Single-qubit depolarizing channel (I, X, Y, Z Kraus set)."""

    _num_wires = 1
    _param_names = ("p",)

    def __init__(self, p: float, wires: Wires = 0) -> None:
        _check_prob(p)
        self.p = p
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        p = self.p
        return [
            _scaled(1 - p, Id._matrix),
            _scaled(p / 3, PauliX._matrix),
            _scaled(p / 3, PauliY._matrix),
            _scaled(p / 3, PauliZ._matrix),
        ]


class AmplitudeDamping(KrausChannel):
    """Amplitude damping: energy loss |1> -> |0> with probability gamma."""

    _num_wires = 1
    _param_names = ("gamma",)

    def __init__(self, gamma: float, wires: Wires = 0) -> None:
        _check_prob(gamma, "gamma")
        self.gamma = gamma
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        g = self.gamma
        return [_const([[1.0, 0.0], [0.0, np.sqrt(1 - g)]]),
                _const([[0.0, np.sqrt(g)], [0.0, 0.0]])]


class PhaseDamping(KrausChannel):
    """Phase damping (dephasing) with probability gamma."""

    _num_wires = 1
    _param_names = ("gamma",)

    def __init__(self, gamma: float, wires: Wires = 0) -> None:
        _check_prob(gamma, "gamma")
        self.gamma = gamma
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        g = self.gamma
        return [_const([[1.0, 0.0], [0.0, np.sqrt(1 - g)]]),
                _const([[0.0, 0.0], [0.0, np.sqrt(g)]])]


class ThermalRelaxationError(KrausChannel):
    """Thermal relaxation: simultaneous T1 relaxation and T2 dephasing.

    ``t2 <= t1`` uses the six-operator Markovian set; ``t2 > t1`` builds the
    Choi matrix and eigendecomposes it (float64, on the host) into four Kraus
    operators, whose phases are the eigensolver's: compare channels by their
    superoperators, not by their Kraus lists.
    """

    _num_wires = 1
    _param_names = ("pe", "t1", "t2", "tg")

    def __init__(self, pe: float, t1: float, t2: float, tg: float, wires: Wires = 0) -> None:
        _check_prob(pe, "pe")
        if t1 <= 0:
            raise ValueError("t1 must be > 0.")
        if t2 <= 0:
            raise ValueError("t2 must be > 0.")
        if t2 > 2 * t1:
            raise ValueError("t2 must be <= 2·t1.")
        if tg < 0:
            raise ValueError("tg must be >= 0.")
        self.pe, self.t1, self.t2, self.tg = pe, t1, t2, tg
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        pe, t1, t2, tg = (float(v) for v in (self.pe, self.t1, self.t2, self.tg))
        eT1 = np.exp(-tg / t1)
        p_reset = 1.0 - eT1
        eT2 = np.exp(-tg / t2)

        if t2 <= t1:
            pz = (1.0 - p_reset) * (1.0 - eT2 / eT1) / 2.0
            pr0 = (1.0 - pe) * p_reset
            pr1 = pe * p_reset
            pid = 1.0 - pz - pr0 - pr1
            return [
                _scaled(pid, Id._matrix),
                _scaled(pz, PauliZ._matrix),
                _scaled(pr0, _P0),
                _scaled(pr0, _const([[0, 1], [0, 0]])),
                _scaled(pr1, _const([[0, 0], [1, 0]])),
                _scaled(pr1, _P1),
            ]

        # Non-Markovian regime: Choi matrix eigendecomposition, column-major
        # vec convention (the JAX package's and PennyLane's).
        choi = np.array(
            [
                [1 - pe * p_reset, 0, 0, eT2],
                [0, pe * p_reset, 0, 0],
                [0, 0, (1 - pe) * p_reset, 0],
                [eT2, 0, 0, 1 - (1 - pe) * p_reset],
            ],
            dtype=np.complex128,
        )
        lams, vecs = np.linalg.eigh(choi)
        return [
            torch.from_numpy(np.sqrt(abs(lams[i])) * vecs[:, i].reshape(2, 2).T.copy())
            for i in range(4)
        ]


class QubitChannel(KrausChannel):
    """Generic channel from a user-supplied Kraus operator list."""

    def __init__(self, kraus_ops: List, wires: Wires = 0) -> None:
        self._kraus_ops = [_as_complex(K) for K in kraus_ops]
        super().__init__(wires=wires)

    def kraus_matrices(self) -> List[torch.Tensor]:
        return self._kraus_ops
