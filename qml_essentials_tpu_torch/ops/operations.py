"""Operation algebra: gates and observables.

An :class:`Operation` couples a matrix (a differentiable function of its
parameters, a complex torch tensor) with the wires it acts on and registers
itself on the active recording tape.  Application to a state delegates to
:mod:`qml_essentials_tpu_torch.ops.kernels`.

Matrices follow their parameters: a gate built from a float64 tensor has a
complex128 matrix on that tensor's device; a Python or numpy scalar angle
and parameter-free gates give complex128 matrices on the CPU (as do
numpy-built Hermitians), so a float64 model computes with them exactly and
a float32 one rounds them once.
The simulator casts every matrix to the state's dtype and device where it is
applied.

Noise channels (:class:`KrausChannel` and its subclasses) carry their Kraus
operators as complex128 CPU tensors built from float64 host arithmetic
(``ThermalRelaxationError``'s Choi eigendecomposition included); they act on
real-split density states (:meth:`Operation.apply_to_density_ri`), and the
density engines of :mod:`~qml_essentials_tpu_torch.ops.simulation` lower
them to superoperators.

The Pauli helpers at the end (:class:`PauliWord`, the packed-bitmask
symplectic algebra with Clifford conjugation tables, and the dense
``pauli_decompose`` / ``evolve_pauli_with_clifford``) serve the analysis
stack; their tables are host numpy, built from the gates' matrices.

The JAX package's complex-state methods (``apply_to_state``,
``apply_to_state_tensor``, ``apply_to_density``, ``apply_to_density_flat``)
split the state into its real pair, run the real-split method and join the
result, so on the card they reach the same kernels as the simulator.

Counterpart of ``qml_essentials_tpu/ops/operations.py``.
"""

from __future__ import annotations

from functools import reduce
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from qml_essentials_tpu_torch.ops import kernels
from qml_essentials_tpu_torch.ops.dtypes import DEFAULT_RDTYPE, _cdtype, cdtype  # noqa: F401 (re-export)
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
    """Gate parameter as a real tensor.  Tensors keep their precision;
    Python and numpy scalars become float64 CPU scalars, so the matrix is
    exact to double precision and the simulator rounds it once to the
    working dtype of the script that runs it (as the JAX package does under
    x64)."""
    if isinstance(theta, torch.Tensor):
        return theta if theta.is_floating_point() else theta.to(DEFAULT_RDTYPE)
    return torch.as_tensor(float(theta), dtype=torch.float64)


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

    def decompose(self) -> List["Operation"]:
        """Decompose into primitive operations (created with ``record=False``)."""
        raise NotImplementedError(
            f"{self.__class__.__name__} does not define a decomposition."
        )

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
        op = Operation(wires=self.wires, matrix=self.matrix.mH, record=False)
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

    def apply_to_state(self, state: torch.Tensor, n_qubits: int) -> torch.Tensor:
        """Apply to a flat complex ``(2**n,)`` statevector: split into its
        real pair, :meth:`apply_to_state_ri` (the kernels on the card), joined
        back."""
        return kernels.from_ri(self.apply_to_state_ri(kernels.to_ri(state), n_qubits))

    def apply_to_state_tensor(self, psi: torch.Tensor, n_qubits: int) -> torch.Tensor:
        """Apply to a ``(2,)*n`` state tensor (its rank gives the qubit count,
        as in the JAX package)."""
        return self.apply_to_state(psi.reshape(-1), psi.dim()).reshape(psi.shape)

    def apply_to_density(self, rho: torch.Tensor, n_qubits: int) -> torch.Tensor:
        """Apply ``rho -> U rho U†`` to a ``(2**n, 2**n)`` density matrix."""
        flat = self.apply_to_density_flat(rho.reshape(-1), n_qubits)
        return flat.reshape(2**n_qubits, 2**n_qubits)

    def apply_to_density_flat(self, rho_flat: torch.Tensor, n_qubits: int) -> torch.Tensor:
        """Apply to a flat complex density state over ``2n`` conceptual
        qubits (ket wires ``0..n-1``, bra wires ``n..2n-1``), through
        :meth:`apply_to_density_ri`."""
        return kernels.from_ri(self.apply_to_density_ri(kernels.to_ri(rho_flat), n_qubits))

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

    def __rmul__(self, coeff_fn: Callable) -> "ParametrizedHamiltonian":
        """``coeff_fn * H`` builds a one-term :class:`ParametrizedHamiltonian`."""
        if not callable(coeff_fn):
            raise TypeError(
                f"Left operand of `* Hermitian` must be callable, got {type(coeff_fn)}"
            )
        return ParametrizedHamiltonian(terms=[(coeff_fn, self.matrix, self.wires)])

    def evolve(self, name: Optional[str] = None, **odeint_kwargs) -> Callable:
        """Gate factory for static evolution ``U = exp(-i t H)``."""
        from qml_essentials_tpu_torch.pulse.evolution import Evolution

        return Evolution.evolve(self, name=name, **odeint_kwargs)


class ParametrizedHamiltonian:
    """Time-dependent Hamiltonian ``H(t) = sum_i f_i(p_i, t) * H_i``.

    Built from explicit ``(coeff_fn, H_mat, wires)`` triples, usually via the
    ``coeff_fn * Hermitian(...)`` shorthand; combine instances with ``+``.
    All terms must currently share the same wire set.  A coefficient
    function is written for one problem (``p[0]``, ``p[-1]``): the solver
    maps it over a batch of problems with ``torch.func.vmap``.
    """

    def __init__(self, terms: List[Tuple[Callable, torch.Tensor, Wires]]) -> None:
        if len(terms) == 0:
            raise ValueError("ParametrizedHamiltonian needs at least one term.")

        first_wires = _as_wire_list(terms[0][2])
        for _, _, w in terms[1:]:
            if _as_wire_list(w) != first_wires:
                raise ValueError(
                    "All terms of a ParametrizedHamiltonian must currently "
                    f"act on the same wires; got {_as_wire_list(w)} vs. "
                    f"{first_wires}. Multi-wire broadcasting across terms is "
                    "not yet supported."
                )

        mats = [_as_complex(H) for _, H, _ in terms]
        for H in mats[1:]:
            if H.shape != mats[0].shape:
                raise ValueError(
                    f"All term matrices must have the same shape; got "
                    f"{tuple(H.shape)} vs. {tuple(mats[0].shape)}."
                )

        self._terms: Tuple[Tuple[Callable, torch.Tensor, List[int]], ...] = tuple(
            (fn, H, _as_wire_list(w)) for (fn, _, w), H in zip(terms, mats)
        )
        self.wires: List[int] = list(first_wires)

    @property
    def coeff_fns(self) -> Tuple[Callable, ...]:
        return tuple(fn for fn, _, _ in self._terms)

    @property
    def H_mats(self) -> Tuple[torch.Tensor, ...]:
        return tuple(H for _, H, _ in self._terms)

    @property
    def n_terms(self) -> int:
        return len(self._terms)

    def __add__(self, other: "ParametrizedHamiltonian") -> "ParametrizedHamiltonian":
        if not isinstance(other, ParametrizedHamiltonian):
            return NotImplemented
        return ParametrizedHamiltonian(terms=list(self._terms) + list(other._terms))

    def __neg__(self) -> "ParametrizedHamiltonian":
        return ParametrizedHamiltonian(
            terms=[
                ((lambda f: lambda p, t: -f(p, t))(fn), H, w)
                for fn, H, w in self._terms
            ]
        )

    def __sub__(self, other: "ParametrizedHamiltonian") -> "ParametrizedHamiltonian":
        if not isinstance(other, ParametrizedHamiltonian):
            return NotImplemented
        return self + (-other)

    def evolve(self, name: Optional[str] = None, **odeint_kwargs) -> Callable:
        """Gate factory solving ``dU/dt = -i [sum_i f_i(p_i, t) H_i] U``."""
        from qml_essentials_tpu_torch.pulse.evolution import Evolution

        return Evolution.evolve(self, name=name, **odeint_kwargs)


# ---------------------------------------------------------------------------
# Fixed gates
# ---------------------------------------------------------------------------


class _NoOp:
    """Every application returns its input unchanged (``Id``, ``Barrier``)."""

    def apply_to_state(self, state: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return state

    def apply_to_state_tensor(self, psi: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return psi

    def apply_to_density(self, rho: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return rho

    def apply_to_density_flat(self, rho_flat: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return rho_flat

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return psi2

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return rho2


class Id(_NoOp, Operation):
    """Identity gate on an arbitrary number of wires."""

    _matrix = torch.eye(2, dtype=torch.complex128)
    _num_wires = None
    is_clifford = True

    def __init__(self, wires: Wires = 0, **kwargs) -> None:
        k = len(_as_wire_list(wires))
        if k > 1:
            kwargs["matrix"] = torch.eye(2**k, dtype=torch.complex128)
        super().__init__(wires=wires, **kwargs)


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


class RandomUnitary(Operation):
    """Gate whose matrix is a random Hermitian draw (Frobenius-normalised).

    *key* is a ``torch.Generator``: ``A = N + i N'`` with both parts drawn
    from it in float64 on its device, ``H = (A + A†) / 2`` scaled to
    ``||H||_F = scale`` (the JAX package's law, one reproducible draw per
    generator state).
    """

    def __init__(
        self,
        wires: Wires,
        key: torch.Generator,
        scale: float = 1.0,
        record: bool = True,
    ) -> None:
        dim = 2 ** len(_as_wire_list(wires))
        draw = dict(generator=key, dtype=torch.float64, device=key.device)
        A = torch.complex(torch.randn((dim, dim), **draw), torch.randn((dim, dim), **draw))
        Hm = (A + A.mH) / 2.0
        Hm = Hm * (scale / torch.linalg.matrix_norm(Hm, ord="fro"))
        super().__init__(wires, matrix=Hm, record=record)


class DiagonalQubitUnitary(Operation):
    """Diagonal unitary ``U = diag(d_0, ..., d_{2^k-1})`` (a batch of
    diagonals ``(Bt, 2^k)`` gives a batch of gates).

    Used by the Golomb data encoding (Peters et al., arXiv:2209.05523).
    Application is a broadcast multiply (one state pass) on any wire subset.
    """

    _param_names = ()

    def __init__(self, diag: torch.Tensor, wires: Wires = 0, **kwargs) -> None:
        diag = _as_complex(diag)
        self.diag = diag
        wires_list = _as_wire_list(wires)
        expected = 2 ** len(wires_list)
        if diag.dim() not in (1, 2) or diag.shape[-1] != expected:
            raise ValueError(
                f"DiagonalQubitUnitary expects {expected} diagonal entries "
                f"for {len(wires_list)} wire(s), got shape {tuple(diag.shape)}"
            )
        kwargs.setdefault("name", "DiagU")
        super().__init__(wires=wires, matrix=torch.diag_embed(diag), **kwargs)

    def apply_to_state_ri(self, psi2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        return kernels.apply_diagonal_flat_ri(psi2, self.diag, self.wires, n_qubits)

    def apply_to_density_ri(self, rho2: torch.Tensor, n_qubits: int) -> torch.Tensor:
        rho2 = kernels.apply_diagonal_flat_ri(rho2, self.diag, self.wires, 2 * n_qubits)
        bra = [w + n_qubits for w in self.wires]
        return kernels.apply_diagonal_flat_ri(
            rho2, torch.conj_physical(self.diag), bra, 2 * n_qubits
        )


class Barrier(_NoOp, Operation):
    """Visual separator; a no-op for every simulation path."""

    _matrix = None


_PAULI_LABELS = ["I", "X", "Y", "Z"]
_PAULI_CLASSES = [Id, PauliX, PauliY, PauliZ]
_PAULI_MATRICES = {
    label: cls._matrix for label, cls in zip(_PAULI_LABELS, _PAULI_CLASSES)
}
_PAULI_MATS = [_PAULI_MATRICES[label] for label in _PAULI_LABELS]


def _pauli_exponential(theta, P: torch.Tensor) -> torch.Tensor:
    """``exp(-i theta/2 P) = cos(theta/2) I - i sin(theta/2) P`` for P²=I;
    a batch of angles ``(Bt,)`` gives ``(Bt, dim, dim)``."""
    theta = _param(theta)
    cd = cdtype(theta.dtype)
    dim = P.shape[0]
    eye = _placed(_eye(dim), theta.device, cd)
    P = _placed(P, theta.device, cd)
    half = theta / 2
    if half.dim():
        half = half[..., None, None]
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

        def decompose(self) -> List["Operation"]:
            if name != "CZ":
                return super().decompose()
            c, t = self.wires
            return [
                H(wires=t, record=False),
                CX(wires=[c, t], record=False),
                H(wires=t, record=False),
            ]

    _Controlled.__name__ = name
    _Controlled.__qualname__ = name
    return _Controlled


CX = _make_controlled_gate(PauliX, "CX")
CY = _make_controlled_gate(PauliY, "CY")
CZ = _make_controlled_gate(PauliZ, "CZ")


def _eye_with_block(dim: int, start: int, block: torch.Tensor) -> torch.Tensor:
    """Identity of size *dim* whose trailing block from *start* is *block*
    (per element of a batched ``(Bt, b, b)`` block)."""
    head = _placed(_eye(start), block.device, block.dtype)
    if block.dim() == 2:
        return torch.block_diag(head, block)
    b = block.shape[-1]
    top = torch.cat([head, head.new_zeros(start, b)], dim=1).expand(block.shape[:-2] + (start, dim))
    bottom = torch.cat([block.new_zeros(block.shape[:-1] + (start,)), block], dim=-1)
    return torch.cat([top, bottom], dim=-2)


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
        ones = torch.ones(p.shape + (3,), dtype=cd, device=p.device)
        diag = torch.cat([ones, torch.exp(1j * p.to(cd))[..., None]], dim=-1)
        super().__init__(wires=wires, matrix=torch.diag_embed(diag), **kwargs)


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

    def decompose(self) -> List["Operation"]:
        w = self.wires[0]
        return [
            RZ(self.phi, wires=w, record=False),
            RY(self.theta, wires=w, record=False),
            RZ(self.omega, wires=w, record=False),
        ]


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

    def generator(self) -> Operation:
        return Hermitian(matrix=_pauli_word_matrix(self.pauli_word), wires=self.wires,
                         record=False)


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

    def generator(self) -> Operation:
        P = _pauli_word_matrix(self.pauli_word)
        dim = 2**self.n_controls * P.shape[0]
        gen = torch.zeros((dim, dim), dtype=P.dtype)
        gen[dim - P.shape[0]:, dim - P.shape[0]:] = P
        return Hermitian(matrix=gen, wires=self.wires, record=False)


def _make_controlled_rotation_subclass(name: str, axis: str) -> type:
    """Single-control rotation subclasses CRX / CRY / CRZ."""

    class _CRot(ControlledPauliRot):
        __doc__ = f"Controlled rotation around the {axis} axis."
        _num_wires = 2

        def __init__(self, theta, wires: List[int] = [0, 1], **kwargs) -> None:
            super().__init__(theta, axis, wires=wires, n_controls=1, **kwargs)

        def decompose(self) -> List["Operation"]:
            c, t = self.wires
            theta = self.theta
            core = [
                RZ(theta / 2, wires=t, record=False),
                CX(wires=[c, t], record=False),
                RZ(-theta / 2, wires=t, record=False),
                CX(wires=[c, t], record=False),
            ]
            if axis == "Z":
                return core
            if axis == "X":
                return [H(wires=t, record=False)] + core + [H(wires=t, record=False)]
            # axis == "Y": CRY = RX(-pi/2)_t · CRZ · RX(pi/2)_t  (exact; the
            # basis change maps Z -> Y on the target), in theta's precision.
            p = _param(theta)
            half_pi = torch.tensor(np.pi / 2, dtype=p.dtype, device=p.device)
            return (
                [RX(half_pi, wires=t, record=False)]
                + core
                + [RX(-half_pi, wires=t, record=False)]
            )

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

    Channels have no single unitary matrix and cannot act on pure states
    (:meth:`apply_to_state` and :meth:`apply_to_state_tensor` raise, through
    :meth:`apply_to_state_ri`); :meth:`apply_to_density_ri` applies the
    Kraus operators one by one, and the complex density methods go through
    it.
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


# ---------------------------------------------------------------------------
# Pauli helpers (dense)
# ---------------------------------------------------------------------------


def evolve_pauli_with_clifford(
    clifford: Operation,
    pauli: Operation,
    adjoint_left: bool = True,
) -> Operation:
    """Dense ``C† P C`` (or ``C P C†``) on the union wire set, as a Hermitian."""
    all_wires = sorted(set(clifford.wires) | set(pauli.wires))
    C = kernels.lift_matrix(clifford.matrix, clifford.wires, all_wires)
    P = kernels.lift_matrix(pauli.matrix, pauli.wires, all_wires)
    cd = torch.promote_types(C.dtype, P.dtype)
    C, P = C.to(cd), P.to(device=C.device, dtype=cd)
    Cd = C.conj().T
    result = (Cd @ P @ C) if adjoint_left else (C @ P @ Cd)
    return Hermitian(matrix=result, wires=all_wires, record=False)


def _dominant_pauli_label(matrix: torch.Tensor) -> Tuple[torch.Tensor, str]:
    """Dominant Pauli term ``(coeff, label)`` via the trace formula.

    Brute-force O(4^n); only used on small matrices (Clifford-conjugated
    Paulis in the Fourier tree).  Computed with one trace per stacked Pauli
    basis element, then a single argmax.
    """
    from itertools import product as _product

    matrix = _as_complex(matrix)
    dim = matrix.shape[0]
    n_qubits = int(round(float(np.log2(dim))))

    labels = []
    coeffs = []
    for idxs in _product(range(4), repeat=n_qubits):
        P = reduce(torch.kron, [_PAULI_MATS[i] for i in idxs])
        P = P.to(device=matrix.device, dtype=matrix.dtype)
        coeffs.append(torch.trace(P @ matrix) / dim)
        labels.append("".join(_PAULI_LABELS[i] for i in idxs))
    coeffs = torch.stack(coeffs)
    best = int(torch.argmax(coeffs.abs()))
    return coeffs[best], labels[best]


def pauli_decompose(matrix: torch.Tensor, wire_order: Optional[List[int]] = None):
    """Dominant Pauli term of a Hermitian matrix as ``(coeff, Operation)``."""
    dim = matrix.shape[0]
    n_qubits = int(round(float(np.log2(dim))))
    if wire_order is None:
        wire_order = list(range(n_qubits))

    coeff, label = _dominant_pauli_label(matrix)
    label_to_idx = {lbl: i for i, lbl in enumerate(_PAULI_LABELS)}

    if sum(1 for ch in label if ch != "I") <= 1:
        for q, ch in enumerate(label):
            if ch != "I":
                result = _PAULI_CLASSES[label_to_idx[ch]](
                    wires=wire_order[q], record=False
                )
                result._pauli_label = ch
                return coeff, result
        result = Id(wires=wire_order[0], record=False)
        result._pauli_label = "I" * n_qubits
        return coeff, result

    P = reduce(torch.kron, [_PAULI_MATRICES[ch] for ch in label])
    result = Hermitian(matrix=P, wires=wire_order, record=False)
    result._pauli_label = label
    return coeff, result


def pauli_string_from_operation(op: Operation) -> str:
    """Pauli word string of a Pauli-like operation (``"X"``, ``"ZZ"``, ...)."""
    label = (
        getattr(op, "pauli_word", None)
        if isinstance(op, PauliRot)
        else getattr(op, "_pauli_label", None)
    )
    if label is not None:
        return label
    builtin = {"PauliX": "X", "PauliY": "Y", "PauliZ": "Z", "I": "I"}.get(op.name)
    if builtin is not None:
        return builtin
    _, pauli_op = pauli_decompose(op.matrix, wire_order=op.wires)
    return pauli_op._pauli_label


def prod(*ops: Operation) -> Operation:
    """Module-level product: ``prod(op1, op2, ...) == op1.prod(op2, ...)``."""
    if not ops:
        raise ValueError("prod() needs at least one operation")
    head, *rest = ops
    return head.prod(*rest)


# ---------------------------------------------------------------------------
# PauliWord — packed-bitmask symplectic Pauli algebra
# ---------------------------------------------------------------------------

# Local Pauli code c = x + 2z per qubit: 0=I, 1=X, 2=Z, 3=Y (Y = i·X·Z).
_CODE_CHARS = "IXZY"
_CHAR_CODE = {ch: c for c, ch in enumerate(_CODE_CHARS)}

# conjugation lookup tables, keyed by the Clifford's matrix bytes:
#   table[c_in] = (c_out, dphase)  over local codes of the gate's wires.
_CONJ_LUTS: dict = {}


def _local_xz_matrix(code: int, k: int) -> np.ndarray:
    """Dense ``2^k x 2^k`` operator ``⊗_i X^{x_i} Z^{z_i}`` for a local code.

    Wire ``i = 0`` (lowest base-4 digit of *code*) is the most significant
    kron factor, matching the gate-matrix convention used throughout.
    """
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    Z = np.array([[1, 0], [0, -1]], dtype=complex)
    out = np.eye(1, dtype=complex)
    for i in range(k):
        c = (code >> (2 * i)) & 3
        f = np.eye(2, dtype=complex)
        if c & 1:
            f = f @ X
        if c & 2:
            f = f @ Z
        out = np.kron(out, f)
    return out


def _build_conj_lut(C: np.ndarray, k: int) -> Optional[List[Tuple[int, int]]]:
    """Conjugation table ``X^x Z^z -> i^d X^x' Z^z'`` under ``P -> C P C†``.

    Returns ``None`` when *C* is not a Clifford (some image is not a single
    signed Pauli), signalling the dense fallback.
    """
    Cd = C.conj().T
    table: List[Tuple[int, int]] = []
    for c_in in range(4**k):
        M = C @ _local_xz_matrix(c_in, k) @ Cd
        hit = None
        for c_out in range(4**k):
            P = _local_xz_matrix(c_out, k)
            # ratio i^d with d integer <=> M == i^d P elementwise
            for d in range(4):
                if np.allclose(M, (1j**d) * P, atol=1e-9):
                    hit = (c_out, d)
                    break
            if hit:
                break
        if hit is None:
            return None
        table.append(hit)
    return table


def _conj_lut_for(clifford: "Operation", adjoint_left: bool):
    """Cached LUT for ``C P C†`` (or ``C† P C``) of a <=2-qubit gate."""
    mat = clifford._matrix
    if mat is None:
        return None
    C = mat.detach().cpu().numpy().astype(np.complex128)
    k = len(clifford.wires)
    if C.shape != (2**k, 2**k) or k > 2:
        return None
    if adjoint_left:
        C = C.conj().T
    key = (C.tobytes(), k)
    if key not in _CONJ_LUTS:
        _CONJ_LUTS[key] = _build_conj_lut(C, k)
    return _CONJ_LUTS[key]


class PauliWord:
    r"""Symbolic n-qubit Pauli ``P = i^phase · X^{x} Z^{z}`` on packed bits.

    The X- and Z-components are stored as integer *bitmasks* (bit ``q`` of
    ``xm``/``zm`` is qubit ``q``'s exponent) with the scalar tracked as
    ``i^phase`` mod 4; ``Y = i X Z`` contributes set bits in both masks.
    Products and commutators are two XORs / popcounts on machine words, and
    Clifford conjugation is a per-gate table lookup — the tables are derived
    at first use from the gate's dense matrix (so *any* 1–2 qubit Clifford,
    e.g. CY, gets an exact symbolic rule automatically), with a dense
    conjugation fallback for wider gates.
    """

    __slots__ = ("xm", "zm", "n", "phase")

    def __init__(self, x, z, phase: int = 0) -> None:
        if isinstance(x, (int, np.integer)):
            raise TypeError("use _make() for mask construction")
        x = np.asarray(x)
        z = np.asarray(z)
        self.n = int(x.shape[0])
        self.xm = int.from_bytes(np.packbits(x.astype(bool), bitorder="little"), "little")
        self.zm = int.from_bytes(np.packbits(z.astype(bool), bitorder="little"), "little")
        self.phase = int(phase) % 4

    @classmethod
    def _make(cls, xm: int, zm: int, n: int, phase: int) -> "PauliWord":
        w = cls.__new__(cls)
        w.xm, w.zm, w.n, w.phase = xm, zm, n, phase % 4
        return w

    # ---- constructors ----------------------------------------------------
    @classmethod
    def identity(cls, n_qubits: int) -> "PauliWord":
        return cls._make(0, 0, n_qubits, 0)

    @classmethod
    def from_pauli_string(
        cls, pauli_string: str, wires: List[int], n_qubits: int
    ) -> "PauliWord":
        xm = zm = 0
        phase = 0
        for ch, w in zip(pauli_string, wires):
            c, w = _CHAR_CODE[ch], int(w)
            xm |= (c & 1) << w
            zm |= (c >> 1) << w
            phase += c == 3  # each Y carries one factor of i
        return cls._make(xm, zm, n_qubits, phase)

    @classmethod
    def from_operation(cls, op: "Operation", n_qubits: int) -> "PauliWord":
        cached = getattr(op, "_pauli_word", None)
        if isinstance(cached, PauliWord) and cached.n == n_qubits:
            return cached
        label = (
            op.pauli_word
            if isinstance(op, PauliRot)
            else {
                "RX": "X", "RY": "Y", "RZ": "Z",
                "PauliX": "X", "PauliY": "Y", "PauliZ": "Z", "I": "I",
            }.get(op.name)
        )
        if label is None:
            label = pauli_string_from_operation(op)
        return cls.from_pauli_string(label, op.wires, n_qubits)

    # ---- views ------------------------------------------------------------
    @property
    def n_qubits(self) -> int:
        return self.n

    def _unpack(self, mask: int) -> np.ndarray:
        raw = mask.to_bytes((self.n + 7) // 8, "little")
        return np.unpackbits(
            np.frombuffer(raw, np.uint8), count=self.n, bitorder="little"
        ).astype(np.int8)

    @property
    def x(self) -> np.ndarray:
        return self._unpack(self.xm)

    @property
    def z(self) -> np.ndarray:
        return self._unpack(self.zm)

    @property
    def xy_mask(self) -> np.ndarray:
        """Boolean mask of qubits carrying X or Y (off-diagonal support)."""
        return self._unpack(self.xm).astype(bool)

    @property
    def is_diagonal(self) -> bool:
        return self.xm == 0

    # ---- algebra ----------------------------------------------------------
    def commutes_with(self, other: "PauliWord") -> bool:
        """Vanishing symplectic form: popcount parity of the cross terms."""
        anti = ((self.xm & other.zm).bit_count() + (self.zm & other.xm).bit_count()) & 1
        return anti == 0

    def compose(self, other: "PauliWord") -> "PauliWord":
        r"""Product: reordering each ``Z^{z1} X^{x2}`` crossing costs ``-1``."""
        cross = (self.zm & other.xm).bit_count()
        return PauliWord._make(
            self.xm ^ other.xm,
            self.zm ^ other.zm,
            self.n,
            self.phase + other.phase + 2 * cross,
        )

    # ---- Clifford conjugation ---------------------------------------------
    def conjugate_by_clifford(
        self, clifford: "Operation", adjoint_left: bool = False
    ) -> "PauliWord":
        """``C P C†`` (or ``C† P C`` with *adjoint_left*) via the gate LUT."""
        wires = list(clifford.wires)
        lut = _conj_lut_for(clifford, adjoint_left)
        if lut is None:
            return self._conjugate_via_matrix(clifford, adjoint_left)
        # Local code of this word on the gate's wires (gate wire order).
        c_in = 0
        for i, w in enumerate(wires):
            c_in |= (((self.xm >> w) & 1) | (((self.zm >> w) & 1) << 1)) << (2 * i)
        c_out, dphase = lut[c_in]
        xm, zm = self.xm, self.zm
        for i, w in enumerate(wires):
            loc = (c_out >> (2 * i)) & 3
            xm = (xm & ~(1 << w)) | ((loc & 1) << w)
            zm = (zm & ~(1 << w)) | (((loc >> 1) & 1) << w)
        return PauliWord._make(xm, zm, self.n, self.phase + dphase)

    def _conjugate_via_matrix(
        self, clifford: "Operation", adjoint_left: bool
    ) -> "PauliWord":
        """Exact dense fallback for Cliffords wider than the LUT covers."""
        C = kernels.lift_matrix(
            clifford.matrix.detach().cpu().to(torch.complex128), clifford.wires,
            list(range(self.n)))
        Cd = C.conj().T
        mat = self.to_matrix()
        out = (Cd @ mat @ C) if adjoint_left else (C @ mat @ Cd)
        return PauliWord.from_matrix(out)

    # ---- expectation / conversions -----------------------------------------
    def zero_expectation(self) -> complex:
        """``<0…0|P|0…0>`` — nonzero only for I/Z words."""
        return complex(1j**self.phase) if self.xm == 0 else 0.0 + 0.0j

    def _codes(self) -> List[int]:
        return [
            ((self.xm >> q) & 1) | (((self.zm >> q) & 1) << 1) for q in range(self.n)
        ]

    def to_pauli_string(self) -> str:
        return "".join(_CODE_CHARS[c] for c in self._codes())

    def leading_phase(self) -> complex:
        """Scalar relating this word to its bare Pauli string (Y = i·X·Z)."""
        n_y = (self.xm & self.zm).bit_count()
        return complex(1j ** ((self.phase - n_y) % 4))

    def to_pauli_string_and_phase(self) -> Tuple[str, complex]:
        return self.to_pauli_string(), self.leading_phase()

    def to_matrix(self) -> torch.Tensor:
        """Dense matrix (host-side, exact integer entries times ``i^phase``),
        complex128 on the CPU like the gates' constant matrices."""
        out = np.eye(1, dtype=complex)
        for c in self._codes():
            out = np.kron(out, _local_xz_matrix(c, 1))
        return torch.from_numpy((1j**self.phase) * out)

    @classmethod
    def from_matrix(cls, matrix: torch.Tensor) -> "PauliWord":
        """Word for a matrix known to be a single (phase-scaled) Pauli."""
        coeff, label = _dominant_pauli_label(matrix)
        word = cls.from_pauli_string(label, list(range(len(label))), len(label))
        quarter_turns = int(round(np.angle(complex(coeff)) / (np.pi / 2)))
        word.phase = (word.phase + quarter_turns) % 4
        return word

    def to_list_repr(self) -> np.ndarray:
        """Legacy int list representation (I=-1, X=0, Y=1, Z=2)."""
        remap = np.array([-1, 0, 2, 1])  # code order I,X,Z,Y -> legacy ints
        return remap[np.asarray(self._codes())]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PauliWord):
            return NotImplemented
        return (self.xm, self.zm, self.n, self.phase) == (
            other.xm, other.zm, other.n, other.phase,
        )

    def __repr__(self) -> str:
        sign = ("+", "+i", "-", "-i")[self.phase]
        return f"PauliWord({sign}{self.to_pauli_string()})"
