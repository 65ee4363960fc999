"""Reference-layout shim: ``qml_essentials_tpu_torch.operations``."""
from qml_essentials_tpu_torch.ops.operations import *  # noqa: F401,F403
from qml_essentials_tpu_torch.ops.operations import (  # noqa: F401
    Operation, Hermitian, ParametrizedHamiltonian, PauliWord,
    Id, PauliX, PauliY, PauliZ, H, S, SWAP, RandomUnitary,
    DiagonalQubitUnitary, Barrier, RX, RY, RZ, CX, CY, CZ, CCX, CSWAP,
    ControlledPhaseShift, Rot, PauliRot, RXX, RYY, RZZ, RZX,
    ControlledPauliRot, CRX, CRY, CRZ, KrausChannel, BitFlip, PhaseFlip,
    DepolarizingChannel, AmplitudeDamping, PhaseDamping,
    ThermalRelaxationError, QubitChannel, evolve_pauli_with_clifford,
    pauli_decompose, pauli_string_from_operation, prod, _cdtype,
)
