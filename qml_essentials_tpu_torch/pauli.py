"""Reference-layout shim: ``qml_essentials_tpu_torch.pauli``."""
from qml_essentials_tpu_torch.analysis.pauli import *  # noqa: F401,F403
from qml_essentials_tpu_torch.analysis.pauli import PauliCircuit  # noqa: F401
