"""Reference-layout shim: ``qml_essentials_tpu_torch.jaqsi``."""
from qml_essentials_tpu_torch.core.jaqsi import *  # noqa: F401,F403
from qml_essentials_tpu_torch.core.jaqsi import (  # noqa: F401
    Script, Hamiltonian, partial_trace, marginalize_probs,
    build_parity_observable, Hermitian, ParametrizedHamiltonian,
)
from qml_essentials_tpu_torch.pulse.evolution import Evolution  # noqa: F401
