"""Reference-layout shim: ``qml_essentials_tpu_torch.entanglement``."""
from qml_essentials_tpu_torch.analysis.entanglement import *  # noqa: F401,F403
from qml_essentials_tpu_torch.analysis.entanglement import (  # noqa: F401
    Entanglement, sample_random_separable_states,
)
