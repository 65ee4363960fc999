"""Reference-layout shim: ``qml_essentials_tpu_torch.math``."""
from qml_essentials_tpu_torch.analysis.math import *  # noqa: F401,F403
from qml_essentials_tpu_torch.analysis.math import (  # noqa: F401
    logm_v, fidelity, trace_distance, phase_difference,
    quantum_fisher_information, fubini_study_metric, _sqrt_matrix,
)
