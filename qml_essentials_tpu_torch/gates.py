"""Reference-layout shim: ``qml_essentials_tpu_torch.gates``."""
from qml_essentials_tpu_torch.models.gates import *  # noqa: F401,F403
from qml_essentials_tpu_torch.models.gates import (  # noqa: F401
    Barrier, Gates, PulseEnvelope, PulseGates, PulseInformation,
    PulseParamManager, PulseParams,
)
