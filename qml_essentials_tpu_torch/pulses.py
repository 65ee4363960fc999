"""Reference-layout shim: ``qml_essentials_tpu_torch.pulses``."""
from qml_essentials_tpu_torch.pulse.pulses import *  # noqa: F401,F403
from qml_essentials_tpu_torch.pulse.pulses import (  # noqa: F401
    PulseParams, PulseEnvelope, PulseInformation, PulseGates,
    PulseParamManager, DecompositionStep, PulseStateSnapshot,
)
