"""Reference-layout shim: ``qml_essentials_tpu_torch.evolution``."""
from qml_essentials_tpu_torch.pulse.evolution import *  # noqa: F401,F403
from qml_essentials_tpu_torch.pulse.evolution import Evolution  # noqa: F401
