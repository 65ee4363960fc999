"""Reference-layout shim: ``qml_essentials_tpu_torch.coefficients``."""
from qml_essentials_tpu_torch.analysis.coefficients import *  # noqa: F401,F403
from qml_essentials_tpu_torch.analysis.coefficients import (  # noqa: F401
    Coefficients, FourierTree, FCC, Datasets,
)
