"""Reference-layout shim: ``qml_essentials_tpu_torch.expressibility``."""
from qml_essentials_tpu_torch.analysis.expressibility import *  # noqa: F401,F403
from qml_essentials_tpu_torch.analysis.expressibility import Expressibility  # noqa: F401
