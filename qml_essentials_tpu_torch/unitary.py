"""Reference-layout shim: ``qml_essentials_tpu_torch.unitary``."""
from qml_essentials_tpu_torch.models.unitary import *  # noqa: F401,F403
from qml_essentials_tpu_torch.models.unitary import UnitaryGates, golomb_ruler  # noqa: F401
