"""Reference-layout shim: ``qml_essentials_tpu_torch.model``."""
from qml_essentials_tpu_torch.models.model import *  # noqa: F401,F403
from qml_essentials_tpu_torch.models.model import Model  # noqa: F401
