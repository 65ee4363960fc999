"""Reference-layout shim: ``qml_essentials_tpu_torch.script``."""
from qml_essentials_tpu_torch.core.executor import *  # noqa: F401,F403
from qml_essentials_tpu_torch.core.executor import Script  # noqa: F401
