"""Reference-layout shim: ``qml_essentials_tpu_torch.topologies``."""
from qml_essentials_tpu_torch.models.topologies import *  # noqa: F401,F403
from qml_essentials_tpu_torch.models.topologies import Topology  # noqa: F401
