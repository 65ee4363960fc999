"""Reference-layout shim: ``qml_essentials_tpu_torch.ansaetze``."""
from qml_essentials_tpu_torch.models.ansaetze import *  # noqa: F401,F403
from qml_essentials_tpu_torch.models.ansaetze import (  # noqa: F401
    Ansaetze, Block, Circuit, DeclarativeCircuit, Encoding,
)
