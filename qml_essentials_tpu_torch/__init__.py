"""qml-essentials-tpu-torch: the PyTorch / CUDA port of qml-essentials-tpu.

A second package beside the JAX one, held to it by tests that feed both the
same inputs.  Plain tensor code is PyTorch; the statevector hot path runs on
hand-written CUDA kernels for Hopper (``ops/cuda_kernels.py``, ``csrc/``),
built with ``nvcc`` at first use.  The module layout mirrors the JAX
package's (``ops/``, ``models/``, ``core/``), module for module.
"""

from qml_essentials_tpu_torch.core import jaqsi  # noqa: F401
from qml_essentials_tpu_torch.core.executor import Script  # noqa: F401
from qml_essentials_tpu_torch.models.ansaetze import (  # noqa: F401
    Ansaetze,
    Block,
    Circuit,
    DeclarativeCircuit,
    Encoding,
)
from qml_essentials_tpu_torch.models.gates import Gates  # noqa: F401
from qml_essentials_tpu_torch.models.model import Model  # noqa: F401
from qml_essentials_tpu_torch.models.topologies import Topology  # noqa: F401
from qml_essentials_tpu_torch.models.unitary import UnitaryGates  # noqa: F401

__version__ = "0.1.0"
