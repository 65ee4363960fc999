"""The device a model, a script or a memory estimate works on.

The port runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  Without CUDA the default raises: it
never falls back to the CPU quietly.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """*device* as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device on a host without CUDA."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available "
            "(pass device='cpu' to run on the CPU)"
        )
    return device
