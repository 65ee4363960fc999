"""Precision configuration of the PyTorch port.

The simulator runs in float32 / complex64 by default.  Float64 is chosen
explicitly per model or per call (``Model(..., dtype=torch.float64)``,
``simulate_and_measure(..., dtype=torch.float64)``, ``simulate_pure`` /
``simulate_mixed``); there is no global switch and no precision read off a
tape.  Gate matrices follow the dtype of their parameters and are cast to
the state's complex dtype where they are applied.

Counterpart of ``qml_essentials_tpu/ops/dtypes.py``.
"""

from __future__ import annotations

import torch

DEFAULT_RDTYPE = torch.float32

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def cdtype(rdtype: torch.dtype = DEFAULT_RDTYPE) -> torch.dtype:
    """Complex dtype paired with a real dtype (complex dtypes map to themselves)."""
    if rdtype in (torch.complex64, torch.complex128):
        return rdtype
    try:
        return _COMPLEX_OF[rdtype]
    except KeyError:
        raise ValueError(f"unsupported real dtype {rdtype}") from None


# Reference alias (``qml_essentials/operations.py``'s ``_cdtype``).
_cdtype = cdtype
