"""Pulse events: what a pulse-mode leaf gate emits for schedule drawing.

While :func:`~qml_essentials_tpu_torch.ops.tape.pulse_recording` is active,
each leaf pulse gate appends one :class:`PulseEvent` to the pulse tape
(:meth:`~qml_essentials_tpu_torch.core.executor.Script.pulse_events`
collects them).  ``LEAF_META`` says which leaves are physical drives (they
have an envelope) and their carrier phase.

Counterpart of the pulse-schedule records of
``qml_essentials_tpu/utils/drawing.py``; the renderer itself belongs to the
drawing module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch


@dataclass
class PulseEvent:
    """One leaf pulse on one or more wires, for schedule rendering."""

    gate: str
    wires: List[int]
    envelope_fn: Optional[Callable]
    envelope_params: torch.Tensor
    w: float
    duration: float
    carrier_phase: float
    parent: Optional[str] = None
    meta: dict = field(default_factory=dict)


# Leaf gate metadata: whether the gate is a physical drive (has an envelope)
# and its carrier phase.
LEAF_META = {
    "RX": {"physical": True, "carrier_phase": 0.0},
    "RY": {"physical": True, "carrier_phase": np.pi / 2},
    "RZ": {"physical": False, "carrier_phase": 0.0},
    "CZ": {"physical": False, "carrier_phase": 0.0},
}
