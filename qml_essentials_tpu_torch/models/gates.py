"""Gate frontend: one name, one backend for now.

``Gates.RX(w, wires, gate_mode=...)`` is the single entry point circuits are
written against.  ``gate_mode="unitary"`` dispatches to
:class:`~qml_essentials_tpu_torch.models.unitary.UnitaryGates`;
``gate_mode="pulse"`` raises ``NotImplementedError`` until the pulse slice
is ported.

Counterpart of ``qml_essentials_tpu/models/gates.py`` (without the pulse
re-exports).
"""

from __future__ import annotations

import logging
from typing import Callable, List, Union

from qml_essentials_tpu_torch.models.unitary import UnitaryGates
from qml_essentials_tpu_torch.ops.operations import Barrier as BarrierOp

log = logging.getLogger(__name__)

# Keywords a gate call may carry; anything else is dropped before the
# backend sees it (the Model forwards a uniform kwarg bundle to every gate).
_ACCEPTED_KWARGS = frozenset(
    {"w", "wires", "phi", "theta", "omega", "noise_params", "random_key"}
)

# Gate-name classifiers (consumed by Block param counting).
_ROTATIONAL = frozenset(
    {"RX", "RY", "RZ", "Rot", "CRX", "CRY", "CRZ", "GolombEncoding", "CPhase"}
)
_ENTANGLING = frozenset({"CX", "CY", "CZ", "CRX", "CRY", "CRZ", "CPhase"})


def Barrier(wires: Union[int, List[int]], *args, **kwargs):
    """Record a Barrier operation (visual separator)."""
    return BarrierOp(wires)


class GatesMeta(type):
    """Resolve ``Gates.<name>`` to a dispatch handler at class level."""

    def __getattr__(cls, gate_name):
        if gate_name.startswith("__"):
            raise AttributeError(gate_name)

        def handler(*args, **kwargs):
            return cls._inner_getattr(gate_name, *args, **kwargs)

        handler.__name__ = gate_name
        return handler


class Gates(metaclass=GatesMeta):
    """Dynamic accessor: ``Gates.RX(w, wires)`` routed to the unitary backend."""

    @classmethod
    def _inner_getattr(cls, gate_name, *args, **kwargs):
        if gate_name == "Barrier":
            return Barrier(*args, **kwargs)

        gate_mode = kwargs.pop("gate_mode", "unitary")
        if gate_mode == "pulse":
            raise NotImplementedError("gate_mode='pulse' comes with the pulse slice")
        if gate_mode != "unitary":
            raise ValueError(f"Unknown gate mode: {gate_mode}. Use 'unitary' or 'pulse'.")

        dropped = kwargs.keys() - _ACCEPTED_KWARGS
        if dropped:
            log.debug(f"Unsupported keyword arguments: {sorted(dropped)}")
            kwargs = {k: v for k, v in kwargs.items() if k in _ACCEPTED_KWARGS}

        gate = getattr(UnitaryGates, gate_name, None)
        if gate is None:
            raise NotImplementedError(f"gate {gate_name!r} is not ported")
        return gate(*args, **kwargs)

    @classmethod
    def parse_gates(
        cls,
        gates: Union[str, Callable, List[Union[str, Callable]], None],
        set_of_gates=None,
    ) -> List[Callable]:
        """Normalise a gate spec (name / callable / list / None) to callables."""
        registry = set_of_gates or cls

        def resolve(item):
            if isinstance(item, str):
                return getattr(registry, item)
            if callable(item):
                return item
            raise ValueError(
                f"Operation {item} is not a valid gate or callable. Got {type(item)}"
            )

        if gates is None:
            return [lambda *args, **kwargs: None]
        if isinstance(gates, list):
            return [resolve(g) for g in gates]
        if isinstance(gates, str) or callable(gates):
            return [resolve(gates)]
        raise ValueError(
            f"Operation {gates} is not a valid gate or callable or list of both."
        )

    @classmethod
    def is_rotational(cls, gate) -> bool:
        """Whether a gate consumes rotation angle parameter(s)."""
        return gate.__name__ in _ROTATIONAL

    @classmethod
    def is_entangling(cls, gate) -> bool:
        """Whether a gate is a two-qubit entangler."""
        return gate.__name__ in _ENTANGLING
