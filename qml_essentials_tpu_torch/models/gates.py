"""Gate frontend: one name, two backends.

``Gates.RX(w, wires, gate_mode=...)`` is the single entry point circuits are
written against.  Which backend implements the gate is a table lookup
(``_BACKENDS``): the matrix backend
(:class:`~qml_essentials_tpu_torch.models.unitary.UnitaryGates`) or the
time-evolution backend
(:class:`~qml_essentials_tpu_torch.pulse.pulses.PulseGates`).  Pulse
parameters are normalised by two small helpers; while a
:class:`~qml_essentials_tpu_torch.pulse.pulses.PulseParamManager` is active
(a model layer in pulse mode), the model's pulse parameters scale each
gate's calibrated parameters element-wise.

Counterpart of ``qml_essentials_tpu/models/gates.py``.
"""

from __future__ import annotations

import logging
import numbers
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from qml_essentials_tpu_torch.models.unitary import UnitaryGates
from qml_essentials_tpu_torch.ops.operations import Barrier as BarrierOp
from qml_essentials_tpu_torch.ops.operations import _placed
from qml_essentials_tpu_torch.pulse.pulses import (  # noqa: F401 (re-exports)
    PulseEnvelope,
    PulseGates,
    PulseInformation,
    PulseParamManager,
    PulseParams,
)

log = logging.getLogger(__name__)

# Keywords a gate call may carry, per backend.  Anything else is dropped
# before the backend sees it (the Model forwards a uniform kwarg bundle to
# every gate; each backend takes its subset).
_COMMON_KWARGS = frozenset(
    {"w", "wires", "phi", "theta", "omega", "noise_params", "random_key"}
)
_BACKENDS = {
    "unitary": (UnitaryGates, _COMMON_KWARGS),
    "pulse": (PulseGates, _COMMON_KWARGS | {"pulse_params"}),
}

# Gate-name classifiers (consumed by Block param counting).
_ROTATIONAL = frozenset(
    {"RX", "RY", "RZ", "Rot", "CRX", "CRY", "CRZ", "GolombEncoding", "CPhase"}
)
_ENTANGLING = frozenset({"CX", "CY", "CZ", "CRX", "CRY", "CRZ", "CPhase"})


def Barrier(wires: Union[int, List[int]], *args, **kwargs):
    """Record a Barrier operation (visual separator)."""
    return BarrierOp(wires)


# ---------------------------------------------------------------------------
# Pulse-parameter normalisation (pure helpers)
# ---------------------------------------------------------------------------


def _flatten_pulse_params(pp) -> Tuple[Sequence, Optional[torch.Tensor]]:
    """Normalise a user-supplied ``pulse_params`` value.

    Returns ``(flat, replacement)`` where ``flat`` is one gate's parameter
    sequence, used for element validation / length checks (a batch
    ``(Bt, P)`` gives its first row), and ``replacement`` (when not None)
    is the tensor the backend should receive instead of the original object
    (a :class:`PulseParams` carries its tensor in ``.params``).
    """
    if isinstance(pp, (list, tuple)):
        return pp, None
    if isinstance(pp, torch.Tensor):
        return pp.reshape(-1, pp.shape[-1])[0] if pp.dim() else pp.reshape(1), None
    if isinstance(pp, PulseParams):
        return pp.params.flatten().tolist(), pp.params
    raise TypeError(f"Unsupported pulse_params type: {type(pp)}")


def _check_pulse_elements(flat, original) -> None:
    """Every pulse parameter must be a real number (a tensor of a real
    dtype)."""
    if isinstance(flat, torch.Tensor):
        ok = not (flat.is_complex() or flat.dtype == torch.bool)
    else:
        ok = all(
            isinstance(x, numbers.Real)
            or (isinstance(x, torch.Tensor) and x.numel() == 1 and not x.is_complex())
            for x in flat
        )
    if not ok:
        raise TypeError(
            "All elements in pulse_params must be int or float, "
            f"got {original}, type {type(original)}."
        )


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
    """Dynamic accessor: ``Gates.RX(w, wires)`` with backend routing.

    ``gate_mode="unitary"`` (default) dispatches to :class:`UnitaryGates`;
    ``gate_mode="pulse"`` to :class:`PulseGates` with pulse-parameter
    validation and (when a :class:`PulseParamManager` is active) slicing +
    scaling of the optimized parameters.
    """

    _pulse_mgr = None

    def __getattr__(self, gate_name):
        if gate_name.startswith("__"):
            raise AttributeError(gate_name)

        def handler(**kwargs):
            return self._inner_getattr(gate_name, **kwargs)

        handler.__name__ = gate_name
        return handler

    @classmethod
    def _inner_getattr(cls, gate_name, *args, **kwargs):
        if gate_name == "Barrier":
            return Barrier(*args, **kwargs)

        gate_mode = kwargs.pop("gate_mode", "unitary")
        try:
            backend, accepted = _BACKENDS[gate_mode]
        except KeyError:
            raise ValueError(
                f"Unknown gate mode: {gate_mode}. Use 'unitary' or 'pulse'."
            ) from None

        dropped = kwargs.keys() - accepted
        if dropped:
            log.debug(f"Unsupported keyword arguments: {sorted(dropped)}")
            kwargs = {k: v for k, v in kwargs.items() if k in accepted}

        kwargs = cls._resolve_pulse_params(gate_name, gate_mode, kwargs)

        gate = getattr(backend, gate_name, None)
        if gate is None:
            raise AttributeError(
                f"'{backend.__name__}' object has no attribute '{gate_name}'"
            )
        return gate(*args, **kwargs)

    @classmethod
    def _resolve_pulse_params(cls, gate_name: str, gate_mode: str, kwargs: dict):
        """Validate explicit pulse parameters and apply manager scaling.

        Two sources, in precedence order: an active
        :class:`PulseParamManager` (circuit building — model pulse params
        act as element-wise scalers on the gate's optimized parameters, in
        the model's dtype and on its device) and an explicit
        ``pulse_params`` kwarg (validated for element type, and for length
        when no manager is active).
        """
        explicit = kwargs.get("pulse_params")
        mgr = getattr(cls, "_pulse_mgr", None)
        managed = isinstance(mgr, PulseParamManager)

        if explicit is not None:
            flat, replacement = _flatten_pulse_params(explicit)
            if replacement is not None:
                kwargs["pulse_params"] = replacement
            _check_pulse_elements(flat, explicit)
            if not managed:
                expected = PulseInformation.gate_by_name(gate_name).size
                if len(flat) != expected:
                    raise ValueError(
                        f"Gate '{gate_name}' expects {expected} pulse "
                        f"parameters, got {len(flat)}"
                    )

        if gate_mode == "pulse" and managed:
            spec = PulseInformation.gate_by_name(gate_name)
            scale = mgr.get(spec.size)
            kwargs["pulse_params"] = _placed(spec.params, scale.device, scale.dtype) * scale

        return kwargs

    @classmethod
    @contextmanager
    def pulse_manager_context(cls, pulse_params: torch.Tensor):
        """Temporarily install the pulse-parameter slicer for circuit building."""
        cls._pulse_mgr = PulseParamManager(pulse_params)
        try:
            yield
        finally:
            cls._pulse_mgr = None

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
