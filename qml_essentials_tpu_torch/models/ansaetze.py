"""Circuit ansaetze: Circuit ABC, declarative Block system, registry, encodings.

Architecture of this module (deliberately different from the reference's
hand-written class-per-circuit layout, in the same generated/static-table
style as :mod:`qml_essentials_tpu_torch.models.unitary`):

* :class:`Block` resolves, per circuit width, to a concrete *placement
  list* — ``sites(n_qubits)`` — and every derived quantity (parameter
  count, pulse-parameter count, gate emission) is one expression over that
  list.  The reference instead re-derives the topology/skip logic three
  times (n_params / n_pulse_params / apply).
* The ansatz registry is a compact structure *table* (``_STRUCTURES``)
  from which the circuit classes are generated; only circuits with custom
  behavior (GHZ) are written out.
* The encoding strategies share one closed-form spectrum rule: every
  strategy's spectrum is ``[-L, L]`` for a strategy-specific limit ``L``,
  and its frequency count is ``2L + 1`` — so one limit function drives
  both ``get_spectrum`` and ``get_n_freqs``.

The registry covers the 19 parameterized circuits of Sim et al. 2019
(arXiv:1905.10876 numbering: Circuit_1..10, 13..20), plus GHZ, No_Ansatz,
No_Entangling, Hardware_Efficient and Strongly_Entangling.  The gate
sequences and topology options in ``_STRUCTURES`` are literature facts and
therefore match the reference's tables entry for entry.

Counterpart of ``qml_essentials_tpu/models/ansaetze.py``: the same
structure table, gate sequences, pulse-parameter counts and encodings.
"""

from __future__ import annotations

import logging
import warnings
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qml_essentials_tpu_torch.models.gates import Gates, PulseInformation
from qml_essentials_tpu_torch.models.topologies import Topology

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Circuit interface
# ---------------------------------------------------------------------------


class Circuit(ABC):
    """Abstract base class for quantum circuit ansaetze.

    A circuit knows three things about itself at a given width: how many
    variational parameters one layer consumes (``n_params_per_layer``),
    where the controlled-rotation angles sit inside that parameter vector
    (``get_control_indices``), and how to emit one layer of gates onto the
    active tape (``build``).  Pulse-mode circuits additionally report
    ``n_pulse_params_per_layer``.
    """

    def __init__(self) -> None:
        pass

    @abstractmethod
    def n_params_per_layer(self, n_qubits: int) -> int:
        """Number of variational parameters required per layer."""
        raise NotImplementedError("n_params_per_layer method is not implemented")

    def n_pulse_params_per_layer(self, n_qubits: int) -> int:
        """Number of pulse parameters required per layer."""
        raise NotImplementedError("n_pulse_params_per_layer method is not implemented")

    @abstractmethod
    def get_control_indices(self, n_qubits: int) -> Optional[List[int]]:
        """Slice indices ``[start, stop, step]`` of controlled-rotation params."""
        raise NotImplementedError("get_control_indices method is not implemented")

    def get_control_angles(self, w: torch.Tensor, n_qubits: int) -> Optional[torch.Tensor]:
        """Extract the controlled-rotation angles from a layer parameter array.

        Accepts both index formats ``get_control_indices`` may produce: a
        3-element slice spec (``None`` marks open bounds) or an explicit
        index list.
        """
        spec = self.get_control_indices(n_qubits)
        if spec is None:
            return w.new_zeros(0)
        is_slice = len(spec) == 3 and None in spec
        return w[..., slice(*spec)] if is_slice else w[..., torch.as_tensor(spec, device=w.device)]

    def _build(self, w: torch.Tensor, n_qubits: int, **kwargs: Any) -> Any:
        """Entry point used by the Model: wraps :meth:`build` with
        pulse-parameter validation and manager installation when the layer
        runs in pulse mode (the layer's pulse parameters ``(n,)``, or
        ``(Bt, n)`` for a batch recorded as one tape)."""
        in_pulse_mode = (
            kwargs.get("gate_mode", "unitary") == "pulse"
            and "pulse_params" in kwargs
        )
        if not in_pulse_mode:
            return self.build(w, n_qubits, **kwargs)

        given = kwargs["pulse_params"].shape[-1]
        expected = self.n_pulse_params_per_layer(n_qubits)
        if given != expected:
            raise ValueError(
                f"Pulse params length {given} "
                f"does not match expected {expected} for {n_qubits} qubits"
            )
        with Gates.pulse_manager_context(kwargs["pulse_params"]):
            return self.build(w, n_qubits, **kwargs)

    @abstractmethod
    def build(self, w: torch.Tensor, n_qubits: int, **kwargs: Any) -> Any:
        """Emit one layer of gates onto the active tape."""
        raise NotImplementedError("build method is not implemented")

    def __call__(self, *args: Any, **kwds: Any) -> Any:
        self._build(*args, **kwds)


# ---------------------------------------------------------------------------
# Block: the placement atom
# ---------------------------------------------------------------------------


class Block:
    """One gate type over a placement pattern — the atom of an ansatz.

    Single-qubit gates place one instance per wire; entangling gates place
    one instance per wire pair produced by ``topology(n_qubits, **options)``.
    ``sites(n_qubits)`` materialises that placement list once, and
    parameter counting / pulse counting / gate emission are all expressions
    over it.
    """

    def __init__(self, gate, topology: Any = None, **kwargs) -> None:
        self.gate = getattr(Gates, gate) if isinstance(gate, str) else gate
        if self.is_entangling and topology is None:
            raise AssertionError("Topology must be specified for entangling gates")
        self.topology = topology
        self.kwargs = kwargs

    def __repr__(self) -> str:
        inner = (
            self.gate.__name__
            if self.topology is None
            else f"{self.topology.__name__}[{self.gate.__name__}]"
        )
        return f"{type(self).__name__}({inner})"

    # -- classification ----------------------------------------------------

    @property
    def is_entangling(self) -> bool:
        return Gates.is_entangling(self.gate)

    @property
    def is_rotational(self) -> bool:
        return Gates.is_rotational(self.gate)

    @property
    def is_controlled_rotation(self) -> bool:
        return self.is_entangling and self.is_rotational

    @property
    def weights_per_site(self) -> int:
        """Rotation angles each placed gate consumes (0 / 1 / 3)."""
        if not self.is_rotational:
            return 0
        return 3 if self.gate.__name__ == "Rot" else 1

    # -- placement ----------------------------------------------------------

    def enough_qubits(self, n_qubits: int) -> bool:
        """Whether the placement pattern fits in *n_qubits*."""
        if not self.is_entangling:
            return n_qubits >= 1
        span = self.kwargs.get("span", 1)
        if callable(span):
            span = span(n_qubits)
        return n_qubits >= 2 and n_qubits > span

    def sites(self, n_qubits: int) -> Sequence:
        """Concrete gate placements at the given width.

        Entangling blocks whose topology does not fit resolve to an empty
        placement list (with a warning) — the block contributes nothing at
        that width, matching the reference's skip semantics.
        """
        if not self.is_entangling:
            return range(n_qubits)
        if not self.enough_qubits(n_qubits):
            warnings.warn(
                f"Skipping {self.topology.__name__} with n_qubits={n_qubits} "
                f"as there are not enough qubits for this topology."
            )
            return ()
        return self.topology(n_qubits=n_qubits, **self.kwargs)

    # -- derived quantities ---------------------------------------------------

    def n_params(self, n_qubits: int) -> int:
        assert n_qubits > 0, "Number of qubits must be positive"
        wps = self.weights_per_site
        return wps * len(self.sites(n_qubits)) if wps else 0

    def n_pulse_params(self, n_qubits: int) -> int:
        assert n_qubits > 0, "Number of qubits must be positive"
        return PulseInformation.num_params(self.gate) * len(self.sites(n_qubits))

    def apply(
        self, n_qubits: int, w: torch.Tensor = None, w_idx: int = None, **kwargs
    ) -> int:
        """Emit the block's gates; returns the advanced weight index."""
        assert n_qubits > 0, "Number of qubits must be positive"
        wps = self.weights_per_site
        for wires in self.sites(n_qubits):
            if wps:
                assert w is not None, "w must be provided for rotational gates"
                assert w_idx is not None, (
                    "w_idx must be provided for rotational gates"
                )
                angles = (w[..., w_idx + k] for k in range(wps))
                self.gate(*angles, wires=wires, **kwargs)
                w_idx += wps
            else:
                self.gate(wires=wires, **kwargs)
        return w_idx


class DeclarativeCircuit(Circuit):
    """A circuit derived entirely from a ``structure()`` tuple of Blocks."""

    @classmethod
    def structure(cls) -> Tuple[Any, ...]:
        """Override in subclasses: the tuple of :class:`Block` descriptors."""
        raise NotImplementedError

    @classmethod
    def n_params_per_layer(cls, n_qubits: int) -> int:
        return sum(block.n_params(n_qubits) for block in cls.structure())

    @classmethod
    def n_pulse_params_per_layer(cls, n_qubits: int) -> int:
        return sum(block.n_pulse_params(n_qubits) for block in cls.structure())

    @classmethod
    def get_control_indices(cls, n_qubits: int) -> Optional[List]:
        """Parameter indices of controlled rotations.

        Built from a per-slot boolean mask over the layer's parameter
        vector.  A contiguous tail compresses to the ``[start, stop, step]``
        slice format the Model consumes; anything else returns the explicit
        index list.
        """
        mask: List[bool] = []
        for block in cls.structure():
            mask += [block.is_controlled_rotation] * block.n_params(n_qubits)

        picked = [i for i, controlled in enumerate(mask) if controlled]
        if not picked:
            return None
        if picked[0] == len(mask) - len(picked) and picked[-1] == len(mask) - 1:
            return [-len(picked), None, None]
        return picked

    @classmethod
    def build(cls, w: torch.Tensor, n_qubits: int, **kwargs: Any) -> None:
        w_idx = 0
        for block in cls.structure():
            w_idx = block.apply(n_qubits, w, w_idx, **kwargs)
            Gates.Barrier(wires=list(range(n_qubits)), **kwargs)


# ---------------------------------------------------------------------------
# Registry: structure tables -> generated circuit classes
# ---------------------------------------------------------------------------

_stairs, _bricks, _all = Topology.stairs, Topology.bricks, Topology.all_to_all

# Gate sequences per ansatz (Sim et al. 2019 Fig. 2 numbering + extras).
# Each entry is a thunk so Block instances are built fresh per access.
_STRUCTURES: Dict[str, Callable[[], Tuple[Block, ...]]] = {
    "No_Ansatz": lambda: (),
    "Circuit_1": lambda: (Block("RX"), Block("RZ")),
    "Circuit_2": lambda: (Block("RX"), Block("RZ"), Block("CX", _stairs)),
    "Circuit_3": lambda: (Block("RX"), Block("RZ"), Block("CRZ", _stairs)),
    "Circuit_4": lambda: (Block("RX"), Block("RZ"), Block("CRX", _stairs)),
    "Circuit_5": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRZ", _all),
        Block("RX"), Block("RZ"),
    ),
    "Circuit_6": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRX", _all),
        Block("RX"), Block("RZ"),
    ),
    "Circuit_7": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRZ", _bricks),
        Block("RX"), Block("RZ"),
        Block("CRZ", _bricks, offset=1),
    ),
    "Circuit_8": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRX", _bricks),
        Block("RX"), Block("RZ"),
        Block("CRX", _bricks, offset=1),
    ),
    "Circuit_9": lambda: (
        Block("H"), Block("CZ", _stairs), Block("RX"),
    ),
    "Circuit_10": lambda: (
        Block("RY"),
        Block("CZ", _stairs, offset=-1, wrap=True),
        Block("RY"),
    ),
    "Circuit_13": lambda: (
        Block("RY"),
        Block("CRZ", _stairs, wrap=True, reverse=True, mirror=False),
        Block("RY"),
        Block("CRZ", _stairs, reverse=False, mirror=False,
              offset=lambda n: n - 1, span=3, wrap=True),
    ),
    "Circuit_14": lambda: (
        Block("RY"),
        Block("CRX", _stairs, wrap=True, reverse=True, mirror=False),
        Block("RY"),
        Block("CRX", _stairs, reverse=False, mirror=False,
              offset=lambda n: n - 1, span=3, wrap=True),
    ),
    "Circuit_15": lambda: (
        Block("RY"),
        Block("CX", _stairs, wrap=True, reverse=True, mirror=False),
        Block("RY"),
        Block("CX", _stairs, reverse=False, mirror=False,
              offset=lambda n: n - 1, span=3, wrap=True),
    ),
    "Circuit_16": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRZ", _bricks),
        Block("CRZ", _bricks, offset=1),
    ),
    "Circuit_17": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRX", _bricks),
        Block("CRX", _bricks, offset=1),
    ),
    "Circuit_18": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRZ", _stairs, wrap=True, mirror=False),
    ),
    "Circuit_19": lambda: (
        Block("RX"), Block("RZ"),
        Block("CRX", _stairs, wrap=True, mirror=False),
    ),
    "Circuit_20": lambda: (
        Block("RY"),
        Block("CX", _stairs, wrap=True, reverse=True, mirror=False),
        Block("RY"),
        Block("CX", _stairs, reverse=False,
              offset=lambda n: n - 2, span=1, wrap=True),
    ),
    "No_Entangling": lambda: (Block("Rot"),),
    "Hardware_Efficient": lambda: (
        Block("RY"), Block("RZ"), Block("RY"),
        Block("CX", _bricks, mirror=False),
        Block("CX", _bricks, offset=-1, modulo=True, wrap=True, mirror=False),
    ),
    "Strongly_Entangling": lambda: (
        Block("Rot"),
        Block("CX", _stairs, wrap=True, reverse=False, mirror=False),
        Block("Rot"),
        Block("CX", _stairs, reverse=False,
              span=lambda n: n // 2, wrap=True, mirror=False),
    ),
}

# Registry order for get_available (parameterized circuits first).
_PARAMETERIZED = [
    f"Circuit_{i}" for i in (*range(1, 11), *range(13, 21))
] + ["No_Entangling", "Strongly_Entangling", "Hardware_Efficient"]


def _circuit_class(name: str) -> type:
    """Generate a DeclarativeCircuit subclass from its structure thunk."""
    thunk = _STRUCTURES[name]
    return type(
        name,
        (DeclarativeCircuit,),
        {
            "structure": classmethod(lambda cls, _thunk=thunk: _thunk()),
            "__doc__": f"{name} ansatz (see module-level _STRUCTURES table).",
            "__qualname__": f"Ansaetze.{name}",
        },
    )


class Ansaetze:
    """Registry of shipped ansaetze (Sim et al. numbering + extras).

    All circuits except :class:`GHZ` are generated from the
    ``_STRUCTURES`` table; access them as ``Ansaetze.Circuit_19`` etc.
    """

    def get_available(parameterized_only: bool = False):
        names = list(_PARAMETERIZED)
        if not parameterized_only:
            names += ["No_Ansatz", "GHZ"]
        return [getattr(Ansaetze, n) for n in names]

    class GHZ(DeclarativeCircuit):
        """GHZ state preparation: H on wire 0, then a CX ladder."""

        @classmethod
        def structure(cls):
            return (
                Block("H"),
                Block("CX", Topology.stairs, reverse=True),
            )

        @classmethod
        def build(cls, w: torch.Tensor, n_qubits: int, **kwargs):
            # Structure-table blocks place H on every wire; GHZ needs it on
            # wire 0 only, hence the explicit build method.
            Gates.H(wires=0, **kwargs)
            for q in range(n_qubits - 1):
                Gates.CX(wires=[q, q + 1], **kwargs)

        @classmethod
        def n_pulse_params_per_layer(cls, n_qubits: int) -> int:
            one_h = PulseInformation.num_params("H")
            ladder = (n_qubits - 1) * PulseInformation.num_params(Gates.CX)
            return one_h + ladder


for _name in _STRUCTURES:
    setattr(Ansaetze, _name, _circuit_class(_name))


# ---------------------------------------------------------------------------
# Input encodings
# ---------------------------------------------------------------------------

# Half-width L of each strategy's integer spectrum [-L, L] at `omegas`
# encoding applications; the frequency count is always 2L + 1.  Golomb's
# limit additionally depends on the ruler (largest mark at 2**n_qubits
# dimensions) and is computed in _spectrum_limit.
_ENC_LIMITS: Dict[str, Callable] = {
    "hamming": lambda omegas: omegas,
    "binary": lambda omegas: 2**omegas - 1,
    "ternary": lambda omegas: int(np.floor(3**omegas / 2)),
}


class Encoding:
    """Input-encoding strategy: hamming / binary / ternary / golomb.

    Implements the frequency-spectrum constructions of
    https://doi.org/10.22331/q-2023-12-20-1210 (hamming/binary/ternary) and
    Peters et al. arXiv:2209.05523 (golomb).
    """

    def __init__(
        self,
        strategy: str,
        gates: Union[str, Callable, List[Union[str, Callable]]],
    ) -> None:
        if strategy not in ("hamming", "binary", "ternary", "golomb"):
            raise ValueError(
                f"Encoding strategy {strategy} not implemented. "
                "Available options: ['hamming', 'binary', 'ternary', 'golomb']"
            )
        self._strategy = strategy
        wrap = getattr(self, strategy)
        log.debug(f"Using encoding strategy: '{wrap.__name__}'")

        if strategy == "golomb":
            # Golomb ignores the per-qubit gate spec: one diagonal
            # multi-qubit gate carries the whole encoding.
            self._gates = []
            self.callable = [wrap(None)]
            return
        try:
            self._gates = Gates.parse_gates(gates, Gates)
        except ValueError as e:
            raise ValueError(f"Error parsing encodings: {e}")
        self.callable = [wrap(g) for g in self._gates]

    def __len__(self) -> int:
        return len(self.callable)

    def __getitem__(self, idx):
        return self.callable[idx]

    def _spectrum_limit(self, omegas):
        """Largest frequency magnitude this strategy reaches at `omegas`."""
        if self._strategy != "golomb":
            return _ENC_LIMITS[self._strategy](omegas)
        from qml_essentials_tpu_torch.models.unitary import golomb_ruler

        n_qubits = getattr(self, "_n_qubits", None)
        if n_qubits is None:
            raise ValueError("Golomb encoding requires n_qubits to be set")
        return omegas * max(golomb_ruler(2**n_qubits))

    def get_n_freqs(self, omegas) -> int:
        """Number of frequencies (both signs + DC) this strategy produces."""
        return int(2 * self._spectrum_limit(omegas) + 1)

    def get_spectrum(self, omegas) -> np.ndarray:
        """Integer frequency spectrum ``[-L, L]`` of the encoding strategy."""
        limit = self._spectrum_limit(omegas)
        return np.arange(-limit, limit + 1)

    @property
    def is_golomb(self) -> bool:
        """Whether this encoding uses the multi-qubit diagonal Golomb gate."""
        return self._strategy == "golomb"

    # -- per-strategy gate wrappers ------------------------------------------

    @staticmethod
    def _frequency_scaled(enc: Callable, base: int) -> Callable:
        """Wrap a per-qubit encoding gate to run at frequency base**wire."""

        def _enc(inputs, wires, **kwargs):
            return enc(inputs * base**wires, wires, **kwargs)

        return _enc

    def hamming(self, enc):
        """Hamming strategy: per-qubit encoding at unit frequency."""
        return enc

    def binary(self, enc):
        """Binary strategy: scale the input by ``2**wire``."""
        return self._frequency_scaled(enc, 2)

    def ternary(self, enc):
        """Ternary strategy: scale the input by ``3**wire``."""
        return self._frequency_scaled(enc, 3)

    def golomb(self, enc):
        """Golomb strategy: one multi-qubit diagonal gate on all wires."""

        def _enc(inputs, wires, **kwargs):
            Gates.GolombEncoding(w=inputs, wires=wires, **kwargs)

        return _enc
