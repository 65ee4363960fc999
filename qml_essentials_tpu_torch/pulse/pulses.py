"""Pulse-level gate system.

Four pieces:

* :class:`PulseParams` — hierarchical (leaf / composite) pulse parameter
  trees; composites are lists of :class:`DecompositionStep`.
* :class:`PulseEnvelope` — registry of envelope shapes (gaussian, square,
  cosine, drag, sech) and the construction of the interaction-picture
  coefficient functions (RWA / lab / drive frames).
* :class:`PulseInformation` — the process-global pulse configuration:
  leaf/composite gate trees, envelope/RWA/frame switches, snapshots.
* :class:`PulseGates` — pulse-backed gate frontend; leaf gates (RX, RY,
  virtual RZ, CZ) evolve small time-dependent Hamiltonians through
  :class:`~qml_essentials_tpu_torch.pulse.evolution.Evolution`; composites
  walk their decomposition trees.

A leaf gate records a pending operation; the recording solves all of a
tape's leaves together, one batched call per Hamiltonian family (see
:mod:`~qml_essentials_tpu_torch.pulse.evolution`).  A leaf takes an angle
``w`` of shape ``()`` or ``(Bt,)`` and pulse parameters ``(P,)`` or
``(Bt, P)`` (a batch recorded as one tape): its matrix is then
``(Bt, d, d)``.  Pulse parameters stored in the trees are float64 CPU
tensors; a leaf computes in the dtype and on the device of the parameters
it is given (a model's pulse scalers), else of its angle.

Composite decompositions live in a declarative recipe table (`_RECIPES`,
gate → [(child, wires, angle)] rows with a tiny angle-expression
vocabulary) compiled into :class:`PulseParams` trees by one function.  The
calibrated default parameters and the recipes are the JAX package's.

Counterpart of ``qml_essentials_tpu/pulse/pulses.py``.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.core import jaqsi as js
from qml_essentials_tpu_torch.models.unitary import UnitaryGates
from qml_essentials_tpu_torch.ops.tape import active_pulse_tape
from qml_essentials_tpu_torch.pulse.evolution import Evolution
from qml_essentials_tpu_torch.utils import safe_random_split

log = logging.getLogger(__name__)


@dataclass
class DecompositionStep:
    """One step of a composite pulse gate.

    Attributes:
        gate: Child :class:`PulseParams`.
        wire_fn: ``"all"`` | ``"target"`` | ``"control"``.
        angle_fn: Maps the parent angle(s) to the child angle (``None`` =
            pass through).
    """

    gate: "PulseParams"
    wire_fn: str = "all"
    angle_fn: Optional[Callable] = None


@dataclass(frozen=True)
class PulseStateSnapshot:
    """Immutable snapshot of the mutable global pulse configuration."""

    envelope: str
    rwa: bool
    frame: str
    leaf_params: Dict[str, torch.Tensor]


class PulseParams:
    """Hierarchical pulse parameter container (leaf or composite).

    A leaf owns a flat parameter vector; a composite owns an ordered list
    of :class:`DecompositionStep` children and exposes their concatenated
    parameters.  ``leaf_params`` addresses the *unique* leaves instead
    (shared leaves appear once).  Splitting a parameter vector slices its
    last axis, so a batch ``(Bt, P)`` splits row by row.

    A composite's concatenation is kept until a leaf's tensor is replaced
    (assign ``params``; do not modify a stored tensor in place), so a gate
    reads the same tensor every time and its copy on the card is made once.
    """

    def __init__(
        self,
        name: str = "",
        params: Optional[torch.Tensor] = None,
        decomposition: Optional[List[DecompositionStep]] = None,
    ) -> None:
        assert (params is None) != (decomposition is None), (
            "Exactly one of `params` or `decomposition` must be provided."
        )
        self.name = name
        self.decomposition = decomposition
        self._cat = None
        if params is not None:
            self._params = params

    # ------------------------------------------------------------- topology
    @property
    def is_leaf(self) -> bool:
        return self.decomposition is None

    @property
    def childs(self) -> List["PulseParams"]:
        return [] if self.is_leaf else [s.gate for s in self.decomposition]

    @property
    def leafs(self) -> List["PulseParams"]:
        """Unique leaf nodes of the tree."""
        if self.is_leaf:
            return [self]
        found: List[PulseParams] = []
        for child in self.childs:
            for leaf in child.leafs:
                if leaf not in found:
                    found.append(leaf)
        return found

    def _parts(self, leaf_level: bool) -> List["PulseParams"]:
        return self.leafs if leaf_level else self.childs

    # ------------------------------------------------------------- sizing
    def __len__(self) -> int:
        if self.is_leaf:
            return len(self._params)
        return sum(len(c) for c in self.childs)

    @property
    def size(self) -> int:
        return len(self)

    @property
    def shape(self) -> List[int]:
        if self.is_leaf:
            return [len(self._params)]
        return [len(c) for c in self.childs]

    def __getitem__(self, idx: int):
        return self._params[idx] if self.is_leaf else self.childs[idx].params

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return self.name

    # ----------------------------------------------------------- parameters
    @property
    def params(self) -> torch.Tensor:
        """Leaf: own vector; composite: concatenation over direct children."""
        if self.is_leaf:
            return self._params
        parts = [c.params for c in self.childs]
        key = tuple(id(p) for p in parts)
        if self._cat is None or self._cat[0] != key:
            self._cat = (key, parts, torch.cat(parts))  # parts keep the ids alive
        return self._cat[2]

    @params.setter
    def params(self, value: torch.Tensor) -> None:
        if self.is_leaf:
            assert isinstance(value, torch.Tensor), "params must be a torch.Tensor"
            self._params = value
            return
        for child, chunk in zip(self.childs, self.split_params(value)):
            child.params = chunk

    @property
    def leaf_params(self) -> torch.Tensor:
        if self.is_leaf:
            return self._params
        return torch.cat([leaf.params for leaf in self.leafs])

    @leaf_params.setter
    def leaf_params(self, value: torch.Tensor) -> None:
        if self.is_leaf:
            self._params = value
            return
        for leaf, chunk in zip(self.leafs, self.split_params(value, leafs=True)):
            leaf.params = chunk

    def split_params(
        self,
        params: Optional[torch.Tensor] = None,
        leafs: bool = False,
    ) -> List[torch.Tensor]:
        """Split *params* (or own) across direct children or unique leaves."""
        if params is None:
            if self.is_leaf:
                return self._params
            return [p.params for p in self._parts(leafs)]
        if self.is_leaf:
            return params
        params = _as_params(params)
        chunks: List[torch.Tensor] = []
        cursor = 0
        for part in self._parts(leafs):
            chunks.append(params[..., cursor : cursor + part.size])
            cursor += part.size
        return chunks


# ---------------------------------------------------------------------------
# Envelopes + coefficient functions
# ---------------------------------------------------------------------------


class PulseEnvelope:
    """Registry of pulse envelope shapes ``(p, t, t_c) -> amplitude``.

    The carrier ``cos(omega_c t + phi_c)`` is applied separately by the
    coefficient functions from :meth:`build_coeff_fns`.  Envelopes are
    written for one problem (``p`` one parameter vector, ``t`` one time);
    the solver maps them over a batch.
    """

    @staticmethod
    def gaussian(p, t, t_c):
        """Gaussian envelope; ``p = [A, sigma]``."""
        return p[0] * torch.exp(-0.5 * ((t - t_c) / p[1]) ** 2)

    @staticmethod
    def square(p, t, t_c):
        """Rectangular envelope; ``p = [A, width]``."""
        return p[0] * (torch.abs(t - t_c) <= p[1] / 2)

    @staticmethod
    def cosine(p, t, t_c):
        """Raised cosine envelope; ``p = [A, width]``."""
        return p[0] * torch.cos(math.pi * torch.clip((t - t_c) / p[1], -0.5, 0.5))

    @staticmethod
    def drag(p, t, t_c):
        """DRAG envelope; ``p = [A, beta, sigma]``."""
        g = p[0] * torch.exp(-0.5 * ((t - t_c) / p[2]) ** 2)
        return g + p[1] * g * (-(t - t_c) / p[2] ** 2)

    @staticmethod
    def sech(p, t, t_c):
        """Hyperbolic secant envelope; ``p = [A, sigma]``."""
        return p[0] / torch.cosh((t - t_c) / p[1])

    # Per-gate calibrated defaults (flat float rows; the trailing element is
    # always the evolution time).  These are physics calibration constants:
    # with them, each pulse leaf reproduces its analytic unitary at
    # fidelity >= 0.99 out of the box.
    _CALIBRATION: Dict[str, Dict[str, Tuple[float, ...]]] = {
        "gaussian": {
            "RX": (0.38009941846766804, 1.631698142660167, 3.007403822238108),
            "RY": (0.3836652338514791, 1.616595983505249, 2.9794135093698966),
        },
        "square": {
            "RX": (1.209655637514602, 0.8266815576721239, 1.1483122857413859),
            "RY": (1.0287942142779052, 0.9860505130182093, 0.9720116870310977),
        },
        "cosine": {"RX": (1.0, 1.0, 1.0), "RY": (1.0, 1.0, 1.0)},
        "drag": {
            "RX": (0.326562746114197, 0.4002767596709071,
                   5.3228107728890315, 3.141300761986467),
            "RY": (0.323287924190616, 0.4065017233024265,
                   7.00299644871222, 3.139481229843545),
        },
        "sech": {"RX": (1.0, 1.0, 1.0), "RY": (1.0, 1.0, 1.0)},
        "general": {"RZ": (0.5,), "CZ": (0.3183098783513154,)},
    }

    # Envelope-parameter count per shape (excludes the evolution time).
    _N_ENV_PARAMS = {"gaussian": 2, "square": 2, "cosine": 2,
                     "drag": 3, "sech": 2, "general": 0}

    @staticmethod
    def available() -> List[str]:
        """Names of all registered envelopes."""
        return list(PulseEnvelope._CALIBRATION)

    @staticmethod
    def get(name: str) -> dict:
        """Envelope metadata by name; raises on unknown names.

        Returns ``{"fn", "n_envelope_params", "defaults"}`` where
        ``defaults`` maps gate name -> calibrated parameter vector (float64).
        """
        if name not in PulseEnvelope._CALIBRATION:
            raise ValueError(
                f"Unknown pulse envelope '{name}'. "
                f"Available: {PulseEnvelope.available()}"
            )
        return {
            "fn": None if name == "general" else getattr(PulseEnvelope, name),
            "n_envelope_params": PulseEnvelope._N_ENV_PARAMS[name],
            "defaults": {
                g: torch.tensor(row, dtype=torch.float64)
                for g, row in PulseEnvelope._CALIBRATION[name].items()
            },
        }

    @staticmethod
    def build_coeff_fns(
        envelope_fn: Callable,
        omega_c: float,
        omega_q: float,
        rwa: bool = True,
        frame: str = "drive",
    ) -> Tuple[Callable, Callable, Callable, Callable]:
        """Build ``(coeff_RX_X, coeff_RX_Y, coeff_RY_X, coeff_RY_Y)``.

        Interaction-picture drive for a qubit driven on X with static
        ``H = (omega_q/2) Z``:

            H_I(t) = Omega(t) cos(omega_c t + phi) [cos(omega_q t) X
                                                    - sin(omega_q t) Y]

        ``rwa=True`` keeps the slow component
        ``(Omega/2)(cos(phi) X + sin(phi) Y)`` only; ``frame="drive"``
        expands the exact product into slow (omega_c - omega_q) and fast
        (omega_c + omega_q) modes via product-to-sum identities
        (numerically friendlier for fixed-grid Magnus); ``frame="lab"``
        keeps the literal product.  The rotation angle is always the last
        element of ``p``.

        Every returned function is a distinct ``def`` (own ``__code__``),
        which the Evolution solver cache uses to key solvers.
        """
        if frame not in ("lab", "drive"):
            raise ValueError(f"Unknown frame {frame!r}; expected 'lab' or 'drive'.")

        def _env(p, t):
            return envelope_fn(p, t, t / 2)

        if rwa:

            def rwa_rx_x(p, t):
                return 0.5 * _env(p, t) * p[-1]

            def rwa_rx_y(p, t):
                return torch.zeros_like(0.5 * _env(p, t) * p[-1])

            def rwa_ry_x(p, t):
                return torch.zeros_like(0.5 * _env(p, t) * p[-1])

            def rwa_ry_y(p, t):
                return 0.5 * _env(p, t) * p[-1]

            return rwa_rx_x, rwa_rx_y, rwa_ry_x, rwa_ry_y

        if frame == "drive":
            slow = omega_c - omega_q
            fast = omega_c + omega_q

            def drv_rx_x(p, t):
                return (
                    0.5 * _env(p, t) * (torch.cos(slow * t) + torch.cos(fast * t)) * p[-1]
                )

            def drv_rx_y(p, t):
                return (
                    -0.5 * _env(p, t) * (torch.sin(fast * t) - torch.sin(slow * t)) * p[-1]
                )

            def drv_ry_x(p, t):
                return (
                    -0.5 * _env(p, t) * (torch.sin(fast * t) + torch.sin(slow * t)) * p[-1]
                )

            def drv_ry_y(p, t):
                return (
                    -0.5 * _env(p, t) * (torch.cos(fast * t) - torch.cos(slow * t)) * p[-1]
                )

            return drv_rx_x, drv_rx_y, drv_ry_x, drv_ry_y

        def lab_rx_x(p, t):
            return _env(p, t) * torch.cos(omega_c * t) * torch.cos(omega_q * t) * p[-1]

        def lab_rx_y(p, t):
            return -_env(p, t) * torch.cos(omega_c * t) * torch.sin(omega_q * t) * p[-1]

        def lab_ry_x(p, t):
            c = torch.cos(omega_c * t + math.pi / 2)
            return _env(p, t) * c * torch.cos(omega_q * t) * p[-1]

        def lab_ry_y(p, t):
            c = torch.cos(omega_c * t + math.pi / 2)
            return -_env(p, t) * c * torch.sin(omega_q * t) * p[-1]

        return lab_rx_x, lab_rx_y, lab_ry_x, lab_ry_y


# ---------------------------------------------------------------------------
# Composite decomposition recipes (standard gate identities, declarative)
# ---------------------------------------------------------------------------

# Angle-expression vocabulary for recipe rows.
_ANGLE_EXPRS: Dict[str, Optional[Callable]] = {
    "w": None,  # pass through
    "0": lambda w: 0.0,
    "pi": lambda w: math.pi,
    "pi/2": lambda w: math.pi / 2,
    "-pi/2": lambda w: -math.pi / 2,
    "w/2": lambda w: w / 2,
    "-w/2": lambda w: -w / 2,
    "w0": lambda w: w[0],
    "w1": lambda w: w[1],
    "w2": lambda w: w[2],
}

# gate -> [(child, wire-selector, angle-expr)], in build order (children
# first).  These are the textbook decompositions into {RX, RY, RZ, CZ}.
_RECIPES: Dict[str, List[Tuple[str, str, str]]] = {
    "H": [("RZ", "all", "pi"), ("RY", "all", "pi/2")],
    "CX": [("H", "target", "0"), ("CZ", "all", "0"), ("H", "target", "0")],
    "CY": [("RZ", "target", "-pi/2"), ("CX", "all", "w"), ("RZ", "target", "pi/2")],
    "CRX": [
        ("RZ", "target", "pi/2"),
        ("RY", "target", "w/2"),
        ("CX", "all", "0"),
        ("RY", "target", "-w/2"),
        ("CX", "all", "0"),
        ("RZ", "target", "-pi/2"),
    ],
    "CRY": [
        ("RY", "target", "w/2"),
        ("CX", "all", "0"),
        ("RY", "target", "-w/2"),
        ("CX", "all", "0"),
    ],
    "CRZ": [
        ("RZ", "target", "w/2"),
        ("CX", "all", "0"),
        ("RZ", "target", "-w/2"),
        ("CX", "all", "0"),
    ],
    "CPhase": [
        ("RZ", "control", "w/2"),
        ("RZ", "target", "w/2"),
        ("CX", "all", "0"),
        ("RZ", "target", "-w/2"),
        ("CX", "all", "0"),
    ],
    "RZZ": [("CX", "all", "0"), ("RZ", "target", "w"), ("CX", "all", "0")],
    "RXX": [
        ("H", "control", "0"),
        ("H", "target", "0"),
        ("CX", "all", "0"),
        ("RZ", "target", "w"),
        ("CX", "all", "0"),
        ("H", "control", "0"),
        ("H", "target", "0"),
    ],
    "RYY": [
        ("RX", "control", "pi/2"),
        ("RX", "target", "pi/2"),
        ("CX", "all", "0"),
        ("RZ", "target", "w"),
        ("CX", "all", "0"),
        ("RX", "control", "-pi/2"),
        ("RX", "target", "-pi/2"),
    ],
    "RZX": [
        ("H", "target", "0"),
        ("CX", "all", "0"),
        ("RZ", "target", "w"),
        ("CX", "all", "0"),
        ("H", "target", "0"),
    ],
    "Rot": [("RZ", "all", "w0"), ("RY", "all", "w1"), ("RZ", "all", "w2")],
}

# Composite build order (children before parents).
_COMPOSITE_ORDER = (
    "H",
    "CX",
    "CY",
    "CRX",
    "CRY",
    "CRZ",
    "CPhase",
    "RZZ",
    "RXX",
    "RYY",
    "RZX",
    "Rot",
)


class PulseInformation:
    """Process-global pulse configuration (envelope, RWA, frame, gate trees).

    :meth:`set_envelope` switches the active pulse shape: it rebuilds every
    :class:`PulseParams` tree and the coefficient functions on
    :class:`PulseGates`, and evicts the Evolution solver cache.
    """

    DEFAULT_ENVELOPE: str = "drag"
    DEFAULT_RWA: bool = True
    DEFAULT_FRAME: str = "drive"
    LEAF_GATE_NAMES: Tuple[str, ...] = ("RX", "RY", "RZ", "CZ")

    OPTIMIZED_PULSES: Dict[str, torch.Tensor] = {}

    # Active configuration, kept in one dict so snapshot/restore and the
    # accessors below are all views of the same record.
    _cfg: Dict[str, object] = {
        "envelope": DEFAULT_ENVELOPE,
        "rwa": DEFAULT_RWA,
        "frame": DEFAULT_FRAME,
    }

    # PulseGates attribute slots that receive the rebuilt coefficient
    # functions, in build_coeff_fns return order (the Sx/Sy shorthands
    # alias the RX-X / RY-Y drives).
    _COEFF_SLOTS = (
        ("_coeff_RX_X", "_coeff_Sx"),
        ("_coeff_RX_Y",),
        ("_coeff_RY_X",),
        ("_coeff_RY_Y", "_coeff_Sy"),
    )

    @classmethod
    def _rebuild_gate_trees(cls) -> None:
        """Instantiate leaf params from the envelope defaults, then compile
        every composite recipe into a PulseParams tree (children first)."""
        calib = dict(PulseEnvelope.get("general")["defaults"])
        calib.update(PulseEnvelope.get(cls._cfg["envelope"])["defaults"])
        for name in cls.LEAF_GATE_NAMES:
            setattr(cls, name, PulseParams(name=name, params=calib[name]))

        for name in _COMPOSITE_ORDER:
            steps = [
                DecompositionStep(getattr(cls, child), selector, _ANGLE_EXPRS[expr])
                for child, selector, expr in _RECIPES[name]
            ]
            setattr(cls, name, PulseParams(name=name, decomposition=steps))

        cls.unique_gate_set = [getattr(cls, n) for n in cls.LEAF_GATE_NAMES]

    @classmethod
    def _reconfigure(cls, **changes) -> None:
        """Apply config changes, then rebuild trees + coefficient functions.

        The single writer of the global pulse state: every public switch
        (:meth:`set_envelope`, :meth:`set_rwa`, :meth:`set_frame`,
        :meth:`restore_state`, :meth:`reset_defaults`) funnels through here.
        """
        nxt = {**cls._cfg, **{k: v for k, v in changes.items() if v is not None}}
        if nxt["frame"] not in ("lab", "drive"):
            raise ValueError(
                f"Unknown frame {nxt['frame']!r}; expected 'lab' or 'drive'."
            )
        shape = PulseEnvelope.get(nxt["envelope"])  # validates the name
        cls._cfg = nxt
        cls._rebuild_gate_trees()

        fns = PulseEnvelope.build_coeff_fns(
            shape["fn"],
            PulseGates.omega_c,
            PulseGates.omega_q,
            rwa=nxt["rwa"],
            frame=nxt["frame"],
        )
        for fn, slots in zip(fns, cls._COEFF_SLOTS):
            for slot in slots:
                setattr(PulseGates, slot, staticmethod(fn))
        for key, val in nxt.items():
            setattr(PulseGates, f"_active_{key}", val)

        # The Evolution solver cache is keyed on the coefficient functions'
        # code objects; rebuilding them orphans cached solvers.
        Evolution.clear_evolve_solver_cache()
        log.info("Pulse config now %s", nxt)

    @classmethod
    def set_envelope(
        cls,
        name: str,
        rwa: Optional[bool] = None,
        frame: Optional[str] = None,
    ) -> None:
        """Switch pulse envelope (and optionally RWA/frame); rebuilds trees."""
        cls._reconfigure(envelope=name, rwa=rwa, frame=frame)

    @classmethod
    def set_rwa(cls, rwa: bool) -> None:
        """Toggle the rotating-wave approximation (rebuilds coeff fns)."""
        cls._reconfigure(rwa=bool(rwa))

    @classmethod
    def set_frame(cls, frame: str) -> None:
        """Switch the exact-coefficient frame (``"lab"`` / ``"drive"``)."""
        cls._reconfigure(frame=str(frame))

    @classmethod
    def get_envelope(cls) -> str:
        return cls._cfg["envelope"]

    @classmethod
    def get_rwa(cls) -> bool:
        return cls._cfg["rwa"]

    @classmethod
    def get_frame(cls) -> str:
        return cls._cfg["frame"]

    # ------------------------------------------------------------ snapshots
    @classmethod
    def snapshot_state(cls) -> PulseStateSnapshot:
        """Immutable snapshot of the active pulse configuration."""
        frozen_leafs = {}
        for name in cls.LEAF_GATE_NAMES:
            tree = getattr(cls, name, None)
            if tree is not None:
                frozen_leafs[name] = tree.params.detach().clone()
        return PulseStateSnapshot(leaf_params=frozen_leafs, **cls._cfg)

    @classmethod
    def restore_state(cls, snapshot: PulseStateSnapshot) -> None:
        """Restore a snapshot produced by :meth:`snapshot_state`."""
        cls._reconfigure(
            envelope=snapshot.envelope, rwa=snapshot.rwa, frame=snapshot.frame
        )
        for name, saved in snapshot.leaf_params.items():
            tree = cls.gate_by_name(name)
            if tree is None or not tree.is_leaf:
                raise ValueError(f"Cannot restore unknown leaf pulse gate {name!r}.")
            if tree.params.shape != saved.shape:
                raise ValueError(
                    f"Snapshot for {name!r} has shape {tuple(saved.shape)}, "
                    f"but active gate expects {tuple(tree.params.shape)}."
                )
            tree.params = saved.clone()

    @classmethod
    @contextmanager
    def preserve_state(cls):
        """Scope guard: restore the global pulse state on exit."""
        snapshot = cls.snapshot_state()
        try:
            yield snapshot
        finally:
            cls.restore_state(snapshot)

    @classmethod
    def reset_defaults(
        cls,
        envelope: Optional[str] = None,
        rwa: Optional[bool] = None,
        frame: Optional[str] = None,
    ) -> None:
        """Reset pulse globals to canonical defaults or explicit values."""
        cls._reconfigure(
            envelope=envelope or cls.DEFAULT_ENVELOPE,
            rwa=cls.DEFAULT_RWA if rwa is None else rwa,
            frame=frame or cls.DEFAULT_FRAME,
        )

    # ------------------------------------------------------------- lookups
    @staticmethod
    def gate_by_name(gate):
        """Look up the :class:`PulseParams` tree for a gate (name or callable)."""
        key = gate if isinstance(gate, str) else gate.__name__
        return getattr(PulseInformation, key, None)

    @staticmethod
    def num_params(gate) -> int:
        """Total pulse-parameter count of a gate's tree."""
        return len(PulseInformation.gate_by_name(gate))

    @staticmethod
    def update_params(path: Optional[str] = None) -> None:
        """Load optimized pulse parameters from a QOC results CSV."""
        path = path or os.path.join(os.getcwd(), "qoc_results.csv")
        if not os.path.isfile(path):
            log.error(f"No optimized pulses found at {path}")
            return
        log.info(f"Loading optimized pulses from {path}")
        with open(path) as f:
            for row in csv.reader(f):
                log.debug(
                    f"Loading optimized pulses for {row[0]} "
                    f"(Fidelity: {float(row[1]):.5f}): {row[2:]}"
                )
                PulseInformation.OPTIMIZED_PULSES[row[0]] = torch.tensor(
                    [float(x) for x in row[2:]], dtype=torch.float64
                )

    @staticmethod
    def shuffle_params(random_key: torch.Generator) -> None:
        """Randomise every leaf gate's parameters, uniform in [0, 1), one
        generator split off *random_key* per leaf (QOC restarts)."""
        leafs = PulseInformation.unique_gate_set
        for tree, gen in zip(leafs, safe_random_split(random_key, len(leafs))):
            tree.params = torch.rand(len(tree), generator=gen, dtype=torch.float64)


# ---------------------------------------------------------------------------
# Gate frontend
# ---------------------------------------------------------------------------


def _as_params(pp) -> torch.Tensor:
    """A pulse parameter vector as a real tensor (a list of numbers as
    float64, like the trees' constants)."""
    if isinstance(pp, torch.Tensor):
        return pp if pp.is_floating_point() else pp.to(torch.float64)
    if isinstance(pp, (list, tuple)) and any(isinstance(x, torch.Tensor) for x in pp):
        return torch.stack([torch.as_tensor(x) for x in pp])
    return torch.as_tensor(np.asarray(pp, dtype=np.float64))


def _leaf_inputs(pulse_params, w=None) -> tuple:
    """``(pulse_params, w, rows)`` of a leaf: the parameters ``(P,)`` or
    ``(rows, P)`` and the angle ``()`` or ``(rows,)`` in one dtype and on one
    device (the angle's if it is a tensor, else the parameters'), both
    expanded to the batch's rows when either is batched (``rows`` None
    otherwise)."""
    pp = _as_params(pulse_params)
    if isinstance(w, torch.Tensor):
        rdt = torch.promote_types(pp.dtype, w.dtype) if w.is_floating_point() else pp.dtype
        device = w.device
        w = w.to(rdt)
    else:
        rdt, device = pp.dtype, pp.device
    pp = pp.to(device=device, dtype=rdt)
    if w is not None and not isinstance(w, torch.Tensor):
        w = torch.full((), float(w), dtype=rdt, device=device)
    lead = torch.broadcast_shapes(pp.shape[:-1], () if w is None else w.shape)
    if not lead:
        return pp, w, None
    rows = lead[0]
    pp = pp.expand(rows, pp.shape[-1])
    return pp, None if w is None else w.expand(rows), rows


def _host(x):
    """A scalar as a float for an event record; a batch stays a tensor."""
    if isinstance(x, torch.Tensor):
        return float(x) if x.numel() == 1 else x.detach()
    return float(x)


class PulseGates:
    """Pulse-level gate frontend (leafs evolve Hamiltonians; composites walk
    decompositions).  See https://doi.org/10.5445/IR/1000184129 for the
    physical model."""

    omega_q = 10 * math.pi
    omega_c = 10 * math.pi

    X = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
    Y = torch.tensor([[0, -1j], [1j, 0]], dtype=torch.complex128)
    Z = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128)
    # complex64, as the JAX package's: the ZZ-coupling generator of the CZ
    # pulse and the H correction phase below are built from it, so they
    # carry float32-rounded multiples of pi in float64 solves too.
    Id = torch.eye(2, dtype=torch.complex64)

    _H_CZ = (math.pi / 4) * (
        torch.kron(Id, Id) - torch.kron(Z, Id).to(Id.dtype)
        - torch.kron(Id, Z).to(Id.dtype) + torch.kron(Z, Z).to(Id.dtype)
    )
    _H_corr = math.pi / 2 * torch.eye(2, dtype=torch.complex64)

    _active_envelope: str = "drag"
    _active_rwa: bool = True
    _active_frame: str = "drive"

    # Coefficient-function slots, filled in by PulseInformation._reconfigure
    # (called via reset_defaults() at the bottom of this module — no pulse
    # gate can run before then).
    _coeff_RX_X = _coeff_RX_Y = _coeff_RY_X = _coeff_RY_Y = None
    _coeff_Sx = _coeff_Sy = None

    @staticmethod
    def _coeff_Sz(p, t):
        """Virtual-RZ coefficient: duration * angle."""
        return p[0] * p[1]

    @staticmethod
    def _coeff_Sc(p, t):
        """Constant coefficient for the H correction phase."""
        return -1.0

    @staticmethod
    def _coeff_Scz(p, t):
        """CZ coupling strength coefficient."""
        return p * math.pi

    # ------------------------------------------------------------ recording
    @staticmethod
    def _record_pulse_event(gate_name, w, wires, pulse_params, parent=None) -> None:
        """Append a PulseEvent to the active pulse tape, if recording."""
        ptape = active_pulse_tape()
        if ptape is None:
            return
        from qml_essentials_tpu_torch.utils.pulse_events import LEAF_META, PulseEvent

        meta = LEAF_META.get(gate_name, {})
        wires_list = [wires] if isinstance(wires, int) else list(wires)
        parts = _as_params(PulseInformation.gate_by_name(gate_name).split_params(pulse_params))

        if meta.get("physical", False):
            info = PulseEnvelope.get(PulseInformation.get_envelope())
            event = PulseEvent(
                gate=gate_name,
                wires=wires_list,
                envelope_fn=info["fn"],
                envelope_params=parts[..., :-1].detach(),
                w=_host(w),
                duration=_host(parts[..., -1]),
                carrier_phase=meta["carrier_phase"],
                parent=parent,
            )
        else:
            event = PulseEvent(
                gate=gate_name,
                wires=wires_list,
                envelope_fn=None,
                envelope_params=parts.detach(),
                w=_host(w) if not isinstance(w, list) else 0.0,
                duration=1.0,
                carrier_phase=0.0,
                parent=parent,
            )
        ptape.append(event)

    # ------------------------------------------------------------ leaf gates
    @staticmethod
    def _drive_rotation(
        gate_name, coeff_x, coeff_y, w, wires, pulse_params, noise_params, random_key
    ) -> None:
        """Shared RX/RY body: evolve the two-quadrature drive Hamiltonian."""
        pulse_params = PulseInformation.gate_by_name(gate_name).split_params(
            pulse_params
        )
        PulseGates._record_pulse_event(gate_name, w, wires, pulse_params)

        H_eff = coeff_x * js.Hamiltonian(PulseGates.X, wires=wires) + coeff_y * (
            js.Hamiltonian(PulseGates.Y, wires=wires)
        )

        w, random_key = UnitaryGates.GateError(w, noise_params, random_key)
        pp, w, rows = _leaf_inputs(pulse_params, w)
        drive_params = torch.cat([pp[..., :-1], w[..., None]], dim=-1)
        H_eff.evolve(name=gate_name)([drive_params, drive_params], pp[..., -1], rows=rows)
        UnitaryGates.Noise(wires, noise_params)

    @staticmethod
    def RX(w, wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """X rotation from the active envelope's interaction-picture drive."""
        PulseGates._drive_rotation(
            "RX",
            PulseGates._coeff_RX_X,
            PulseGates._coeff_RX_Y,
            w,
            wires,
            pulse_params,
            noise_params,
            random_key,
        )

    @staticmethod
    def RY(w, wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """Y rotation (carrier phase +pi/2)."""
        PulseGates._drive_rotation(
            "RY",
            PulseGates._coeff_RY_X,
            PulseGates._coeff_RY_Y,
            w,
            wires,
            pulse_params,
            noise_params,
            random_key,
        )

    @staticmethod
    def RZ(w, wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """Virtual Z rotation (phase tracking, no physical pulse)."""
        pulse_params = PulseInformation.RZ.split_params(pulse_params)
        PulseGates._record_pulse_event("RZ", w, wires, pulse_params)

        H_eff = PulseGates._coeff_Sz * js.Hamiltonian(PulseGates.Z, wires=wires)
        w, random_key = UnitaryGates.GateError(w, noise_params, random_key)
        pp, w, rows = _leaf_inputs(pulse_params, w)
        H_eff.evolve(name="RZ")([torch.cat([pp[..., :1], w[..., None]], dim=-1)], 1.0,
                                rows=rows)
        UnitaryGates.Noise(wires, noise_params)

    @staticmethod
    def CZ(wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """Controlled-Z from the ZZ-coupling Hamiltonian."""
        if pulse_params is None:
            pulse_params = PulseInformation.CZ.params
        PulseGates._record_pulse_event("CZ", 0.0, wires, pulse_params)

        H_eff = PulseGates._coeff_Scz * js.Hamiltonian(PulseGates._H_CZ, wires=wires)
        pp, _, rows = _leaf_inputs(pulse_params)
        H_eff.evolve(name="CZ")([pp], 1.0, rows=rows)
        UnitaryGates.Noise(wires, noise_params)

    # ------------------------------------------------------------ composites
    @staticmethod
    def _resolve_wires(selector, wires):
        """Map a wire selector (``all``/``target``/``control``) to wires."""
        wires_list = [wires] if isinstance(wires, int) else list(wires)
        if selector == "all":
            return wires if len(wires_list) > 1 else wires_list[0]
        if selector == "target":
            return wires_list[-1] if len(wires_list) > 1 else wires_list[0]
        if selector == "control":
            return wires_list[0]
        raise ValueError(f"Unknown wire_fn: {selector!r}")

    @staticmethod
    def _execute_composite(gate_name, w, wires, pulse_params=None) -> None:
        """Walk a composite gate's decomposition steps.

        Child call shape is decided by the child's *kind*: angle leafs and
        composites take ``(w, wires, ...)``, CZ takes no angle, Rot unpacks
        its angle triple.
        """
        tree = PulseInformation.gate_by_name(gate_name)
        for step, child_params in zip(
            tree.decomposition, tree.split_params(pulse_params)
        ):
            target = PulseGates._resolve_wires(step.wire_fn, wires)
            angle = w if step.angle_fn is None else step.angle_fn(w)
            child = getattr(PulseGates, step.gate.name)
            if step.gate.name in ("CZ", "H", "CX", "CY"):
                child(wires=target, pulse_params=child_params)
            elif step.gate.name == "Rot":
                child(*angle, wires=target, pulse_params=child_params)
            else:
                child(angle, wires=target, pulse_params=child_params)

    @staticmethod
    def Rot(phi, theta, omega, wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """General rotation via RZ/RY/RZ pulse decomposition."""
        if noise_params is not None and "GateError" in noise_params:
            angles = []
            for a in (phi, theta, omega):
                a, random_key = UnitaryGates.GateError(a, noise_params, random_key)
                angles.append(a)
            phi, theta, omega = angles
        PulseGates._execute_composite("Rot", [phi, theta, omega], wires, pulse_params)
        UnitaryGates.Noise(wires, noise_params)

    @staticmethod
    def PauliRot(pauli, theta, wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """Not available as a pulse gate."""
        raise NotImplementedError("PauliRot gate is not implemented as PulseGate")

    @staticmethod
    def H(wires, pulse_params=None, noise_params=None, random_key=None) -> None:
        """Hadamard via RZ(pi)·RY(pi/2) plus a correction phase."""
        PulseGates._execute_composite("H", 0.0, wires, pulse_params)
        # The correction does not depend on the parameters: one unbatched
        # gate in their dtype, on their device.
        like = _as_params(PulseInformation.H.params if pulse_params is None else pulse_params)
        H_corr = PulseGates._coeff_Sc * js.Hamiltonian(PulseGates._H_corr, wires=wires)
        H_corr.evolve(name="H")([like.new_zeros(())], 1.0)
        UnitaryGates.Noise(wires, noise_params)


def _install_composite_frontends() -> None:
    """Generate the uniform composite gate methods from the recipe table.

    ``CX`` / ``CY`` take no angle; the remaining composites take one angle
    and apply GateError noise to it first (matching the unitary backend).
    """

    def angleless(name):
        def gate(wires, pulse_params=None, noise_params=None, random_key=None):
            PulseGates._execute_composite(name, 0.0, wires, pulse_params)
            UnitaryGates.Noise(wires, noise_params)

        gate.__name__ = name
        gate.__qualname__ = f"PulseGates.{name}"
        gate.__doc__ = f"{name} via its pulse decomposition recipe."
        return staticmethod(gate)

    def angled(name):
        def gate(w, wires, pulse_params=None, noise_params=None, random_key=None):
            w, random_key = UnitaryGates.GateError(w, noise_params, random_key)
            PulseGates._execute_composite(name, w, wires, pulse_params)
            UnitaryGates.Noise(wires, noise_params)

        gate.__name__ = name
        gate.__qualname__ = f"PulseGates.{name}"
        gate.__doc__ = f"{name} via its pulse decomposition recipe."
        return staticmethod(gate)

    for name in ("CX", "CY"):
        setattr(PulseGates, name, angleless(name))
    for name in ("CRY", "CRZ", "CPhase", "RXX", "RYY", "RZZ", "RZX"):
        setattr(PulseGates, name, angled(name))

    # CRX matches the reference in not perturbing its angle with GateError
    # (the decomposition's RZ/RY children receive exact sub-angles).
    def crx(w, wires, pulse_params=None, noise_params=None, random_key=None):
        PulseGates._execute_composite("CRX", w, wires, pulse_params)
        UnitaryGates.Noise(wires, noise_params)

    crx.__name__ = "CRX"
    crx.__qualname__ = "PulseGates.CRX"
    PulseGates.CRX = staticmethod(crx)


_install_composite_frontends()


class PulseParamManager:
    """Cursor-based slicer over a flat model pulse-parameter vector (its
    last axis: a batch ``(Bt, n)`` slices row by row)."""

    def __init__(self, pulse_params: torch.Tensor) -> None:
        self.pulse_params = pulse_params
        self.idx = 0

    def get(self, n: int):
        """Return the next *n* parameters and advance the cursor."""
        lo, self.idx = self.idx, self.idx + n
        if self.idx > self.pulse_params.shape[-1]:
            raise ValueError("Not enough pulse parameters left for this gate")
        part = self.pulse_params[..., lo : self.idx]
        return part.squeeze() if part.dim() == 1 else part


# Initialise the global pulse configuration once PulseGates exists, so leaf
# defaults, composite trees and coefficient functions are consistent.
PulseInformation.reset_defaults()
