"""Quantum Optimal Control: pulse-parameter synthesis around one population
optimiser.

* **One population-descent engine** (:meth:`QOC._descend`): a population of
  candidate parameter vectors ``(R, P)`` advances together, every member
  with its own Adam(W) state, its own gradient-norm clip, its own NaN guard
  (a member whose update goes non-finite freezes, optimiser state
  included) and its own early stop.  The optimiser is optax's algorithm
  written on ``(R, P)`` tensors (:class:`_PopulationAdam`, with optax's
  defaults: eps 1e-8, bias correction, AdamW weight decay 1e-4, and its
  ``warmup_cosine_decay_schedule``), not ``torch.optim``, whose AdamW
  decays by default 100 times harder and clips over the whole population.
  Stage 0 (grid scan refinement), single-restart Stage 1 and multi-restart
  Stage 1 are different populations fed to the same engine.
* **Declarative gate specs** (:data:`_GATE_LIBRARY`): each optimisable gate
  is one table row (wire count, angle arity, probe preparation) from which
  the (pulse, target) circuit pairs, the ``create_<gate>`` methods and the
  joint-mode variants are generated.
* Cost terms self-register on :class:`CostFnRegistry` via a decorator.

QOC runs in float64 (pulse landscapes have tiny curvature near the
optimum), its circuits on the card unless ``device="cpu"``; each cost
evaluation executes its probe circuits as batches over the sampled angles,
so a circuit's pulse gates are solved once per evaluation and family.

Run as a CLI: ``python -m qml_essentials_tpu_torch.pulse.qoc --gates RX RY ...``
(``--device cpu`` on a host without CUDA).  The plots import matplotlib
when they are drawn.

Counterpart of ``qml_essentials_tpu/pulse/qoc.py``.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import logging
import math
import os
import time
from dataclasses import dataclass
from functools import reduce
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from qml_essentials_tpu_torch.analysis.math import fidelity, phase_difference
from qml_essentials_tpu_torch.core import jaqsi as js
from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from qml_essentials_tpu_torch.models.gates import Gates, PulseEnvelope, PulseInformation
from qml_essentials_tpu_torch.ops import operations as op

log = logging.getLogger(__name__)

# QOC's working precision.
DTYPE = torch.float64


# ---------------------------------------------------------------------------
# Probes and angle sampling
# ---------------------------------------------------------------------------


def _linspace(start, stop, num: int, endpoint: bool = True, device=None) -> torch.Tensor:
    """``num`` points from *start* to *stop* (a tensor stop keeps its
    gradient), computed as ``jax.numpy.linspace`` computes them."""
    div = num - 1 if endpoint else num
    if num <= 1:
        return torch.full((num,), float(start), dtype=DTYPE, device=device)
    step = torch.arange(div, dtype=DTYPE, device=device) / div
    out = start * (1 - step) + stop * step
    if endpoint:
        out = torch.cat([out, torch.as_tensor(stop, dtype=DTYPE, device=device).reshape(1)])
    return out


def _sample_rotation_angles(n_samples: int, device=None) -> torch.Tensor:
    """Boundary-biased angle sample: full sweep + extra density in [pi/2, 3pi/2]."""
    if n_samples <= 1:
        return _linspace(0.0, 2.0 * math.pi, max(n_samples, 1), False, device)
    k_focus = max(1, n_samples // 3)
    sweep = _linspace(0.0, 2 * math.pi, n_samples - k_focus, False, device)
    focus = _linspace(math.pi / 2, 3 * math.pi / 2, k_focus, False, device)
    return torch.cat([sweep, focus])


def _with_basis_prep(circuit_fn: Callable, k: int, n_wires: int) -> Callable:
    """Prefix *circuit_fn* with PauliX gates preparing basis state |k> (MSB first)."""

    def prepared(*args, **kwargs):
        for i in range(n_wires):
            if (k >> (n_wires - 1 - i)) & 1:
                op.PauliX(wires=i)
        circuit_fn(*args, **kwargs)

    prepared.__name__ = f"basis{k}_{circuit_fn.__name__}"
    return prepared


def _script(circuit_fn: Callable, n_wires: int, device) -> js.Script:
    return js.Script(circuit_fn, n_qubits=n_wires, device=device, dtype=DTYPE)


def _basis_scripts(circuit_fn: Callable, n_wires: int, device=DEFAULT_DEVICE) -> List[js.Script]:
    """One Script per computational basis start state (column probes)."""
    return [
        _script(_with_basis_prep(circuit_fn, k, n_wires), n_wires, device)
        for k in range(2**n_wires)
    ]


# ---------------------------------------------------------------------------
# Cost terms (self-registering)
# ---------------------------------------------------------------------------


class Cost:
    """Weighted, kwargs-injected cost term; compose terms with ``+``."""

    def __init__(
        self,
        cost: Callable,
        weight: Union[float, Tuple],
        ckwargs: Optional[dict] = None,
    ):
        self.cost = cost
        self.weight = weight
        self.ckwargs = ckwargs if ckwargs is not None else {}

    def __call__(self, *args, **kwargs):
        value = self.cost(*args, **kwargs, **self.ckwargs)
        if isinstance(self.weight, tuple):
            terms = [v * w for v, w in zip(value, self.weight, strict=True)]
            return torch.stack([torch.as_tensor(t) for t in terms]).sum()
        return value * self.weight

    def __add__(self, other):
        if other is None:
            return lambda *args, **kwargs: self(*args, **kwargs)
        if callable(other):
            return lambda *args, **kwargs: (
                self(*args, **kwargs) + other(*args, **kwargs)
            )
        raise TypeError(f"Cannot add Cost and {type(other)}")


class CostFnRegistry:
    """Registry of cost functions available for pulse optimisation."""

    _REGISTRY: Dict[str, dict] = {}

    @classmethod
    def register(cls, name: str, fn: Callable, default_weight, ckwargs_keys) -> None:
        """Register a cost function under *name*."""
        cls._REGISTRY[name] = {
            "fn": fn,
            "default_weight": default_weight,
            "ckwargs_keys": list(ckwargs_keys),
        }

    @classmethod
    def _declare(cls, name: str, default_weight, ckwargs_keys):
        """Decorator form of :meth:`register` used by the built-in terms."""

        def wrap(fn):
            cls.register(name, fn, default_weight, ckwargs_keys)
            return fn

        return wrap

    @classmethod
    def available(cls) -> List[str]:
        return list(cls._REGISTRY)

    @classmethod
    def get(cls, name: str) -> dict:
        if name not in cls._REGISTRY:
            raise ValueError(
                f"Unknown cost function '{name}'. Available: {cls.available()}"
            )
        return cls._REGISTRY[name]

    @classmethod
    def parse_cost_arg(
        cls, spec: Union[str, Tuple]
    ) -> Tuple[str, Union[float, Tuple[float, ...]]]:
        """Parse ``"name:w1,w2,..."`` into ``(name, weight)``."""
        if isinstance(spec, tuple):
            return spec
        name, _, weight_str = spec.partition(":")
        default = cls.get(name)["default_weight"]
        if weight_str:
            parts = tuple(float(x) for x in weight_str.split(","))
            weight = parts[0] if len(parts) == 1 else parts
        else:
            weight = default
        n_given = len(weight) if isinstance(weight, tuple) else 1
        n_needed = len(default) if isinstance(default, tuple) else 1
        if n_given != n_needed:
            raise ValueError(
                f"Cost function '{name}' expects {n_needed} weight(s), got {n_given}."
            )
        return name, weight


@CostFnRegistry._declare(
    "fidelity", (0.5, 0.5), ["pulse_scripts", "target_scripts", "n_samples"]
)
def fidelity_cost_fn(
    pulse_params: torch.Tensor,
    pulse_scripts: Union[js.Script, List[js.Script]],
    target_scripts: Union[js.Script, List[js.Script]],
    n_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-vector cost ``(1 - F, 1 - cos(dphi))`` averaged over angles.

    Multiple (pulse, target) script pairs probe different initial states
    (|0> and |+>), exposing rotation-axis tilt; all angles run in one
    batched execution per script.
    """
    if not isinstance(pulse_scripts, (list, tuple)):
        pulse_scripts = [pulse_scripts]
    if not isinstance(target_scripts, (list, tuple)):
        target_scripts = [target_scripts]
    assert len(pulse_scripts) == len(target_scripts), (
        f"pulse_scripts and target_scripts must have the same length "
        f"({len(pulse_scripts)} vs {len(target_scripts)})."
    )

    ws = _sample_rotation_angles(n_samples, pulse_scripts[0].device)
    infid, dephase = [], []
    for probe_p, probe_t in zip(pulse_scripts, target_scripts):
        got = probe_p.execute(
            type="state", args=(ws, pulse_params), in_axes=(0, None)
        )
        want = probe_t.execute(type="state", args=(ws,), in_axes=(0,))
        infid.append(torch.mean(1.0 - fidelity(got, want)))
        dephase.append(torch.mean(1.0 - torch.cos(phase_difference(got, want))))
    return torch.mean(torch.stack(infid)), torch.mean(torch.stack(dephase))


@CostFnRegistry._declare(
    "unitary",
    (0.5, 0.5),
    ["pulse_basis_scripts", "target_basis_scripts", "n_samples", "n_qubits"],
)
def unitary_cost_fn(
    pulse_params: torch.Tensor,
    pulse_basis_scripts: List[js.Script],
    target_basis_scripts: List[js.Script],
    n_samples: int,
    n_qubits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Process-fidelity cost ``(1 - |Tr E|^2/d^2, 1 - cos(angle Tr E))``.

    The full unitary at every sampled angle is column-stacked from the
    ``2**n`` basis-state evolutions; ``E = U_target^dag U_pulse``.  The
    phase term pins the global phase so composed gates stay consistent.
    """
    d = 2**n_qubits
    for label, scripts in (
        ("pulse_basis_scripts", pulse_basis_scripts),
        ("target_basis_scripts", target_basis_scripts),
    ):
        assert len(scripts) == d, f"{label} must have {d} entries; got {len(scripts)}."

    ws = _sample_rotation_angles(n_samples, pulse_basis_scripts[0].device)
    U_pulse = torch.stack(
        [
            s.execute(type="state", args=(ws, pulse_params), in_axes=(0, None))
            for s in pulse_basis_scripts
        ],
        dim=-1,
    )
    U_target = torch.stack(
        [s.execute(type="state", args=(ws,), in_axes=(0,)) for s in target_basis_scripts],
        dim=-1,
    )

    # Only the trace of E is needed: Tr(U_t^dag U_p) = sum_ij conj(U_t)_ij U_p_ij.
    trE = torch.einsum("sji,sji->s", U_target.conj(), U_pulse)
    return (
        torch.mean(1.0 - trE.abs() ** 2 / d**2),
        torch.mean(1.0 - torch.cos(torch.angle(trE))),
    )


def joint_unitary_cost_fn(
    pulse_params: torch.Tensor,
    gate_specs: List[dict],
    n_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sum of :func:`unitary_cost_fn` terms sharing one theta.

    Each spec carries ``{name, n_qubits, weight, assembler,
    pulse_basis_scripts, target_basis_scripts}``; the assembler maps the
    joint vector to that gate's flat pulse params.
    """
    acc = torch.zeros(2, dtype=DTYPE, device=pulse_params.device)
    norm = sum(s["weight"] for s in gate_specs)
    for spec in gate_specs:
        pair = unitary_cost_fn(
            spec["assembler"](pulse_params),
            spec["pulse_basis_scripts"],
            spec["target_basis_scripts"],
            n_samples,
            spec["n_qubits"],
        )
        acc = acc + spec["weight"] * torch.stack(pair)
    if norm > 0:
        acc = acc / norm
    return acc[0], acc[1]


@CostFnRegistry._declare("pulse_width", 1.0, ["envelope"])
def pulse_width_cost_fn(pulse_params: torch.Tensor, envelope: str) -> torch.Tensor:
    """Penalty on the pulse width (last envelope parameter; 0 if none)."""
    n_env = PulseEnvelope.get(envelope)["n_envelope_params"]
    width = pulse_params[n_env - 1] if n_env > 0 else 0
    return torch.as_tensor(width, dtype=DTYPE)


@CostFnRegistry._declare("evolution_time", 1.0, ["t_target"])
def evolution_time_cost_fn(pulse_params: torch.Tensor, t_target: float) -> torch.Tensor:
    """Squared relative deviation of the evolution time from *t_target*."""
    return ((pulse_params[-1] - t_target) / t_target) ** 2


@CostFnRegistry._declare("spectral_density", 1.0, ["envelope"])
def spectral_density_cost_fn(
    pulse_params: torch.Tensor, envelope: str, n_fft: int = 1024
) -> torch.Tensor:
    """Normalised RMS bandwidth of the pulse's power spectral density."""
    shape = PulseEnvelope.get(envelope)
    n_env, env_fn = shape["n_envelope_params"], shape["fn"]
    if n_env == 0 or env_fn is None:
        return torch.zeros((), dtype=DTYPE)

    t_evol = pulse_params[-1]
    grid = _linspace(0.0, t_evol, n_fft, device=pulse_params.device)
    signal = torch.func.vmap(lambda t: env_fn(pulse_params[:n_env], t, t_evol / 2))(grid)
    psd = torch.fft.rfft(signal).abs() ** 2
    psd = psd / (torch.sum(psd) + 1e-12)
    freqs = _linspace(0.0, 1.0, psd.shape[0], device=psd.device)
    centroid = torch.sum(freqs * psd)
    return torch.sqrt(torch.sum((freqs - centroid) ** 2 * psd)).to(DTYPE)


# ---------------------------------------------------------------------------
# Declarative gate library
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _GateSpec:
    """One optimisable gate: circuit shape + symmetry-breaking probe prep.

    ``prep``/``post`` rows are ``(gate_name, wire, takes_angle)``; angle
    rows receive the sampled probe angle *w*.  ``angles`` is the pulse
    gate's own angle arity (0 for CX/CZ/H-like, 3 for Rot).  ``target``
    overrides the analytic operation name when it differs.
    """

    wires: int = 1
    angles: int = 1
    prep: Tuple[Tuple[str, int, bool], ...] = ()
    post: Tuple[Tuple[str, int, bool], ...] = ()
    target: Optional[str] = None


_GATE_LIBRARY: Dict[str, _GateSpec] = {
    "RX": _GateSpec(),
    "RY": _GateSpec(),
    "RZ": _GateSpec(prep=(("H", 0, False),), post=(("H", 0, False),)),
    "H": _GateSpec(angles=0, prep=(("RY", 0, True),)),
    "Rot": _GateSpec(angles=3, prep=(("H", 0, False),)),
    "CX": _GateSpec(wires=2, angles=0, prep=(("RY", 0, True), ("H", 1, False))),
    "CY": _GateSpec(wires=2, angles=0, prep=(("RX", 0, True), ("H", 1, False))),
    "CZ": _GateSpec(wires=2, angles=0, prep=(("RY", 0, True), ("H", 1, False))),
    "CRX": _GateSpec(wires=2, prep=(("H", 0, False),)),
    "CRY": _GateSpec(wires=2, prep=(("H", 0, False),)),
    "CRZ": _GateSpec(wires=2, prep=(("H", 0, False), ("H", 1, False))),
    "CPhase": _GateSpec(
        wires=2,
        prep=(("H", 0, False), ("H", 1, False)),
        target="ControlledPhaseShift",
    ),
}


def _emit_stage(rows: Tuple[Tuple[str, int, bool], ...], w) -> None:
    """Apply a prep/post row list: analytic gates on the given wires."""
    for gate_name, wire, takes_angle in rows:
        ctor = getattr(op, gate_name)
        if takes_angle:
            ctor(w, wires=wire)
        else:
            ctor(wires=wire)


def _pair_from_spec(name: str, with_probes: bool = True) -> Tuple[Callable, Callable]:
    """Build the matching (pulse, target) circuit functions for a gate.

    ``with_probes=False`` drops the prep/post stages — joint mode probes
    every basis column already, so preps would only obscure errors.
    """
    spec = _GATE_LIBRARY[name]
    wires = 0 if spec.wires == 1 else list(range(spec.wires))
    target_name = spec.target or name

    def angle_args(w):
        if spec.angles == 0:
            return ()
        if spec.angles == 1:
            return (w,)
        return tuple(w * (i + 1) for i in range(spec.angles))

    def pulse_circuit(w, pp):
        if with_probes:
            _emit_stage(spec.prep, w)
        getattr(Gates, name)(
            *angle_args(w), wires=wires, pulse_params=pp, gate_mode="pulse"
        )
        if with_probes:
            _emit_stage(spec.post, w)

    def target_circuit(w):
        if with_probes:
            _emit_stage(spec.prep, w)
        getattr(op, target_name)(*angle_args(w), wires=wires)
        if with_probes:
            _emit_stage(spec.post, w)

    pulse_circuit.__name__ = f"pulse_{name}"
    target_circuit.__name__ = f"target_{name}"
    return pulse_circuit, target_circuit


# ---------------------------------------------------------------------------
# The population optimiser (optax's algorithms on (R, P) tensors)
# ---------------------------------------------------------------------------


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup from *init_value* to *peak_value* over *warmup_steps*,
    then cosine decay to *end_value* at *decay_steps* (counted from 0,
    warmup included): optax's schedule of the same name, on a tensor of
    step counts.  Like optax's, whose step counts are int32, it computes in
    float32: the learning rates an optax optimiser applies carry float32
    rounding."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={cosine_steps}."
        )

    def linear(count):
        if warmup_steps <= 0:
            return torch.full_like(count, init_value)
        frac = 1 - torch.clamp(count, 0, warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        count = torch.clamp(count, max=float(cosine_steps))
        decay = 0.5 * (1 + torch.cos(math.pi * count / cosine_steps))
        return peak_value * ((1 - alpha) * decay**exponent + alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.float32)
        return torch.where(count < warmup_steps, linear(count), cosine(count - warmup_steps))

    return schedule


class _PopulationAdam:
    """optax's ``adam`` (``weight_decay=None``) or ``adamw``, optionally
    behind ``clip_by_global_norm(clip)``, on a population ``(R, P)``: each
    row has its own moments, step counts and gradient-norm clip.
    *learning_rate* is a number or a schedule of the step count."""

    def __init__(self, learning_rate, weight_decay: Optional[float] = None,
                 clip: Optional[float] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.learning_rate, self.weight_decay, self.clip = learning_rate, weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: torch.Tensor) -> dict:
        rows = params.shape[0]
        zero = torch.zeros(rows, dtype=torch.int64, device=params.device)
        return {"mu": torch.zeros_like(params), "nu": torch.zeros_like(params),
                "count": zero, "schedule_count": zero.clone()}

    def update(self, grads: torch.Tensor, state: dict, params: torch.Tensor):
        if self.clip is not None:
            norm = torch.sqrt(torch.sum(grads * grads, dim=-1, keepdim=True))
            grads = torch.where(norm < self.clip, grads, (grads / norm) * self.clip)
        mu = (1 - self.b1) * grads + self.b1 * state["mu"]
        nu = (1 - self.b2) * grads**2 + self.b2 * state["nu"]
        count = state["count"] + 1
        c = count.to(params.dtype)[:, None]
        mu_hat = mu / (1 - self.b1**c)
        nu_hat = nu / (1 - self.b2**c)
        updates = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay is not None:
            updates = updates + self.weight_decay * params
        if callable(self.learning_rate):
            lr = self.learning_rate(state["schedule_count"]).to(params.dtype)[:, None]
        else:
            lr = self.learning_rate
        updates = -lr * updates
        return updates, {"mu": mu, "nu": nu, "count": count,
                         "schedule_count": state["schedule_count"] + 1}


def _value_and_grad(fn: Callable, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        value = fn(x)
        (grad,) = torch.autograd.grad(value, x, allow_unused=True)
    return value.detach(), torch.zeros_like(x) if grad is None else grad


# ---------------------------------------------------------------------------
# QOC
# ---------------------------------------------------------------------------


class QOC:
    """Pulse-level gate synthesis around one population optimiser."""

    GATES_1Q: List[str] = ["RX", "RY", "RZ", "Rot", "H"]
    GATES_2Q: List[str] = ["CX", "CY", "CZ", "CRX", "CRY", "CRZ"]

    DEFAULT_PARAM_RANGES = {n: [(0.05, 3.0)] * n for n in (1, 2, 3, 4)}
    SCAN_REL_FACTORS: Tuple[float, ...] = (0.5, 0.75, 1.0, 1.25, 1.5)

    def __init__(
        self,
        envelope: str,
        cost_fns: List[Tuple[str, Union[float, Tuple[float, ...]]]],
        t_target: float,
        n_steps: int,
        n_samples: int,
        learning_rate: float,
        log_interval: int = 50,
        file_dir: str = None,
        warmup_ratio: float = 0.0,
        end_lr_ratio: float = 1.0,
        n_restarts: int = 1,
        restart_noise_scale: float = 0.5,
        grad_clip: float = 1.0,
        random_seed: int = 42,
        scan_steps: int = 0,
        scan_grid_size: int = 5,
        scan_ranges: Optional[List[Tuple[float, float]]] = None,
        log_scale_params: Optional[List[int]] = None,
        early_stop_patience: int = 0,
        early_stop_min_delta: float = 0.0,
        plot: bool = False,
        device=DEFAULT_DEVICE,
    ):
        """Configure the optimiser; see the CLI (`--help`) for knob semantics.
        *device*: where the probe circuits run (the card by default)."""
        plain = (
            "envelope", "t_target", "n_steps", "n_samples", "learning_rate",
            "warmup_ratio", "end_lr_ratio", "log_interval",
            "restart_noise_scale", "grad_clip", "scan_steps",
            "scan_grid_size", "scan_ranges", "plot",
        )
        bound = locals()
        for knob in plain:
            setattr(self, knob, bound[knob])
        self.device = resolve_device(device)
        self.file_dir = file_dir or os.path.dirname(os.path.realpath(__file__))
        self.n_restarts = max(1, n_restarts)
        self.random_key = torch.Generator().manual_seed(random_seed)
        self.early_stop_patience = max(0, int(early_stop_patience))
        self.early_stop_min_delta = float(early_stop_min_delta)

        if log_scale_params is None:
            # Amplitude + evolution time are scale-like for physical shapes.
            has_env = PulseEnvelope.get(envelope)["n_envelope_params"] >= 2
            log_scale_params = [0, -1] if has_env else []
        self.log_scale_params = log_scale_params

        total = sum(
            sum(w) if isinstance(w, tuple) else w
            for name, w in cost_fns
            if CostFnRegistry.get(name)  # validates the name
        )
        assert math.isclose(total, 1.0, rel_tol=1e-8), (
            f"Cost function weights must sum to 1. Got {total}"
        )
        self.cost_fns = cost_fns

        log.info(
            f"QOC: {n_steps} steps x {self.n_restarts} restarts, "
            f"{n_samples} angle samples, lr={learning_rate}, "
            f"envelope={envelope!r}"
        )
        PulseInformation.set_envelope(self.envelope)

    # ---------------------------------------------------------- persistence
    def save_results(self, gate: str, fidelity: float, pulse_params) -> None:
        """Write/merge per-gate optimised params + fidelity into the CSV."""
        if self.file_dir is None:
            return
        os.makedirs(self.file_dir, exist_ok=True)
        path = os.path.join(self.file_dir, f"qoc_results_{self.envelope}.csv")

        # Merge: one row per gate, newest entry wins (warn on downgrades).
        order: List[str] = []
        table: Dict[str, list] = {}
        if os.path.isfile(path):
            with open(path, newline="") as f:
                for row in csv.reader(f):
                    if row:
                        order.append(row[0])
                        table[row[0]] = row
        prior = table.get(gate)
        if prior is not None and fidelity <= float(prior[1]):
            log.warning(
                f"Pulse parameters for {gate} already exist with higher "
                f"fidelity ({prior[1]} >= {fidelity})"
            )
        if gate not in table:
            order.append(gate)
        table[gate] = [gate, fidelity] + [float(x) for x in pulse_params]

        with open(path, mode="w", newline="") as f:
            csv.writer(f).writerows(table[g] for g in order)

    # --------------------------------------------------------- log-space
    def _log_mask(self, n: int) -> torch.Tensor:
        """Boolean mask of log-reparameterised entries for length-*n* vectors."""
        mask = np.zeros(n, dtype=bool)
        for idx in self.log_scale_params:
            mask[idx % n if -n <= idx < n else n] = True  # IndexError if out
        return torch.as_tensor(mask)

    def _to_log_space(self, params: torch.Tensor) -> torch.Tensor:
        """Replace log-scaled entries by ``log(|p| + eps)``."""
        if not self.log_scale_params:
            return params
        mask = self._log_mask(params.shape[-1]).to(params.device)
        return torch.where(mask, torch.log(params.abs() + 1e-12), params)

    def _from_log_space(self, log_params: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`_to_log_space`."""
        if not self.log_scale_params:
            return log_params
        mask = self._log_mask(log_params.shape[-1]).to(log_params.device)
        return torch.where(mask, torch.exp(log_params), log_params)

    # ------------------------------------------------------------ the engine
    def _descend(
        self,
        total_cost: Callable,
        starts: torch.Tensor,
        optimizer: _PopulationAdam,
        n_steps: int,
        patience: int = 0,
        min_delta: float = 0.0,
    ) -> dict:
        """Population descent (the single optimiser loop of this build).

        ``starts`` is ``(R, P)`` in *physical* space.  All R members advance
        in lock-step: per-member Adam state, per-member best-so-far
        tracking, per-member NaN guard (a member whose update goes
        non-finite freezes rather than poisoning the population) and masked
        early stopping.  A halted member's parameters stay where they are,
        so its loss is not computed again.

        Returns a dict with ``best`` (R, P) physical params, ``best_loss``
        (R,), ``init_loss`` (R,), ``losses`` (n_steps, R) and ``halted`` (R,).
        """

        def cost_log(lp):
            raw = total_cost(self._from_log_space(lp))
            return torch.where(torch.isfinite(raw), raw, torch.full_like(raw, math.inf))

        eff_patience = patience if patience > 0 else n_steps + 1
        lp = self._to_log_space(starts.to(DTYPE))
        rows = lp.shape[0]
        with torch.no_grad():
            init_loss = torch.stack([cost_log(lp[r]) for r in range(rows)])
        state = optimizer.init(lp)
        best_loss, best_lp = init_loss.clone(), lp.clone()
        stale = torch.zeros(rows, dtype=torch.int64)
        halted = torch.zeros(rows, dtype=torch.bool)
        last_loss = init_loss.clone()
        grads = torch.zeros_like(lp)
        losses = []
        for _ in range(n_steps):
            loss = last_loss.clone()
            for r in range(rows):
                if not bool(halted[r]):
                    loss[r], grads[r] = _value_and_grad(cost_log, lp[r])
            updates, new_state = optimizer.update(grads, state, lp)
            moved = lp + updates
            diverged = ~torch.isfinite(moved).all(dim=-1).cpu()

            improved = loss < best_loss - min_delta
            best_loss = torch.where(improved, loss, best_loss)
            best_lp = torch.where(improved.to(lp.device)[:, None], lp, best_lp)
            stale = torch.where(improved, torch.zeros_like(stale), stale + 1)

            halted = halted | diverged | (stale >= eff_patience)
            keep = halted.to(lp.device)
            lp = torch.where(keep[:, None], lp, moved)
            state = {k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)), state[k], v)
                     for k, v in new_state.items()}
            last_loss = loss
            losses.append(loss)
        return {
            "best": self._from_log_space(best_lp),
            "best_loss": best_loss,
            "init_loss": init_loss,
            "losses": torch.stack(losses) if losses else torch.zeros((0, rows), dtype=DTYPE),
            "halted": halted,
        }

    # ------------------------------------------------------------- stage 0
    def _build_scan_grid(
        self,
        n_params: int,
        init_pulse_params: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Grid for Stage 0: user ranges > multiplicative around init > legacy."""

        def log_axes(ranges):
            assert len(ranges) == n_params, (
                f"scan_ranges has {len(ranges)} entries but gate has "
                f"{n_params} parameters."
            )
            return [
                torch.logspace(math.log10(lo), math.log10(hi), self.scan_grid_size,
                               dtype=DTYPE)
                for lo, hi in ranges
            ]

        if self.scan_ranges is not None:
            axes = log_axes(self.scan_ranges)
        elif init_pulse_params is not None:
            if self.scan_grid_size == len(self.SCAN_REL_FACTORS):
                factors = torch.tensor(self.SCAN_REL_FACTORS, dtype=DTYPE)
            elif self.scan_grid_size <= 1:
                factors = torch.tensor([1.0], dtype=DTYPE)
            else:
                factors = torch.linspace(0.5, 1.5, self.scan_grid_size, dtype=DTYPE)
            axes = [factors * float(p) for p in init_pulse_params]
        else:
            axes = log_axes(
                self.DEFAULT_PARAM_RANGES.get(n_params, [(0.1, 10.0)] * n_params)
            )

        grid = torch.tensor(list(itertools.product(*[a.tolist() for a in axes])),
                            dtype=DTYPE)
        return grid, axes

    def stage_0_opt(
        self, init_pulse_params: torch.Tensor, total_cost: Callable
    ) -> Tuple[torch.Tensor, Optional[Tuple[List[torch.Tensor], list]]]:
        """Stage 0: the whole candidate grid refines as one population.

        Every grid point gets ``scan_steps`` Adam steps through
        :meth:`_descend`; best-so-far tracking already keeps the raw
        candidate when refinement doesn't help.  Solver failures are
        downgraded to +inf losses via throw=False for the scan's duration.
        """
        if self.scan_steps <= 0:
            return init_pulse_params, None

        init_pulse_params = torch.as_tensor(init_pulse_params, dtype=DTYPE)
        grid, axes = self._build_scan_grid(
            len(init_pulse_params), init_pulse_params=init_pulse_params
        )
        # The incumbent joins the population so Stage 0 can only improve it.
        population = torch.cat([init_pulse_params[None, :].cpu(), grid])
        log.info(
            f"Stage 0: {len(grid)} candidates x {self.scan_steps} "
            f"refinement steps (one population)"
        )

        refiner = _PopulationAdam(
            self.learning_rate * 2, clip=self.grad_clip if self.grad_clip > 0 else 1.0
        )

        prev_defaults = js.Evolution.set_solver_defaults(throw=False)
        try:
            out = self._descend(total_cost, population, refiner, self.scan_steps)
        finally:
            if prev_defaults:
                js.Evolution.set_solver_defaults(**prev_defaults)

        best_losses = out["best_loss"].cpu().numpy()
        finite = np.isfinite(best_losses)
        if not finite.any():
            log.warning("Stage 0: every candidate diverged; keeping the init.")
            return init_pulse_params, (axes, [])

        n_skipped = int((~finite[1:]).sum())
        if n_skipped:
            log.warning(
                f"Stage 0: skipped {n_skipped}/{len(grid)} candidates due to "
                "solver failure or non-finite loss."
            )
        landscape = [
            (ci, grid[ci], float(best_losses[ci + 1]))
            for ci in range(len(grid))
            if finite[ci + 1]
        ]
        winner = int(np.argmin(np.where(finite, best_losses, np.inf)))
        best_params = out["best"][winner]
        log.info(
            f"Stage 0 complete. Best loss: {float(best_losses[winner]):.6e}, "
            f"params: {best_params}"
        )
        return best_params, (axes, landscape)

    # ------------------------------------------------------------- stage 1
    def _lr_schedule(self):
        """Warmup-cosine decay when configured, else the flat learning rate."""
        warmup_steps = int(self.n_steps * self.warmup_ratio)
        end_value = self.learning_rate * self.end_lr_ratio
        if warmup_steps <= 0 and self.end_lr_ratio >= 1.0:
            return self.learning_rate
        return warmup_cosine_decay_schedule(
            init_value=(end_value if warmup_steps > 0 else self.learning_rate),
            peak_value=self.learning_rate,
            warmup_steps=warmup_steps,
            decay_steps=self.n_steps,
            end_value=end_value,
        )

    def _restart_population(self, center: torch.Tensor) -> torch.Tensor:
        """(n_restarts, P) start matrix; row 0 is the unperturbed incumbent."""
        center = torch.as_tensor(center, dtype=DTYPE).cpu()
        n_params = center.shape[0]
        if self.n_restarts == 1:
            return center[None, :]
        noise = torch.randn((self.n_restarts, n_params), generator=self.random_key,
                            dtype=DTYPE)
        noise[0] = 0.0
        spread = torch.clamp(center.abs(), min=0.1) * self.restart_noise_scale
        starts = center[None, :] + noise * spread[None, :]

        # Evolution time and log-scaled entries must stay positive.
        keep_positive = np.zeros(n_params, dtype=bool)
        keep_positive[-1] = True
        for idx in self.log_scale_params:
            keep_positive[idx % n_params if -n_params <= idx < n_params else n_params] = True
        return torch.where(torch.as_tensor(keep_positive)[None, :], starts.abs(), starts)

    def stage_1_opt(
        self, best_scan_params: torch.Tensor, total_costs: Callable
    ) -> Tuple[torch.Tensor, list, torch.Tensor]:
        """Stage 1: AdamW + schedule through the engine; restarts are rows."""
        schedule = self._lr_schedule()
        use_clip = self.grad_clip and self.grad_clip > 0 and np.isfinite(self.grad_clip)
        optimizer = _PopulationAdam(schedule, weight_decay=1e-4,
                                    clip=self.grad_clip if use_clip else None)

        out = self._descend(
            total_costs,
            self._restart_population(best_scan_params),
            optimizer,
            self.n_steps,
            patience=self.early_stop_patience,
            min_delta=self.early_stop_min_delta,
        )

        best_losses = out["best_loss"].cpu().numpy()
        for r, bl in enumerate(best_losses):
            log.info(
                f"Restart {r + 1}/{self.n_restarts} finished with best loss: "
                f"{float(bl):.3e}"
            )
        winner = int(np.argmin(best_losses))
        winner_steps = out["losses"][:, winner].cpu().numpy()
        for step in range(0, self.n_steps, max(1, self.log_interval)):
            log.info(f"Step {step}/{self.n_steps}, Loss: {float(winner_steps[step]):.3e}")
        if bool(out["halted"][winner]):
            log.info("Winner restart halted early (patience/NaN guard).")

        history = [out["init_loss"][winner]] + list(out["losses"][:, winner])
        return out["best"][winner], history, out["best_loss"][winner]

    # ------------------------------------------------------------- per-gate
    def optimize(self, wires: int) -> Callable:
        """Decorator factory running the two-stage optimisation for a gate."""

        def decorator(create_circuits):
            def wrapper(init_pulse_params: torch.Tensor = None):
                pulse_circuit, target_circuit = create_circuits()
                gate_name = create_circuits.__name__.split("_", 1)[1]
                if init_pulse_params is None:
                    init_pulse_params = PulseInformation.gate_by_name(gate_name).params
                init_pulse_params = torch.as_tensor(init_pulse_params, dtype=DTYPE)

                def plus_prep(circuit_fn):
                    def prepared(*args, **kwargs):
                        for q in range(wires):
                            op.H(wires=q)
                        circuit_fn(*args, **kwargs)

                    prepared.__name__ = f"plus_{circuit_fn.__name__}"
                    return prepared

                # |0> and |+> probes for the state cost; basis columns for
                # the process cost.
                dev = self.device
                resources = {
                    "pulse_scripts": [
                        _script(pulse_circuit, wires, dev),
                        _script(plus_prep(pulse_circuit), wires, dev),
                    ],
                    "target_scripts": [
                        _script(target_circuit, wires, dev),
                        _script(plus_prep(target_circuit), wires, dev),
                    ],
                    "pulse_basis_scripts": _basis_scripts(pulse_circuit, wires, dev),
                    "target_basis_scripts": _basis_scripts(target_circuit, wires, dev),
                    "envelope": self.envelope,
                    "n_samples": self.n_samples,
                    "n_qubits": wires,
                    "t_target": self.t_target,
                }

                terms = [
                    Cost(
                        cost=meta["fn"],
                        weight=weight,
                        ckwargs={k: resources[k] for k in meta["ckwargs_keys"]},
                    )
                    for name, weight in self.cost_fns
                    for meta in (CostFnRegistry.get(name),)
                ]
                composed = reduce(lambda acc, t: t + acc, terms, None)

                def total_costs(p):
                    # The circuits run on the QOC's device; the optimiser
                    # keeps its population on the host.
                    return composed(p.to(dev)).cpu()

                best_scan_params, scan_data = self.stage_0_opt(
                    init_pulse_params, total_costs
                )
                best_params, best_history, best_loss = self.stage_1_opt(
                    best_scan_params, total_costs
                )
                self.save_results(
                    gate=gate_name,
                    fidelity=1 - best_loss.item(),
                    pulse_params=best_params,
                )

                if self.plot:
                    if scan_data is not None:
                        self.plot_loss_landscape(gate_name, *scan_data)
                    self.plot_loss_curve(gate_name, best_history)
                return best_params, best_history

            return wrapper

        return decorator

    def _create_pair(self, gate_name: str) -> Tuple[Callable, Callable]:
        if gate_name not in _GATE_LIBRARY:
            raise ValueError(f"No factory for gate {gate_name!r}.")
        return _pair_from_spec(gate_name, with_probes=True)

    def optimize_all(self, sel_gates, make_log: bool) -> None:
        """Per-gate optimisation over the selected gates; optional log CSV."""
        history: Dict[str, list] = {}
        for gate in self.GATES_1Q + self.GATES_2Q:
            if gate not in sel_gates and "all" not in sel_gates:
                continue
            n_wires = _GATE_LIBRARY[gate].wires
            log.info(f"Optimizing {gate} gate...")
            best_params, losses = self.optimize(wires=n_wires)(
                getattr(self, f"create_{gate}")
            )()
            best_fid = 1 - min(float(v) for v in losses)
            log.info(f"Best achieved fidelity: {best_fid * 100:.5f}%")
            history[gate] = history.get(gate, []) + [float(v) for v in losses]

        if make_log:
            with open(os.path.join(self.file_dir, "qoc_logs.csv"), "w") as f:
                writer = csv.writer(f)
                writer.writerow(history.keys())
                writer.writerows(zip(*history.values()))

    # ------------------------------------------------------------ joint mode
    JOINT_LEAVES_DEFAULT: Tuple[str, ...] = ("RX", "RY", "RZ", "CZ")
    JOINT_TARGETS_DEFAULT: Tuple[str, ...] = (
        "RX", "RY", "RZ", "H", "CX", "CRX", "CRY", "CRZ",
    )
    # Composites are up-weighted: they are what fails tightened tests, and
    # the leaves start near-perfect so they would otherwise dominate.
    JOINT_WEIGHTS_DEFAULT: Dict[str, float] = {
        "RX": 0.3, "RY": 0.3, "RZ": 0.3, "H": 1.0,
        "CX": 2.0, "CRX": 3.0, "CRY": 3.0, "CRZ": 3.0,
    }
    # RX/RY differ only by a static carrier phase -- share their envelope.
    JOINT_TIED_GROUPS_DEFAULT: Tuple[Tuple[str, ...], ...] = (("RX", "RY"),)

    def _build_joint_layout(
        self,
        leaf_names: Tuple[str, ...],
        tied_groups: Optional[Tuple[Tuple[str, ...], ...]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, slice], List[int]]:
        """Joint theta layout: per-leaf slices (tied leaves share a slice)."""
        if tied_groups is None:
            tied_groups = self.JOINT_TIED_GROUPS_DEFAULT

        # Union-find-lite: each leaf points at its group representative.
        rep_of = {n: n for n in leaf_names}
        for group in tied_groups:
            members = [n for n in group if n in rep_of]
            for m in members[1:]:
                rep_of[m] = members[0]

        n_env = PulseEnvelope.get(self.envelope)["n_envelope_params"]
        slices: Dict[str, slice] = {}
        chunks: List[torch.Tensor] = []
        log_idx: List[int] = []
        cursor = 0
        for name in leaf_names:
            rep = rep_of[name]
            if rep != name:
                slices[name] = slices[rep]
                continue
            tree = PulseInformation.gate_by_name(name)
            assert tree is not None and tree.is_leaf, (
                f"_build_joint_layout: {name!r} is not a leaf gate"
            )
            group = [m for m in leaf_names if rep_of[m] == name]
            # Tied leaves start from the elementwise mean of their members.
            chunk = torch.mean(
                torch.stack(
                    [
                        torch.as_tensor(PulseInformation.gate_by_name(m).params, dtype=DTYPE)
                        for m in group
                    ]
                ),
                dim=0,
            )
            width = chunk.shape[0]
            slices[name] = slice(cursor, cursor + width)
            chunks.append(chunk)
            if name in ("RX", "RY") and n_env >= 2:
                log_idx += [cursor, cursor + width - 1]  # amplitude + time
            cursor += width

        return torch.cat(chunks), slices, log_idx

    @staticmethod
    def _assemble_for_gate(
        theta: torch.Tensor, pp_obj, leaf_slices: Dict[str, slice]
    ) -> torch.Tensor:
        """Flat per-gate pulse params drawn from the joint theta."""
        if pp_obj.is_leaf:
            sl = leaf_slices.get(pp_obj.name)
            if sl is None:
                return torch.as_tensor(pp_obj.params, dtype=DTYPE).to(theta.device)
            return theta[sl]
        return torch.cat(
            [
                QOC._assemble_for_gate(theta, child, leaf_slices)
                for child in pp_obj.childs
            ]
        )

    def _joint_stage_0_coord_descent(
        self,
        init_theta: torch.Tensor,
        leaf_slices: Dict[str, slice],
        total_cost: Callable,
    ) -> torch.Tensor:
        """Per-leaf grid sweeps with greedy acceptance (O(sum) not O(prod))."""
        if self.scan_steps <= 0:
            log.info("Joint Stage 0: scan disabled (scan_steps=0); skipping.")
            return init_theta

        def safe(t):
            with torch.no_grad():
                raw = total_cost(t)
            return raw if bool(torch.isfinite(raw)) else torch.full_like(raw, math.inf)

        theta = init_theta
        best = safe(theta)
        log.info(
            f"Joint Stage 0: coordinate descent over {len(leaf_slices)} "
            f"leaves, init_loss={float(best):.6e}"
        )

        prev_defaults = js.Evolution.set_solver_defaults(throw=False)
        try:
            swept: set = set()
            for leaf_name, sl in leaf_slices.items():
                span = (sl.start, sl.stop)
                if span in swept or sl.stop == sl.start:
                    continue
                swept.add(span)
                grid, _ = self._build_scan_grid(
                    sl.stop - sl.start, init_pulse_params=theta[sl]
                )
                variants = theta[None, :].repeat(len(grid), 1)
                variants[:, sl] = grid
                losses = torch.stack([safe(v) for v in variants])
                idx = int(torch.argmin(losses))
                if float(losses[idx]) < float(best):
                    best = losses[idx]
                    theta = variants[idx]
                log.info(
                    f"  Joint scan after leaf {leaf_name}: "
                    f"best_loss={float(best):.6e}"
                )
        finally:
            if prev_defaults:
                js.Evolution.set_solver_defaults(**prev_defaults)
        return theta

    def optimize_joint(
        self,
        target_gates: Optional[List[str]] = None,
        leaf_names: Optional[List[str]] = None,
        weights: Optional[Dict[str, float]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, slice], list]:
        """Joint composite-aware optimisation of the shared leaf params."""
        target_gates = list(target_gates or self.JOINT_TARGETS_DEFAULT)
        leaf_names = list(leaf_names or self.JOINT_LEAVES_DEFAULT)
        merged = dict(self.JOINT_WEIGHTS_DEFAULT, **{
            k: float(v) for k, v in (weights or {}).items()
        })

        log.info(f"Joint optimisation: leaves={leaf_names}, targets={target_gates}")
        init_theta, leaf_slices, joint_log_idx = self._build_joint_layout(
            tuple(leaf_names)
        )

        gate_specs: List[dict] = []
        for gname in target_gates:
            tree = PulseInformation.gate_by_name(gname)
            if tree is None:
                log.warning(f"  Skipping unknown gate {gname!r}.")
                continue
            n_wires = _GATE_LIBRARY[gname].wires
            # Prep-free pairs: the unitary cost probes every basis column,
            # so symmetry-breaking preps would only obscure errors.
            pulse_circuit, target_circuit = _pair_from_spec(gname, with_probes=False)
            gate_specs.append(
                {
                    "name": gname,
                    "n_qubits": n_wires,
                    "weight": merged.get(gname, 1.0),
                    "assembler": (
                        lambda theta, _tree=tree: QOC._assemble_for_gate(
                            theta, _tree, leaf_slices
                        )
                    ),
                    "pulse_basis_scripts": _basis_scripts(pulse_circuit, n_wires,
                                                          self.device),
                    "target_basis_scripts": _basis_scripts(target_circuit, n_wires,
                                                           self.device),
                }
            )

        # Reuse the unitary weight tuple for the joint objective.
        weight_tuple = next(
            (w for n, w in self.cost_fns if n == "unitary"), (0.5, 0.5)
        )
        joint = Cost(
            cost=joint_unitary_cost_fn,
            weight=weight_tuple,
            ckwargs={"gate_specs": gate_specs, "n_samples": self.n_samples},
        )

        def joint_cost(theta):
            return joint(theta.to(self.device)).cpu()

        saved_log_scale = self.log_scale_params
        self.log_scale_params = joint_log_idx
        try:
            theta0 = self._joint_stage_0_coord_descent(
                init_theta, leaf_slices, joint_cost
            )
            best_theta, history, best_loss = self.stage_1_opt(theta0, joint_cost)
        finally:
            self.log_scale_params = saved_log_scale

        log.info(f"Joint optimisation done. final loss={float(best_loss):.6e}")
        joint_fid = float(1.0 - best_loss)
        for leaf_name, sl in leaf_slices.items():
            self.save_results(leaf_name, joint_fid, best_theta[sl])
            # Make the new leaf defaults live in this process.
            PulseInformation.gate_by_name(leaf_name).params = best_theta[sl].clone()

        return best_theta, leaf_slices, history

    # ------------------------------------------------------------- plotting
    def plot_loss_landscape(
        self, gate_name: str, grid_axes: List[torch.Tensor], landscape_data: list
    ) -> None:
        """Save a Phase-0 loss-landscape figure (1-D/2-D/sorted scatter)."""
        import matplotlib.pyplot as plt

        if not landscape_data:
            log.warning("plot_loss_landscape: no landscape data to plot, skipping.")
            return
        os.makedirs(self.file_dir, exist_ok=True)
        n_params = len(grid_axes)
        indices, _cands, losses = zip(*landscape_data)
        losses_arr = np.array(losses, dtype=float)

        fig, ax = plt.subplots(figsize=(8, 5))
        if n_params == 1:
            xs = np.array([float(grid_axes[0][i]) for i in indices])
            sc = ax.scatter(xs, losses_arr, c=losses_arr, cmap="viridis_r", s=60)
            fig.colorbar(sc, ax=ax, label="Loss")
            ax.set(xlabel="Parameter value", xscale="log", yscale="log")
        elif n_params == 2:
            n = self.scan_grid_size
            grid = np.full((n, n), np.nan)
            for ci, _, loss in landscape_data:
                grid[divmod(ci, n)] = loss
            cmap = plt.cm.viridis_r.copy()
            cmap.set_bad(color="lightgrey")
            im = ax.imshow(
                np.ma.masked_invalid(grid),
                origin="lower",
                cmap=cmap,
                aspect="auto",
                extent=[
                    float(grid_axes[1][0]),
                    float(grid_axes[1][-1]),
                    float(grid_axes[0][0]),
                    float(grid_axes[0][-1]),
                ],
            )
            fig.colorbar(im, ax=ax, label="Loss")
        else:
            order = np.argsort(losses_arr)
            sc = ax.scatter(
                losses_arr[order],
                np.arange(len(order)),
                c=np.array(indices)[order],
                cmap="plasma",
                s=40,
            )
            fig.colorbar(sc, ax=ax, label="Trial number")
            ax.set(xlabel="Loss", xscale="log")

        ax.set_title(f"Loss Landscape (Phase 0) — {gate_name}")
        fig.tight_layout()
        path = os.path.join(self.file_dir, f"{gate_name}_loss_landscape.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        log.info(f"Loss landscape saved to {path}")

    def plot_loss_curve(self, gate_name: str, loss_history: list) -> None:
        """Save a Phase-1 training-loss curve figure."""
        import matplotlib.pyplot as plt

        if not loss_history:
            log.warning("plot_loss_curve: empty loss history, skipping.")
            return
        os.makedirs(self.file_dir, exist_ok=True)
        losses = [float(v) for v in loss_history]

        fig, ax = plt.subplots(figsize=(9, 4))
        ax.plot(losses, linewidth=1.2, label="Loss")
        ax.axhline(
            min(losses), color="red", linestyle="--", label=f"Best: {min(losses):.3e}"
        )
        ax.set(xlabel="Step", ylabel="Loss", yscale="log")
        ax.set_title(f"Training Loss (Phase 1) — {gate_name}")
        ax.legend()
        fig.tight_layout()
        path = os.path.join(self.file_dir, f"{gate_name}_loss_curve.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        log.info(f"Loss curve saved to {path}")


def _install_create_methods() -> None:
    """Generate ``QOC.create_<gate>`` from the gate library (compat API)."""
    for gate_name in _GATE_LIBRARY:
        def creator(self, _g=gate_name):
            return _pair_from_spec(_g, with_probes=True)

        creator.__name__ = f"create_{gate_name}"
        creator.__qualname__ = f"QOC.create_{gate_name}"
        creator.__doc__ = f"(pulse, target) circuit pair for {gate_name}."
        setattr(QOC, creator.__name__, creator)


_install_create_methods()


# Canonical knob defaults (also drives the CLI below).
default_qoc_params = dict(
    envelope="drag", cost_fns=[("unitary", (0.5, 0.5))],
    t_target=0.5, n_steps=800, n_samples=20,
    learning_rate=0.0001, warmup_ratio=0.05, end_lr_ratio=0.01,
    log_interval=50, file_dir=None,
    n_restarts=5, restart_noise_scale=0.01, grad_clip=1.0, random_seed=1000,
    scan_steps=20, scan_grid_size=4, scan_ranges=None, log_scale_params=None,
    early_stop_patience=0, early_stop_min_delta=0.0,
)


# ---------------------------------------------------------------------------
# Profiling probe
# ---------------------------------------------------------------------------


def profile_pulse_pipeline(
    gate: str = "RX",
    n_samples: int = 3,
    rwa: Optional[bool] = None,
    n_qubits: int = 1,
    device=DEFAULT_DEVICE,
) -> dict:
    """Time the first and the steady-state forward and loss + gradient of a
    pulse gate's circuit (the first call builds the solver; on the card it
    also loads the kernels)."""
    device = resolve_device(device)

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    with PulseInformation.preserve_state():
        if rwa is not None:
            PulseInformation.set_rwa(bool(rwa))
        from qml_essentials_tpu_torch.pulse.pulses import PulseGates

        def pulse_circuit(theta, pp):
            getattr(PulseGates, gate)(theta, wires=0, pulse_params=pp)

        def target_circuit(theta):
            getattr(op, gate)(theta, wires=0)

        pulse_script = _script(pulse_circuit, n_qubits, device)
        theta = torch.tensor(math.pi / 4, dtype=DTYPE, device=device)
        pp = PulseInformation.gate_by_name(gate).params.to(device)
        with torch.no_grad():
            want = _script(target_circuit, n_qubits, device).execute(
                type="state", args=(theta,)
            )

        def fwd(theta, pp):
            with torch.no_grad():
                return pulse_script.execute(type="state", args=(theta, pp))

        def loss_and_grad(pp):
            def loss_fn(p):
                got = pulse_script.execute(type="state", args=(theta, p))
                return 1.0 - torch.abs(torch.vdot(want, got)) ** 2

            return _value_and_grad(loss_fn, pp)

        compile_fwd = timed(fwd, theta, pp)
        compile_grad = timed(loss_and_grad, pp)
        fwd_times = [timed(fwd, theta, pp) for _ in range(n_samples)]
        grad_times = [timed(loss_and_grad, pp) for _ in range(n_samples)]
        loss, _ = loss_and_grad(pp)

        result = {
            "gate": gate,
            "rwa": PulseInformation.get_rwa(),
            "compile_fwd": compile_fwd,
            "mean_fwd": float(np.mean(fwd_times)),
            "compile_grad": compile_grad,
            "mean_grad": float(np.mean(grad_times)),
            "loss": float(loss),
        }
        log.info(
            f"[profile] gate={gate} rwa={result['rwa']} "
            f"first fwd/grad: {compile_fwd * 1e3:.1f}/{compile_grad * 1e3:.1f} ms, "
            f"mean fwd/grad: {result['mean_fwd'] * 1e3:.1f}/"
            f"{result['mean_grad'] * 1e3:.1f} ms"
        )
        return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

# Plain numeric/string knobs exposed 1:1 as --flags (typed off the default).
_CLI_SCALARS = (
    "t_target", "n_steps", "n_samples", "learning_rate", "warmup_ratio",
    "end_lr_ratio", "log_interval", "file_dir", "n_restarts",
    "restart_noise_scale", "grad_clip", "random_seed", "scan_steps",
    "scan_grid_size", "early_stop_patience", "early_stop_min_delta",
)


def _build_arg_parser() -> argparse.ArgumentParser:
    """CLI for pulse-level gate synthesis."""
    parser = argparse.ArgumentParser(
        description="Quantum Optimal Control — pulse-level gate synthesis."
    )
    parser.add_argument(
        "--gates",
        type=str,
        nargs="+",
        default=["RX", "RY", "RZ", "CZ"],
        choices=QOC.GATES_1Q + QOC.GATES_2Q + ["all"],
    )
    parser.add_argument(
        "--envelope",
        type=str,
        default=default_qoc_params["envelope"],
        choices=PulseEnvelope.available(),
    )
    parser.add_argument(
        "--costs", type=str, nargs="+", default=default_qoc_params["cost_fns"]
    )
    for knob in _CLI_SCALARS:
        default = default_qoc_params[knob]
        kind = str if default is None else type(default)
        parser.add_argument(f"--{knob}", type=kind, default=default)
    parser.add_argument("--scan_ranges", type=str, nargs="*", default=None)
    for flag in ("log", "plot", "joint", "rwa", "drive"):
        parser.add_argument(f"--{flag}", action="store_true", default=False)
    parser.add_argument("--no-log", action="store_false", dest="log")
    parser.add_argument("--joint_targets", nargs="+", type=str, default=None)
    parser.add_argument("--joint_leaves", nargs="+", type=str, default=None)
    parser.add_argument("--joint_weights", nargs="+", type=str, default=None)
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    """CLI entry point."""
    args = _build_arg_parser().parse_args(argv)

    scan_ranges = None
    if args.scan_ranges is not None:
        scan_ranges = [
            tuple(float(x) for x in pair.split(",")) for pair in args.scan_ranges
        ]

    PulseInformation.set_rwa(args.rwa)
    PulseInformation.set_frame("drive" if args.drive else "lab")

    logger = logging.getLogger("qml_essentials_tpu_torch.pulse.qoc")
    logger.setLevel(logging.INFO)
    logger.addHandler(logging.StreamHandler())

    qoc = QOC(
        envelope=args.envelope,
        cost_fns=[CostFnRegistry.parse_cost_arg(s) for s in args.costs],
        scan_ranges=scan_ranges,
        plot=args.plot,
        device=args.device,
        **{knob: getattr(args, knob) for knob in _CLI_SCALARS},
    )

    if args.joint:
        joint_weights = None
        if args.joint_weights:
            joint_weights = dict(
                (g.strip(), float(w))
                for g, w in (spec.split(":") for spec in args.joint_weights)
            )
        qoc.optimize_joint(
            target_gates=args.joint_targets,
            leaf_names=args.joint_leaves,
            weights=joint_weights,
        )
    else:
        qoc.optimize_all(sel_gates=args.gates, make_log=args.log)


if __name__ == "__main__":
    main()
