"""The data-reuploading quantum circuit Model (user-facing), as an nn.Module.

The circuit *structure* never changes between calls: which ansatz layers
run, which encoding gates fire (the data-reuploading mask is concrete),
where state preparation goes.  The model therefore compiles it once into a
**static segment program** — a tuple of ``("prep",)`` / ``("pqc", layer)`` /
``("enc", layer, sites)`` / ``("golomb", layer)`` descriptors — and
``_variational`` walks that program, emitting gates onto the active tape.

The model lives on one explicit ``device`` (the card by default, the CPU
with ``device="cpu"``) in one explicit real ``dtype`` (float32 by default,
float64 on request).  Its variational parameters are an
``nn.Parameter`` of shape ``[batch, impl_layers, n_params_per_layer]``.  The
forward pass is differentiable with respect to ``params`` (and ``enc_params``
with ``trainable_frequencies``) on the CPU and on the card, where the
gradient runs through the kernels' backwards; serve forward-only requests
under ``torch.inference_mode()``, which keeps no residuals.

Noise (``noise_params``: Kraus channels after the gates, state-preparation
and measurement flips, decoherence at the end, Gaussian ``GateError`` on the
angles) makes the tape noisy, which the executor simulates as a density
matrix on the card's kernels; ``execution_type="density"`` returns one, and
``shots`` estimates ``expval`` / ``probs`` from samples.  Where the JAX
package threads PRNG keys, the model threads ``torch.Generator`` objects: its
own (``random_key``, seeded by ``random_seed``) gives each call one
generator, and each call one per batch element and one for the shots.

``gate_mode="pulse"`` runs every ansatz and state-preparation gate at the
pulse level (:mod:`~qml_essentials_tpu_torch.pulse.pulses`; the encodings
stay exact): each gate's matrix solves its drive Hamiltonian, all of a
request's gates in one batched solve per Hamiltonian family.  The model's
``pulse_params`` ``[batch, impl_layers, n_pulse_params_per_layer]`` scale
the gates' calibrated pulse parameters element-wise and are trainable like
``params``; their batch axis is the third of ``repeat_batch_axis``.  The
constructor's ``pulse_shape`` sets the process-global pulse envelope, as the
JAX package's does.

Counterpart of ``qml_essentials_tpu/models/model.py``.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from qml_essentials_tpu_torch.core import jaqsi as js
from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from qml_essentials_tpu_torch.models.ansaetze import Ansaetze, Circuit, Encoding
from qml_essentials_tpu_torch.models.gates import Gates, PulseInformation
from qml_essentials_tpu_torch.ops import operations as op
from qml_essentials_tpu_torch.ops.operations import KrausChannel
from qml_essentials_tpu_torch.ops.tape import recording
from qml_essentials_tpu_torch.utils import GeneratorBatch, profiling, safe_random_split

log = logging.getLogger(__name__)


# Supported decoherence/noise knobs and their inactive defaults.
_NOISE_DEFAULTS: Dict[str, Union[float, None]] = {
    "BitFlip": 0.0,
    "PhaseFlip": 0.0,
    "Depolarizing": 0.0,
    "MultiQubitDepolarizing": 0.0,
    "AmplitudeDamping": 0.0,
    "PhaseDamping": 0.0,
    "GateError": 0.0,
    "ThermalRelaxation": None,
    "StatePreparation": 0.0,
    "Measurement": 0.0,
}

_THERMAL_KEYS = ("t1", "t2", "t_factor")


def _f64_limit() -> int:
    from qml_essentials_tpu_torch.ops import simulation

    return simulation.LARGE_STATE_MIN_N // 2  # a noisy tape runs on 2n wires


class _KeyStream:
    """Hands out one child generator per call, split off one parent
    (``None`` flows through: noise-free circuits never draw).  A
    :class:`~qml_essentials_tpu_torch.utils.GeneratorBatch` parent splits
    each element's generator."""

    __slots__ = ("key",)

    def __init__(self, key: Optional[torch.Generator]) -> None:
        self.key = key

    def __call__(self) -> Optional[torch.Generator]:
        return safe_random_split(self.key, 1)[0]


class Model(nn.Module):
    """A data-reuploading quantum circuit model.

    Parameter tensors have shape ``[batch, impl_layers, n_params_per_layer]``
    where ``impl_layers = n_layers + 1`` when data reuploading is active
    (the closing ansatz layer after the last encoding, Schuld et al.).
    """

    def __init__(
        self, n_qubits: int, n_layers: int,
        circuit_type: Union[str, Circuit] = "No_Ansatz",
        data_reupload: Union[bool, List[List[bool]], List[List[List[bool]]]] = True,
        state_preparation: Union[str, Callable, List[Union[str, Callable]], None] = None,
        encoding: Union[Encoding, str, Callable, List[Union[str, Callable]]] = Gates.RX,
        trainable_frequencies: bool = False, initialization: str = "random",
        initialization_domain: List[float] = [0, 2 * np.pi],
        output_qubit: Union[List[int], int] = -1, shots: Optional[int] = None,
        random_seed: int = 1000, remove_zero_encoding: bool = True,
        repeat_batch_axis: List[bool] = [True, True, True],
        pulse_shape: str = "gaussian",
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        """Build the model and compile its segment program.

        Args:
            n_qubits: Number of qubits.
            n_layers: Number of ansatz layers.
            circuit_type: Ansatz name (see :class:`Ansaetze`) or Circuit class.
            data_reupload: ``True``/``False`` or an explicit boolean mask of
                shape ``(n_layers, n_qubits[, n_input_feat])``.
            state_preparation: Gate(s) applied to every qubit before layer 0.
            encoding: Encoding gate(s) or an :class:`Encoding` strategy.
            trainable_frequencies: Make encoding scales trainable.
            initialization: ``random`` | ``zeros`` | ``pi`` |
                ``zero-controlled`` | ``pi-controlled``.
            initialization_domain: ``[lo, hi]`` for random init.
            output_qubit: Measured qubit(s); ``-1`` = all.
            shots: Finite-shot count (``None`` = analytic).
            random_seed: Seed of the model's ``torch.Generator``: parameter
                init, then one generator per call for noise and shots.
            remove_zero_encoding: Elide encoding gates for all-zero inputs.
            repeat_batch_axis: Which of the (inputs, params, pulse) axes fuse
                into the flat execution batch.
            pulse_shape: Active pulse envelope for pulse-mode execution
                (sets the process-global envelope).
            device: Device of the parameters and the simulation: the card
                by default (raises without CUDA); ``"cpu"`` on request.
            dtype: Real dtype of the simulation (float32 or float64; on the
                card float64 below ``LARGE_STATE_MIN_N`` qubits, where the
                window kernels' batch entries carry it; forward and the
                kernels' own autograd backwards, not the adjoint executor).
        """
        super().__init__()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and n_qubits >= _f64_limit() and dtype != torch.float32:
            raise NotImplementedError(
                "on the card float64 runs below LARGE_STATE_MIN_N qubits (the batch entries of "
                "the window kernels); the large-state kernels take float32 only")
        self.dtype = dtype
        self.n_qubits: int = n_qubits
        self.n_layers: int = n_layers
        self.output_qubit = output_qubit
        self.shots = shots
        self.remove_zero_encoding = remove_zero_encoding
        self.trainable_frequencies = trainable_frequencies
        self.repeat_batch_axis = list(repeat_batch_axis)
        self.noise_params = None
        self.execution_type = "expval"
        self._zero_inputs = False
        self._batch_shape: Optional[Tuple[int, int, int]] = None

        PulseInformation.set_envelope(pulse_shape)

        # State preparation: resolved once into (gate, pulse_params) pairs.
        try:
            self._sp = Gates.parse_gates(state_preparation, Gates)
        except ValueError as e:
            raise ValueError(f"Error parsing encodings: {e}")
        self.sp_pulse_params = []
        for g in self._sp:
            info = PulseInformation.gate_by_name(getattr(g, "__name__", str(g)))
            self.sp_pulse_params.append(None if info is None else info.params)

        self._enc = encoding if isinstance(encoding, Encoding) else Encoding(
            "hamming", encoding
        )
        if self._enc.is_golomb:
            self._enc._n_qubits = n_qubits
        self.n_input_feat: int = len(self._enc)
        self.enc_params = nn.Parameter(
            torch.ones((n_layers, n_qubits, self.n_input_feat), dtype=dtype, device=self.device),
            requires_grad=trainable_frequencies,
        )

        self.pqc: Circuit = (
            getattr(Ansaetze, circuit_type or "No_Ansatz")()
            if isinstance(circuit_type, str)
            else circuit_type()
        )

        # Data-reupload mask: also compiles the segment program.
        self.data_reupload = data_reupload

        impl_layers = n_layers + (1 if self.has_dru else 0)
        self._params_shape = (impl_layers, self.pqc.n_params_per_layer(n_qubits))
        self._pulse_params_shape = (impl_layers, self.pqc.n_pulse_params_per_layer(n_qubits))

        self._inialization_strategy = initialization
        self._initialization_domain = initialization_domain
        self._params = nn.Parameter(torch.empty((1, *self._params_shape), dtype=dtype,
                                                device=self.device))
        self.random_key = self.initialize_params(torch.Generator().manual_seed(random_seed))
        self._pulse_params = nn.Parameter(torch.ones((1, *self._pulse_params_shape),
                                                     dtype=dtype, device=self.device))

        self.script = js.Script(
            f=self._variational, n_qubits=n_qubits, device=self.device, dtype=dtype
        )

    # =============================================================== properties
    @property
    def noise_params(self) -> Optional[Dict[str, Union[float, Dict[str, float]]]]:
        """Noise parameter dict, or ``None`` when noise-free."""
        return self._noise_params

    @noise_params.setter
    def noise_params(self, kvs: Optional[Dict]) -> None:
        self._noise_params = self._canon_noise(kvs)

    @staticmethod
    def _canon_noise(kvs: Optional[Dict]) -> Optional[Dict]:
        """Fill defaults, warn on unknown keys, validate thermal relaxation."""
        if kvs is None or all(v == 0.0 for v in kvs.values()):
            return None
        for key in set(kvs) - set(_NOISE_DEFAULTS):
            warnings.warn(f"Ignoring unsupported noise type {key!r}.", UserWarning)
        merged = dict(_NOISE_DEFAULTS)
        merged.update(kvs)

        tr = merged["ThermalRelaxation"]
        if isinstance(tr, dict):
            for k in set(tr) - set(_THERMAL_KEYS):
                warnings.warn(
                    f"Unknown ThermalRelaxation key {k!r} ignored (expected t1/t2/t_factor).",
                    UserWarning,
                )
            tr = {k: tr.get(k, 0.0) for k in _THERMAL_KEYS}
            if not all(tr.values()) or tr["t2"] > 2 * tr["t1"]:
                warnings.warn(
                    "ThermalRelaxation values are degenerate (need all nonzero "
                    "and t2 <= 2*t1); skipping the channel.",
                    UserWarning,
                )
                merged["ThermalRelaxation"] = 0.0
            else:
                merged["ThermalRelaxation"] = tr
        return merged

    @property
    def output_qubit(self) -> List[int]:
        """Measured qubit indices (``-1`` expanded to all qubits)."""
        return self._output_qubit

    @output_qubit.setter
    def output_qubit(self, value: Union[int, List[int]]) -> None:
        if isinstance(value, int):
            if value == -1:
                value = list(range(self.n_qubits))
            else:
                if value >= self.n_qubits:
                    raise ValueError(
                        f"output_qubit {value} is out of range for {self.n_qubits} qubits."
                    )
                value = [value]
        elif len(value) > self.n_qubits:
            raise ValueError(
                f"output_qubit lists at most {self.n_qubits} entries (got {len(value)})."
            )
        self._output_qubit = value

    @property
    def execution_type(self) -> str:
        """One of ``expval`` / ``probs`` / ``state`` / ``density``."""
        return self._execution_type

    @execution_type.setter
    def execution_type(self, value: str) -> None:
        k = len(self.output_qubit)
        shapes = {"expval": (k,), "probs": (2,) * k, "state": (2**k,),
                  "density": (2**k, 2**k)}
        if value not in shapes:
            raise ValueError(f"Invalid execution type: {value}.")
        self._result_shape = shapes[value]
        if value == "state" and not self.all_qubit_measurement:
            warnings.warn(
                f"execution_type={value!r} always covers the full register; "
                f"output_qubit={self.output_qubit} has no effect.",
                UserWarning,
            )
        if value == "probs" and self.shots is None:
            warnings.warn("probs mode without shots returns exact probabilities.", UserWarning)
        if value == "density" and self.shots is not None:
            raise ValueError("density mode is incompatible with finite shots.")
        self._execution_type = value

    @property
    def shots(self) -> Optional[int]:
        """Number of measurement shots (``None`` = analytic)."""
        return self._shots

    @shots.setter
    def shots(self, value: Optional[int]) -> None:
        self._shots = None if (type(value) is int and value <= 0) else value

    @property
    def params(self) -> torch.Tensor:
        """Variational parameters, batch-first."""
        return self._params

    @params.setter
    def params(self, value) -> None:
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.ndim == 2:
            value = value[None]
        self._params.data = value.detach().clone()

    @property
    def pulse_params(self) -> torch.Tensor:
        """Pulse-parameter scalers, batch-first (ones: the calibration)."""
        return self._pulse_params

    @pulse_params.setter
    def pulse_params(self, value) -> None:
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.ndim == 2:
            value = value[None]
        self._pulse_params.data = value.detach().clone()

    @property
    def data_reupload(self) -> np.ndarray:
        """Concrete boolean reupload mask, shape (n_layers, n_qubits, n_feat)."""
        return self._data_reupload

    @data_reupload.setter
    def data_reupload(self, value) -> None:
        self._data_reupload = self._canon_mask(value)
        self._derive_spectrum()
        self._compile_program()

    def _canon_mask(self, value) -> np.ndarray:
        """Normalise bool/2D/3D mask input to a concrete (L, Q, F) array."""
        L, Q, F = self.n_layers, self.n_qubits, self.n_input_feat
        if isinstance(value, bool):
            if value:
                return np.ones((L, Q, F), dtype=bool)
            mask = np.zeros((L, Q, F), dtype=bool)
            mask[0, 0] = True
            return mask
        mask = np.asarray(value)
        if mask.ndim == 2:
            if mask.shape != (L, Q):
                raise ValueError(
                    f"Data reuploading array has wrong shape. "
                    f"Expected {(L, Q)} or {(L, Q, F)}, got {mask.shape}."
                )
            mask = np.repeat(mask[..., None], F, axis=2)
        if mask.shape != (L, Q, F):
            raise ValueError(
                f"Data reuploading array has wrong shape. "
                f"Expected {(L, Q, F)}, got {mask.shape}."
            )
        return mask.astype(bool)

    def _derive_spectrum(self) -> None:
        """Per-feature degree / frequency estimate from the encoding count."""
        counts = [
            int(np.count_nonzero(self._data_reupload[..., f]))
            for f in range(self.n_input_feat)
        ]
        self.degree = tuple(self._enc.get_n_freqs(c) for c in counts)
        self.frequencies = tuple(self._enc.get_spectrum(c) for c in counts)
        self._has_dru = max(int(np.max(f)) for f in self.frequencies) > 1

    def _compile_program(self) -> None:
        """Compile the static circuit structure into a segment tuple."""
        program: List[tuple] = []
        if self._sp:
            program.append(("prep",))
        golomb = self._enc.is_golomb
        for layer in range(self.n_layers):
            program.append(("pqc", layer))
            mask = self._data_reupload[layer]
            if golomb:
                if mask[:, 0].any():
                    program.append(("golomb", layer))
            else:
                sites = tuple(
                    (q, f)
                    for q in range(self.n_qubits)
                    for f in range(self.n_input_feat)
                    if mask[q, f]
                )
                if sites:
                    program.append(("enc", layer, sites))
        if self._has_dru:
            program.append(("pqc", self.n_layers))
        self._program = tuple(program)

    @property
    def has_dru(self) -> bool:
        """Whether data reuploading is active (spectrum beyond degree 1)."""
        return self._has_dru

    @property
    def all_qubit_measurement(self) -> bool:
        """Whether the measurement covers every qubit."""
        return self.output_qubit == list(range(self.n_qubits))

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        """(B_inputs, B_params, B_pulse) from the last call; (1, 1, 1) before."""
        return self._batch_shape or (1, 1, 1)

    @property
    def eff_batch_shape(self) -> Tuple[int, ...]:
        """Batch shape restricted to the enabled repeat axes."""
        return tuple(
            s for s, on in zip(self.batch_shape, self.repeat_batch_axis) if on and s
        )

    def exact_spectrum(self, method: str = "tree") -> Tuple[np.ndarray, ...]:
        """Exact per-feature Fourier support via the analytic FourierTree.

        Unlike :attr:`frequencies` (an encoding-count estimate that can
        overestimate), this derives the support symbolically; see
        :meth:`~qml_essentials_tpu_torch.analysis.coefficients.FourierTree.get_exact_support`.
        """
        from qml_essentials_tpu_torch.analysis.coefficients import FourierTree

        tree = FourierTree(self)
        where = {feat: pos for pos, feat in enumerate(tree.features)}

        seen: set = set()
        for freqs in tree.get_exact_support(method=method):
            arr = np.atleast_2d(np.asarray(freqs))
            for row in arr:
                seen.add(tuple(int(v) for v in np.atleast_1d(row)))

        out = []
        for feat in range(self.n_input_feat):
            if seen and feat in where:
                out.append(np.array(sorted({t[where[feat]] for t in seen}), dtype=int))
            else:
                out.append(np.array([0], dtype=int))
        return tuple(out)

    # ============================================================ param init
    _INIT_STRATEGIES = ("random", "zeros", "pi", "zero-controlled", "pi-controlled")

    def initialize_params(
        self,
        random_key: Optional[torch.Generator] = None,
        repeat: int = 1,
        initialization: Optional[str] = None,
        initialization_domain: Optional[List[float]] = None,
    ) -> torch.Generator:
        """(Re-)initialise the variational parameters from a seeded
        ``torch.Generator``; returns the generator, advanced."""
        strategy = initialization or self._inialization_strategy
        lo, hi = initialization_domain or self._initialization_domain
        shape = (repeat, *self._params_shape)
        gen = self.random_key if random_key is None else random_key

        if strategy not in self._INIT_STRATEGIES:
            raise ValueError("Invalid initialization method")

        if strategy == "zeros":
            drawn = torch.zeros(shape, dtype=self.dtype)
        elif strategy == "pi":
            drawn = torch.full(shape, np.pi, dtype=self.dtype)
        else:
            drawn = torch.rand(shape, generator=gen, dtype=self.dtype) * (hi - lo) + lo

        if strategy.endswith("-controlled"):
            pin = 0.0 if strategy.startswith("zero") else np.pi
            ctl = self.pqc.get_control_indices(self.n_qubits)
            if ctl is None:
                warnings.warn(
                    f"{strategy} init requested but the ansatz exposes no "
                    f"controlled-rotation slots; keeping the random draw.",
                    UserWarning,
                )
            elif len(ctl) == 3 and None in ctl:
                drawn[:, :, slice(*ctl)] = pin
            else:
                drawn[:, :, ctl] = pin

        self.params = drawn
        log.info(f"Initialized parameters {shape} with strategy {strategy}.")
        return gen

    def load_numpy(self, params: np.ndarray, enc_params: Optional[np.ndarray] = None,
                   pulse_params: Optional[np.ndarray] = None) -> None:
        """Install parameters exported from the JAX package's Model
        (``np.asarray(model.params)``, shape ``[batch, impl_layers,
        n_params_per_layer]``, ``np.asarray(model.enc_params)`` and
        ``np.asarray(model.pulse_params)``, ``[batch, impl_layers,
        n_pulse_params_per_layer]``), so both packages compute the same
        function."""
        params = np.array(params)
        if params.ndim == 2:
            params = params[None]
        if params.shape[1:] != self._params_shape:
            raise ValueError(
                f"params shape {params.shape} does not match "
                f"[batch, {self._params_shape[0]}, {self._params_shape[1]}]"
            )
        self.params = torch.as_tensor(params)
        if enc_params is not None:
            enc = torch.as_tensor(np.array(enc_params), dtype=self.dtype, device=self.device)
            if tuple(enc.shape) != tuple(self.enc_params.shape):
                raise ValueError(
                    f"enc_params shape {tuple(enc.shape)} != {tuple(self.enc_params.shape)}"
                )
            self.enc_params.data = enc
        if pulse_params is not None:
            pulse = np.array(pulse_params)
            if pulse.ndim == 2:
                pulse = pulse[None]
            if pulse.shape[1:] != self._pulse_params_shape:
                raise ValueError(
                    f"pulse_params shape {pulse.shape} does not match "
                    f"[batch, {self._pulse_params_shape[0]}, {self._pulse_params_shape[1]}]"
                )
            self.pulse_params = torch.as_tensor(pulse)

    # ================================================================ circuit
    def transform_input(self, inputs: torch.Tensor, enc_params: torch.Tensor) -> torch.Tensor:
        """Linear input scaling by encoding parameters (arXiv:2309.03279)."""
        return inputs * enc_params

    def _variational(
        self,
        params: torch.Tensor,
        inputs: torch.Tensor,
        pulse_params: Optional[torch.Tensor] = None,
        random_key: Optional[torch.Generator] = None,
        enc_params: Optional[torch.Tensor] = None,
        gate_mode: str = "unitary",
        noise_params: Optional[Dict] = None,
    ) -> None:
        """Interpret the segment program, emitting gates (and, with noise,
        channels) onto the active tape.  *random_key* is the generator of
        this circuit's noise: each segment gets a child of it (no child is
        split off without noise: nothing would draw from it).

        A batch recorded as one tape passes *params* ``(Bt, impl_layers,
        n_params_per_layer)``, *inputs* ``(Bt, n_input_feat)`` and/or
        *pulse_params* ``(Bt, impl_layers, n_pulse_params_per_layer)``, and
        *random_key* a ``GeneratorBatch``: every per-element index counts
        from the right, so each gate receives ``(Bt,)`` angles and
        ``(Bt, P)`` pulse parameters."""
        if params.ndim > 2 and params.shape[0] == 1:
            params = params[0]
        if inputs.ndim > 1 and inputs.shape[0] == 1:
            inputs = inputs[0]
        if pulse_params is None:
            if gate_mode == "pulse":
                warnings.warn("_variational called without pulse_params; falling back to "
                              "the stored self.pulse_params.", RuntimeWarning)
            pulse_params = self.pulse_params
        if pulse_params.ndim > 2 and pulse_params.shape[0] == 1:
            pulse_params = pulse_params[0]
        if enc_params is None:
            enc_params = self.enc_params
        if noise_params is None and self.noise_params is not None:
            warnings.warn("_variational called without noise_params; falling back to "
                          "the stored self.noise_params.", RuntimeWarning)
            noise_params = self.noise_params
        if noise_params is not None and random_key is None:
            warnings.warn("_variational called without a random_key while noise is "
                          "active; reusing the model generator.", RuntimeWarning)
            random_key = self.random_key

        keys = _KeyStream(random_key if noise_params is not None else None)
        elide_encoding = (
            self.remove_zero_encoding and self._zero_inputs and self.batch_shape[0] == 1
        )
        if noise_params is not None:
            p_prep = noise_params.get("StatePreparation", 0.0)
            if p_prep > 0:
                for q in range(self.n_qubits):
                    op.BitFlip(p_prep, wires=q)

        for segment in self._program:
            kind = segment[0]
            if kind == "prep":
                for q in range(self.n_qubits):
                    for gate, gate_pp in zip(self._sp, self.sp_pulse_params):
                        gate(wires=q, pulse_params=gate_pp, noise_params=noise_params,
                             random_key=keys(), gate_mode=gate_mode)
            elif kind == "pqc":
                layer = segment[1]
                self.pqc(
                    params[..., layer, :],
                    self.n_qubits,
                    pulse_params=pulse_params[..., min(layer, pulse_params.shape[-2] - 1), :],
                    noise_params=noise_params,
                    random_key=keys(),
                    gate_mode=gate_mode,
                )
            elif kind == "enc":
                keys()  # a layer-level split, as in the JAX package
                if elide_encoding:
                    continue
                layer, sites = segment[1], segment[2]
                for q, f in sites:
                    self._enc[f](
                        self.transform_input(inputs[..., f], enc_params[layer, q, f]),
                        wires=q,
                        noise_params=noise_params,
                        random_key=keys(),
                    )
            elif kind == "golomb":
                keys()
                if elide_encoding:
                    continue
                layer = segment[1]
                self._enc[0](
                    self.transform_input(inputs[..., 0], enc_params[layer, :, 0].mean()),
                    wires=list(range(self.n_qubits)),
                    noise_params=noise_params,
                    random_key=keys(),
                )

        if noise_params is not None:
            self._emit_decoherence(noise_params)

    def _emit_decoherence(self, noise_params: Dict) -> None:
        """Post-circuit decoherence channels on every qubit."""
        amp = noise_params.get("AmplitudeDamping", 0.0)
        phase = noise_params.get("PhaseDamping", 0.0)
        meas = noise_params.get("Measurement", 0.0)
        thermal = noise_params.get("ThermalRelaxation", 0.0)
        tg = (self._get_circuit_depth() * thermal["t_factor"]
              if isinstance(thermal, dict) else None)
        for q in range(self.n_qubits):
            if amp > 0:
                op.AmplitudeDamping(amp, wires=q)
            if phase > 0:
                op.PhaseDamping(phase, wires=q)
            if meas > 0:
                op.BitFlip(meas, wires=q)
            if tg is not None:
                op.ThermalRelaxationError(1.0, thermal["t1"], thermal["t2"], tg, q)

    def _get_circuit_depth(self, inputs=None) -> int:
        """Critical-path depth of the noise-free circuit (cached): each gate
        starts after the busiest of its wires; depth is the latest finish.
        Recorded with zero inputs unless *inputs* are given, as in the JAX
        package (encodings elided under ``remove_zero_encoding``); the
        model's zero-input flag is restored afterwards."""
        cached = getattr(self, "_depth_cache", None)
        if cached is not None:
            return cached
        zero_inputs = self._zero_inputs
        saved = self._noise_params
        self._noise_params = None
        try:
            inputs = self._inputs_validation(inputs)
            with recording() as tape, torch.no_grad():
                self._variational(self.params[0], inputs[0], noise_params=None)
        finally:
            self._noise_params = saved
            self._zero_inputs = zero_inputs

        finish: Dict[int, int] = {}
        depth = 0
        for gate in tape:
            if isinstance(gate, KrausChannel):
                continue
            t = 1 + max((finish.get(w, 0) for w in gate.wires), default=0)
            finish.update({w: t for w in gate.wires})
            depth = max(depth, t)
        self._depth_cache = depth
        return depth

    def _build_obs(self) -> Tuple[str, List[op.Operation]]:
        """Translate execution_type / output_qubit into (meas_type, obs)."""
        if self.execution_type != "expval":
            return self.execution_type, []
        obs = [
            op.PauliZ(wires=spec, record=False)
            if isinstance(spec, int)
            else js.build_parity_observable(list(spec))
            for spec in self.output_qubit
        ]
        return "expval", obs

    # ================================================================ drawing
    def _draw_call_args(self, inputs) -> tuple:
        """One parameter set and one input, as the drawing records them: the
        first of each (a drawing shows one circuit, not a batch)."""
        inputs = self._inputs_validation(inputs)
        params = self.params[0] if self.params.ndim == 3 else self.params
        inp = inputs[0] if inputs.ndim == 2 else inputs
        return params, inp

    def draw(self, inputs=None, figure: str = "text", **kwargs: Any) -> Union[str, Any]:
        """Render the noise-free circuit: ``text`` | ``mpl`` | ``tikz`` |
        ``pulse`` (``mpl`` and ``pulse`` need matplotlib)."""
        if figure == "pulse":
            return self.draw_pulse(inputs=inputs, **kwargs)
        params, inp = self._draw_call_args(inputs)
        saved = self._noise_params
        self._noise_params = None
        try:
            return self.script.draw(
                figure=figure,
                args=(params, inp),
                kwargs={"noise_params": None},
                **kwargs,
            )
        finally:
            self._noise_params = saved

    def draw_pulse(self, inputs=None, **kwargs: Any) -> Any:
        """Render the pulse schedule of the circuit (pulse mode; needs
        matplotlib)."""
        params, inp = self._draw_call_args(inputs)
        pulse = self.pulse_params[0] if self.pulse_params.ndim == 3 else self.pulse_params
        return self.script.draw(
            figure="pulse",
            args=(params, inp, pulse),
            kwargs={"gate_mode": "pulse", "noise_params": None},
            **kwargs,
        )

    def __str__(self) -> str:
        return self.draw(figure="text")

    __repr__ = __str__

    # ============================================================= validation
    def _params_validation(self, params) -> torch.Tensor:
        """Normalise params to (batch, impl_layers, n_params_per_layer); a
        tensor passed in is used as given and its values are stored."""
        if params is None:
            return self.params
        if not isinstance(params, torch.Tensor):
            params = torch.as_tensor(np.asarray(params), dtype=self.dtype)
        params = params.to(device=self.device, dtype=self.dtype)
        if params.ndim == 2:
            params = params[None]
        if params is not self._params:
            self.params = params
        return params

    def _pulse_params_validation(self, pulse_params) -> torch.Tensor:
        """Normalise pulse params to (batch, impl_layers,
        n_pulse_params_per_layer); a tensor passed in is used as given and
        its values are stored."""
        if pulse_params is None:
            return self.pulse_params
        if not isinstance(pulse_params, torch.Tensor):
            pulse_params = torch.as_tensor(np.asarray(pulse_params), dtype=self.dtype)
        pulse_params = pulse_params.to(device=self.device, dtype=self.dtype)
        if pulse_params.ndim == 2:
            pulse_params = pulse_params[None]
        if pulse_params is not self._pulse_params:
            self.pulse_params = pulse_params
        return pulse_params

    def _enc_params_validation(self, enc_params) -> torch.Tensor:
        """Normalise encoding params to (n_layers, n_qubits, n_input_feat)."""
        if enc_params is None:
            enc_params = self.enc_params
        else:
            enc_params = torch.as_tensor(enc_params, dtype=self.dtype, device=self.device)
            self.enc_params.data = enc_params.detach().clone()
        if enc_params.ndim == 1:
            if self.n_input_feat > 1:
                raise ValueError(
                    f"Input dimension {self.n_input_feat} >1 but "
                    f"`enc_params` has shape {tuple(enc_params.shape)}"
                )
            enc_params = enc_params.reshape(-1, 1)
        return enc_params

    def _inputs_validation(self, inputs) -> torch.Tensor:
        """Normalise inputs to (batch_size, n_input_feat)."""
        F = self.n_input_feat
        if inputs is None:
            inputs = torch.zeros((1, F), dtype=self.dtype)
        elif isinstance(inputs, list):
            inputs = torch.as_tensor(np.stack(inputs), dtype=self.dtype)
        elif isinstance(inputs, (int, float)):
            inputs = torch.tensor([inputs], dtype=self.dtype)
        elif not isinstance(inputs, torch.Tensor):
            inputs = torch.as_tensor(np.asarray(inputs), dtype=self.dtype)
        inputs = inputs.to(device=self.device, dtype=self.dtype)

        self._zero_inputs = not bool(inputs.any())

        if inputs.ndim <= 1:
            if F == 1:
                inputs = inputs.reshape(-1, 1)
            elif inputs.shape[0] == F:
                inputs = inputs.reshape(1, -1)
            else:
                warnings.warn(
                    f"Got {inputs.shape[0]} input values for {F} features; "
                    "broadcasting the column to every feature.",
                    UserWarning,
                )
                inputs = inputs.reshape(-1, 1).repeat(1, F)
        elif inputs.shape[1] != F:
            raise ValueError(
                f"Input shape {tuple(inputs.shape)} does not match the expected "
                f"{F} feature column(s)."
            )
        return inputs

    # =============================================================== batching
    def _assimilate_batch(
        self, inputs: torch.Tensor, params: torch.Tensor, pulse_params: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fuse the (inputs × params × pulse) batch axes into one flat axis:
        each tensor whose own axis is enabled is broadcast over the other
        enabled axes and flattened."""
        sizes = (
            inputs.shape[0],
            1 if 0 in params.shape else params.shape[0],
            pulse_params.shape[0],
        )
        self._batch_shape = sizes
        enabled = self.repeat_batch_axis

        def spread(t: torch.Tensor, axis: int) -> torch.Tensor:
            if sizes[axis] <= 1 or not enabled[axis]:
                return t
            lead = tuple(sizes[i] if (enabled[i] or i == axis) else 1 for i in range(3))
            expand = [1, 1, 1]
            expand[axis] = sizes[axis]
            t = t.reshape(tuple(expand) + tuple(t.shape[1:]))
            t = t.expand(lead + tuple(t.shape[3:]))
            return t.reshape((-1,) + tuple(t.shape[3:]))

        return spread(inputs, 0), spread(params, 1), spread(pulse_params, 2)

    # ================================================================ forward
    def forward(self, params=None, inputs=None, **kwargs) -> torch.Tensor:
        """Execute the model; see :meth:`_forward`.  Under a profiler the
        call is a ``model.forward`` span, the request of every span inside it
        (:mod:`~qml_essentials_tpu_torch.utils.profiling`)."""
        with profiling.span("model.forward", opens_request=True):
            return self._forward(params=params, inputs=inputs, **kwargs)

    def _forward(
        self,
        params: Optional[torch.Tensor] = None,
        inputs=None,
        pulse_params: Optional[torch.Tensor] = None,
        enc_params: Optional[torch.Tensor] = None,
        data_reupload=None,
        noise_params: Optional[Dict] = None,
        execution_type: Optional[str] = None,
        force_mean: bool = False,
        gate_mode: str = "unitary",
    ) -> torch.Tensor:
        """Forward pass: canonicalise → fuse batches → execute → shape.

        Output shapes by ``execution_type``: ``expval`` → (n_out,),
        ``probs`` → (2,)*k, ``state`` → (2^n,), ``density`` → (2^k, 2^k),
        with leading batch dims.  Each call splits one generator off the
        model's, then one per batch element (the circuit's noise) and, with
        shots, one for the draws.
        """
        for knob, value in (("noise_params", noise_params),
                            ("execution_type", execution_type),
                            ("data_reupload", data_reupload)):
            if value is not None:
                setattr(self, knob, value)
        if pulse_params is not None and gate_mode != "pulse":
            raise ValueError(
                "pulse_params only apply in gate_mode='pulse'; drop them or "
                "switch the gate mode."
            )

        params = self._params_validation(params)
        pulse_params = self._pulse_params_validation(pulse_params)
        inputs = self._inputs_validation(inputs)
        enc_params = self._enc_params_validation(enc_params)
        inputs, params, pulse_params = self._assimilate_batch(inputs, params, pulse_params)

        self.random_key, call_key = safe_random_split(self.random_key)
        shot_key = None
        if self.shots is not None:
            call_key, shot_key = safe_random_split(call_key)

        meas_type, obs = self._build_obs()
        run_kwargs = dict(noise_params=self.noise_params, gate_mode=gate_mode)
        B = int(np.prod(self.eff_batch_shape))

        if B > 1:
            axes = tuple(0 if b > 1 else None for b in self.batch_shape)
            # One noise generator per element; none without noise (nothing
            # draws from them).
            keys = (GeneratorBatch(safe_random_split(call_key, B))
                    if self.noise_params is not None else None)
            result = self.script.execute(
                type=meas_type,
                obs=obs,
                args=(params, inputs, pulse_params, keys, enc_params),
                kwargs=run_kwargs,
                in_axes=(axes[1], axes[0], axes[2], None if keys is None else 0, None),
                shots=self.shots,
                generator=shot_key,
            )
        else:
            result = self.script.execute(
                type=meas_type, obs=obs, kwargs=run_kwargs,
                args=(params, inputs, pulse_params, call_key, enc_params),
                shots=self.shots, generator=shot_key,
            )
        return self._shape_result(result, force_mean)

    def _shape_result(self, result: torch.Tensor, force_mean: bool) -> torch.Tensor:
        """Post-process raw executor output into the documented shape."""
        partial = not self.all_qubit_measurement
        if partial and self.execution_type == "density":
            result = js.partial_trace(result, self.n_qubits, self.output_qubit)
        elif partial and self.execution_type == "probs":
            groups = self.output_qubit
            if isinstance(groups[0], (list, tuple)):
                result = torch.stack(
                    [js.marginalize_probs(result, self.n_qubits, list(g)) for g in groups]
                )
            else:
                result = js.marginalize_probs(result, self.n_qubits, groups)

        result = result.reshape((*self.eff_batch_shape, *self._result_shape)).squeeze()

        if (
            force_mean
            and self.execution_type in ("expval", "probs")
            and result.ndim > 0
            and self._result_shape[0] > 1
        ):
            result = result.mean(dim=-1)
        return result
