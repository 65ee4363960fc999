"""The data-reuploading quantum circuit Model (user-facing), as an nn.Module.

The circuit *structure* never changes between calls: which ansatz layers
run, which encoding gates fire (the data-reuploading mask is concrete),
where state preparation goes.  The model therefore compiles it once into a
**static segment program** — a tuple of ``("prep",)`` / ``("pqc", layer)`` /
``("enc", layer, sites)`` / ``("golomb", layer)`` descriptors — and
``_variational`` walks that program, emitting gates onto the active tape.

The model lives on one explicit ``device`` in one explicit real ``dtype``
(float32 by default, float64 on request).  Its variational parameters are an
``nn.Parameter`` of shape ``[batch, impl_layers, n_params_per_layer]``.  The
forward pass is differentiable with respect to ``params`` (and ``enc_params``
with ``trainable_frequencies``) on the CPU and on the card, where the
gradient runs through the kernels' backwards; serve forward-only requests
under ``torch.inference_mode()``, which keeps no residuals.

Counterpart of ``qml_essentials_tpu/models/model.py`` (unitary gates,
``expval`` / ``probs`` / ``state``; noise, shots, density and pulses come
with later slices and raise ``NotImplementedError``).
"""

from __future__ import annotations

import logging
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from qml_essentials_tpu_torch.core import jaqsi as js
from qml_essentials_tpu_torch.models.ansaetze import Ansaetze, Circuit, Encoding
from qml_essentials_tpu_torch.models.gates import Gates
from qml_essentials_tpu_torch.ops import operations as op

log = logging.getLogger(__name__)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


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
        repeat_batch_axis: List[bool] = [True, True],
        device: Union[str, torch.device] = "cpu",
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
            shots: Finite-shot count; only ``None`` (analytic) is ported.
            random_seed: Seed of the ``torch.Generator`` for parameter init.
            remove_zero_encoding: Elide encoding gates for all-zero inputs.
            repeat_batch_axis: Which of the (inputs, params) axes fuse into
                the flat execution batch.
            device: Device of the parameters and the simulation.
            dtype: Real dtype of the simulation (float32 or float64).
        """
        super().__init__()
        self.device = _resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 only so far")
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
        self._batch_shape: Optional[Tuple[int, int]] = None

        try:
            self._sp = Gates.parse_gates(state_preparation, Gates)
        except ValueError as e:
            raise ValueError(f"Error parsing encodings: {e}")

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

        self._inialization_strategy = initialization
        self._initialization_domain = initialization_domain
        self._params = nn.Parameter(torch.empty((1, *self._params_shape), dtype=dtype,
                                                device=self.device))
        self.random_key = self.initialize_params(torch.Generator().manual_seed(random_seed))

        self.script = js.Script(
            f=self._variational, n_qubits=n_qubits, device=self.device, dtype=dtype
        )

    # =============================================================== properties
    @property
    def noise_params(self) -> Optional[Dict]:
        """Noise parameter dict; only ``None`` (noise-free) is ported."""
        return None

    @noise_params.setter
    def noise_params(self, kvs: Optional[Dict]) -> None:
        if kvs is not None and any(v for v in kvs.values()):
            raise NotImplementedError("noise_params come with the density slice")

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
        """One of ``expval`` / ``probs`` / ``state``."""
        return self._execution_type

    @execution_type.setter
    def execution_type(self, value: str) -> None:
        k = len(self.output_qubit)
        shapes = {"expval": (k,), "probs": (2,) * k, "state": (2**k,)}
        if value == "density":
            raise NotImplementedError("density execution comes with the density slice")
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
        self._execution_type = value

    @property
    def shots(self) -> Optional[int]:
        """Number of measurement shots (``None`` = analytic)."""
        return self._shots

    @shots.setter
    def shots(self, value: Optional[int]) -> None:
        value = None if (type(value) is int and value <= 0) else value
        if value is not None:
            raise NotImplementedError("finite-shot sampling is not ported yet")
        self._shots = value

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
        """(B_inputs, B_params) from the last call; (1, 1) before."""
        return self._batch_shape or (1, 1)

    @property
    def eff_batch_shape(self) -> Tuple[int, ...]:
        """Batch shape restricted to the enabled repeat axes."""
        return tuple(
            s for s, on in zip(self.batch_shape, self.repeat_batch_axis) if on and s
        )

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

    def load_numpy(self, params: np.ndarray, enc_params: Optional[np.ndarray] = None) -> None:
        """Install parameters exported from the JAX package's Model
        (``np.asarray(model.params)``, shape ``[batch, impl_layers,
        n_params_per_layer]``, and ``np.asarray(model.enc_params)``), so both
        packages compute the same function."""
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

    # ================================================================ circuit
    def transform_input(self, inputs: torch.Tensor, enc_params: torch.Tensor) -> torch.Tensor:
        """Linear input scaling by encoding parameters (arXiv:2309.03279)."""
        return inputs * enc_params

    def _variational(
        self,
        params: torch.Tensor,
        inputs: torch.Tensor,
        enc_params: Optional[torch.Tensor] = None,
        gate_mode: str = "unitary",
        noise_params: Optional[Dict] = None,
    ) -> None:
        """Interpret the segment program, emitting gates onto the active tape."""
        if params.ndim > 2 and params.shape[0] == 1:
            params = params[0]
        if inputs.ndim > 1 and inputs.shape[0] == 1:
            inputs = inputs[0]
        if enc_params is None:
            enc_params = self.enc_params

        elide_encoding = (
            self.remove_zero_encoding and self._zero_inputs and self.batch_shape[0] == 1
        )
        for segment in self._program:
            kind = segment[0]
            if kind == "prep":
                for q in range(self.n_qubits):
                    for gate in self._sp:
                        gate(wires=q, noise_params=noise_params, gate_mode=gate_mode)
            elif kind == "pqc":
                layer = segment[1]
                self.pqc(
                    params[layer],
                    self.n_qubits,
                    noise_params=noise_params,
                    gate_mode=gate_mode,
                )
            elif kind == "enc":
                if elide_encoding:
                    continue
                layer, sites = segment[1], segment[2]
                for q, f in sites:
                    self._enc[f](
                        self.transform_input(inputs[..., f], enc_params[layer, q, f]),
                        wires=q,
                        noise_params=noise_params,
                    )
            elif kind == "golomb":
                if elide_encoding:
                    continue
                layer = segment[1]
                self._enc[0](
                    self.transform_input(inputs[..., 0], enc_params[layer, :, 0].mean()),
                    wires=list(range(self.n_qubits)),
                    noise_params=noise_params,
                )

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
        self, inputs: torch.Tensor, params: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fuse the (inputs × params) batch axes into one flat axis: each
        tensor whose own axis is enabled is broadcast over the other enabled
        axis and flattened."""
        sizes = (inputs.shape[0], 1 if 0 in params.shape else params.shape[0])
        self._batch_shape = sizes
        enabled = self.repeat_batch_axis

        def spread(t: torch.Tensor, axis: int) -> torch.Tensor:
            if sizes[axis] <= 1 or not enabled[axis]:
                return t
            lead = tuple(sizes[i] if (enabled[i] or i == axis) else 1 for i in range(2))
            expand = [1, 1]
            expand[axis] = sizes[axis]
            t = t.reshape(tuple(expand) + tuple(t.shape[1:]))
            t = t.expand(lead + tuple(t.shape[2:]))
            return t.reshape((-1,) + tuple(t.shape[2:]))

        return spread(inputs, 0), spread(params, 1)

    # ================================================================ forward
    def forward(self, params=None, inputs=None, **kwargs) -> torch.Tensor:
        """Execute the model; see :meth:`_forward`."""
        return self._forward(params=params, inputs=inputs, **kwargs)

    def _forward(
        self,
        params: Optional[torch.Tensor] = None,
        inputs=None,
        enc_params: Optional[torch.Tensor] = None,
        data_reupload=None,
        noise_params: Optional[Dict] = None,
        execution_type: Optional[str] = None,
        force_mean: bool = False,
        gate_mode: str = "unitary",
    ) -> torch.Tensor:
        """Forward pass: canonicalise → fuse batches → execute → shape.

        Output shapes by ``execution_type``: ``expval`` → (n_out,),
        ``probs`` → (2,)*k, ``state`` → (2^n,), with leading batch dims.
        """
        if gate_mode == "pulse":
            raise NotImplementedError("gate_mode='pulse' comes with the pulse slice")
        for knob, value in (("noise_params", noise_params),
                            ("execution_type", execution_type),
                            ("data_reupload", data_reupload)):
            if value is not None:
                setattr(self, knob, value)

        params = self._params_validation(params)
        inputs = self._inputs_validation(inputs)
        enc_params = self._enc_params_validation(enc_params)
        inputs, params = self._assimilate_batch(inputs, params)

        meas_type, obs = self._build_obs()
        run_kwargs = dict(gate_mode=gate_mode)
        B = int(np.prod(self.eff_batch_shape))

        if B > 1:
            axes = tuple(0 if b > 1 else None for b in self.batch_shape)
            result = self.script.execute(
                type=meas_type,
                obs=obs,
                args=(params, inputs, enc_params),
                kwargs=run_kwargs,
                in_axes=(axes[1], axes[0], None),
            )
        else:
            result = self.script.execute(
                type=meas_type, obs=obs, kwargs=run_kwargs,
                args=(params, inputs, enc_params),
            )
        return self._shape_result(result, force_mean)

    def _shape_result(self, result: torch.Tensor, force_mean: bool) -> torch.Tensor:
        """Post-process raw executor output into the documented shape."""
        if not self.all_qubit_measurement and self.execution_type == "probs":
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
