"""Fourier analysis of QML models.

Four components:

* :class:`Coefficients` — numerical spectrum: one batched model call on a
  uniform input grid (on the model's device, through the executors and
  kernels every forward takes), then ``torch.fft.fftn`` there.
* :class:`FourierTree` — analytic coefficients after Nemkov et al.
  (PhysRevA.108.032406).  Every expansion path is *square-free* (each
  rotation contributes at most one sine or cosine factor): leaves are
  stored as boolean sin/cos **bitmasks** with a complex amplitude, expanded
  by an explicit work-stack walk (or the native enumerator of
  :mod:`qml_essentials_tpu_torch.native`), and the input-frequency structure
  comes from convolving two-term waves ``cos(wx) -> {+w: 1/2, -w: 1/2}``,
  ``i sin(wx) -> {+w: 1/2, -w: -1/2}`` per active encoding column.
  Symbolic structure is exact host numpy; parameter-dependent factors are
  torch on the model's device (differentiable).
* :class:`FCC` — Fourier-coefficient-correlation fingerprints
  (arXiv:2508.20868).  All four correlation flavours share one masked
  pairwise-moment function, so NaN tolerance is implemented once.
* :class:`Datasets` — random model-compatible Fourier-series targets.

Coefficients are torch tensors on the model's device; frequencies are host
numpy arrays.  Random draws come from ``torch.Generator`` objects.

Counterpart of ``qml_essentials_tpu/analysis/coefficients.py``.
"""

from __future__ import annotations

import logging
import math
import sys
import warnings
from collections import defaultdict
from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from scipy.stats import rankdata

from qml_essentials_tpu_torch import native
from qml_essentials_tpu_torch.analysis.pauli import PauliCircuit
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops.dtypes import cdtype
from qml_essentials_tpu_torch.ops.operations import PauliWord
from qml_essentials_tpu_torch.utils import safe_random_split

log = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# =========================================================================
# Numerical spectrum (FFT over an input grid)
# =========================================================================


class Coefficients:
    """Numerical Fourier coefficients of a model via FFT over an input grid."""

    @classmethod
    def get_spectrum(
        cls,
        model: Model,
        mfs: int = 1,
        mts: int = 1,
        shift: bool = False,
        trim: bool = False,
        numerical_cap: Optional[float] = -1,
        **kwargs,
    ) -> Tuple[torch.Tensor, Union[np.ndarray, List[np.ndarray]]]:
        """FFT-extracted coefficients and frequencies of the model.

        Args:
            model: The model to sample.
            mfs: Frequency-domain oversampling multiplier.
            mts: Time-domain oversampling multiplier.
            shift: Apply fftshift to centre the spectrum.
            trim: Remove the Nyquist row from even-length axes.
            numerical_cap: Zero out coefficients below this magnitude (for a
                single feature, frequencies that vanish entirely are dropped).
        """
        kwargs.setdefault("force_mean", True)
        kwargs.setdefault("execution_type", "expval")
        d = model.n_input_feat

        coeffs, freqs = cls._fourier_transform(model, mfs, mts, **kwargs)

        imag_leak = float(coeffs.detach().sum().imag)
        # Real models must have conjugate-symmetric spectra; the leak budget
        # scales with the model's precision (f32 accumulates ~1e-6 over the grid).
        leak_atol = 1.0e-6 if model.dtype == torch.float64 else 1.0e-4
        if not abs(imag_leak) <= leak_atol:
            raise ValueError(
                f"Spectrum is not real. Imaginary part of coefficients is: "
                f"{imag_leak}"
            )

        if trim:
            for ax in range(d):
                if coeffs.shape[ax] % 2 == 0:
                    nyq = coeffs.shape[ax] // 2
                    rest = [i for i in range(coeffs.shape[ax]) if i != nyq]
                    coeffs = coeffs.index_select(ax, torch.tensor(rest, device=coeffs.device))
                    freqs = [np.delete(f, len(f) // 2, axis=0) for f in freqs]

        if shift:
            coeffs = torch.fft.fftshift(coeffs, dim=tuple(range(d)))
            freqs = np.fft.fftshift(freqs)

        if numerical_cap is not None and numerical_cap > 0:
            keep = coeffs.abs() >= numerical_cap
            coeffs = torch.where(keep, coeffs, torch.zeros_like(coeffs))
            if d == 1:
                alive = (
                    coeffs != 0
                    if coeffs.ndim == 1
                    else torch.any(coeffs != 0, dim=tuple(range(1, coeffs.ndim)))
                )
                coeffs = coeffs[alive]
                freqs = [freqs[0][_host(alive)]]

        return coeffs, (freqs[0] if len(freqs) == 1 else freqs)

    @classmethod
    def _fourier_transform(
        cls, model: Model, mfs: int, mts: int, **kwargs: Any
    ) -> Tuple[torch.Tensor, list]:
        """Evaluate the model on a uniform grid and FFT the outputs."""
        d = model.n_input_feat
        axes_pts = [mfs * model.degree[i] for i in range(d)]
        axes = [np.arange(0, 2 * mts * np.pi, 2 * np.pi / pts) for pts in axes_pts]
        grid = np.array(np.meshgrid(*axes)).T.reshape(-1, d)

        out = model(inputs=torch.as_tensor(grid, dtype=model.dtype), **kwargs)
        out = out.reshape(*[len(a) for a in axes], -1).squeeze()

        coeffs = torch.fft.fftn(out, dim=tuple(range(d)))
        norm = math.prod(out.shape[:d])
        freqs = [np.fft.fftfreq(mts * axes_pts[i], 1 / axes_pts[i]) for i in range(d)]
        return coeffs / norm, freqs

    @classmethod
    def get_psd(cls, coeffs: torch.Tensor) -> torch.Tensor:
        """Power spectral density of the coefficients."""
        coeffs = torch.as_tensor(coeffs)
        power = coeffs.real**2 + (coeffs.imag**2 if coeffs.is_complex() else 0.0)
        return (2.0 / len(coeffs) ** 2) * power

    @classmethod
    def evaluate_Fourier_series(
        cls,
        coefficients: torch.Tensor,
        frequencies,
        inputs: Union[torch.Tensor, np.ndarray, list, float],
    ) -> torch.Tensor:
        """Evaluate ``sum_w c_w exp(i w · x)`` at one or more input points,
        on the coefficients' device and in their precision."""
        coefficients = torch.as_tensor(coefficients)
        if not coefficients.is_complex():
            coefficients = coefficients.to(cdtype(coefficients.dtype))
        flat_c, flat_w = cls._flatten_spectrum(coefficients, frequencies)
        rdt, dev = coefficients.real.dtype, coefficients.device
        flat_w = flat_w.to(device=dev, dtype=rdt)

        inputs = torch.as_tensor(_host(inputs), dtype=rdt, device=dev)
        d = flat_w.shape[1]
        if inputs.ndim == 0:
            inputs = inputs.reshape(1, 1)
        elif inputs.ndim == 1:
            if d == 1:
                inputs = inputs[:, None]
            elif inputs.shape[0] == d:
                inputs = inputs[None, :]
            else:
                inputs = inputs[:, None].repeat(1, d)

        phases = torch.exp(1j * (inputs @ flat_w.T))
        series = torch.tensordot(phases, flat_c, dims=([1], [0]))
        return torch.squeeze(series.real)

    @staticmethod
    def _flatten_spectrum(coefficients: torch.Tensor, frequencies):
        """Normalise (coeffs, freqs) to a flat (n, ...) / (n, d) pair.

        Accepts per-axis frequency lists, a 1-D array, a (d, n_axis) array of
        axis frequencies matching a grid of coefficients, or an already-flat
        (n, d) array.
        """

        def from_axes(axis_freqs):
            axis_freqs = [torch.as_tensor(_host(f)) for f in axis_freqs]
            mesh = torch.stack(torch.meshgrid(*axis_freqs, indexing="ij"), dim=-1)
            flat_w = mesh.reshape(-1, len(axis_freqs))
            flat_c = coefficients.reshape(
                flat_w.shape[0], *coefficients.shape[len(axis_freqs):]
            )
            return flat_c, flat_w

        if isinstance(frequencies, list):
            return from_axes(frequencies)
        frequencies = torch.as_tensor(_host(frequencies))
        if frequencies.ndim == 1:
            flat_w = frequencies[:, None]
            return (
                coefficients.reshape(flat_w.shape[0], *coefficients.shape[1:]),
                flat_w,
            )
        d, per_axis = frequencies.shape
        if tuple(coefficients.shape[:d]) == (per_axis,) * d:
            return from_axes(list(frequencies))
        return (
            coefficients.reshape(frequencies.shape[0], *coefficients.shape[1:]),
            frequencies,
        )


# =========================================================================
# Analytic spectrum (Nemkov-style sine-cosine expansion)
# =========================================================================


class _LeafTable(NamedTuple):
    """Square-free expansion of one observable root.

    Each row is one leaf of the sine-cosine expansion: boolean masks over
    the canonical rotations marking which contribute a sine / cosine
    factor, and the complex amplitude ``<0|P|0>`` of the surviving Pauli
    word.  ``i ** popcount(sin_mask[leaf])`` folds the imaginary units of
    the ``(i sin)`` factors.
    """

    sin_mask: np.ndarray  # (n_leaves, n_rot) bool
    cos_mask: np.ndarray  # (n_leaves, n_rot) bool
    amp: np.ndarray  # (n_leaves,) complex128


class FourierTree:
    """Analytic Fourier coefficients of a model (Nemkov et al.).

    Usage::

        tree = FourierTree(model)
        exp = tree()                          # expectation value
        coeff_list, freq_list = tree.get_spectrum()
    """

    def __init__(self, model: Model):
        self.model = model
        self.n_qubits = model.n_qubits

        self._params = self._debatch(model.params)

        # Pauli-Clifford normal form at a fixed probe input.  The probe only
        # fixes angles; which Pauli words appear is input-independent.
        probe = np.ones(model.n_input_feat)
        rotations, observables = self._canonical_form(self._params, probe)

        self.parameters = [_squeeze(p) for p in PauliCircuit.get_parameters(rotations)]
        self.n_params = len(self.parameters)
        self.rotation_words = [
            PauliWord.from_operation(r, self.n_qubits) for r in rotations
        ]
        self.observable_words = [
            PauliWord.from_operation(o, self.n_qubits) for o in observables
        ]

        # Light cone: prefix-cumulative X/Y support of the rotations.
        self._cone = np.zeros((self.n_params, self.n_qubits), dtype=bool)
        acc = np.zeros(self.n_qubits, dtype=bool)
        for i, w in enumerate(self.rotation_words):
            acc |= w.xy_mask
            self._cone[i] = acc

        self._locate_encodings(probe)
        self._tables: Optional[List[_LeafTable]] = None
        self._waves: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None

    # ----------------------------------------------------------- canonical
    @staticmethod
    def _debatch(params) -> torch.Tensor:
        params = torch.as_tensor(params)
        if params.ndim > 2 and params.shape[0] > 1:
            warnings.warn(
                f"FourierTree describes one parameter set; dropping "
                f"{params.shape[0] - 1} extra batch entries.",
                UserWarning,
            )
        return params[0] if params.ndim > 2 else params

    def _canonical_form(self, params, inputs):
        """Record the circuit and commute Cliffords into the observables."""
        inputs = self.model._inputs_validation(inputs)
        tape = self.model.script._record(
            params=self._debatch(params), inputs=inputs
        )
        _, obs = self.model._build_obs()
        return PauliCircuit.from_parameterised_circuit(
            tape, observables=obs, n_qubits=self.n_qubits
        )

    def _angles_at(self, inputs) -> np.ndarray:
        """Concrete canonical rotation angles for the given inputs."""
        rotations, _ = self._canonical_form(self._params, inputs)
        return np.array([_value(p) for p in PauliCircuit.get_parameters(rotations)])

    def _locate_encodings(self, probe: np.ndarray) -> None:
        """Identify encoding columns by probing each feature.

        Canonical angles are affine in the inputs (encodings are linear and
        Clifford commutation can only flip signs), so the angle difference
        under a unit step of feature *f* is exactly that column's integer
        frequency scaling.
        """
        tol = 1e-6
        d = self.model.n_input_feat
        theta0 = np.array([_value(p) for p in self.parameters])
        slopes = np.stack(
            [
                self._angles_at(probe + np.eye(d)[f]) - theta0
                for f in range(d)
            ]
        )

        self.input_indices: Dict[int, list] = defaultdict(list)
        self.all_input_indices: List[int] = []
        self.input_scaling = np.ones(self.n_params, dtype=np.int64)
        for col in range(self.n_params):
            hot = np.flatnonzero(np.abs(slopes[:, col]) > tol)
            if hot.size == 0:
                continue
            if hot.size > 1:
                raise NotImplementedError(
                    f"Rotation {col} mixes input features {hot.tolist()}; "
                    "each encoding rotation must be linear in one feature."
                )
            f = int(hot[0])
            slope = float(slopes[f, col])
            w = int(round(slope))
            if abs(slope - w) > tol:
                warnings.warn(
                    f"Rounding non-integer input scaling {slope:.4f} on "
                    f"rotation {col} (feature {f}) to {w}; only integer "
                    "frequency scalings are representable.",
                    UserWarning,
                )
            self.input_indices[f].append(col)
            self.all_input_indices.append(col)
            self.input_scaling[col] = w

        inset = set(self.all_input_indices)
        self.var_positions = np.array(
            sorted(set(range(self.n_params)) - inset), dtype=np.int64
        )
        self.features = sorted(self.input_indices)

    # -------------------------------------------------------------- tables
    def _leaf_tables(self) -> List[_LeafTable]:
        if self._tables is None:
            self._tables = [
                self._expand_root(obs) for obs in self.observable_words
            ]
        return self._tables

    def _expand_root(self, root: PauliWord) -> _LeafTable:
        """Expand one observable through the rotations (iterative walk).

        Work items are ``(pauli_idx, observable, sin_mask, cos_mask)``; the
        native C++ enumerator is used when loadable (same contract, count
        matrices reinterpreted as masks — paths are square-free).
        """
        n = self.n_params
        got = native.enumerate_leaves(self.rotation_words, root, self.n_qubits)
        if got is not None:
            S, C, amp = got
            return _LeafTable(
                np.asarray(S, dtype=bool), np.asarray(C, dtype=bool), amp
            )

        sin_rows: List[np.ndarray] = []
        cos_rows: List[np.ndarray] = []
        amps: List[complex] = []
        empty = np.zeros(n, dtype=bool)
        stack = [(n - 1, root, empty, empty)]

        while stack:
            idx, obs, smask, cmask = stack.pop()

            # Light-cone prune: an X/Y of the observable that no remaining
            # rotation can touch makes <0|...|0> vanish on every leaf below.
            if idx >= 0 and (obs.xy_mask & ~self._cone[idx]).any():
                continue

            # Skip commuting rotations.
            while idx >= 0 and obs.commutes_with(self.rotation_words[idx]):
                idx -= 1

            if idx < 0:
                a = obs.zero_expectation()
                if a != 0:
                    sin_rows.append(smask)
                    cos_rows.append(cmask)
                    amps.append(a)
                continue

            word = self.rotation_words[idx]
            cos_branch = cmask.copy()
            cos_branch[idx] = True
            sin_branch = smask.copy()
            sin_branch[idx] = True
            stack.append((idx - 1, obs, smask, cos_branch))
            stack.append((idx - 1, word.compose(obs), sin_branch, cmask))

        if not amps:
            z = np.zeros((0, n), dtype=bool)
            return _LeafTable(z, z.copy(), np.zeros(0, dtype=np.complex128))
        return _LeafTable(
            np.stack(sin_rows), np.stack(cos_rows), np.array(amps)
        )

    def _wave_tables(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per root: (freqs, W) with ``coeffs = W @ (amp · var_factors)``.

        Built by convolving, per leaf, the two-term waves of its active
        encoding columns: ``cos(w x_f) -> ±w @ 1/2, 1/2`` and
        ``i sin(w x_f) -> ±w @ 1/2, -1/2`` on feature axis *f*.  Weights
        are dyadic rationals times powers of i — exact in complex128, so
        downstream zero tests are exact too.
        """
        if self._waves is not None:
            return self._waves

        d = len(self.features)
        axis_of = {f: a for a, f in enumerate(self.features)}
        col_feature = {}
        for f, cols in self.input_indices.items():
            for c in cols:
                col_feature[c] = f

        self._waves = []
        for table in self._leaf_tables():
            n_leaves = table.amp.shape[0]
            bucket: Dict[tuple, np.ndarray] = defaultdict(
                lambda: np.zeros(n_leaves, dtype=np.complex128)
            )
            zero = (0,) * max(d, 1)
            for leaf in range(n_leaves):
                wave: Dict[tuple, complex] = {zero: 1.0}
                for col in self.all_input_indices:
                    s = bool(table.sin_mask[leaf, col])
                    c = bool(table.cos_mask[leaf, col])
                    if not (s or c):
                        continue
                    ax = axis_of[col_feature[col]]
                    w = int(self.input_scaling[col])
                    lo_w = 0.5 if c else -0.5  # i·sin flips the -w term
                    nxt: Dict[tuple, complex] = defaultdict(complex)
                    for omega, amp in wave.items():
                        up = list(omega)
                        up[ax] += w
                        nxt[tuple(up)] += amp * 0.5
                        dn = list(omega)
                        dn[ax] -= w
                        nxt[tuple(dn)] += amp * lo_w
                    wave = nxt
                for omega, amp in wave.items():
                    if amp != 0:
                        bucket[omega][leaf] += amp

            if bucket:
                omegas = sorted(bucket)
                W = np.stack([bucket[o] for o in omegas])
                freqs = np.array(omegas, dtype=np.int64)
            else:
                freqs = np.zeros((1, max(d, 1)), dtype=np.int64)
                W = np.zeros((1, n_leaves), dtype=np.complex128)
            if freqs.shape[1] == 1:
                freqs = freqs[:, 0]
            self._waves.append((freqs, W))
        return self._waves

    # ---------------------------------------------------------- evaluation
    def _angle(self, p) -> torch.Tensor:
        """One canonical angle as a tensor in the model's dtype and device
        (decompositions leave Python floats, e.g. CRY's ±pi/2)."""
        return torch.as_tensor(p).to(device=self.model.device, dtype=self.model.dtype)

    def _mask_products(self, table: _LeafTable, columns: np.ndarray) -> torch.Tensor:
        """Per-leaf ``prod cos(θ) · prod (i sin(θ))`` over *columns*."""
        cd = cdtype(self.model.dtype)
        dev = self.model.device
        n_leaves = table.amp.shape[0]
        if n_leaves == 0:
            return torch.zeros(0, dtype=cd, device=dev)
        if columns.size == 0:
            return torch.ones(n_leaves, dtype=cd, device=dev)

        theta = torch.stack([self._angle(self.parameters[c]) for c in columns])
        S = torch.as_tensor(table.sin_mask[:, columns], device=dev)
        C = torch.as_tensor(table.cos_mask[:, columns], device=dev)
        one = torch.ones((), dtype=theta.dtype, device=dev)
        cosf = torch.where(C, torch.cos(theta)[None, :], one)
        sinf = torch.where(S, torch.sin(theta)[None, :], one)
        real = torch.prod(cosf * sinf, dim=1)

        n_sin = np.asarray(table.sin_mask[:, columns]).sum(axis=1)
        i_pow = np.array([1, 1j, -1, -1j], dtype=np.complex128)[n_sin % 4]
        return real.to(cd) * torch.as_tensor(i_pow, dtype=cd, device=dev)

    def _amp(self, table: _LeafTable) -> torch.Tensor:
        return torch.as_tensor(table.amp, dtype=cdtype(self.model.dtype),
                               device=self.model.device)

    def __call__(
        self,
        params: Optional[torch.Tensor] = None,
        inputs: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> torch.Tensor:
        """Expectation value(s) via the expansion (matches the circuit)."""
        if kwargs.get("execution_type", "expval") != "expval":
            raise NotImplementedError(
                f'Currently, only "expval" execution type is supported when '
                f"building FourierTree. Got {kwargs.get('execution_type', 'expval')}."
            )
        if kwargs.get("noise_params") is not None:
            raise NotImplementedError(
                "Currently, noise is not supported when building FourierTree."
            )

        params = (
            self.model._params_validation(params)
            if params is not None
            else self.model.params
        )
        inputs = self.model._inputs_validation(
            inputs if inputs is not None else 1.0
        )

        rotations, _ = self._canonical_form(params, inputs)
        self.parameters = [_squeeze(p) for p in PauliCircuit.get_parameters(rotations)]

        every = np.arange(self.n_params, dtype=np.int64)
        vals = torch.stack(
            [
                torch.sum(self._amp(t) * self._mask_products(t, every)).real
                for t in self._leaf_tables()
            ]
        )
        return vals.mean() if kwargs.get("force_mean", False) else vals

    def get_spectrum(
        self, force_mean: bool = False
    ) -> Tuple[List[torch.Tensor], List[np.ndarray]]:
        """Analytic coefficients and frequencies, one entry per root."""
        coeff_list: List[torch.Tensor] = []
        freq_list: List[np.ndarray] = []
        for table, (freqs, W) in zip(self._leaf_tables(), self._wave_tables()):
            leaf_val = self._amp(table) * self._mask_products(table, self.var_positions)
            W = torch.as_tensor(W, dtype=leaf_val.dtype, device=leaf_val.device)
            coeff_list.append(W @ leaf_val)
            freq_list.append(freqs)
        if force_mean:
            return self._average_roots(coeff_list, freq_list)
        return coeff_list, freq_list

    @staticmethod
    def _average_roots(coeff_list, freq_list):
        """Average the per-root spectra over the union of their supports."""
        total: Dict[tuple, complex] = defaultdict(complex)
        for coeffs, freqs in zip(coeff_list, freq_list):
            fa = np.atleast_1d(np.asarray(freqs))
            for j in range(fa.shape[0]):
                key = tuple(np.atleast_1d(fa[j]).astype(int).tolist())
                total[key] += complex(coeffs[j])
        n = max(len(coeff_list), 1)
        keys = sorted(total)
        like = coeff_list[0]
        mean = torch.tensor([total[k] / n for k in keys], dtype=like.dtype, device=like.device)
        farr = np.array(keys, dtype=np.int64)
        if farr.shape[1] == 1:
            farr = farr[:, 0]
        return [mean], [farr]

    # ------------------------------------------------------------- support
    def get_exact_support(self, method: str = "tree") -> List[np.ndarray]:
        """Exact symbolic frequency support (no parameter sampling).

        ``"tree"`` groups leaves by their variational mask signature and
        tests the exact dyadic group sums (fully exact, detects cross-path
        cancellation).  ``"dp"`` merges states on (rotation, observable)
        and unions expansion supports — scales to deep circuits, single
        feature, no cancellation detection (a tight superset).
        """
        if method == "dp":
            return self._support_by_dp()
        if method != "tree":
            raise ValueError(f"Unknown method '{method}'. Use 'tree' or 'dp'.")

        out = []
        for table, (freqs, W) in zip(self._leaf_tables(), self._wave_tables()):
            freqs = np.asarray(freqs)
            if table.amp.shape[0] == 0:
                out.append(freqs[:0])
                continue
            sig = np.hstack(
                [
                    table.sin_mask[:, self.var_positions],
                    table.cos_mask[:, self.var_positions],
                ]
            )
            _, gid = np.unique(sig, axis=0, return_inverse=True)
            gid = np.asarray(gid).reshape(-1)
            per_leaf = (W * table.amp[None, :]).T  # (n_leaves, n_freq)
            sums = np.zeros((gid.max() + 1, W.shape[0]), dtype=np.complex128)
            np.add.at(sums, gid, per_leaf)
            out.append(freqs[(np.abs(sums) > 1e-12).any(axis=0)])
        return out

    def _support_by_dp(self) -> List[np.ndarray]:
        """Bitmask DP over merged (rotation index, observable) states.

        Each state's value is a bitset over aggregate (n_sin, n_cos) input
        counts; the reachable counts' expansion supports are unioned.
        Implemented as memoised recursion over integer-packed Pauli words.
        """
        if len(self.features) != 1:
            raise NotImplementedError(
                "The 'dp' support method handles exactly one input feature; "
                "use method='tree' for multi-feature models."
            )
        if self.all_input_indices and np.any(
            self.input_scaling[self.all_input_indices] != 1
        ):
            raise NotImplementedError(
                "The 'dp' support method aggregates sin/cos counts and so "
                "cannot represent per-gate frequency scalings; use "
                "method='tree'."
            )

        rot = [(w.xm, w.zm) for w in self.rotation_words]
        cone_bits = []
        acc = 0
        for x, _ in rot:
            acc |= x
            cone_bits.append(acc)

        is_enc = np.zeros(self.n_params, dtype=bool)
        is_enc[self.all_input_indices] = True
        stride = int(is_enc.sum()) + 1  # bit (s, c) lives at s*stride + c

        def odd_bits(v: int) -> int:
            return bin(v).count("1") & 1

        def solve(idx: int, xo: int, zo: int, memo: dict) -> int:
            if idx >= 0 and (xo & ~cone_bits[idx]):
                return 0
            while idx >= 0:
                xr, zr = rot[idx]
                if odd_bits(xo & zr) ^ odd_bits(zo & xr):
                    break
                idx -= 1
            else:
                return 1 if xo == 0 else 0
            key = (idx, xo, zo)
            if key in memo:
                return memo[key]
            xr, zr = rot[idx]
            via_cos = solve(idx - 1, xo, zo, memo)
            via_sin = solve(idx - 1, xo ^ xr, zo ^ zr, memo)
            if is_enc[idx]:
                val = (via_cos << 1) | (via_sin << stride)
            else:
                val = via_cos | via_sin
            memo[key] = val
            return val

        limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(limit, self.n_params + 1000))
        try:
            supports = []
            for obs in self.observable_words:
                reached = solve(self.n_params - 1, obs.xm, obs.zm, {})
                freqs: set = set()
                while reached:
                    low = reached & -reached
                    bit = low.bit_length() - 1
                    freqs |= _trig_power_support(bit // stride, bit % stride)
                    reached ^= low
                supports.append(np.array(sorted(freqs), dtype=np.int64))
        finally:
            sys.setrecursionlimit(limit)
        return supports


def _squeeze(p):
    """A canonical angle as recorded: a 0-d tensor, or a Python float."""
    return p.squeeze() if isinstance(p, torch.Tensor) else p


def _value(p) -> float:
    """A canonical angle's value on the host."""
    return float(p.detach()) if isinstance(p, torch.Tensor) else float(p)


@lru_cache(maxsize=None)
def _trig_power_support(s: int, c: int) -> frozenset:
    """Non-vanishing frequencies of ``cos^c(x) (i sin x)^s``.

    Exact integer polynomial arithmetic: with ``t = e^{2ix}`` the product is
    ``e^{-i(s+c)x} (t-1)^s (t+1)^c / 2^{s+c}``; surviving exponents are the
    non-zero coefficients of that polynomial.
    """
    poly = np.array([1], dtype=object)
    for _ in range(s):
        poly = np.convolve(poly, np.array([-1, 1], dtype=object))
    for _ in range(c):
        poly = np.convolve(poly, np.array([1, 1], dtype=object))
    m = s + c
    return frozenset(2 * k - m for k, a in enumerate(poly) if a != 0)


# =========================================================================
# Fourier-coefficient correlation (FCC)
# =========================================================================


def _masked_moments(mat: torch.Tensor):
    """Pairwise column moments of *mat*, ignoring non-finite entries.

    Returns ``(nobs, sx, sy, sxy, sxx, syy)`` where for each column pair
    (i, j) the sums run over rows finite in *both* columns: ``sx = Σ x̄``,
    ``sxy = Σ x̄y`` (conjugated left factor), ``sxx = Σ|x|²``.  Every FCC
    correlation flavour is a closed form over these six matrices, so NaN
    handling lives in exactly one place.
    """
    mat = torch.as_tensor(mat)
    finite = torch.isfinite(mat)
    w = finite.to(mat.real.dtype if mat.is_complex() else mat.dtype)
    x = torch.where(finite, mat, torch.zeros_like(mat))
    wx = w.to(x.dtype)

    nobs = w.T @ w
    sx = x.conj().T @ wx
    sy = wx.T @ x
    sxy = x.conj().T @ x
    a2 = x.abs() ** 2
    sxx = a2.T @ w
    syy = w.T @ a2
    return nobs, sx, sy, sxy, sxx, syy


def _nan_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, float("nan"))


class FCC:
    """Fourier-coefficient-correlation fingerprints (arXiv:2508.20868)."""

    # ------------------------------------------------------------ sampling
    @classmethod
    def _calculate_coefficients(
        cls,
        model: Model,
        n_samples: int,
        random_key: Optional[torch.Generator] = None,
        scale: bool = False,
        **kwargs: Any,
    ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Sampled (params, coefficients, frequencies) for the fingerprint."""
        if n_samples > 0:
            total = (
                int(2**model.n_qubits * n_samples * model.n_input_feat)
                if scale
                else n_samples
            )
            if scale:
                log.info(f"Using {total} samples.")
            model.initialize_params(random_key, repeat=total)
        coeffs, freqs = Coefficients.get_spectrum(
            model, shift=True, trim=True, **kwargs
        )
        return model.params, coeffs, freqs

    # --------------------------------------------------------- fingerprint
    @classmethod
    def get_fourier_fingerprint(
        cls,
        model: Model,
        n_samples: int,
        random_key: Optional[torch.Generator] = None,
        method: Optional[str] = "pearson",
        scale: Optional[bool] = False,
        weight: Optional[bool] = False,
        trim_redundant: Optional[bool] = True,
        nan_to_one: Optional[bool] = False,
        **kwargs: Any,
    ) -> Tuple[torch.Tensor, Any]:
        """Correlation matrix of sampled coefficients + frequency labels."""
        _, coeffs, freqs = cls._calculate_coefficients(
            model, n_samples, random_key, scale, **kwargs
        )

        if trim_redundant and not weight:
            # Drop negative frequencies *before* correlating (cheaper).
            keep = cls._nonneg_indices(freqs)
            labels = cls._flat_frequencies(freqs)[keep]
            sub = coeffs.reshape(-1, coeffs.shape[-1])[torch.as_tensor(keep)]
            fp = cls._correlate(sub.T, method=method)
            if nan_to_one:
                fp = torch.where(torch.isnan(fp), torch.ones_like(fp), fp)
            return cls._lower_triangle(fp, labels)

        fp = cls._correlate(coeffs.T, method=method)
        if nan_to_one:
            fp = torch.where(torch.isnan(fp), torch.ones_like(fp), fp)
        if weight:
            fp = cls._weighting_mean(fp, coeffs)
        if trim_redundant:
            keep = cls._nonneg_indices(freqs)
            labels = cls._flat_frequencies(freqs)[keep]
            k = torch.as_tensor(keep, device=fp.device)
            return cls._lower_triangle(fp[k][:, k], labels)
        return fp, freqs

    @staticmethod
    def _lower_triangle(fp: torch.Tensor, labels: np.ndarray):
        """Keep the strict lower triangle; drop all-NaN rows/columns."""
        M = fp.shape[0]
        tri = torch.ones((M, M), dtype=torch.bool, device=fp.device).tril(diagonal=-1)
        fp = torch.where(tri, fp, _nan_like(fp))
        rows = torch.any(torch.isfinite(fp), dim=1)
        cols = torch.any(torch.isfinite(fp), dim=0)
        return fp[rows][:, cols], (labels[_host(rows)], labels[_host(cols)])

    @classmethod
    def get_fcc(
        cls,
        model: Model,
        n_samples: int,
        random_key: Optional[torch.Generator] = None,
        method: Optional[str] = "pearson",
        scale: Optional[bool] = False,
        weight: Optional[bool] = False,
        trim_redundant: Optional[bool] = True,
        **kwargs,
    ) -> torch.Tensor:
        """Average |correlation| of sampled Fourier coefficients (the FCC)."""
        fp, _ = cls.get_fourier_fingerprint(
            model,
            n_samples,
            random_key,
            method,
            scale,
            weight,
            trim_redundant=trim_redundant,
            **kwargs,
        )
        return cls.calculate_fcc(fp)

    @classmethod
    def calculate_fcc(cls, fourier_fingerprint: torch.Tensor) -> torch.Tensor:
        """FCC of an existing fingerprint: mean absolute finite entry."""
        return torch.nanmean(torch.as_tensor(fourier_fingerprint).abs())

    # ------------------------------------------------------------ plumbing
    @classmethod
    def _nonneg_indices(cls, freqs) -> np.ndarray:
        """Flat (C-order) indices whose frequency is >= 0 on every axis."""
        fa = np.asarray(freqs)
        if fa.ndim == 1:
            return np.where(fa >= 0)[0]
        axes = [fa[i] >= 0 for i in range(fa.shape[0])]
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)
        return np.where(np.all(grid, axis=0).ravel())[0]

    @classmethod
    def _flat_frequencies(cls, freqs) -> np.ndarray:
        """Per-coefficient frequency labels in the same C order."""
        fa = np.asarray(freqs)
        if fa.ndim == 1:
            return fa
        mesh = np.meshgrid(*[fa[i] for i in range(fa.shape[0])], indexing="ij")
        return np.stack(mesh, axis=-1).reshape(-1, fa.shape[0])

    # -------------------------------------------------------- correlations
    @classmethod
    def _correlate(cls, mat: torch.Tensor, method: str = "pearson") -> torch.Tensor:
        """Correlate flattened coefficient axes with the chosen method."""
        if mat.ndim < 2:
            raise ValueError("Input matrix must have at least 2 dimensions")
        flat = mat.reshape(mat.shape[0], -1)
        impl = {
            "pearson": cls._pearson,
            "complex_pearson": cls._complex_pearson,
            "spearman": cls._spearman,
            "covariance": cls._covariance,
        }.get(method)
        if impl is None:
            raise ValueError(
                f"Unknown correlation method: {method}. Must be 'pearson', "
                "'complex_pearson', 'spearman' or 'covariance'."
            )
        return impl(flat)

    @classmethod
    def _covariance(cls, mat: torch.Tensor, minp: int = 1) -> torch.Tensor:
        """NaN-tolerant Hermitian sample covariance between columns."""
        nobs, sx, sy, sxy, _, _ = _masked_moments(mat)
        n = torch.where(nobs > 0, nobs, torch.ones_like(nobs))
        centered = sxy - sx * sy / n
        cov = centered / torch.where(nobs > 1, nobs - 1, _nan_like(nobs))
        return torch.where(nobs < minp, _nan_like(cov), cov)

    @classmethod
    def _complex_pearson(cls, mat: torch.Tensor, minp: int = 1) -> torch.Tensor:
        """NaN-tolerant complex Pearson correlation (Hermitian normalised)."""
        nobs, sx, sy, sxy, sxx, syy = _masked_moments(mat)
        n = torch.where(nobs > 0, nobs, torch.ones_like(nobs))
        cxy = sxy - sx * sy / n
        vx = sxx - sx.abs() ** 2 / n
        vy = syy - sy.abs() ** 2 / n
        scale = torch.sqrt(vx * vy)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        r = torch.where(scale > 0, cxy / safe, _nan_like(cxy))
        mag = r.abs()
        r = torch.where(mag > 1.0, r / mag, r)
        return torch.where(nobs < minp, _nan_like(r), r)

    @classmethod
    def _pearson(cls, mat: torch.Tensor, minp: int = 1) -> torch.Tensor:
        """NaN-tolerant Pearson correlation (complex split into re/im rows)."""
        mat = torch.as_tensor(mat)
        if mat.is_complex():
            mat = torch.cat([mat.real, mat.imag], dim=0)
        cov = cls._covariance(mat, minp=minp)
        sd = torch.sqrt(torch.diagonal(cov))
        scale = sd[:, None] * sd[None, :]
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        r = torch.where(scale > 0, cov / safe, _nan_like(cov))
        return torch.clamp(r.real if r.is_complex() else r, -1.0, 1.0)

    @classmethod
    def _spearman(cls, mat: torch.Tensor, minp: int = 1) -> torch.Tensor:
        """NaN-tolerant Spearman correlation: rank-transform (host scipy),
        then Pearson on the original device."""
        mat = torch.as_tensor(mat)
        if mat.is_complex():
            mat = torch.cat([mat.real, mat.imag], dim=0)
        host = _host(mat)
        N, K = host.shape
        if N < minp:
            return torch.full((K, K), float("nan"), dtype=mat.dtype, device=mat.device)
        ranks = np.full((N, K), np.nan)
        for j in range(K):
            ok = np.isfinite(host[:, j])
            if ok.any():
                ranks[ok, j] = rankdata(host[ok, j], method="average")
        return cls._pearson(torch.as_tensor(ranks, device=mat.device), minp=minp)

    # ----------------------------------------------------------- weighting
    @classmethod
    def _weighting_linear(cls, fourier_fingerprint: torch.Tensor) -> torch.Tensor:
        """Triangular ("tent") frequency weighting peaking at DC."""
        M, K = fourier_fingerprint.shape
        if not (M % 2 and K % 2):
            raise ValueError(
                "Correlation matrix must have odd dimensions. "
                "Hint: use `trim` argument when calling `get_spectrum`."
            )
        if M != K:
            raise ValueError("Correlation matrix must be square.")
        mid = M // 2
        idx = torch.arange(M, device=fourier_fingerprint.device)
        tent = (mid - (idx - mid).abs()) / (2 * mid)
        return fourier_fingerprint * (tent[:, None] + tent[None, :])

    @classmethod
    def _weighting_mean(
        cls, fourier_fingerprint: torch.Tensor, coeffs: torch.Tensor
    ) -> torch.Tensor:
        """Rank-1 weighting by mean coefficient magnitudes."""
        if fourier_fingerprint.shape[0] != fourier_fingerprint.shape[1]:
            raise ValueError("Correlation matrix must be square.")
        if coeffs.ndim < 2:
            raise ValueError(
                "Coefficient matrix must contain coefficient axes and a sample axis."
            )
        mags = coeffs.mean(dim=-1).abs().T.reshape(-1)
        if fourier_fingerprint.shape[0] != mags.shape[0]:
            raise ValueError(
                "Correlation matrix size must match the number of Fourier coefficients."
            )
        return fourier_fingerprint * mags[:, None] * mags[None, :]


# =========================================================================
# Datasets
# =========================================================================


class Datasets:
    """Model-compatible random Fourier-series targets."""

    @classmethod
    def generate_fourier_series(
        cls,
        random_key: Optional[torch.Generator],
        model: Model,
        coefficients_min: float = 0.0,
        coefficients_max: float = 1.0,
        zero_centered: bool = False,
    ):
        """Random Fourier series over the model's frequency spectrum.

        Coefficients are drawn uniformly from a complex annulus with
        conjugate symmetry enforced, so the series is real.  Returns
        ``[domain_samples, values, coefficients]`` on the model's device.
        """
        d = model.n_input_feat
        domain = np.stack(
            np.meshgrid(
                *[np.arange(0, 2 * np.pi, 2 * np.pi / deg) for deg in model.degree]
            )
        ).T.reshape(-1, d)
        freqs = np.stack(np.meshgrid(*model.frequencies)).T.reshape(-1, d)
        domain = torch.as_tensor(domain, dtype=model.dtype, device=model.device)
        freqs = torch.as_tensor(freqs, dtype=model.dtype, device=model.device)

        half = cls.uniform_circle(
            random_key,
            low=coefficients_min,
            high=coefficients_max,
            size=math.prod(model.degree) // 2 + 1,
            dtype=model.dtype,
        ).to(model.device)
        anchor = 0.0 if zero_centered else half[0].real
        half = torch.cat([torch.as_tensor(anchor, dtype=half.dtype, device=half.device)
                          .reshape(1), half[1:]])
        coefficients = torch.cat([torch.flip(half[1:], dims=(0,)).conj(), half])

        values = (
            (torch.exp(1j * (domain @ freqs.T)) * coefficients).sum(dim=1)
            / coefficients.numel()
        ).real
        return [
            domain.reshape(*model.degree, -1),
            values.reshape(model.degree),
            coefficients.reshape(model.degree),
        ]

    @classmethod
    def uniform_circle(
        cls,
        random_key: Optional[torch.Generator],
        size: Union[List, int],
        low: float = 0.0,
        high: float = 1.0,
        dtype: torch.dtype = torch.float64,
    ) -> torch.Tensor:
        """Complex numbers uniform in the annulus ``low <= |z|^2 <= high``
        (drawn on the CPU from two generators split off *random_key*)."""
        size = (size,) if isinstance(size, int) else tuple(size)
        k_mag, k_arg = safe_random_split(random_key)
        mag = torch.sqrt(torch.rand(size, generator=k_mag, dtype=dtype) * (high - low) + low)
        arg = torch.rand(size, generator=k_arg, dtype=dtype)
        return mag * torch.exp(2j * np.pi * arg)
