"""Entanglement measures: Meyer-Wallach, Bell, relative entropy, EoF, CE.

Every measure consumes a :class:`~qml_essentials_tpu_torch.models.model.Model`
and runs its circuit, on the model's device and in its dtype, under an
overridden execution type.  The shared plumbing lives in three module
helpers: `_param_batch` (sample or reuse a parameter batch), `_replicated`
(build a multi-register circuit from the model's variational tape via
:func:`copy_to_tape`), and `_run_batched` (dispatch a Script over the
parameter batch with one ``torch.Generator`` per sample for its noise).

Where the JAX package threads PRNG keys, this module threads generators:
``random_key`` draws the parameter batch, then one child per sample.  The
copies of a replicated register replay the same generator state, so they
carry the same noise draws, as the JAX package's copies share one key.
Pulse parameters are not threaded yet (they come with the pulse slice).

Counterpart of ``qml_essentials_tpu/analysis/entanglement.py``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from qml_essentials_tpu_torch.analysis.math import _hermitian, logm_v
from qml_essentials_tpu_torch.core import jaqsi as js
from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import operations as op
from qml_essentials_tpu_torch.ops.tape import copy_to_tape
from qml_essentials_tpu_torch.utils import safe_random_split

log = logging.getLogger(__name__)


# ----------------------------------------------------------------- plumbing


def _param_batch(model, n_samples, random_key, scale):
    """Sample a fresh parameter batch, or reuse the model's stored one.

    ``n_samples > 0`` draws that many sets (× 2^n when *scale*); otherwise
    the stored parameters are used, batch-first.
    Returns ``(params, advanced_generator, n_batch)``.
    """
    if scale and n_samples is not None and n_samples > 0:
        n_samples = 2**model.n_qubits * n_samples
    if n_samples is not None and n_samples > 0:
        random_key = model.initialize_params(random_key, repeat=n_samples)
    else:
        log.info(f"Using sample size of model params: {model.params.shape[0]}")
    params = model.params
    return params, random_key, params.shape[0]


def _replicated(model, copies: List[int], suffix: Callable[[], None]):
    """Circuit function replaying the model's tape on shifted registers.

    *copies* lists the register offsets (in units of ``n_qubits``) that
    receive a copy of the variational circuit; *suffix* appends the
    measurement network.  Every copy starts from the same state of the
    sample's generator, so noisy copies draw the same noise.
    """
    n = model.n_qubits

    def circuit(params, inputs, random_key=None, **kw):
        def body():
            model._variational(params, inputs, random_key=random_key, **kw)

        start = None if random_key is None else random_key.get_state()
        for c in copies:
            if start is not None:
                random_key.set_state(start)
            copy_to_tape(body, offset=c * n)
        suffix()

    return circuit


def _run_batched(script, model, params, inputs, random_key, n_batch, *,
                 type: str, obs=None, kwargs=None):
    """Execute *script* over the parameter batch with per-sample generators
    (the inputs are passed positionally, so a user's ``inputs`` keyword
    does not reach the circuit twice)."""
    obs = obs or []
    kwargs = {k: v for k, v in (kwargs or {}).items() if k != "inputs"}
    if n_batch > 1:
        keys = list(safe_random_split(random_key, n_batch))
        return script.execute(
            type=type,
            obs=obs,
            args=(params, inputs, keys),
            in_axes=(0, None, 0),
            kwargs=kwargs,
        )
    return script.execute(
        type=type,
        obs=obs,
        args=(params, inputs, random_key),
        kwargs=kwargs,
    )


def _script(model, circuit, n_wires: int) -> js.Script:
    return js.Script(f=circuit, n_qubits=n_wires, device=model.device, dtype=model.dtype)


def _sampled_densities(model, n_samples, random_key, scale, **kwargs):
    """Batched density matrices over a (possibly fresh) parameter batch."""
    _param_batch(model, n_samples, random_key, scale)
    kwargs.setdefault("inputs", None)
    dim = 2**model.n_qubits
    return model(execution_type="density", **kwargs).reshape(-1, dim, dim)


def _qubit_purities(rhos: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """``Tr rho_{-j}^2`` of the reduction of each density matrix of the
    batch onto every qubit but ``j``, one ``j`` a column: ``(batch, n)``.
    For a pure state it equals the purity of qubit ``j`` alone."""
    B = rhos.shape[0]
    vals = []
    for j in range(n_qubits):
        a, b = 2**j, 2 ** (n_qubits - j - 1)
        r = torch.diagonal(rhos.reshape(B, a, 2, b, a, 2, b), dim1=2, dim2=5).sum(-1)
        r = r.reshape(B, a * b, a * b)
        vals.append(torch.diagonal((r @ r).real, dim1=-2, dim2=-1).sum(-1))
    return torch.stack(vals, dim=-1)


def _mw_values(rhos: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Per-sample Meyer-Wallach measure ``2 (1 - mean_j Tr rho_j^2)``."""
    return 2.0 * (1.0 - _qubit_purities(rhos, n_qubits).mean(dim=-1))


# ----------------------------------------------------------------- measures


class Entanglement:
    """Entangling-capability measures over sampled model parameters."""

    @classmethod
    def meyer_wallach(cls, model: Model, n_samples: Optional[int],
                      random_key: Optional[torch.Generator] = None,
                      scale: bool = False, **kwargs: Any) -> torch.Tensor:
        """Meyer-Wallach entangling capability (pure states), in [0, 1].

        Averages ``2 (1 - mean_j Tr rho_j^2)`` over sampled parameter sets
        (Meyer & Wallach 2002; sampling protocol of Sim et al. 2019).
        """
        if "noise_params" in kwargs:
            log.warning(
                "Meyer-Wallach measure not suitable for noisy circuits. "
                "Consider 'concentratable entanglement' instead."
            )
        rhos = _sampled_densities(model, n_samples, random_key, scale, **kwargs)
        values = _mw_values(rhos, model.n_qubits)
        log.debug(f"Variance of measure: {values.var(unbiased=False)}")
        return values.mean()

    @classmethod
    def bell_measurements(cls, model: Model, n_samples: int,
                          random_key: Optional[torch.Generator] = None,
                          scale: bool = False, **kwargs: Any) -> float:
        """Meyer-Wallach via Bell measurements on a doubled (2n) register."""
        if "noise_params" in kwargs:
            log.warning(
                "Bell Measurements not suitable for noisy circuits. "
                "Consider 'concentratable entanglement' instead."
            )
        n = model.n_qubits

        def bell_pairs():
            for q in range(n):
                op.CX(wires=[q, q + n])
                op.H(wires=q)

        # First copy sits at offset 0, partner register at offset n.
        script = _script(model, _replicated(model, [0, 1], bell_pairs), 2 * n)

        params, random_key, n_batch = _param_batch(
            model, n_samples, random_key, scale
        )
        inputs = model._inputs_validation(kwargs.get("inputs", None))
        probs = _run_batched(
            script, model, params, inputs, random_key, n_batch,
            type="probs", kwargs=kwargs,
        )

        # P(|11>) on the pair (q, q+n) estimates (1 - Tr rho_q^2) / 2.
        p11 = torch.stack(
            [js.marginalize_probs(probs, 2 * n, [q, q + n]) for q in range(n)],
            dim=-2,
        )[..., -1]
        purities = 1 - 2 * p11
        if purities.is_complex() and abs(float(purities.imag.sum())) > 1e-6:
            log.warning("Imaginary part of probabilities detected")
            purities = purities.abs()

        values = 2 * (1 - purities.mean(dim=0))
        log.debug(f"Variance of measure: {values.var(unbiased=False)}")
        return min(max(float(values.mean()), 0.0), 1.0)

    @classmethod
    def relative_entropy(cls, model: Model, n_samples: int, n_sigmas: int,
                         random_key: Optional[torch.Generator] = None,
                         scale: bool = False, **kwargs: Any) -> torch.Tensor:
        """Relative entropy of entanglement vs sampled separable states.

        An upper bound (the nearest separable state is NP-hard to find),
        normalised by the GHZ state's relative entropy so results land in
        [0, 1].
        """
        if scale:
            n_sigmas = 2**model.n_qubits * n_sigmas

        if random_key is None:
            random_key = model.random_key
        log_sigmas = sample_random_separable_states(
            model.n_qubits, n_samples=n_sigmas, random_key=random_key, take_log=True,
            device=model.device, dtype=model.dtype,
        )
        random_key, _ = safe_random_split(random_key)

        rhos, log_rhos = cls._log_densities(
            model, n_samples, random_key, scale, **kwargs
        )
        divergences = torch.stack(
            [cls._relative_entropies(rhos, log_rhos, ls) for ls in log_sigmas]
        )

        # The GHZ state maximises the measure — normalise against it.
        ghz = Model(model.n_qubits, 1, "GHZ", data_reupload=False,
                    device=model.device, dtype=model.dtype)
        ghz_rho, ghz_log = cls._log_densities(ghz, None, None, False, **kwargs)
        ghz_div = cls._relative_entropies(ghz_rho, ghz_log, log_sigmas)

        best = (divergences / ghz_div).T.min(dim=1).values
        log.debug(f"Variance of measure: {best.var(unbiased=False)}")
        return best.mean()

    @classmethod
    def _log_densities(cls, model, n_samples, random_key, scale, **kwargs):
        """Density matrices and their base-2 matrix logarithms."""
        rhos = _sampled_densities(model, n_samples, random_key, scale, **kwargs)
        return rhos, logm_v(rhos) / np.log(2)

    @classmethod
    def _relative_entropies(cls, rhos, log_rhos, log_sigmas):
        """``S(rho || sigma) = Tr[rho (log rho - log sigma)]``, batched.

        ``log_sigmas`` is either one matrix (broadcast over rhos) or a
        stack aligned against tiled rhos (sigma-major result).
        """
        if log_sigmas.ndim == 3:
            m = log_sigmas.shape[0]
            k = rhos.shape[0]
            r = rhos.repeat(m, 1, 1)
            lr = log_rhos.repeat(m, 1, 1)
            ls = log_sigmas
        else:
            m, k = 1, rhos.shape[0]
            r, lr = rhos, log_rhos
            ls = log_sigmas.expand(rhos.shape)

        div = torch.diagonal(r @ (lr - ls), dim1=-2, dim2=-1).sum(-1).abs()
        return div.reshape(m, k) if m > 1 else div

    @classmethod
    def entanglement_of_formation(cls, model: Model, n_samples: int,
                                  random_key: Optional[torch.Generator] = None,
                                  scale: bool = False,
                                  always_decompose: bool = False,
                                  **kwargs: Any) -> torch.Tensor:
        """Entanglement of formation via an eigenvector decomposition.

        The pure-state decomposition is not unique; this reports the
        entanglement of *some* decomposition (arXiv:quant-ph/0504163).
        Pure inputs reduce to Meyer-Wallach unless ``always_decompose``.
        """
        rhos = _sampled_densities(model, n_samples, random_key, scale, **kwargs)
        n = model.n_qubits
        dim = 2**n

        evals, evecs = torch.linalg.eigh(_hermitian(rhos))
        one = torch.ones((), dtype=evals.dtype, device=evals.device)
        is_pure = bool(torch.isclose(evals, one).any(dim=-1).all())
        if not always_decompose and is_pure:
            return _mw_values(rhos, n).mean()

        # The outer product of each row of the eigenvector matrix with itself,
        # weighted by the eigenvalue of the same index (the JAX package's
        # decomposition, row for row).
        projectors = torch.einsum(
            "sij,sik->sijk", evecs, evecs.conj()
        ).reshape(-1, dim, dim)
        mw = _mw_values(projectors, n).reshape(-1, dim)
        return torch.einsum("si,si->s", mw, evals).mean()

    @classmethod
    def concentratable_entanglement(cls, model: Model, n_samples: int,
                                    random_key: Optional[torch.Generator] = None,
                                    scale: bool = False,
                                    **kwargs: Any) -> float:
        """Concentratable entanglement via a 3n-qubit SWAP test
        (arXiv:2104.06923); valid for noisy circuits too."""
        n = model.n_qubits

        def swap_network():
            for i in range(n):
                op.H(wires=i)
            for i in range(n):
                op.CSWAP(wires=[i, i + n, i + 2 * n])
            for i in range(n):
                op.H(wires=i)

        # Two circuit copies on registers 1 and 2; ancillas on register 0.
        script = _script(model, _replicated(model, [1, 2], swap_network), 3 * n)

        params, random_key, n_batch = _param_batch(
            model, n_samples, random_key, scale
        )
        inputs = model._inputs_validation(kwargs.get("inputs", None))
        probs = _run_batched(
            script, model, params, inputs, random_key, n_batch,
            type="probs", kwargs=kwargs,
        )

        anc = js.marginalize_probs(probs, 3 * n, tuple(range(n)))
        values = 1 - anc[..., 0]
        log.debug(f"Variance of measure: {values.var(unbiased=False)}")
        return float(values.mean())

    @classmethod
    def concentratable_entanglement_estimation(
            cls, model: Model, n_samples: int,
            random_key: Optional[torch.Generator] = None,
            scale: bool = False, **kwargs: Any) -> float:
        """Concentratable entanglement estimated from Bell-basis
        measurements on a doubled register with a composite SWAP observable."""
        n = model.n_qubits

        def bell_basis():
            for i in range(n):
                op.CX(wires=[i, i + n])
                op.H(wires=i)

        script = _script(model, _replicated(model, [0, 1], bell_basis), 2 * n)

        params, random_key, n_batch = _param_batch(
            model, n_samples, random_key, scale
        )
        inputs = model._inputs_validation(kwargs.get("inputs", None))
        expvals = _run_batched(
            script, model, params, inputs, random_key, n_batch,
            type="expval", obs=[cls._swap_parity_observable(n)], kwargs=kwargs,
        )

        values = 1 - expvals
        log.debug(f"Variance of measure: {values.var(unbiased=False)}")
        return float(values.mean())

    @staticmethod
    def _swap_parity_observable(n: int) -> op.Operation:
        """``(1/2^n) prod_i (Id + SWAP_{i,i+n})`` in the Bell basis
        (where SWAP is diagonal: diag(1, 1, 1, -1))."""
        swap_diag = torch.diag(torch.tensor([1, 1, 1, -1], dtype=torch.complex128))
        total = None
        for i in range(n):
            factor = op.Id([i, i + n], record=False) + op.Operation(
                [i, i + n], swap_diag, record=False
            )
            total = factor if total is None else total @ factor
        return (1 / 2**n) * total


def sample_random_separable_states(
    n_qubits: int,
    n_samples: int,
    random_key: Optional[torch.Generator],
    take_log: bool = False,
    device=DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Random separable density matrices (products of single-qubit
    rotations), on *device* in *dtype*."""
    product_model = Model(n_qubits, 1, "No_Entangling", data_reupload=False,
                          device=device, dtype=dtype)
    product_model.initialize_params(random_key, repeat=n_samples)
    sigmas = product_model(execution_type="density", inputs=None)
    if take_log:
        sigmas = logm_v(sigmas) / np.log(2.0)
    return sigmas
