"""Expressibility: sampled state-fidelity histograms vs the Haar measure.

Sim et al. 2019: the fidelities of random state pairs, histogrammed, are
compared with the Haar fidelity distribution by a Kullback-Leibler
divergence.

* The sampled states are one batched density evaluation of the model on
  its device; the fidelities run there too, through the
  eigendecomposition-based matrix square root.
* The histogram counts on that device with ``jnp.histogram``'s semantics:
  bins ``[lo, hi)`` over ``linspace(0, 1, n_bins + 1)``, the last bin closed
  at 1, values outside ``[0, 1]`` dropped (``torch.bucketize`` and
  ``bincount``; ``torch.histc`` computes its bin from a division and can
  put a value on an edge into the other bin).
* The binned Haar integral is evaluated in **closed form**: the fidelity
  PDF ``(N-1)(1-F)^(N-2)`` has antiderivative ``-(1-F)^(N-1)``, so each
  bin's mass is ``(1-lo)^(N-1) - (1-hi)^(N-1)`` exactly (the ``cache``
  flag is accepted for API compatibility and ignored).

Counterpart of ``qml_essentials_tpu/analysis/expressibility.py``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.analysis.math import _hermitian, _sqrt_matrix
from qml_essentials_tpu_torch.models.model import Model


def _uhlmann_fidelities(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Batched Uhlmann fidelity ``(Tr sqrt(sqrt(rho) sigma sqrt(rho)))^2``."""
    root = _sqrt_matrix(rho)
    evs = torch.linalg.eigvalsh(_hermitian(root @ sigma @ root)).clamp(min=0.0)
    return (torch.sum(torch.sqrt(evs), dim=-1) ** 2).abs()


def _histogram(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Counts of *values* in the bins of *edges*, as ``jnp.histogram``:
    ``[edges[i], edges[i+1])``, the last bin closed, outliers dropped."""
    n_bins = edges.numel() - 1
    idx = torch.bucketize(values, edges, right=True)
    idx = torch.where(values == edges[-1], torch.full_like(idx, n_bins), idx)
    keep = (idx >= 1) & (idx <= n_bins)
    return torch.bincount(idx[keep] - 1, minlength=n_bins)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Expressibility:
    """Sim et al. 2019 expressibility: KL(fidelity histogram || Haar PDF)."""

    @classmethod
    def _sample_state_fidelities(cls, model: Model, n_samples: int,
                                 random_key: Optional[torch.Generator] = None,
                                 kwargs: Any = None) -> torch.Tensor:
        """Fidelities of ``n_samples`` random state pairs (on the model's
        device).  One batched density evaluation produces ``2 n`` states; the
        first half pairs with the second."""
        model.initialize_params(random_key, repeat=n_samples * 2)
        dms = model(params=model.params, execution_type="density", **(kwargs or {}))
        return _uhlmann_fidelities(dms[:n_samples], dms[n_samples:])

    @classmethod
    def state_fidelities(cls, n_samples: int, n_bins: int, model: Model,
                         random_key: Optional[torch.Generator] = None,
                         scale: bool = False,
                         **kwargs: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """Histogram of sampled state fidelities; returns (bin edges, counts/n)."""
        if scale:
            n_samples *= 2**model.n_qubits
            n_bins *= model.n_qubits

        fids = cls._sample_state_fidelities(
            model=model, n_samples=n_samples, random_key=random_key, kwargs=kwargs
        )
        edges = torch.as_tensor(np.linspace(0, 1, n_bins + 1), dtype=fids.dtype,
                                device=fids.device)
        counts = _histogram(fids, edges)
        return edges, counts.to(fids.dtype) / n_samples

    # ------------------------------------------------------------- Haar side
    @classmethod
    def _haar_probability(cls, fidelity: float, n_qubits: int) -> float:
        """Haar fidelity PDF ``(N-1)(1-F)^(N-2)`` (Sim et al. 2019)."""
        N = 2**n_qubits
        return (N - 1) * (1 - fidelity) ** (N - 2)

    @classmethod
    def haar_integral(cls, n_qubits: int, n_bins: int, cache: bool = True,
                      scale: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-bin Haar PDF mass, in closed form (float64, host).

        ``integral (N-1)(1-F)^(N-2) dF = -(1-F)^(N-1)``, so bin ``[lo, hi)``
        carries exactly ``(1-lo)^(N-1) - (1-hi)^(N-1)``.  The *cache*
        argument is accepted for API compatibility but unused.
        """
        if scale:
            n_bins *= n_qubits
        N = 2**n_qubits
        edges = np.linspace(0.0, 1.0, n_bins + 1)
        survivals = (1.0 - edges) ** (N - 1)
        masses = survivals[:-1] - survivals[1:]
        return torch.from_numpy(np.linspace(0.0, 1.0, n_bins)), torch.from_numpy(masses)

    # ------------------------------------------------------------ divergence
    @classmethod
    def kullback_leibler_divergence(cls, vqc_prob_dist, haar_dist) -> np.ndarray:
        """Row-wise ``KL(p || haar)`` with the 0 log 0 := 0 convention (host)."""
        p = np.atleast_2d(_host(vqc_prob_dist).astype(np.float64))
        q = _host(haar_dist).astype(np.float64)
        if p.shape[-1] != q.shape[-1]:
            raise ValueError(
                "All probabilities for inputs should have the same shape as "
                f"Haar. Got {q.shape} for Haar and {p.shape} for VQC"
            )
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = np.where(p > 0, p * (np.log(p) - np.log(q)), 0.0)
            terms = np.where((p > 0) & (q == 0), np.inf, terms)
        return terms.sum(axis=-1)

    @classmethod
    def kl_divergence_to_haar(cls, model: Model, n_samples: int, n_bins: int,
                              random_key: Optional[torch.Generator] = None,
                              scale: bool = False,
                              **kwargs: Any) -> np.ndarray:
        """Shortcut: sample fidelities, histogram, KL against the Haar PDF."""
        _, hist = cls.state_fidelities(
            n_samples, n_bins, model, random_key=random_key,
            scale=scale, **kwargs,
        )
        _, haar = cls.haar_integral(model.n_qubits, n_bins=n_bins, scale=scale)
        return cls.kullback_leibler_divergence(hist, haar)
