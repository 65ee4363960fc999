"""The statistics of a window and of a check."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95 % of the values at or below it."""
    if not values:
        raise ValueError("p95 of no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def closed_loop(issue, seconds: float, clock) -> Dict[str, object]:
    """Drive ``issue()`` (one request, returns when its result is on the
    host) from the first issue until the first moment ``seconds`` have
    passed; the request running then completes and counts.  Returns the
    window's start, end and each request's latency."""
    t0 = clock()
    latencies: List[float] = []
    end = t0
    while True:
        start = clock()
        if start - t0 >= seconds and latencies:
            break
        issue()
        end = clock()
        latencies.append(end - start)
    return {"t0": t0, "t_end": end, "latencies": latencies}


def _gated(gate: List[np.ndarray], floor_ratio: float, element_floor: float = None):
    """Each leaf's mask of the elements that count, and whether the leaf
    counts: a leaf whose gate norm is under ``floor_ratio`` of the median
    leaf's does not, nor within a leaf an element whose gate is under
    ``element_floor`` (default ``floor_ratio``) of the leaf's median element
    (Adam turns a gradient that is nought to rounding into a full-size
    step)."""
    element_floor = floor_ratio if element_floor is None else element_floor
    masks = [np.abs(g) >= element_floor * np.median(np.abs(g)) for g in gate]
    gate_norms = np.array([np.linalg.norm(g) for g in gate])
    keep = gate_norms >= floor_ratio * float(np.median(gate_norms))
    return masks, keep


def norm_gaps(program: List[np.ndarray], reference: List[np.ndarray],
              floor_ratio: float = 1e-3, gate: List[np.ndarray] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's.

    With ``gate`` (the reference's first gradient, leaf by leaf), what moves
    by round-off alone is left out (:func:`_gated`)."""
    masks, keep = _gated(reference if gate is None else gate, floor_ratio)
    ref_norms = np.array([np.linalg.norm(r[m]) for r, m in zip(reference, masks)])
    median = float(np.median(ref_norms))
    worst = 0.0
    for p, m, k, rn in zip(program, masks, keep, ref_norms):
        if k:
            worst = max(worst, abs(float(np.linalg.norm(p[m])) - rn) / max(rn, median))
    return worst


def element_gap(program: List[np.ndarray], reference: List[np.ndarray],
                gate: List[np.ndarray], element_floor: float, floor_ratio: float = 1e-3) -> float:
    """The widest gap between an element of the program and the same element
    of the reference, over the elements whose gate is at least
    ``element_floor`` of its leaf's median element, in the leaves that
    :func:`_gated` keeps."""
    masks, keep = _gated(gate, floor_ratio, element_floor)
    worst = 0.0
    for p, r, m, k in zip(program, reference, masks, keep):
        if k and m.any():
            worst = max(worst, float(np.max(np.abs(p[m] - r[m]))))
    return worst
