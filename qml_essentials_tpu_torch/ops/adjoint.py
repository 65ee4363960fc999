"""Plan normalisation for the plan-level gradient executors.

:func:`normalize_plan` turns a contraction plan into a static step list
(hashable metadata) plus a tuple of real-split payload tensors — window
matrices as ``(2, K, K)`` (Re, Im) pairs and diagonals as ``(2, 2**k)``
pairs, both pre-permuted to sorted wire order.  Keeping payloads real
sidesteps complex-cotangent conventions: autograd through
``torch.stack([m.real, m.imag])`` carries the payload gradients back to the
gate parameters through the window composition.

The saved-residual executor (:mod:`qml_essentials_tpu_torch.ops.saved`)
runs on it.  The adjoint-state executor itself (the residual-free backward
that reconstructs each step's input by inverting the unitary step, with its
kernels) comes with the adjoint slice; until then a gradient that the
``"auto"`` rule or ``BACKWARD_MODE = "adjoint"`` sends there raises
``NotImplementedError`` (:mod:`qml_essentials_tpu_torch.ops.simulation`).

Counterpart of ``qml_essentials_tpu/ops/adjoint.py:69-144`` (the port has
no chain steps and no noise channels on the statevector path yet).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from qml_essentials_tpu_torch.ops import kernels
from qml_essentials_tpu_torch.ops.operations import DiagonalQubitUnitary, Operation


def _pair(x: torch.Tensor) -> torch.Tensor:
    """Stack a tensor into its (Re, Im) pair (real inputs get zero Im)."""
    if x.is_complex():
        return torch.stack([x.real, x.imag])
    return torch.stack([x, torch.zeros_like(x)])


def normalize_plan(
    plan: List[Tuple[str, object, List[int]]], n: int
) -> Tuple[tuple, tuple]:
    """Normalise a contraction plan for the plan-level executors.

    Accepts both raw :func:`~qml_essentials_tpu_torch.ops.simulation.plan_contractions`
    output (kinds ``mat``/``op``) and scheduled plans (kinds
    ``mat``/``diag``/``rot``, and ``rotmat``/``matrot`` with
    ``FUSE_LAYOUT_ROT`` on).  Returns ``(static, payloads)``: ``static`` is a
    tuple of steps ``("mat", wires)``, ``("diag", wires)``, ``("rot", r)``,
    ``(kind, r, wires)`` with wires sorted, and ``payloads`` the matching
    tuple of real-split tensors.  (The reference returns ``None`` for noise
    channels; the port's statevector path has none yet.)
    """
    static: list = []
    payloads: list = []
    for kind, payload, wires in plan:
        if kind == "rot":
            static.append(("rot", int(payload)))
            continue
        if kind in ("rotmat", "matrot"):
            r, mat = payload
            static.append((kind, int(r), tuple(int(w) for w in wires)))
            payloads.append(_pair(mat))
            continue
        if kind == "diag":
            d, w = payload, list(wires)
        elif kind == "mat":
            d, w = None, list(wires)
            mat = payload
        else:  # "op"
            op = payload
            cls = op.__class__
            if cls.apply_to_state_ri is not Operation.apply_to_state_ri:
                if isinstance(op, DiagonalQubitUnitary):
                    d, w = op.diag, list(op.wires)
                else:
                    continue  # no-op override (Id, Barrier)
            else:
                d, w = None, list(op.wires)
                mat = op.matrix

        k = len(w)
        srt = sorted(int(x) for x in w)
        if d is not None:
            if w != srt:
                order = [w.index(x) for x in srt]
                d = d.reshape((2,) * k).permute(*order).reshape(-1)
            static.append(("diag", tuple(srt)))
            payloads.append(_pair(d))
        else:
            if w != srt:
                rank = {x: i for i, x in enumerate(srt)}
                mat = kernels.permute_gate_qubits(mat, [rank[x] for x in w], k)
            static.append(("mat", tuple(srt)))
            payloads.append(_pair(mat))
    return tuple(static), tuple(payloads)
