"""Wire-pair topologies for two-qubit gate layers.

``Topology`` generates ``[control, target]`` pair lists from a unified
stairs generator; ``bricks`` and ``all_to_all`` derive from it.

Counterpart of ``qml_essentials_tpu/models/topologies.py``, unchanged: the
generator semantics (offset/wrap/reverse/mirror/span/stride/modulo) define
every shipped ansatz's structure.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Union

log = logging.getLogger(__name__)


class Topology:
    """Static generators of ``[control, target]`` wire pairs."""

    @classmethod
    def stairs(
        cls,
        n_qubits: int,
        offset: Union[int, Callable] = 0,
        wrap: bool = False,
        reverse: bool = True,
        mirror: bool = True,
        span: Union[int, Callable] = 1,
        stride: int = 1,
        modulo: bool = True,
    ) -> List[List[int]]:
        """Unified nearest-neighbour / spanned pair generator.

        Defaults produce an "upstairs" entangling sequence without wrapping.

        Args:
            n_qubits: Number of qubits.
            offset: Start offset (int or ``f(n_qubits) -> int``).
            wrap: Include the wrap-around gate (n pairs instead of n-1).
            reverse: Reverse the iteration direction.
            mirror: Swap control and target roles.
            span: Distance between control and target (int or callable).
            stride: Step between consecutive pairs (2 gives brick layers).
            modulo: Whether out-of-range indices wrap via mod n; when False
                out-of-range pairs are skipped.
        """
        ctrls: List[int] = []
        targets: List[int] = []

        n_gates = n_qubits if wrap else n_qubits - 1
        off = offset(n_qubits) if callable(offset) else offset
        sp = span(n_qubits) if callable(span) else span

        for q in range(0, n_gates, stride):
            target = q + off + sp
            if target >= n_qubits and not modulo:
                continue
            control = q + off
            if control < 0 and not modulo:
                continue
            target %= n_qubits
            control %= n_qubits
            if target == control:
                log.warning("Skipping gate where control == target")
                continue
            ctrls.append(control)
            targets.append(target)

        if reverse:
            ctrls = list(reversed(ctrls))
            targets = list(reversed(targets))
        if mirror:
            ctrls, targets = targets, ctrls

        return [list(pair) for pair in zip(ctrls, targets)]

    @classmethod
    def bricks(cls, n_qubits: int, **kwargs) -> List[List[int]]:
        """Brick-layer pairs: stride-2 stairs without modulo wrapping."""
        kwargs.setdefault("stride", 2)
        kwargs.setdefault("modulo", False)
        return cls.stairs(n_qubits=n_qubits, **kwargs)

    @classmethod
    def all_to_all(cls, n_qubits: int) -> List[List[int]]:
        """Every ordered pair ``(i, j)`` with ``i != j`` (descending sweep)."""
        pairs: List[List[int]] = []
        for ql in range(n_qubits):
            for q in range(n_qubits):
                if q != ql:
                    pairs.append(
                        [n_qubits - ql - 1, (n_qubits - q - 1) % n_qubits]
                    )
        return pairs
