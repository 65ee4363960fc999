"""Thread-local recording tapes.

Circuit functions are plain Python callables whose body instantiates
:class:`~qml_essentials_tpu_torch.ops.operations.Operation` objects.  While
a recording context is active, every freshly constructed operation appends
itself to the innermost tape.  Tapes live in ``threading.local`` storage so
concurrent threads never interleave.

:func:`copy_to_tape` replays a recorded body on shifted wires, to build
multi-register circuits (the analysis stack's Bell and SWAP-test doubling).

A pulse gate records an operation whose matrix is still to be solved (its
``_pending`` attribute): closing a recording solves every pending operation
of the tape together, one batched solve per Hamiltonian family
(:meth:`~qml_essentials_tpu_torch.pulse.evolution.Evolution.resolve`), so
whatever reads the tape afterwards sees plain matrices.  A second,
independent tape collects the pulse events the pulse gates emit, for
schedule drawing.

Counterpart of ``qml_essentials_tpu/ops/tape.py``.
"""

from __future__ import annotations

import copy
import threading
from contextlib import contextmanager
from typing import TYPE_CHECKING, Callable, Iterator, List, Optional

if TYPE_CHECKING:  # pragma: no cover
    from qml_essentials_tpu_torch.ops.operations import Operation

_tls = threading.local()


def _stack(attr: str = "ops") -> list:
    stack = getattr(_tls, attr, None)
    if stack is None:
        stack = []
        setattr(_tls, attr, stack)
    return stack


def active_tape() -> Optional[List["Operation"]]:
    """Innermost active operation tape, or ``None`` when not recording."""
    stack = _stack()
    return stack[-1] if stack else None


def resolve_pending(tape: List["Operation"]) -> None:
    """Solve the pending pulse operations of *tape* in place, one batched
    solve per Hamiltonian family."""
    pending = [o for o in tape if o.__dict__.get("_pending") is not None]
    if pending:
        from qml_essentials_tpu_torch.pulse.evolution import Evolution

        Evolution.resolve(pending)


@contextmanager
def recording() -> Iterator[List["Operation"]]:
    """Open a fresh operation tape; nested recordings stack independently.
    On a clean exit the tape's pending pulse operations are solved."""
    stack = _stack()
    tape: List["Operation"] = []
    stack.append(tape)
    try:
        yield tape
    finally:
        stack.pop()
    resolve_pending(tape)


def active_pulse_tape() -> Optional[list]:
    """Innermost active pulse-event tape, or ``None``."""
    stack = _stack("pulse")
    return stack[-1] if stack else None


@contextmanager
def pulse_recording() -> Iterator[list]:
    """Collect pulse events emitted by pulse-mode leaf gates."""
    stack = _stack("pulse")
    tape: list = []
    stack.append(tape)
    try:
        yield tape
    finally:
        stack.pop()


def shift_and_append(tape_ops: List["Operation"], offset: int) -> None:
    """Replay *tape_ops* on the active tape with all wires shifted by *offset*.

    Each operation is shallow-copied so the source tape stays intact.
    """
    current = active_tape()
    if current is None:
        return
    for o in tape_ops:
        shifted = copy.copy(o)
        shifted._wires = [w + offset for w in o.wires]
        current.append(shifted)


def copy_to_tape(fn: Callable, offset: int) -> None:
    """Record ``fn()`` on a side tape, then replay it shifted by *offset*."""
    with recording() as side_tape:
        fn()
    shift_and_append(side_tape, offset)
