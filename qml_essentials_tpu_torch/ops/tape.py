"""Thread-local recording tapes.

Circuit functions are plain Python callables whose body instantiates
:class:`~qml_essentials_tpu_torch.ops.operations.Operation` objects.  While
a recording context is active, every freshly constructed operation appends
itself to the innermost tape.  Tapes live in ``threading.local`` storage so
concurrent threads never interleave.

:func:`copy_to_tape` replays a recorded body on shifted wires, to build
multi-register circuits (the analysis stack's Bell and SWAP-test doubling).

Counterpart of ``qml_essentials_tpu/ops/tape.py`` (operation tapes only;
the pulse-event tape comes with the pulse slice).
"""

from __future__ import annotations

import copy
import threading
from contextlib import contextmanager
from typing import TYPE_CHECKING, Callable, Iterator, List, Optional

if TYPE_CHECKING:  # pragma: no cover
    from qml_essentials_tpu_torch.ops.operations import Operation

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "ops", None)
    if stack is None:
        stack = []
        _tls.ops = stack
    return stack


def active_tape() -> Optional[List["Operation"]]:
    """Innermost active operation tape, or ``None`` when not recording."""
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def recording() -> Iterator[List["Operation"]]:
    """Open a fresh operation tape; nested recordings stack independently."""
    stack = _stack()
    tape: List["Operation"] = []
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
