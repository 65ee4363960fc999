"""Thread-local recording tapes.

Circuit functions are plain Python callables whose body instantiates
:class:`~qml_essentials_tpu_torch.ops.operations.Operation` objects.  While
a recording context is active, every freshly constructed operation appends
itself to the innermost tape.  Tapes live in ``threading.local`` storage so
concurrent threads never interleave.

Counterpart of ``qml_essentials_tpu/ops/tape.py`` (operation tapes only;
the pulse-event tape comes with the pulse slice).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import TYPE_CHECKING, Iterator, List, Optional

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

