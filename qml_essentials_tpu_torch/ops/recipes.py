"""Plan recipes: the planner's structure kept apart from its payloads.

The planner (:mod:`~qml_essentials_tpu_torch.ops.simulation`, and
:mod:`~qml_essentials_tpu_torch.ops.chains` beneath it) decides the plan
from the tape's structure only — which gate classes act on which wires — and
computes its payloads (fused windows, diagonals, the outer-product start)
from the gates' matrices.  Each payload computation goes through
:func:`lazy`: on a tape of real operations it runs at once, so the planner
returns tensors as before; on a *proxy* tape (:func:`proxy_tape`), whose
matrices are :class:`Ref` placeholders, it returns a :class:`Lazy` node, and
the planner returns a *skeleton*: the plan with its payloads as recipes.

:func:`materialize` evaluates a skeleton against a freshly recorded tape of
the same structure: the plan cache of
:class:`~qml_essentials_tpu_torch.core.executor.Script` keeps the skeleton
per :func:`tape_signature`, so a repeated request skips the planner's
structural work (grouping, the layout DP, re-fusion, rotation fusion, the
chain grouping) and only recomposes the payloads.  Materializing with
``rows`` picks the rows of a batched tape (an int: one element; a slice: a
chunk) before composing.

:class:`RowPlans` serves a batch that runs element by element: it composes
the skeleton once for the chunk's rows (a payload no batched gate reaches
once, shared by every element; the others once with their batch axis, each
split into its rows by one ``unbind``) and hands each element its row.  A
state-sized payload (:func:`per_element`) is built for one element at a
time, from that element's rows of its arguments, never for the chunk.

The JAX package has no counterpart: its plans are traced once under ``jit``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from qml_essentials_tpu_torch.ops.operations import KrausChannel, Operation


class Ref:
    """A tensor attribute of the operation at *index* of the tape being
    materialized; *base* is its rank per element (a batched tape adds one
    leading dimension)."""

    __slots__ = ("index", "attr", "base")

    def __init__(self, index: int, attr: str, base: int) -> None:
        self.index, self.attr, self.base = index, attr, base


class Lazy:
    """A deferred call ``fn(*args)`` whose arguments hold :class:`Ref` or
    :class:`Lazy` nodes (inside tuples and lists too)."""

    __slots__ = ("fn", "args")

    def __init__(self, fn: Callable, args: tuple) -> None:
        self.fn, self.args = fn, args


def _deferred(x: Any) -> bool:
    if isinstance(x, (Ref, Lazy)):
        return True
    if isinstance(x, (tuple, list)):
        return any(_deferred(v) for v in x)
    return False


def lazy(fn: Callable, *args: Any) -> Any:
    """``fn(*args)`` now when no argument is deferred, else a :class:`Lazy`
    node evaluated by :func:`materialize`."""
    if any(_deferred(a) for a in args):
        return Lazy(fn, args)
    return fn(*args)


class PerElement(Lazy):
    """A :class:`Lazy` node whose value is state-sized: :class:`RowPlans`
    evaluates it for one element at a time, never for a chunk."""

    __slots__ = ()


def per_element(fn: Callable, *args: Any) -> Any:
    """:func:`lazy` for a state-sized payload (*fn* takes one element's
    arguments only): a :class:`PerElement` node when an argument is
    deferred."""
    if any(_deferred(a) for a in args):
        return PerElement(fn, args)
    return fn(*args)


class _Proxy:
    """Marker base of the proxy operations :func:`proxy_tape` builds."""


_PROXY_CLASSES: Dict[type, type] = {}

# Tensor attributes the planner reads, and their rank per element.
_BASE_RANK = {"_matrix": 2, "diag": 1}


def _proxy_class(cls: type) -> type:
    if cls not in _PROXY_CLASSES:
        _PROXY_CLASSES[cls] = type(cls.__name__, (cls, _Proxy), {})
    return _PROXY_CLASSES[cls]


def proxy_tape(tape: List[Operation]) -> List[Operation]:
    """Structural stand-ins of *tape*'s operations: same classes (so the
    planner's ``isinstance`` tests hold), wires and host attributes, with
    every tensor attribute replaced by a :class:`Ref` to the tape position.
    A proxy holds no tensor of the tape, so a cached skeleton keeps no
    autograd graph alive."""
    out = []
    for i, op in enumerate(tape):
        p = object.__new__(_proxy_class(op.__class__))
        for k, v in op.__dict__.items():
            if isinstance(v, torch.Tensor):
                v = Ref(i, k, _BASE_RANK.get(k, v.dim()))
            p.__dict__[k] = v
        p.__dict__["_tape_index"] = i
        out.append(p)
    return out


def derived(cls: type, name: str, wires: List[int], **attrs: Any) -> Operation:
    """An operation of class *cls* that the planner derives from the tape
    (the doubled gates of the interleaved lowering), its tensor attributes
    *attrs* given: a plain one when none is deferred, else a proxy that
    :func:`materialize` evaluates.  No constructor runs (nothing is
    recorded or validated)."""
    deferred = any(_deferred(v) for v in attrs.values())
    op = object.__new__(_proxy_class(cls) if deferred else cls)
    op.__dict__.update(name=name, _wires=list(wires), **attrs)
    return op


def _batched(t: Any, base: int) -> bool:
    """Whether *t* is a batched tensor: of rank ``base + 1``, one above its
    rank per element."""
    return isinstance(t, torch.Tensor) and t.dim() > base


def _rows(t: torch.Tensor, base: int, rows) -> torch.Tensor:
    """Rows *rows* of a batched tensor (rank ``base + 1``); a tensor of the
    per-element rank is shared by every element and returned whole."""
    if rows is None or not _batched(t, base):
        return t
    return t[rows]


def _tape_op(p: Operation, tape: List[Operation]) -> Optional[Operation]:
    """The tape's operation that proxy *p* stands for; None for a derived
    operation."""
    i = p.__dict__.get("_tape_index")
    if i is not None and isinstance(tape[i], type(p).__mro__[1]):
        return tape[i]
    return None


def _with(op: Operation, attrs: Dict[str, Any]) -> Operation:
    """A copy of *op* with its attributes *attrs* replaced."""
    out = object.__new__(op.__class__)
    out.__dict__.update(op.__dict__)
    out.__dict__.update(attrs)
    return out


class _Materializer:
    def __init__(self, tape: List[Operation], rows) -> None:
        self.tape, self.rows = tape, rows
        self.memo: Dict[int, Any] = {}

    def op(self, p: Operation) -> Operation:
        """The operation a proxy stands for: the tape's own (its tensors cut
        to *rows*), or a derived one with its deferred attributes evaluated."""
        real = _tape_op(p, self.tape)
        if real is not None:
            if self.rows is None:
                return real
            return _with(real, {k: _rows(v, _BASE_RANK[k], self.rows)
                                for k, v in real.__dict__.items()
                                if isinstance(v, torch.Tensor) and k in _BASE_RANK})
        out = object.__new__(type(p).__mro__[1])
        for k, v in p.__dict__.items():
            if k != "_tape_index":
                out.__dict__[k] = self(v)
        return out

    def __call__(self, x: Any) -> Any:
        if isinstance(x, Ref):
            key = id(x)
            if key not in self.memo:
                self.memo[key] = _rows(getattr(self.tape[x.index], x.attr), x.base, self.rows)
            return self.memo[key]
        if isinstance(x, Lazy):
            key = id(x)
            if key not in self.memo:
                self.memo[key] = x.fn(*(self(a) for a in x.args))
            return self.memo[key]
        if isinstance(x, _Proxy):
            key = id(x)
            if key not in self.memo:
                self.memo[key] = self.op(x)
            return self.memo[key]
        if isinstance(x, tuple):
            return tuple(self(v) for v in x)
        if isinstance(x, list):
            return [self(v) for v in x]
        return x


def materialize(skeleton: Any, tape: List[Operation], rows=None) -> Any:
    """Evaluate a skeleton (a plan, its start, a lowered tape, in any nesting
    of tuples and lists) against *tape*, a recording with the structure the
    skeleton was planned for.  *rows*: ``None`` (the whole batch), an int
    (one element) or a slice (a chunk) of a batched tape."""
    return _Materializer(tape, rows)(skeleton)


class _PerRow(tuple):
    """A payload's value for each row of a chunk, in :class:`RowPlans`."""


class RowPlans:
    """A skeleton composed once for the rows *rows* of a batched tape
    (``None``: the whole batch; a slice: a chunk) and handed out element by
    element (:meth:`element`).

    Each payload is composed by one :func:`materialize` of the chunk.  One
    that no batched gate reaches is the same tensor in every element's plan;
    a batched one is split into its rows by one ``unbind`` (one autograd
    node a payload), as are the batched tensors of the tape's operations.
    A :class:`PerElement` node and a derived operation are composed here
    down to their arguments only: :meth:`element` builds them for that
    element from its rows of them."""

    def __init__(self, skeleton: Any, tape: List[Operation], rows=None) -> None:
        self.skeleton, self.tape = skeleton, tape
        self.first = 0 if rows is None else range(batch_of(tape))[rows][0]
        self._chunk = _Materializer(tape, rows)
        self._batched: Dict[int, bool] = {}
        self._seen: set = set()
        # id of a node -> its value for the chunk, or a _PerRow of its rows
        self._parts: Dict[int, Any] = {}
        self._compose(skeleton)
        del self._chunk, self._batched, self._seen  # keep the payloads only

    def _is_batched(self, x: Any) -> bool:
        """Whether a batched gate reaches the node *x*."""
        if isinstance(x, (tuple, list)):
            return any(self._is_batched(v) for v in x)
        if not isinstance(x, (Ref, Lazy)):
            return False
        key = id(x)
        if key not in self._batched:
            if isinstance(x, Ref):
                self._batched[key] = _batched(getattr(self.tape[x.index], x.attr), x.base)
            else:
                self._batched[key] = any(self._is_batched(a) for a in x.args)
        return self._batched[key]

    def _compose(self, x: Any) -> None:
        if isinstance(x, (tuple, list)):
            for v in x:
                self._compose(v)
            return
        if not isinstance(x, (Ref, Lazy, _Proxy)) or id(x) in self._seen:
            return
        self._seen.add(id(x))
        if isinstance(x, PerElement):
            self._compose(x.args)
        elif isinstance(x, (Ref, Lazy)):
            v = self._chunk(x)
            self._parts[id(x)] = _PerRow(v.unbind(0)) if self._is_batched(x) else v
        elif _tape_op(x, self.tape) is None:  # a derived operation
            self._compose(list(x.__dict__.values()))
        else:
            op = self._chunk(x)
            cols = {k: v.unbind(0) for k, v in op.__dict__.items()
                    if k in _BASE_RANK and _batched(v, _BASE_RANK[k])}
            self._parts[id(x)] = _PerRow(_with(op, dict(zip(cols, row)))
                                         for row in zip(*cols.values())) if cols else op

    def element(self, row: int) -> Any:
        """The skeleton for the tape's row *row* (an index into the whole
        batch, within the chunk): materialized for that row with the chunk's
        payloads in hand, shared or that row's."""
        i = row - self.first
        m = _Materializer(self.tape, row)
        m.memo = {k: v[i] if isinstance(v, _PerRow) else v for k, v in self._parts.items()}
        return m(self.skeleton)


def _hashable(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return ("tensor", str(v.dtype))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (int, float, str, bool, type(None), complex)):
        return v
    return type(v).__name__


def _kraus_key(op: KrausChannel) -> tuple:
    """A channel's operators, which are the plan's constants: its host
    parameters where it has them (its class and they fix the operators),
    else the operators by content."""
    params = op.parameters
    if params and all(isinstance(p, (int, float)) for p in params):
        return ("params",) + tuple(params)
    return tuple(hash(k.detach().cpu().numpy().tobytes()) for k in op.kraus_matrices())


def tape_signature(tape: List[Operation]) -> tuple:
    """Structure of a tape for the plan cache: per operation its class,
    wires and host attributes (a tensor attribute contributes its dtype, not
    its values; the gate parameters, whose effect is the matrix, none), a
    channel its Kraus operators by content.  Tapes with equal signatures
    share a plan skeleton."""
    sig = []
    for op in tape:
        skip = {"_wires", "name", *op._param_names}
        attrs = tuple(sorted((k, _hashable(v)) for k, v in op.__dict__.items()
                             if k not in skip))
        item = (op.__class__.__qualname__, op.__class__.__module__, tuple(op.wires), attrs)
        if isinstance(op, KrausChannel):
            item += (_kraus_key(op),)
        sig.append(item)
    return tuple(sig)


def batch_of(tape: List[Operation]) -> Optional[int]:
    """The batch size of a recorded tape (the leading dimension of its
    batched matrices and diagonals), ``None`` when nothing is batched; raises
    ``ValueError`` when two batched tensors disagree."""
    sizes = set()
    for op in tape:
        for k, base in _BASE_RANK.items():
            v = op.__dict__.get(k)
            if isinstance(v, torch.Tensor) and v.dim() == base + 1:
                sizes.add(v.shape[0])
    if len(sizes) > 1:
        raise ValueError(f"batched gates disagree on the batch size: {sorted(sizes)}")
    return sizes.pop() if sizes else None
