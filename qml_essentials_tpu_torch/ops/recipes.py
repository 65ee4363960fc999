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


def _rows(t: torch.Tensor, base: int, rows) -> torch.Tensor:
    """Rows *rows* of a batched tensor (rank ``base + 1``); a tensor of the
    per-element rank is shared by every element and returned whole."""
    if rows is None or t.dim() <= base:
        return t
    return t[rows]


class _Materializer:
    def __init__(self, tape: List[Operation], rows) -> None:
        self.tape, self.rows = tape, rows
        self.memo: Dict[int, Any] = {}

    def op(self, p: Operation) -> Operation:
        """The operation a proxy stands for: the tape's own (its tensors cut
        to *rows*), or a derived one with its deferred attributes evaluated."""
        i = p.__dict__.get("_tape_index")
        if i is not None and isinstance(self.tape[i], type(p).__mro__[1]):
            real = self.tape[i]
            if self.rows is None:
                return real
            cut = object.__new__(real.__class__)
            for k, v in real.__dict__.items():
                if isinstance(v, torch.Tensor) and k in _BASE_RANK:
                    v = _rows(v, _BASE_RANK[k], self.rows)
                cut.__dict__[k] = v
            return cut
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
