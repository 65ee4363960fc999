"""Distributed statevector simulation: the state sharded over the ranks of a
``state`` mesh axis (``torch.distributed``).

Each of ``D = 2**g`` ranks of the state group holds the ``2**(n-g)``
amplitudes whose leading ``g`` qubit positions equal its index in the group
(bit ``g-1-p`` of the index is position ``p``), as the real-split shard
``(2, 2**(n-g))`` — ``(2, Bt, 2**(n-g))`` under a batch; Re/Im and the batch
ride along as payload of every collective:

* the tape is fused into windows (:func:`_fused_ops`, the single-device
  planner's :func:`~qml_essentials_tpu_torch.ops.simulation.plan_contractions`
  capped at the local width), and the host plans the layout from the
  windows' wire lists alone (:func:`_plan_layout`: Belady victims, one
  grouped exchange before each window that touches a sharded position);
* a window on local positions runs on the ported kernels
  (:func:`~qml_essentials_tpu_torch.ops.kernels.apply_matrix_pair_ri`: on the
  card the window and top-window kernels, the rotation kernel for a
  ring-wrapped support, their batch entries for a batched shard);
* an exchange swaps ``m`` sharded positions with ``m`` local ones: the
  ``2**m`` ranks that differ only in the swapped bits trade one slot each, in
  one ``all_to_all_single`` over the state group whose split sizes are zero
  outside those ranks (or ``2**m - 1`` rounds of paired send/receive,
  ``BATCHED_EXCHANGE = "ppermute"``, for batched shards); a shard larger
  than ``EXCHANGE_PIECE_BYTES`` moves in pieces, one collective a piece.
  Slot ``idx`` goes to the rank ``base | spread(idx)``; the slots are put in rank order
  explicitly, since that order is not ascending when the pairs' sharded
  positions are not sorted.  A ``gloo`` group with shards on the card stages
  the slots through pinned host memory (``staged``); NCCL takes them as
  they lie;
* measurements reduce with an all-reduce over the state group.

Gradients.  Every rank computes the same loss from the reduced (replicated)
outputs, so a replicating collective (the all-reduce of the readouts, the
all-gather of a state) passes each rank its own part of the cotangent, and
the replicated gate payloads' gradients are all-reduced over the state group:
every rank ends with the whole gradient.  An unbatched unitary plan
(``ADJOINT``) runs as one ``torch.autograd.Function`` whose backward walks
the plan back on the ported adjoint steps
(:func:`~qml_essentials_tpu_torch.ops.adjoint.walk_back`: the adjoint-step
kernels, the paired rotation for a ring-wrapped support) between the
exchanges, each exchange moving ψ and λ together — no residuals.  Other
plans (a batched shard, the density engine's superoperators, ``ADJOINT``
off) differentiate through the kernels' own backwards, in
``torch.utils.checkpoint`` segments of ``sqrt(T)`` steps from
``CHECKPOINT_MIN_STEPS`` steps.

Counterpart of ``qml_essentials_tpu/parallel/state_sharding.py``.
"""

from __future__ import annotations

import logging
import math
from functools import reduce
from operator import or_
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from qml_essentials_tpu_torch.core.executor import Script, _batch_size, _element, _NotVectorisable
from qml_essentials_tpu_torch.ops import adjoint, kernels, saved
from qml_essentials_tpu_torch.ops.dtypes import cdtype
from qml_essentials_tpu_torch.ops.operations import (
    Barrier,
    DiagonalQubitUnitary,
    KrausChannel,
    Operation,
)
from qml_essentials_tpu_torch.utils import GeneratorBatch, safe_random_split

logger = logging.getLogger(__name__)

# Host layout plans built (one per program and tape structure); tests assert
# that a repeated signature builds no second one.
TRACE_COUNT: int = 0

# Unbatched unitary plans differentiate by the residual-free adjoint walk.
ADJOINT: bool = True

# From this many steps, plans differentiated through the kernels' own
# backwards run in ~sqrt(T) checkpoint segments (residuals of ~2 sqrt(T)
# shards instead of T).
CHECKPOINT_MIN_STEPS: int = 16

# Exchange of batched shards: "a2a" (one all_to_all_single, the batch as
# payload) or "ppermute" (2**m - 1 rounds of paired send/receive).
BATCHED_EXCHANGE: str = "a2a"

# This rank's exchange statistics: exchanges run, and bytes sent to other
# ranks.  Read and reset by callers that report them.
EXCHANGES: int = 0
EXCHANGE_BYTES: int = 0

# An exchange moves its shard in pieces of at most this many bytes, one
# collective a piece, so that it holds its input, its output and a few
# pieces at once (a 32-qubit register on four ranks has 8.6 GB shards).
EXCHANGE_PIECE_BYTES: int = 1 << 28


class ShardingUnavailable(NotImplementedError):
    """A tape or request the sharded backend cannot run.

    Raised on the host at plan time, so :meth:`Script._try_sharded_state`
    falls back to the single-device path.  Noisy tapes route through the
    sharded density engine
    (:mod:`~qml_essentials_tpu_torch.parallel.density_sharding`), which raises
    this for tapes with no contiguous doubled form.
    """


class _OpStep(NamedTuple):
    """One window of the layout plan: ``exchange`` is the ``(global_pos,
    victim_pos)`` pairs swapped in one grouped exchange before it,
    ``local_axes`` the positions (minus g) of its wires after that."""

    exchange: Tuple[Tuple[int, int], ...]
    local_axes: Tuple[int, ...]


class _LayoutPlan(NamedTuple):
    steps: Tuple[_OpStep, ...]
    final_order: Tuple[int, ...]  # final_order[p] = logical qubit at position p


def _plan_layout(wire_lists: Sequence[Sequence[int]], n: int, g: int) -> _LayoutPlan:
    """Host-side static layout planner: whenever a window touches sharded
    positions, one grouped exchange brings all of its sharded wires local;
    the victims are the free local positions whose next use lies farthest
    ahead (ties toward higher positions)."""
    order = list(range(n))
    steps: List[_OpStep] = []

    INF = float("inf")
    T = len(wire_lists)
    nxt = [INF] * n
    next_use: List[List[float]] = [None] * T
    for t in range(T - 1, -1, -1):
        next_use[t] = list(nxt)
        for w in wire_lists[t]:
            nxt[w] = t

    for t, wires in enumerate(wire_lists):
        pos = {q: p for p, q in enumerate(order)}
        global_ws = [w for w in wires if pos[w] < g]
        pairs: List[Tuple[int, int]] = []
        if global_ws:
            protected = set(wires)
            cands = [p for p in range(g, n) if order[p] not in protected]
            if len(cands) < len(global_ws):
                raise ShardingUnavailable(
                    "Gate support too wide for the sharded layout: "
                    f"{len(global_ws)} global bits but only {len(cands)} "
                    "free local positions."
                )
            future = next_use[t]
            cands.sort(key=lambda p: (future[order[p]], p), reverse=True)
            for w, victim in zip(global_ws, cands):
                gpos = pos[w]
                pairs.append((gpos, victim))
                order[gpos], order[victim] = order[victim], order[gpos]
                pos[order[gpos]] = gpos
                pos[order[victim]] = victim
        steps.append(_OpStep(exchange=tuple(pairs), local_axes=tuple(pos[w] - g for w in wires)))
    return _LayoutPlan(steps=tuple(steps), final_order=tuple(order))


# ---------------------------------------------------------------------------
# The state group and its collectives
# ---------------------------------------------------------------------------


class _Axis:
    """One axis of a device mesh as this rank sees it: the group, its size
    ``D``, this rank's index ``d`` in it (its group rank), the global ranks
    in group order, and whether collectives stage through host memory (a
    ``gloo`` group with tensors on the card)."""

    def __init__(self, mesh, axis: str) -> None:
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no {axis!r} axis: {names}")
        self.name = axis
        self.group = mesh.get_group(axis)
        self.D = int(mesh.size(names.index(axis)))
        self.d = int(mesh.get_local_rank(axis))
        self.ranks = list(dist.get_process_group_ranks(self.group))
        self.staged = mesh.device_type == "cuda" and dist.get_backend(self.group) == "gloo"


def _wire(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """*t* as a collective takes it: a pinned host copy when staged."""
    if ax.staged and t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h
    return t.contiguous()


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return h.to(like.device) if h.device != like.device else h


def _all_reduce(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    buf = _wire(t.detach(), ax)
    buf = buf.clone() if buf.data_ptr() == t.data_ptr() else buf
    dist.all_reduce(buf, group=ax.group)
    return _back(buf, t)


def _all_gather(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """``(D, *t.shape)``: every rank's *t* in group order."""
    src = _wire(t.detach(), ax)
    out = torch.empty((ax.D,) + tuple(t.shape), dtype=t.dtype, device=src.device,
                      pin_memory=ax.staged and t.is_cuda)
    dist.all_gather(list(out.unbind(0)), src, group=ax.group)
    return _back(out, t)


class _Sum(torch.autograd.Function):
    """All-reduce (sum) of per-rank partials; every rank computes the same
    loss from the sum, so each rank's partial takes the cotangent as is."""

    @staticmethod
    def forward(ctx, t, ax):
        return _all_reduce(t, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather ``(D, ...)``; each rank's part takes its own slice of the
    (replicated) cotangent."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.d = ax.d
        return _all_gather(t, ax)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.d], None


def _all_reduce_list(grads: Sequence[Optional[torch.Tensor]], ax: _Axis,
                     likes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor of *grads* over the group in one collective per
    dtype (a missing grad counts as zeros)."""
    grads = [torch.zeros_like(x) if gr is None else gr for gr, x in zip(grads, likes)]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, gr in enumerate(grads):
        by_dtype.setdefault(gr.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), ax)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.reshape(grads[i].shape)
    return out


class _ReplicatedGrads(torch.autograd.Function):
    """Identity on replicated tensors whose gradients are summed over the
    group: each rank's autograd sees only its own part of the work."""

    @staticmethod
    def forward(ctx, ax, *tensors):
        ctx.ax = ax
        ctx.save_for_backward(*tensors)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *_all_reduce_list(grads, ctx.ax, ctx.saved_tensors))


def _replicated(tensors: Sequence[torch.Tensor], ax: _Axis) -> List[torch.Tensor]:
    """*tensors* with their gradients summed over *ax* (those that need
    one; the others pass as they are)."""
    tensors = list(tensors)
    idx = [i for i, t in enumerate(tensors)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if not idx or not torch.is_grad_enabled():
        return tensors
    for i, t in zip(idx, _ReplicatedGrads.apply(ax, *(tensors[i] for i in idx))):
        tensors[i] = t
    return tensors


# ---------------------------------------------------------------------------
# The exchanges
# ---------------------------------------------------------------------------


def _members(pairs: Sequence[Tuple[int, int]], g: int, d: int) -> List[int]:
    """Group index of the rank that owns slot ``idx`` of this rank's
    exchange group: ``base | spread(idx)``."""
    m = len(pairs)
    masks = [1 << (g - 1 - p) for p, _ in pairs]
    base = d & ~reduce(or_, masks)
    out = []
    for idx in range(2**m):
        dev = base
        for j in range(m):
            if (idx >> (m - 1 - j)) & 1:
                dev |= masks[j]
        out.append(dev)
    return out


_SLOT_ORDERS: Dict[tuple, torch.Tensor] = {}


def _a2a(x: torch.Tensor, members: List[int], ax: _Axis) -> torch.Tensor:
    """Slot ``idx`` of *x* ``(M, C)`` to rank ``members[idx]``; slot ``idx``
    of the result from it.  One ``all_to_all_single`` over the whole group,
    zero rows outside the exchange group, slots put in rank order."""
    order = sorted(range(len(members)), key=members.__getitem__)
    key = (tuple(order), x.device)
    perm = _SLOT_ORDERS.get(key)
    if perm is None:  # one upload an order, not one a piece
        perm = _SLOT_ORDERS[key] = torch.tensor(order, device=x.device)
    send = _wire(x.index_select(0, perm), ax)
    recv = torch.empty_like(send)
    splits = [0] * ax.D
    for dev in members:
        splits[dev] = 1
    dist.all_to_all_single(recv, send, splits, splits, group=ax.group)
    return torch.empty_like(x).index_copy_(0, perm, _back(recv, x))


def _rounds(x: torch.Tensor, members: List[int], ax: _Axis) -> torch.Tensor:
    """The same exchange as ``2**m - 1`` rounds of paired send/receive: in
    round ``o`` this rank trades slot ``mine ^ o`` with the rank owning it."""
    mine = members.index(ax.d)
    out = x.clone()
    for o in range(1, len(members)):
        idx = mine ^ o
        peer = ax.ranks[members[idx]]
        send = _wire(x[idx], ax)
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer, ax.group),
                                       dist.P2POp(dist.irecv, recv, peer, ax.group)])
        for r in reqs:
            r.wait()
        out[idx] = _back(recv, x)
    return out


def _exchange_bits(local: torch.Tensor, pairs: Sequence[Tuple[int, int]], ax: _Axis,
                   via_ppermute: bool = False) -> torch.Tensor:
    """Swap sharded positions with local ones: ``local`` is ``(..., 2**nl)``
    (Re/Im, a batch, or ψ and λ stacked lead), ``pairs`` ``(global_pos,
    victim_pos)``.  The victim axes become the slot axes; the leading axes
    ride along as payload.  The amplitude axis is viewed as one dim a
    victim position and one a run of the others (a few dims at any width),
    and the shard moves in pieces (:data:`EXCHANGE_PIECE_BYTES`), each
    gathered from that view with its slot dims first and written back
    through the same view of the result."""
    global EXCHANGES, EXCHANGE_BYTES
    g = int(math.log2(ax.D))
    nl = int(local.shape[-1]).bit_length() - 1
    lead = tuple(local.shape[:-1])
    o = len(lead)
    m = len(pairs)
    runs, dims = kernels.bit_runs(nl, [v - g for _, v in pairs])
    slots = [o + i for i in dims]
    perm = slots + list(range(o)) + [o + i for i in range(len(runs)) if o + i not in slots]
    shape = lead + tuple(runs)
    x = local.reshape(shape).permute(*perm)
    out = torch.empty(local.shape, dtype=local.dtype, device=local.device)
    y = out.view(shape).permute(*perm)
    members = _members(pairs, g, ax.d)
    move = _rounds if via_ppermute and BATCHED_EXCHANGE == "ppermute" else _a2a
    for cut in kernels.pieces(tuple(x.shape[m:]), 2**m * local.element_size(),
                              EXCHANGE_PIECE_BYTES):
        part = (slice(None),) * m + cut
        xs = x[part]
        y[part] = move(xs.reshape(2**m, -1), members, ax).view(xs.shape)
    EXCHANGES += 1
    EXCHANGE_BYTES += (2**m - 1) * (local.numel() >> m) * local.element_size()
    return out


class _Exchange(torch.autograd.Function):
    """The exchange is an involutive permutation: its backward is itself."""

    @staticmethod
    def forward(ctx, local, pairs, ax, via_ppermute):
        ctx.meta = (pairs, ax, via_ppermute)
        return _exchange_bits(local, pairs, ax, via_ppermute)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _exchange_bits(g.contiguous(), *ctx.meta), None, None, None


def _exchange(local: torch.Tensor, pairs: Sequence[Tuple[int, int]], ax: _Axis,
              via_ppermute: bool = False) -> torch.Tensor:
    """Differentiable exchange (``via_ppermute`` marks batched shards, which
    take :data:`BATCHED_EXCHANGE`)."""
    if not pairs:
        return local
    return _Exchange.apply(local, tuple(tuple(p) for p in pairs), ax, via_ppermute)


# ---------------------------------------------------------------------------
# The local plan and its backward
# ---------------------------------------------------------------------------


class _Local(NamedTuple):
    """A plan as the local kernels run it: normalised steps (sorted local
    axes), the exchange before each, and the width of the shard."""

    static: tuple
    exchanges: Tuple[Tuple[Tuple[int, int], ...], ...]
    nl: int
    ax: _Axis
    via_ppermute: bool


def _run_local(local: torch.Tensor, payloads: Sequence[torch.Tensor], meta: _Local
               ) -> torch.Tensor:
    for step, pairs, w2 in zip(meta.static, meta.exchanges, payloads):
        if pairs:
            local = _exchange_bits(local, pairs, meta.ax, meta.via_ppermute)
        local = saved._one_step(local, w2, step, meta.nl)
    return local


class _ShardedPlan(torch.autograd.Function):
    """``(local, *payloads) -> final local shard`` with the adjoint-state
    backward: each segment between exchanges walked back on the adjoint
    kernels, ψ and λ exchanged together, the payload grads all-reduced."""

    @staticmethod
    def forward(ctx, local, meta, *payloads):
        out = _run_local(local, payloads, meta)
        ctx.meta = meta
        ctx.save_for_backward(out, *payloads)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        out, *payloads = ctx.saved_tensors
        meta = ctx.meta
        T = len(meta.static)
        starts = [t for t in range(T) if t == 0 or meta.exchanges[t]]
        psi, lam = out, g.contiguous()
        grads: List[Optional[torch.Tensor]] = [None] * T
        for s, e in reversed(list(zip(starts, starts[1:] + [T]))):
            psi, lam, gs = adjoint.walk_back(meta.static[s:e], meta.nl, psi, payloads[s:e], lam)
            grads[s:e] = gs
            if meta.exchanges[s]:
                both = torch.cat([psi, lam.to(psi.dtype)])
                psi = lam = None  # the exchange holds ψ and λ once, stacked
                both = _exchange_bits(both, meta.exchanges[s], meta.ax, meta.via_ppermute)
                psi, lam = both[:2], both[2:]
        return (None, None, *_all_reduce_list(grads, meta.ax, payloads))


def _fused_ops(ops: Sequence[Operation], n: int, g: int, *, dtype: torch.dtype = torch.complex64,
               device=None) -> List[Operation]:
    """Fuse adjacent gates into window Operations before layout planning:
    the single-device planner's window fusion with windows capped at the
    local width (so each can be made local), complex *dtype* on *device*."""
    from qml_essentials_tpu_torch.ops import simulation as _sim

    width = min(_sim.FUSE_MAX_WIDTH, max(n - g, 1))
    fused: List[Operation] = []
    for kind, payload, wires in _sim.plan_contractions(list(ops), max_width=width, dtype=dtype,
                                                       device=device):
        if kind == "mat":
            fused.append(Operation(wires=list(wires), matrix=payload, record=False,
                                   name="Window"))
        else:
            fused.append(payload)
    return fused


# ---------------------------------------------------------------------------
# Observables
# ---------------------------------------------------------------------------


class _ObsSpec(NamedTuple):
    """Static measurement plan of one observable: a ``zword`` folds the
    probability shard (device-constant signs for sharded Z factors); a
    ``general`` Hermitian takes one involutive exchange bringing its wires
    local, then ``<psi|O|psi>`` on ``local_axes`` and the all-reduce."""

    kind: str  # "zword" | "general"
    word: Tuple[int, ...]
    exchange: Tuple[Tuple[int, int], ...]
    local_axes: Tuple[int, ...]
    op: Optional[Operation]


def reduce_zword(word: Sequence[int]) -> Tuple[int, ...]:
    """Reduce repeated wires of a Z-word mod 2 (``Z·Z = I``)."""
    from collections import Counter

    return tuple(sorted(w for w, c in Counter(word).items() if c % 2 == 1))


def zword_of(obs: Operation) -> Optional[Tuple[int, ...]]:
    """Wires carrying Z if *obs* is an I/Z Pauli word (a plain ``PauliZ`` or
    an operation tagged with an I/Z ``_pauli_label``), else None."""
    label = getattr(obs, "_pauli_label", None)
    if label is not None and set(label) <= {"I", "Z"}:
        return tuple(w for ch, w in zip(label, obs.wires) if ch == "Z")
    if (
        obs.__class__.__name__ == "PauliZ"
        and len(obs.wires) == 1
        and obs._matrix is obs.__class__._matrix
    ):
        return (obs.wires[0],)
    return None


def _frozen(args: tuple) -> tuple:
    """*args* with each generator copied: a host-side recording draws what
    the run's recording will draw, and leaves the caller's streams alone."""
    def copy(a):
        if isinstance(a, torch.Generator):
            return torch.Generator(device=a.device).set_state(a.get_state())
        if isinstance(a, GeneratorBatch):
            return GeneratorBatch([copy(x) for x in a.generators])
        if isinstance(a, (list, tuple)) and a and all(isinstance(x, torch.Generator) for x in a):
            return type(a)(copy(x) for x in a)
        return a
    return tuple(copy(a) for a in args)


def _split_batch(mesh, data_axis: str, args: tuple, in_axes: Tuple) -> Tuple[tuple, _Axis, range]:
    """This rank's rows of a batch split over *data_axis* of *mesh*: the
    arguments narrowed to them (each tensor's gradient summed over the axis
    first), the axis, and the rows."""
    dax = _Axis(mesh, data_axis)
    bl = _batch_size(args, in_axes) // dax.D
    lo = dax.d * bl
    part = []
    for a, ax in zip(args, in_axes):
        if isinstance(a, torch.Tensor):
            a = _replicated([a], dax)[0]
            part.append(a if ax is None else a.narrow(ax, lo, bl))
        else:
            part.append(a if ax is None else a[lo:lo + bl])
    return tuple(part), dax, range(lo, lo + bl)


class ShardedStateSim:
    """Statevector simulator with the state sharded over a mesh axis.

    Example:
        >>> mesh = make_mesh((4,), ("state",), device="cpu")
        >>> sim = ShardedStateSim(n_qubits=20, mesh=mesh, device="cpu")
        >>> expvals = sim.expval_z(tape_fn, wires=[0, 19])

    The circuit is given as ``tape_fn(*args) -> List[Operation]``.  Every
    rank of the mesh calls the same methods with the same arguments.  The
    shard is real-split in *dtype* (float32 or float64) on *device* (the
    mesh's: the current card for a ``cuda`` mesh).
    """

    def __init__(self, n_qubits: int, mesh, axis: str = "state", *,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        self.n = n_qubits
        self.mesh = mesh
        self.axis = axis
        self.comm = _Axis(mesh, axis)
        D = self.comm.D
        g = int(math.log2(D))
        if 2**g != D:
            raise ValueError(f"state axis size must be a power of two, got {D}")
        if g > n_qubits:
            raise ValueError("more state shards than qubits")
        self.g = g
        self.dtype = dtype
        device = torch.device(mesh.device_type if device is None else device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if (device.type == "cuda" and dist.get_backend(self.comm.group) == "nccl"
                and device.index != torch.cuda.current_device()):
            raise ValueError(
                f"shards on {device}, but this rank's current card is "
                f"cuda:{torch.cuda.current_device()}: NCCL exchanges on the current card "
                "(call torch.cuda.set_device(rank) before init_process_group)")
        self.device = device
        # The adjoint walk undoes each window by its dagger: unitary tapes
        # only.  The density engine clears this.
        self.adjointable = True

    @property
    def staged(self) -> bool:
        """Whether this sim's collectives stage through pinned host memory."""
        return self.comm.staged

    # ---------------------------------------------------------------- core
    def _live_ops(self, ops: Sequence[Operation]) -> List[Operation]:
        ops = [op for op in ops if not isinstance(op, Barrier)]
        for op in ops:
            if isinstance(op, KrausChannel):
                raise ShardingUnavailable(
                    "This simulator is statevector-only; noise channels "
                    "route through the sharded density engine "
                    "(parallel.ShardedDensitySim)."
                )
        return _fused_ops(ops, self.n, self.g, dtype=cdtype(self.dtype), device=self.device)

    def _plan_of(self, fused: Sequence[Operation]) -> _LayoutPlan:
        global TRACE_COUNT
        TRACE_COUNT += 1
        return _plan_layout([list(op.wires) for op in fused], self.n, self.g)

    def _host_plan(self, tape_fn: Callable, *args) -> _LayoutPlan:
        """Record the tape on the host and build the static layout plan."""
        return self._plan_of(self._live_ops(tape_fn(*_frozen(args))))

    def _measurement_exchange(
        self, order: Sequence[int], wires: Sequence[int]
    ) -> Tuple[Tuple[Tuple[int, int], ...], Tuple[int, ...]]:
        """One grouped exchange bringing *wires* local after the circuit
        (victims: the highest free local positions).  Returns the pairs and
        the post-exchange order."""
        order = list(order)
        pos = {q: p for p, q in enumerate(order)}
        global_ws = [w for w in wires if pos[w] < self.g]
        pairs: List[Tuple[int, int]] = []
        if global_ws:
            protected = set(wires)
            cands = [p for p in range(self.g, self.n) if order[p] not in protected]
            if len(cands) < len(global_ws):
                raise ShardingUnavailable(
                    "Observable support too wide for the sharded layout: "
                    f"{len(global_ws)} global bits but only {len(cands)} "
                    "free local positions."
                )
            cands.sort(reverse=True)
            for w, victim in zip(global_ws, cands):
                gpos = pos[w]
                pairs.append((gpos, victim))
                order[gpos], order[victim] = order[victim], order[gpos]
                pos[order[gpos]] = gpos
                pos[order[victim]] = victim
        return tuple(pairs), tuple(order)

    def _plan_obs(self, observables: Sequence, order: Sequence[int]) -> Tuple[_ObsSpec, ...]:
        """Measurement specs for ints (single-qubit Z), wire tuples (Z-parity
        words) and :class:`Operation` observables."""
        specs: List[_ObsSpec] = []
        for ob in observables:
            if isinstance(ob, int):
                specs.append(_ObsSpec("zword", (ob,), (), (), None))
                continue
            if isinstance(ob, tuple):
                specs.append(_ObsSpec("zword", reduce_zword(ob), (), (), None))
                continue
            w = zword_of(ob)
            if w is not None:
                specs.append(_ObsSpec("zword", reduce_zword(w), (), (), None))
                continue
            pairs, new_order = self._measurement_exchange(order, list(ob.wires))
            pos = {q: p for p, q in enumerate(new_order)}
            axes = tuple(pos[w] - self.g for w in ob.wires)
            specs.append(_ObsSpec("general", (), pairs, axes, ob))
        return tuple(specs)

    def _zero_local(self, batch: Optional[int]) -> torch.Tensor:
        lead = () if batch is None else (batch,)
        local = torch.zeros((2,) + lead + (2 ** (self.n - self.g),), dtype=self.dtype,
                            device=self.device)
        if self.comm.d == 0:
            local[0, ..., 0] = 1.0
        return local

    def _simulate_local(self, fused: List[Operation], plan: _LayoutPlan,
                        via_ppermute: bool = False, batch: Optional[int] = None
                        ) -> torch.Tensor:
        """Run the fused tape on the local shard following the static plan:
        ``(2, [batch,] 2**(n-g))``."""
        nl = self.n - self.g
        local = self._zero_local(batch)
        exchanges = tuple(step.exchange for step in plan.steps)
        lplan = [("diag" if isinstance(op, DiagonalQubitUnitary) else "mat",
                  op.diag if isinstance(op, DiagonalQubitUnitary) else op.matrix,
                  list(step.local_axes)) for op, step in zip(fused, plan.steps)]
        grad = torch.is_grad_enabled() and any(
            isinstance(p, torch.Tensor) and p.requires_grad for _, p, _ in lplan)

        if batch is None and ADJOINT and self.adjointable:
            static, payloads = adjoint.normalize_plan(lplan, nl)
            payloads = [p.to(device=self.device, dtype=self.dtype).contiguous()
                        for p in payloads]
            meta = _Local(static, exchanges, nl, self.comm, via_ppermute)
            if not grad:
                return _run_local(local, payloads, meta)
            return _ShardedPlan.apply(local, meta, *payloads)

        pays = [kernels._pair_of(p, local, vector=(kind == "diag")).contiguous()
                for kind, p, _ in lplan]
        pays = _replicated(pays, self.comm)

        def apply_range(x, seg_pays, seg):
            for w2, (kind, _, axes), pairs in zip(seg_pays, lplan[seg], exchanges[seg]):
                if pairs:
                    x = _exchange(x, pairs, self.comm, via_ppermute)
                if kind == "diag":
                    x = kernels.apply_diagonal_pair_ri(x, w2, axes, nl)
                else:
                    x = kernels.apply_matrix_pair_ri(x, w2, axes, nl)
            return x

        T = len(lplan)
        if T < CHECKPOINT_MIN_STEPS or not grad:
            return apply_range(local, pays, slice(0, T))
        seg = max(math.isqrt(T), 1)
        for start in range(0, T, seg):
            part = slice(start, min(start + seg, T))

            def seg_fn(x, *seg_pays, _part=part):
                return apply_range(x, seg_pays, _part)

            local = checkpoint(seg_fn, local, *pays[part], use_reentrant=False)
        return local

    def _global_sign(self, order: Sequence[int], logical: int) -> float:
        """±1 sign of a Z on a sharded qubit, constant on this rank."""
        p = list(order).index(logical)
        return 1.0 - 2.0 * ((self.comm.d >> (self.g - 1 - p)) & 1)

    def _local_zword_val(self, probs: torch.Tensor, word: Sequence[int],
                         order: Sequence[int]) -> torch.Tensor:
        """This rank's partial of ``<Z_{w1} Z_{w2} ...>``: signs for sharded
        factors, the ``(1, -1)`` fold of the shard for local ones."""
        g = self.g
        sign = 1.0
        weights: List = [None] * (self.n - g)
        for w in word:
            p = list(order).index(w)
            if p < g:
                sign *= self._global_sign(order, w)
            else:
                weights[p - g] = (1.0, -1.0)
        return sign * kernels.reduce_diagonal_expectation(probs, weights)

    def _local_general_val(self, local: torch.Tensor, spec: _ObsSpec,
                           via_ppermute: bool) -> torch.Tensor:
        """This rank's partial of ``<psi|O|psi>``: the planned exchange, O on
        its local axes, ``Re sum conj(psi) O psi``."""
        psi = _exchange(local, spec.exchange, self.comm, via_ppermute)
        w2 = kernels._pair_of(spec.op.matrix, psi)
        o_psi = kernels.apply_matrix_pair_ri(psi, w2, list(spec.local_axes), self.n - self.g)
        return (psi[0] * o_psi[0] + psi[1] * o_psi[1]).sum(-1)

    def _local_obs_vals(self, local: torch.Tensor, specs: Sequence[_ObsSpec],
                        order: Sequence[int], via_ppermute: bool) -> torch.Tensor:
        """Partials of every spec, stacked on the last axis."""
        probs = None
        vals = []
        for spec in specs:
            if spec.kind == "zword":
                if probs is None:
                    probs = local[0] ** 2 + local[1] ** 2
                vals.append(self._local_zword_val(probs, spec.word, order))
            else:
                vals.append(self._local_general_val(local, spec, via_ppermute))
        return torch.stack(vals, dim=-1)

    def _local_shot_expval(self, est: torch.Tensor, spec: _ObsSpec, order: Sequence[int],
                           via_ppermute: bool = False) -> torch.Tensor:
        """Partial expval from an estimated-probability shard: the observable
        enters through its computational-basis diagonal only."""
        if spec.kind == "zword":
            return self._local_zword_val(est, spec.word, order)
        t = _exchange(est.unsqueeze(0), spec.exchange, self.comm, via_ppermute)[0]
        axes = list(spec.local_axes)
        srt = sorted(axes)
        marg = kernels.marginal_probs_on(t, srt, self.n - self.g)
        k = len(axes)
        diag = np.real(np.diagonal(spec.op.matrix.detach().cpu().numpy())).reshape((2,) * k)
        perm = [axes.index(a) for a in srt]
        d_sorted = np.transpose(diag, perm).reshape(-1)
        return marg @ torch.as_tensor(d_sorted, dtype=marg.dtype, device=marg.device)

    # ----------------------------------------------------------- programs
    def _scalar_slice(self, example_args: tuple, in_axes: Optional[Tuple]) -> tuple:
        """First batch element of *example_args*."""
        if in_axes is None:
            return example_args
        return tuple(_element(a, ax, 0) for a, ax in zip(example_args, in_axes))

    def _batch_tape(self, tape_fn: Callable, args: tuple, in_axes: Tuple
                    ) -> Optional[List[Operation]]:
        """The batch recorded once (batch-first arguments, gates with a
        leading batch axis, as the executor's vectorised route records it),
        or None when the circuit cannot be recorded so (its elements then
        run one by one)."""
        from qml_essentials_tpu_torch.ops import recipes

        try:
            ops = tape_fn(*(Script._batched_arg(a, ax) for a, ax in zip(args, in_axes)))
        except _NotVectorisable:
            return None
        except Exception:  # noqa: BLE001 - the element loop records what is real
            return None
        rows = recipes.batch_of(ops)
        return ops if rows in (None, _batch_size(args, in_axes)) else None

    def _program(self, tape_fn: Callable, example_args: tuple, in_axes: Optional[Tuple],
                 data_axis: Optional[str], readout: Callable) -> Callable:
        """A callable ``run(*args)``: record, fuse, (re)plan when the fused
        wire lists change, simulate the local shard and hand it to
        ``readout(local, plan, batched, via_ppermute, index)``, which
        answers batch-first.  A batch runs vectorised on ``(2, Bt,
        2**(n-g))`` shards, split over *data_axis* and gathered back;
        *readout* sees this rank's rows.  A batch that cannot be recorded
        at once runs element by element (*index* is then the element's row
        among this rank's)."""
        plans: Dict[tuple, _LayoutPlan] = {}

        def plan_for(fused):
            key = tuple(tuple(op.wires) for op in fused)
            plan = plans.get(key)
            if plan is None:
                plan = plans[key] = self._plan_of(fused)
            return plan

        plan_for(self._live_ops(tape_fn(*_frozen(self._scalar_slice(example_args, in_axes)))))

        def one(single_args, via_ppermute=False, index=None):
            fused = self._live_ops(tape_fn(*single_args))
            plan = plan_for(fused)
            return readout(self._simulate_local(fused, plan, via_ppermute), plan, False,
                           via_ppermute, index)

        def run(*args):
            if in_axes is None:
                return one(args)
            part, dax = args, None
            if data_axis is not None:
                part, dax, _ = _split_batch(self.mesh, data_axis, args, in_axes)
            ops = self._batch_tape(tape_fn, part, in_axes)
            if ops is None:
                B = _batch_size(part, in_axes)
                out = torch.stack([one(tuple(_element(a, ax, i) for a, ax in zip(part, in_axes)),
                                       True, i) for i in range(B)])
            else:
                from qml_essentials_tpu_torch.ops import recipes

                fused = self._live_ops(ops)
                plan = plan_for(fused)
                rows = recipes.batch_of(ops)
                local = self._simulate_local(fused, plan, True, rows)
                out = readout(local, plan, rows is not None, True, None)
                if rows is None:
                    out = out.expand((_batch_size(part, in_axes),) + tuple(out.shape))
            if dax is None:
                return out
            gathered = _Gather.apply(out, dax)
            return gathered.reshape((-1,) + tuple(gathered.shape[2:]))

        return run

    def expval_z(self, tape_fn: Callable, wires: Sequence[int], *args) -> torch.Tensor:
        """⟨Z_w⟩ (or a Z-parity word for a tuple entry) for each entry of
        *wires*; differentiable."""
        words = tuple((w,) if isinstance(w, int) else tuple(w) for w in wires)
        return self.build_expval_program(tape_fn, words, args)(*args)

    def expval(self, tape_fn: Callable, observables: Sequence, *args) -> torch.Tensor:
        """⟨O⟩ for each observable (ints, wire tuples, or Operations)."""
        return self.build_expval_program(tape_fn, tuple(observables), args)(*args)

    def build_expval_program(self, tape_fn: Callable, observables: Tuple, example_args: tuple,
                             in_axes: Optional[Tuple] = None,
                             data_axis: Optional[str] = None) -> Callable:
        """Program for expectation values: ``(n_obs,)``, or ``(B, n_obs)``
        with *in_axes* (the batch optionally split over *data_axis*)."""
        specs_of: Dict[tuple, tuple] = {}

        def readout(local, plan, batched, via_ppermute, index):
            order = plan.final_order
            specs = specs_of.get(order)
            if specs is None:
                specs = specs_of[order] = self._plan_obs(observables, order)
            partials = self._local_obs_vals(local, specs, order, via_ppermute)
            return _Sum.apply(partials, self.comm)

        return self._program(tape_fn, example_args, in_axes, data_axis, readout)

    def _unpermute(self, stacked: torch.Tensor, order: Sequence[int], batched: bool
                   ) -> torch.Tensor:
        """Device-major gathered amplitudes ``(..., 2**n)`` (Re/Im and a
        batch leading) -> logical qubit order."""
        n = self.n
        inv = [int(i) for i in np.argsort(order)]
        lead = tuple(stacked.shape[:-1])
        o = len(lead)
        x = stacked.reshape(lead + (2,) * n).permute(*range(o), *[i + o for i in inv])
        return x.reshape(stacked.shape)

    def _gathered_state(self, local: torch.Tensor, plan: _LayoutPlan, batched: bool
                        ) -> torch.Tensor:
        """The whole real-split state ``(2, [B,] 2**n)`` in logical order."""
        full = _Gather.apply(local, self.comm).movedim(0, -2)
        full = full.reshape(tuple(local.shape[:-1]) + (-1,))
        return self._unpermute(full, plan.final_order, batched)

    def build_shot_program(self, tape_fn: Callable, type: str, observables: Tuple, shots: int,
                           example_args: tuple, in_axes: Optional[Tuple] = None,
                           data_axis: Optional[str] = None) -> Callable:
        """Finite shots without gathering the state: every rank draws the
        same shard choices from the all-gathered shard masses (the same
        generator on every rank), then its own share of draws from its
        local distribution.  ``probs`` gathers the sharded histogram;
        ``expval`` folds each observable's diagonal against it and reduces.
        Returns ``fn(generator, *args)`` (a list of one generator per
        element when batched)."""
        if type not in ("probs", "expval"):
            raise ValueError(
                "Shot simulation is only supported for 'probs' and "
                f"'expval', got {type!r}."
            )
        specs_of: Dict[tuple, tuple] = {}
        draws: List = []

        def readout(local, plan, batched, via_ppermute, index):
            gens = draws[0] if index is None else [draws[0][index]]
            p_loc = (local[0] ** 2 + local[1] ** 2).detach()
            rows = p_loc if batched else p_loc.unsqueeze(0)
            masses = _all_gather(rows.sum(-1), self.comm)  # (D, rows)
            ests = []
            for i, p in enumerate(rows):
                gen = gens[i] if batched or index is not None else gens
                if gen is None:
                    gen = torch.Generator(device=p.device).manual_seed(0)
                elif gen.device != p.device:
                    gen = safe_random_split(gen, 1, device=p.device)[0]
                choice = torch.multinomial(masses[:, i].clamp_min(0), shots, replacement=True,
                                           generator=gen)
                seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
                mine = int((choice == self.comm.d).sum())
                counts = torch.zeros(p.shape[-1], dtype=p.dtype, device=p.device)
                if mine:
                    lg = torch.Generator(device=p.device).manual_seed(seed + self.comm.d)
                    picks = torch.multinomial(p.clamp_min(0), mine, replacement=True, generator=lg)
                    counts = torch.bincount(picks, minlength=p.shape[-1]).to(p.dtype)
                ests.append(counts / shots)
            est = torch.stack(ests) if batched else ests[0]
            if type == "probs":
                full = _all_gather(est, self.comm).movedim(0, -2)
                full = full.reshape(tuple(est.shape[:-1]) + (-1,))
                return self._unpermute(full, plan.final_order, batched)
            order = plan.final_order
            specs = specs_of.get(order)
            if specs is None:
                specs = specs_of[order] = self._plan_obs(observables, order)
            vals = torch.stack([self._local_shot_expval(est, s, order, via_ppermute)
                                for s in specs], dim=-1)
            return _all_reduce(vals, self.comm)

        program = self._program(tape_fn, example_args, in_axes, data_axis, readout)

        def run(generator, *args):
            gens = generator
            if in_axes is not None and data_axis is not None:
                dax = _Axis(self.mesh, data_axis)
                bl = len(gens) // dax.D
                gens = list(gens)[dax.d * bl:(dax.d + 1) * bl]
            draws[:] = [gens]
            with torch.no_grad():
                return program(*args)

        return run

    def sample(self, tape_fn: Callable, type: str, observables: Sequence, shots: int,
               generator, *args) -> torch.Tensor:
        """One-shot helper around :meth:`build_shot_program`."""
        return self.build_shot_program(tape_fn, type, tuple(observables), shots, args
                                       )(generator, *args)

    def _build_state_ri(self, tape_fn: Callable, example_args: tuple,
                        in_axes: Optional[Tuple] = None,
                        data_axis: Optional[str] = None) -> Callable:
        """Program returning the whole real-split state in logical order."""

        def readout(local, plan, batched, via_ppermute, index):
            x = self._gathered_state(local, plan, batched)
            return x.movedim(0, 1) if batched else x

        return self._program(tape_fn, example_args, in_axes, data_axis, readout)

    def build_state_program(self, tape_fn: Callable, example_args: tuple,
                            in_axes: Optional[Tuple] = None,
                            data_axis: Optional[str] = None) -> Callable:
        """Program returning the complex statevector in logical qubit order,
        ``(2**n,)`` or ``(B, 2**n)`` (every rank gathers it)."""
        fn = self._build_state_ri(tape_fn, example_args, in_axes, data_axis)

        def run(*args):
            ri = fn(*args)
            return kernels.from_ri(ri.movedim(1, 0) if in_axes is not None else ri)

        return run

    def build_probs_program(self, tape_fn: Callable, example_args: tuple,
                            in_axes: Optional[Tuple] = None,
                            data_axis: Optional[str] = None) -> Callable:
        """Program for the full probability vector (logical order)."""
        fn = self._build_state_ri(tape_fn, example_args, in_axes, data_axis)

        def run(*args):
            ri = fn(*args)
            if in_axes is not None:
                ri = ri.movedim(1, 0)
            return ri[0] ** 2 + ri[1] ** 2

        return run

    def state(self, tape_fn: Callable, *args) -> torch.Tensor:
        """Full statevector in logical qubit order (one-shot helper)."""
        return self.build_state_program(tape_fn, args)(*args)

    def probs(self, tape_fn: Callable, *args) -> torch.Tensor:
        """Full probability vector in logical qubit order."""
        return self.build_probs_program(tape_fn, args)(*args)


def sharded_expval_z(tape_fn: Callable, n_qubits: int, wires: Sequence[int], mesh=None,
                     axis: str = "state", *args) -> torch.Tensor:
    """One-shot helper: ⟨Z⟩ on *wires* with the state sharded over *mesh*
    (the configured one when None)."""
    from qml_essentials_tpu_torch import parallel as _parallel

    mesh = mesh if mesh is not None else _parallel.get_mesh()
    if mesh is None:
        raise ValueError("No mesh configured; call parallel.set_mesh first.")
    return ShardedStateSim(n_qubits, mesh, axis).expval_z(tape_fn, wires, *args)
