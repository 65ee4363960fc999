"""Distributed density-matrix simulation over the interleaved doubled register.

The single-device density engine lowers an n-qubit noisy tape to a pure
tape on 2n wires with ket and bra bits interleaved (data qubit ``w`` owns
doubled wires ``2w`` and ``2w+1``; every gate becomes ``U ⊗ conj(U)``, every
Kraus channel one superoperator:
:func:`~qml_essentials_tpu_torch.ops.simulation._lower_interleaved_tape`).
The doubled register is a 2n-qubit state, so
:class:`~qml_essentials_tpu_torch.parallel.state_sharding.ShardedStateSim`
runs it sharded over the ``state`` axis: the same layout planner,
exchanges and window kernels.

Measurements never gather the density matrix:

* ``probs`` and diagonal expvals read the pair diagonal (every (ket, bra)
  bit pair equal) off each shard.  Under the physical layout a data qubit's
  pair is both local (a ``torch.diagonal``), both sharded (the rank holds
  diagonal entries only when its two index bits agree) or split (the local
  bit indexed at the rank's sharded bit).  ``probs`` gathers the ``2**k``
  selected entries of each rank and one host-built index puts them in
  logical order.
* A general Hermitian measures ``Tr(O ρ_S)``: one planned exchange brings
  its qubits' pairs local, the pair selection with those pairs kept
  partial-traces the rest, the local ``ρ_S`` contracts against ``O`` and
  the ranks' partials are summed.
* Finite shots draw from the gathered exact ``probs`` (a ``2**n`` vector),
  with diagonal-only expvals.
* ``density`` gathers the doubled state and de-interleaves it: the matrix is
  the requested output.

Gradients run through the kernels' own backwards (``adjointable = False``:
a superoperator is not undone by its dagger), the replicated payloads'
gradients summed over the state group.

Counterpart of ``qml_essentials_tpu/parallel/density_sharding.py``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.ops import kernels
from qml_essentials_tpu_torch.ops.dtypes import cdtype  # noqa: F401
from qml_essentials_tpu_torch.ops.operations import Operation
from qml_essentials_tpu_torch.parallel.state_sharding import (  # noqa: F401
    ShardedStateSim,
    ShardingUnavailable,
    _exchange,
    _Gather,
    _Sum,
    reduce_zword,
    zword_of,
)

logger = logging.getLogger(__name__)


class _PairLayout(NamedTuple):
    """Each data qubit's (ket, bra) wire pair under the physical order:
    ``local`` pairs have both bits on local axes, ``glob`` both in the rank
    index, ``mixed`` one in each."""

    local: Tuple[Tuple[int, int, int], ...]  # (w, axis_ket, axis_bra)
    glob: Tuple[Tuple[int, int, int], ...]  # (w, pos_ket, pos_bra)
    mixed: Tuple[Tuple[int, int, int], ...]  # (w, global_pos, local_axis)


def _classify_pairs(
    order: Sequence[int], n: int, g: int, keep: frozenset
) -> Tuple[_PairLayout, Tuple[Tuple[int, int, int], ...]]:
    """Split the data-qubit pairs into layout classes; *keep* pairs stay
    whole and must be local (returned as ``(w, axis_ket, axis_bra)``)."""
    pos = {q: p for p, q in enumerate(order)}
    local, glob, mixed, kept = [], [], [], []
    for w in range(n):
        pk, pb = pos[2 * w], pos[2 * w + 1]
        if w in keep:
            if pk < g or pb < g:
                raise ShardingUnavailable(
                    f"observable qubit {w} has a sharded ket/bra bit after "
                    "the measurement exchange"
                )
            kept.append((w, pk - g, pb - g))
            continue
        if pk >= g and pb >= g:
            local.append((w, pk - g, pb - g))
        elif pk < g and pb < g:
            glob.append((w, pk, pb))
        else:
            gp, la = (pk, pb - g) if pk < g else (pb, pk - g)
            mixed.append((w, gp, la))
    return _PairLayout(tuple(local), tuple(glob), tuple(mixed)), tuple(kept)


def _device_bit(d: int, g: int, p: int) -> int:
    """Bit of rank index *d* at sharded physical position *p*."""
    return (d >> (g - 1 - p)) & 1


def _pair_select(
    local: torch.Tensor,
    layout: _PairLayout,
    kept: Tuple[Tuple[int, int, int], ...],
    d: int,
    g: int,
    lead: int = 0,
) -> Tuple[torch.Tensor, Optional[float], List[int], List[Tuple[int, int, int]]]:
    """Select the shard's pair-diagonal entries, kept pairs untouched.

    *local* is ``lead_dims + (2,) * (2n - g)`` (*lead* leading axes: Re/Im,
    a batch).  Returns ``(x, mask, diag_qubits, kept_axes)``: ``x`` with the
    kept pairs' axes first (in their surviving order) and one trailing
    diagonal axis per ``local`` pair in ascending-qubit order; ``mask`` the
    0/1 validity of this rank from both-sharded pairs (``None``: valid);
    ``diag_qubits`` the qubit of each trailing axis; ``kept_axes`` the kept
    pairs' ``(w, ket_axis, bra_axis)`` after the lead.
    """
    alive: List = list(range(local.dim() - lead))
    for w, gp, la in sorted(layout.mixed, key=lambda t: -t[2]):
        cur = alive.index(la)
        local = local.select(lead + cur, _device_bit(d, g, gp))
        alive.pop(cur)

    diag_qubits: List[int] = []
    for w, ak, ab in sorted(layout.local):
        c1, c2 = alive.index(ak), alive.index(ab)
        local = torch.diagonal(local, dim1=lead + c1, dim2=lead + c2)
        for c in sorted((c1, c2), reverse=True):
            alive.pop(c)
        alive.append(("diag", w))
        diag_qubits.append(w)

    mask = None
    for w, pk, pb in layout.glob:
        eq = float(_device_bit(d, g, pk) == _device_bit(d, g, pb))
        mask = eq if mask is None else mask * eq

    kept_axes = [(w, alive.index(ak), alive.index(ab)) for w, ak, ab in kept]
    return local, mask, diag_qubits, kept_axes


class _DensObs(NamedTuple):
    """Static measurement spec of one observable on the doubled register."""

    kind: str  # "zword" | "general"
    word: Tuple[int, ...]
    exchange: Tuple[Tuple[int, int], ...]
    order: Tuple[int, ...]  # physical order after the exchange
    op: Optional[Operation]


def _shot_diags(observables: Sequence) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """``(wires, diagonal)`` of each observable for diagonal-only shot
    expvals (ints and wire tuples are Z-words)."""
    out = []
    for ob in observables:
        if isinstance(ob, int):
            word, op_obj = (ob,), None
        elif isinstance(ob, tuple):
            word, op_obj = reduce_zword(ob), None
        else:
            word, op_obj = zword_of(ob), ob
            if word is not None:
                word = reduce_zword(word)
        if word is not None:
            diag = np.ones(1)
            wires = list(word)
            for _ in wires:
                diag = np.kron(diag, np.array([1.0, -1.0]))
        else:
            wires = list(op_obj.wires)
            diag = np.real(np.diagonal(op_obj.matrix.detach().cpu().numpy()))
        out.append((tuple(wires), diag))
    return out


class ShardedDensitySim:
    """Density-matrix simulator sharded over a mesh axis: the interleaved
    doubled register run by :class:`ShardedStateSim` on ``2 * n_qubits``
    wires.  Tapes with no contiguous doubled form raise
    :class:`ShardingUnavailable` at plan time."""

    def __init__(self, n_qubits: int, mesh, axis: str = "state", *,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        self.n = n_qubits
        self.inner = ShardedStateSim(2 * n_qubits, mesh, axis, dtype=dtype, device=device)
        self.inner.adjointable = False  # superoperators are not unitary
        self.mesh = mesh
        self.axis = axis
        self.g = self.inner.g

    # ---------------------------------------------------------------- plan
    def _lowered_fn(self, tape_fn: Callable) -> Callable:
        """*tape_fn* lowered to the 2n-wire interleaved tape."""
        from qml_essentials_tpu_torch.ops import simulation as _sim

        n, g = self.n, self.g
        local_width = 2 * n - g

        def lowered(*args) -> List[Operation]:
            dtape = _sim._lower_interleaved_tape(list(tape_fn(*args)), n)
            if dtape is None:
                raise ShardingUnavailable(
                    "tape has no interleaved doubled form (wide gate, "
                    "diagonal or channel); use the single-device density path"
                )
            for op in dtape:
                if len(op.wires) > local_width:
                    raise ShardingUnavailable(
                        f"doubled operator on {len(op.wires)} wires exceeds "
                        f"the local shard width {local_width}"
                    )
            return dtape

        return lowered

    def _plan(self, lowered_fn: Callable, *args):
        return self.inner._host_plan(lowered_fn, *args)

    def _plan_obs(self, observables: Sequence, order: Sequence[int]) -> Tuple[_DensObs, ...]:
        """Specs: ints, wire tuples and I/Z-labelled Operations are Z-words;
        any other Operation a pair exchange plus a local ``Tr(O ρ_S)``."""
        specs: List[_DensObs] = []
        for ob in observables:
            if isinstance(ob, int):
                specs.append(_DensObs("zword", (ob,), (), tuple(order), None))
                continue
            if isinstance(ob, tuple):
                specs.append(_DensObs("zword", reduce_zword(ob), (), tuple(order), None))
                continue
            w = zword_of(ob)
            if w is not None:
                specs.append(_DensObs("zword", reduce_zword(w), (), tuple(order), None))
                continue
            pair_wires = [b for q in ob.wires for b in (2 * q, 2 * q + 1)]
            pairs, new_order = self.inner._measurement_exchange(order, pair_wires)
            specs.append(_DensObs("general", (), pairs, tuple(new_order), ob))
        return tuple(specs)

    def _planes(self, local: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """The shard ``(2, [B,] 2**nl)`` as ``(2, [B,]) + (2,) * nl``, and
        the number of leading axes."""
        lead = tuple(local.shape[:-1])
        nl = 2 * self.n - self.g
        return local.reshape(lead + (2,) * nl), len(lead)

    # ----------------------------------------------------------- local math
    def _local_zword_val(self, local: torch.Tensor, word: Sequence[int],
                         order: Sequence[int]) -> torch.Tensor:
        """This rank's partial of ``Tr(Z_word ρ)`` off the pair diagonal
        (the real plane: the diagonal of ρ is real)."""
        x, o = self._planes(local[0])
        d, g = self.inner.comm.d, self.g
        layout, _ = _classify_pairs(order, self.n, g, frozenset())
        x, mask, diag_qubits, _ = _pair_select(x, layout, (), d, g, o)
        word = set(word)
        sign = 1.0
        for w, pk, _ in layout.glob:
            if w in word:
                sign *= 1.0 - 2.0 * _device_bit(d, g, pk)
        for w, gp, _ in layout.mixed:
            if w in word:
                sign *= 1.0 - 2.0 * _device_bit(d, g, gp)
        for i, w in enumerate(diag_qubits):
            if w in word:
                shape = [1] * x.dim()
                shape[o + i] = 2
                x = x * torch.tensor([1.0, -1.0], dtype=x.dtype, device=x.device).reshape(shape)
        val = x.reshape(tuple(x.shape[:o]) + (-1,)).sum(-1) * sign
        return val if mask is None else val * mask

    def _local_general_val(self, local: torch.Tensor, spec: _DensObs,
                           via_ppermute: bool = False) -> torch.Tensor:
        """This rank's partial of ``Tr(O ρ)`` (the sum over ranks completes
        the trace)."""
        x = _exchange(local, spec.exchange, self.inner.comm, via_ppermute)
        x, o = self._planes(x)
        keep = frozenset(spec.op.wires)
        layout, kept = _classify_pairs(spec.order, self.n, self.g, keep)
        x, mask, _, kept_axes = _pair_select(x, layout, kept, self.inner.comm.d, self.g, o)
        kept_set = {a for _, ak, ab in kept_axes for a in (ak, ab)}
        sum_axes = tuple(o + a for a in range(x.dim() - o) if a not in kept_set)
        rho = x.sum(dim=sum_axes) if sum_axes else x
        remap = {a: i for i, a in enumerate(sorted(kept_set))}
        by_qubit = {w: (remap[ak], remap[ab]) for w, ak, ab in kept_axes}
        perm = ([by_qubit[q][0] for q in spec.op.wires]
                + [by_qubit[q][1] for q in spec.op.wires])
        m = len(spec.op.wires)
        rho = rho.permute(*range(o), *(o + p for p in perm))
        rho = rho.reshape(tuple(rho.shape[:o]) + (2**m, 2**m)).transpose(-1, -2)
        w2 = kernels._pair_of(spec.op.matrix, rho)
        val = (w2[0] * rho[0] - w2[1] * rho[1]).sum(dim=(-2, -1))
        return val if mask is None else val * mask

    # ------------------------------------------------------------ programs
    def build_expval_program(self, tape_fn: Callable, observables: Tuple, example_args: tuple,
                             in_axes: Optional[Tuple] = None,
                             data_axis: Optional[str] = None) -> Callable:
        """Program for ``Tr(O ρ)``: ``(n_obs,)``, or ``(B, n_obs)`` with
        *in_axes* (the batch optionally split over *data_axis*)."""
        lowered = self._lowered_fn(tape_fn)
        specs_of: dict = {}

        def readout(local, plan, batched, via_ppermute, index):
            order = plan.final_order
            specs = specs_of.get(order)
            if specs is None:
                specs = specs_of[order] = self._plan_obs(observables, order)
            vals = [self._local_zword_val(local, s.word, order) if s.kind == "zword"
                    else self._local_general_val(local, s, via_ppermute) for s in specs]
            return _Sum.apply(torch.stack(vals, dim=-1), self.inner.comm)

        return self.inner._program(lowered, example_args, in_axes, data_axis, readout)

    def _probs_sel(self, order: Sequence[int], diag_qubits: Sequence[int]) -> np.ndarray:
        """Index of each logical diagonal entry in the rank-major gathered
        selections: the sharded bits pin the rank, the ``local`` pairs'
        values index its trailing diagonal axes."""
        n, g = self.n, self.g
        k = len(diag_qubits)
        xs = np.arange(2**n, dtype=np.int64)
        v = [(xs >> (n - 1 - w)) & 1 for w in range(n)]
        d = np.zeros_like(xs)
        for p in range(g):
            d |= v[order[p] // 2] << (g - 1 - p)
        j = np.zeros_like(xs)
        for i, w in enumerate(diag_qubits):
            j |= v[w] << (k - 1 - i)
        return d * (2**k) + j

    def build_probs_program(self, tape_fn: Callable, example_args: tuple,
                            in_axes: Optional[Tuple] = None,
                            data_axis: Optional[str] = None) -> Callable:
        """Exact ``probs`` (the ``2**n`` pair diagonal, logical order): each
        rank's ``2**k`` selected entries, one all-gather, one index."""
        lowered = self._lowered_fn(tape_fn)
        sels: dict = {}

        def readout(local, plan, batched, via_ppermute, index):
            order = plan.final_order
            layout, _ = _classify_pairs(order, self.n, self.g, frozenset())
            x, o = self._planes(local[0])
            x, _, diag_qubits, _ = _pair_select(x, layout, (), self.inner.comm.d, self.g, o)
            x = x.reshape(tuple(x.shape[:o]) + (-1,))
            sel = sels.get(order)
            if sel is None:
                sel = sels[order] = torch.as_tensor(self._probs_sel(order, diag_qubits),
                                                    device=x.device)
            stacked = _Gather.apply(x, self.inner.comm).movedim(0, -2)  # ([B,] D, 2**k)
            return stacked.reshape(tuple(x.shape[:-1]) + (-1,)).index_select(-1, sel)

        return self.inner._program(lowered, example_args, in_axes, data_axis, readout)

    def build_density_program(self, tape_fn: Callable, example_args: tuple,
                              in_axes: Optional[Tuple] = None,
                              data_axis: Optional[str] = None) -> Callable:
        """Full ``(2**n, 2**n)`` density matrix (``(B, 2**n, 2**n)``
        batched): the gathered doubled state, de-interleaved."""
        from qml_essentials_tpu_torch.ops import simulation as _sim

        state_fn = self.inner._build_state_ri(self._lowered_fn(tape_fn), example_args,
                                              in_axes=in_axes, data_axis=data_axis)
        dim = 2**self.n

        def run(*args):
            ri = state_fn(*args)  # interleaved logical order, batch-first
            if in_axes is not None:
                ri = ri.movedim(1, 0)
            ri = ri.index_select(-1, _sim._deinterleave_index(self.n, ri.device))
            return kernels.from_ri(ri).reshape(tuple(ri.shape[1:-1]) + (dim, dim))

        return run

    def density(self, tape_fn: Callable, *args) -> torch.Tensor:
        """One-shot helper around :meth:`build_density_program`."""
        return self.build_density_program(tape_fn, args)(*args)

    def build_shot_program(self, tape_fn: Callable, type: str, observables: Tuple, shots: int,
                           example_args: tuple, in_axes: Optional[Tuple] = None,
                           data_axis: Optional[str] = None) -> Callable:
        """Finite shots from the gathered exact ``probs`` with diagonal-only
        expvals; ``fn(generator, *args)`` (one generator per element when
        batched)."""
        from qml_essentials_tpu_torch.ops import simulation as _sim

        if type not in ("probs", "expval"):
            raise ShardingUnavailable(
                f"sharded density shots support probs/expval, not {type!r}"
            )
        probs_fn = self.build_probs_program(tape_fn, example_args, in_axes=in_axes,
                                            data_axis=data_axis)
        diags = _shot_diags(observables) if type == "expval" else []
        n = self.n

        def sample_one(gen, p):
            est = _sim._draw(p, shots, gen, 2**n)
            if type == "probs":
                return est
            vals = []
            for wires, diag in diags:
                srt = sorted(wires)
                marg = kernels.marginal_probs_on(est, srt, n)
                perm = [list(wires).index(a) for a in srt]
                d_sorted = np.transpose(diag.reshape((2,) * len(wires)), perm).reshape(-1)
                vals.append(marg @ torch.as_tensor(d_sorted, dtype=est.dtype, device=est.device))
            return torch.stack(vals)

        def run(generator, *args):
            with torch.no_grad():
                p = probs_fn(*args)
            if in_axes is None:
                return sample_one(generator, p)
            return torch.stack([sample_one(gen, row) for gen, row in zip(generator, p)])

        return run
