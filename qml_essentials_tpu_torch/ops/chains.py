"""Chain planner: whole-region single-pass execution groups.

Groups a tape's gates into **chain steps**: each step applies a whole
sequence of windows and diagonals to a block of the flat state that holds
a wide contiguous *bit span*, in one launch of the chain kernel
(``cuda_kernels.chain_apply``; its adjoint is ``cuda_kernels.adjoint_chain``):

- geometry ``"L"``: block = state bits ``[0, CHAIN_SL)`` (the 17 low bits =
  the 17 *highest* wires — the flat state is big-endian, wire 0 = MSB).
  Windows on bits ``[0, 8)``/``[0, 9)`` are minor-axis products; windows
  inside ``[7, SL)`` are row products.
- geometry ``"H"``: block = state bits ``[n-8, n)`` (the 8 lowest wires) as
  rows, with column chunks of the remaining bits.  Windows are row
  products.  Diagonals on *any* bits apply in either geometry.

Ring-wrap entanglers (e.g. ``CRX(n-1, 0)`` — one wire in each region) are
transpiled into (1q conjugators) · (two-bit diagonal) · (1q conjugators)†:
the conjugators absorb into the neighbouring windows of their own region
and the diagonal is an elementwise pattern inside either pass.

The planner is conservative: anything it cannot express (wide diagonals,
gates straddling regions without a known conjugator decomposition) makes
:func:`plan_chains` return ``None`` and the caller falls back to the
scheduled window plan.  It is off by default (``simulation.USE_CHAINS``).

Counterpart of ``qml_essentials_tpu/ops/chains.py``, descriptor for
descriptor; payloads are complex tensors in the plan's dtype, on its device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.ops import cuda_kernels
from qml_essentials_tpu_torch.ops.kernels import bkron
from qml_essentials_tpu_torch.ops.recipes import lazy
from qml_essentials_tpu_torch.ops.operations import (
    Barrier,
    DiagonalQubitUnitary,
    Id,
    KrausChannel,
    Operation,
)

# Bit span of the "L" geometry block.
CHAIN_SL: int = 17

# Bit width of the "H" geometry block (the low-wire rows).
CHAIN_HB: int = 8

# Maximum diagonal arity of a chain descriptor.
_MAX_DIAG_BITS: int = 2

# Conjugators K with K Z K^dag = P for each Pauli letter.
_H = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2.0)
_S = np.array([[1, 0], [0, 1j]], dtype=np.complex64)
_CONJ = {
    "I": None,
    "Z": None,
    "X": _H,
    "Y": _S @ _H,
}

# Gate classes that are exactly diagonal in the computational basis.
_DIAGONAL_CLASSES = {"CZ", "CRZ", "ControlledPhaseShift", "RZZ"}


def _bit(w: int, n: int) -> int:
    """Flat-state bit position of wire *w* (big-endian: wire 0 = MSB)."""
    return n - 1 - w


def _conjugator_letters(op: Operation) -> Optional[List[str]]:
    """Per-wire Pauli letters whose conjugators diagonalise *op*, or None.

    Covers the entangler zoo: controlled rotations / controlled Paulis
    (conjugator on the target only) and two-qubit Pauli rotations
    (conjugator per target letter).
    """
    name = op.__class__.__name__
    if name in _DIAGONAL_CLASSES:
        return ["I"] * len(op.wires)
    word = getattr(op, "pauli_word", None)
    n_controls = getattr(op, "n_controls", 0)
    if word is not None and n_controls == 1 and len(word) == 1:
        return ["I", word]  # CRX / CRY / CRZ / ControlledPauliRot(1, 1)
    if word is not None and n_controls == 0 and len(word) == len(op.wires):
        return list(word)  # RXX / RYY / RZZ / RZX / 2q PauliRot
    if name in ("CX", "CY"):
        return ["I", name[1]]
    return None


def _seam_diagonal(kron: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """The diagonal of ``kron^dag mat kron`` (per element of a batched
    gate), with the conjugators in the gate's dtype and on its device."""
    kron = kron.to(device=mat.device, dtype=mat.dtype)
    return torch.diagonal(kron.conj().T @ mat @ kron, dim1=-2, dim2=-1)


def _diag_sorted(d: torch.Tensor, order: Optional[list], k: int, device, dtype) -> torch.Tensor:
    """A diagonal in *dtype* on *device*, its wires reordered ascending."""
    d = d.to(device=device, dtype=dtype)
    if order is not None:
        lead = tuple(d.shape[:-1])
        o = len(lead)
        d = d.reshape(lead + (2,) * k).permute(*range(o), *[o + i for i in order])
        d = d.reshape(lead + (-1,))
    return d


def _decompose_seam(op: Operation) -> Optional[list]:
    """Split a two-qubit gate into (conjugators, diagonal, conjugators^dag).

    Returns ``[(kind, payload, wires), ...]`` pseudo-items in application
    order, or ``None`` when the gate has no known conjugator form.  The
    diagonal is computed from the gate's matrix, so autograd reaches the
    gate's parameter.
    """
    if len(op.wires) != 2:
        return None
    letters = _conjugator_letters(op)
    if letters is None:
        return None
    ks = [None if _CONJ[c] is None else torch.as_tensor(_CONJ[c], dtype=torch.complex128)
          for c in letters]
    kmats = [torch.eye(2, dtype=torch.complex128) if k is None else k for k in ks]
    kron = torch.kron(kmats[0], kmats[1])
    d4 = lazy(_seam_diagonal, kron, op.matrix)

    items: list = []
    for w, k in zip(op.wires, ks):
        if k is not None:
            items.append(("mat", k.conj().T, [w]))
    items.append(("diag", d4, list(op.wires)))
    for w, k in zip(op.wires, ks):
        if k is not None:
            items.append(("mat", k, [w]))
    return items


# ---------------------------------------------------------------------------
# Group assignment (greedy with disjoint-support commutation)
# ---------------------------------------------------------------------------


class _Group:
    __slots__ = ("region", "items", "support")

    def __init__(self, region: str) -> None:
        self.region = region
        self.items: list = []
        self.support: set = set()

    def add(self, item) -> None:
        self.items.append(item)
        self.support |= set(item[2])


def _regions_of(kind: str, wires: Sequence[int], n: int) -> List[str]:
    """Geometries whose resident span covers this item's wires."""
    if kind == "diag":
        return ["L", "H"]  # diagonals apply in either geometry
    regions = []
    if all(w >= n - CHAIN_SL for w in wires):
        regions.append("L")
    if all(w < CHAIN_HB for w in wires):
        regions.append("H")
    return regions


def _assign_groups(items: list, n: int) -> Optional[List[_Group]]:
    """Greedy placement into region groups, commuting over disjoint ones.

    An item may join any group of a matching region as long as its support
    is disjoint from every *later* group's support (disjoint unitaries
    commute, so hopping over them preserves semantics).
    """
    groups: List[_Group] = []
    for item in items:
        kind, _, wires = item
        regions = _regions_of(kind, wires, n)
        if not regions:
            return None
        support = set(wires)
        placed = False
        # A cross-region (ring-wrap) diagonal goes to an H group (its
        # windows are narrow row products), a fresh one if ordering forbids
        # joining.
        wrap_diag = kind == "diag" and any(w < CHAIN_HB for w in wires) and any(
            w >= CHAIN_HB for w in wires)
        accept = ["H"] if wrap_diag else regions
        blocked: set = set()
        for i in range(len(groups) - 1, -1, -1):
            if groups[i].region in accept and not (support & blocked):
                groups[i].add(item)
                placed = True
                break
            blocked |= groups[i].support
            if support & blocked:
                break  # no earlier group can accept it either
        if not placed:
            g = _Group("H" if wrap_diag else regions[0])
            g.add(item)
            groups.append(g)
    return groups


# ---------------------------------------------------------------------------
# Per-group fusion into chain descriptors
# ---------------------------------------------------------------------------


def _span_valid(lo: int, hi: int, region: str, n: int) -> bool:
    """Window-geometry validity of a *bit* span [lo, hi)."""
    if region == "H":
        return n - CHAIN_HB <= lo and hi <= n and hi - lo <= 8
    # L geometry: minor windows [0, 8); row windows inside [7, SL).
    if lo < 7:
        return lo == 0 and hi <= 8  # snapped minor window
    return hi <= CHAIN_SL and hi - lo <= 8


def _snap(lo: int, hi: int, region: str) -> Tuple[int, int]:
    if region == "L" and lo < 7:
        return 0, max(hi, 8)
    return lo, hi


def _compose_bits(group: list, lo: int, hi: int, n: int, dtype, device) -> torch.Tensor:
    """Compose gates into one matrix on the bit span [lo, hi) (wires
    [n-hi, n-lo); the first wire is the window axis' MSB, bit hi-1)."""
    from qml_essentials_tpu_torch.ops import simulation

    mat, _ = simulation._compose_window(group, n - hi, n - lo, dtype, device)
    return mat


def _lift_span(lo: int, hi: int, region: str, n: int) -> Tuple[int, int, list]:
    """Lift a window's span to the kernels' shapes; returns ``(lo, hi,
    pads)``, *pads* the identity extensions in order, each ``("high", bits)``
    (new high bits: ``kron(eye, W)``) or ``("low", bits)`` (``kron(W, eye)``).

    Minor windows lift to exactly [0, 8) (or keep [0, 9)); row windows lift
    to width >= 7 (K >= 128) by identity-extension.
    """
    pads: list = []
    if region == "L" and lo == 0:
        target = 8 if hi <= 8 else 9
        if hi < target:
            pads.append(("high", target - hi))  # new bits are HIGH bits
            hi = target
        return lo, hi, pads
    if hi - lo < 7:
        base = 7 if region == "L" else n - CHAIN_HB
        top = CHAIN_SL if region == "L" else n
        new_lo = max(base, hi - 7)
        if new_lo < lo:
            pads.append(("low", lo - new_lo))
            lo = new_lo
        if hi - lo < 7:
            new_hi = min(top, lo + 7)
            if new_hi > hi:
                pads.append(("high", new_hi - hi))
                hi = new_hi
    return lo, hi, pads


def _pad_window(mat: torch.Tensor, pads: list) -> torch.Tensor:
    """Apply :func:`_lift_span`'s identity extensions to a window."""
    for side, bits in pads:
        eye = torch.eye(2**bits, dtype=mat.dtype, device=mat.device)
        mat = bkron(eye, mat) if side == "high" else bkron(mat, eye)
    return mat


def _fuse_group(g: _Group, n: int, dtype, device) -> Optional[Tuple[tuple, list]]:
    """Fuse one group's items into ordered chain descriptors + payloads.

    Same greedy-window structure as ``simulation.plan_contractions`` but in
    bit coordinates with geometry-valid spans.  Returns ``(descs, payloads)``
    or ``None`` when an item cannot be expressed.
    """
    region = g.region
    descs: list = []
    payloads: list = []
    windows: List[list] = []  # [ops, lo, hi, support_bits]

    def emit_window(ops: list, lo: int, hi: int) -> None:
        mat = _compose_bits(ops, lo, hi, n, dtype, device)
        lo2, hi2, pads = _lift_span(lo, hi, region, n)
        descs.append(("win", lo2, hi2))
        payloads.append(lazy(_pad_window, mat, pads) if pads else mat)

    def flush(idxs: Optional[List[int]] = None) -> None:
        if idxs is None:
            idxs = list(range(len(windows)))
        for i in sorted(idxs, reverse=True):
            ops, lo, hi, _ = windows.pop(i)
            emit_window(ops, lo, hi)

    for kind, payload, wires in g.items:
        bits = sorted(_bit(w, n) for w in wires)
        if kind == "diag":
            if len(bits) > _MAX_DIAG_BITS:
                return None
            flush([i for i, w in enumerate(windows) if w[3] & set(bits)])
            # Payload index: first wire = MSB.  Reorder to wires ascending
            # (= bits descending) if recorded otherwise.
            k = len(wires)
            srt_w = sorted(wires)
            order = [list(wires).index(w) for w in srt_w] if list(wires) != srt_w else None
            descs.append(("diag", tuple(sorted(bits, reverse=True))))
            payloads.append(lazy(_diag_sorted, payload, order, k, device, dtype))
            continue

        op = payload  # a _GateShim: ("mat", matrix, wires)
        lo, hi = _snap(bits[0], bits[-1] + 1, region)
        if not _span_valid(lo, hi, region, n):
            return None
        support = set(bits)

        touching = [i for i, w in enumerate(windows) if w[3] & support]
        if len(touching) > 1:
            mlo = min(lo, *(windows[i][1] for i in touching))
            mhi = max(hi, *(windows[i][2] for i in touching))
            mlo, mhi = _snap(mlo, mhi, region)
            if _span_valid(mlo, mhi, region, n):
                ops: list = []
                sup: set = set()
                for i in touching:
                    ops.extend(windows[i][0])
                    sup |= windows[i][3]
                for i in sorted(touching, reverse=True):
                    windows.pop(i)
                ops.append(op)
                windows.append([ops, mlo, mhi, sup | support])
            else:
                flush(touching)
                windows.append([[op], lo, hi, support])
            continue
        if len(touching) == 1:
            i = touching[0]
            ops, wlo, whi, sup = windows[i]
            nlo, nhi = _snap(min(wlo, lo), max(whi, hi), region)
            if _span_valid(nlo, nhi, region, n):
                ops.append(op)
                windows[i] = [ops, nlo, nhi, sup | support]
            else:
                flush([i])
                windows.append([[op], lo, hi, support])
            continue
        placed = False
        for i, (ops, wlo, whi, sup) in enumerate(windows):
            nlo, nhi = _snap(min(wlo, lo), max(whi, hi), region)
            if _span_valid(nlo, nhi, region, n):
                ops.append(op)
                windows[i] = [ops, nlo, nhi, sup | support]
                placed = True
                break
        if not placed:
            windows.append([[op], lo, hi, support])

    flush()
    return tuple(descs), payloads


class _GateShim:
    """Minimal Operation-like wrapper (``.matrix``, ``.wires``) for
    ``simulation._compose_window``."""

    __slots__ = ("matrix", "wires")

    def __init__(self, matrix: torch.Tensor, wires: List[int]) -> None:
        self.matrix = matrix
        self.wires = wires


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def plan_chains(
    tape: List[Operation], n: int, dtype: torch.dtype = torch.complex64, device=None
) -> Optional[List[Tuple[str, object, List[int]]]]:
    """Build a chain plan from a tape, or None when it cannot express it.

    Returns plan steps ``("chain", (geom, descs, payloads), wires)``: *geom*
    is ``("L", CHAIN_SL)`` or ``("H", CHAIN_HB)``, *descs* a hashable tuple
    of ``("win", lo, hi)`` / ``("diag", bits)`` descriptors (bit coordinates,
    diagonal bits MSB first) in application order, and *payloads* the
    matching complex tensors (complex *dtype*, on *device*).
    """
    if n < CHAIN_SL + 1:
        return None

    items: list = []
    for op in tape:
        if isinstance(op, Barrier):
            continue
        if isinstance(op, Id) and op._matrix is Id._matrix:
            continue
        if isinstance(op, KrausChannel):
            return None
        if (
            op.__class__.apply_to_state_ri is not Operation.apply_to_state_ri
            and not isinstance(op, DiagonalQubitUnitary)
        ):
            continue  # custom no-op application (Id subclasses, Barrier)
        if isinstance(op, DiagonalQubitUnitary):
            items.append(("diag", op.diag, list(op.wires)))
            continue
        wires = list(op.wires)
        if _regions_of("mat", wires, n):
            items.append(("mat", _GateShim(op.matrix, wires), wires))
            continue
        seam = _decompose_seam(op)
        if seam is None:
            return None
        for kind, payload, ws in seam:
            items.append((kind, _GateShim(payload, ws) if kind == "mat" else payload, ws))

    if not items:
        return []

    groups = _assign_groups(items, n)
    if groups is None:
        return None

    steps: List[Tuple[str, object, List[int]]] = []
    for g in groups:
        fused = _fuse_group(g, n, dtype, device)
        if fused is None:
            return None
        descs, payloads = fused
        if not descs:
            continue
        geom = ("L", CHAIN_SL) if g.region == "L" else ("H", CHAIN_HB)
        steps.append(("chain", (geom, descs, tuple(payloads)), sorted(g.support)))
    return steps


def chain_usable(geom: tuple, descs: tuple, n: int) -> bool:
    """Whether the chain kernels take this step (the large-state regime),
    else the adjoint executor expands it (:func:`expand_chain_step`)."""
    from qml_essentials_tpu_torch.ops import simulation

    return n >= simulation.LARGE_STATE_MIN_N and cuda_kernels.chain_geometry_fits(geom, n)


def expand_chain_step(geom: tuple, descs: tuple, n: int) -> List[Tuple[str, tuple]]:
    """Expand a chain step into plain (kind, wires) steps.

    ``("win", lo, hi)`` becomes ``("mat", wires)`` on wires [n-hi, n-lo);
    ``("diag", bits)`` becomes ``("diag", wires)`` with wires ascending.
    Descriptors and payloads stay 1:1.
    """
    out: List[Tuple[str, tuple]] = []
    for d in descs:
        if d[0] == "win":
            lo, hi = d[1], d[2]
            out.append(("mat", tuple(range(n - hi, n - lo))))
        else:
            out.append(("diag", tuple(n - 1 - b for b in d[1])))
    return out
