"""The yardstick: the card's peaks, the work of one kernel call, and the
model flops of a circuit.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.  A kernel
call's work is counted from the shapes it is called at: each input byte read
once and each output byte written once, and the product's operations as the
algorithm needs them (a window of K amplitudes costs 8K real flops an
amplitude forward, 16K backward for the pullback and the gram, 24K plus the
8K^3 of ``G0 W`` for an adjoint step).  Its least time is the larger of its
operations over the TF32 tensor-core peak and its bytes over the HBM rate, so
no kernel can take less (frozen from the program's phase-6 formulas).

Model flops count the circuit itself, gate by gate, whatever implements it:
each k-qubit gate a dense ``2^k x 2^k`` complex product on every amplitude of
the register (8 real flops a complex multiply-add), a density matrix as
``U rho U^dag`` (two products on ``4^n`` entries) with every Kraus operator of
every channel counted the same way.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_TF32 = 495e12  # dense TF32 tensor-core FLOP/s
PEAK_HBM = 3.35e12  # HBM3 bytes/s

# Kernel wrappers of the program's ``ops/cuda_kernels.py``, by the work
# their product does: flops an amplitude per window row.
FORWARD = ("window_apply", "window_apply_top", "rotmat_apply", "matrot_apply", "rotwin_apply")
BACKWARD = ("window_apply_bwd", "window_apply_top_bwd", "rotmat_apply_bwd", "matrot_apply_bwd",
            "rotwin_apply_bwd")
ADJOINT = ("adjoint_step", "adjoint_step_top", "adjoint_rotmat", "adjoint_matrot")
MOVES = ("rotate", "rotate_pair", "chain_apply", "adjoint_chain")  # counted by bytes alone
WRAPPERS = FORWARD + BACKWARD + ADJOINT + MOVES


def _tensors(obj) -> Iterable:
    if hasattr(obj, "element_size") and hasattr(obj, "numel"):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def tensor_bytes(objs) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(objs))


def call_work(name: str, args: Sequence, out) -> Tuple[float, float]:
    """(flops, bytes) of one wrapper call: ``args`` as passed, ``out`` as
    returned.  The window is the wrapper's matrix argument ``w2`` and the
    state its real-split state (half its values are amplitudes): ``(psi2,
    w2, ...)`` for a forward, ``(w2, g, x, ...)`` for a backward, ``(w2,
    psi2, lam2, ...)`` for an adjoint step."""
    nbytes = tensor_bytes(args) + tensor_bytes(out)
    if name in MOVES:
        return 0.0, float(nbytes)
    if name in FORWARD:
        state, window = args[0], args[1]
    else:
        window, state = args[0], args[2] if name in BACKWARD else args[1]
    K = int(window.shape[-1])
    amps = state.numel() // 2
    if name in FORWARD:
        flops = 8 * K * amps
    elif name in BACKWARD:
        flops = 16 * K * amps
    else:
        flops = 24 * K * amps + 8 * K**3
    return float(flops), float(nbytes)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_TF32, nbytes / PEAK_HBM)


def model_flops(gate_wires: Sequence[Sequence[int]], n: int, density: bool = False,
                kraus: int = 0) -> float:
    """Model flops of one circuit evaluation: ``gate_wires`` lists each gate's
    wires in order; a ``density`` matrix takes each gate as ``U rho U^dag``
    and ``kraus`` single-qubit Kraus operators on each wire after each gate
    (a configuration's reference gives these: ``flop_inputs``)."""
    total = 0.0
    for wires in gate_wires:
        d = 2 ** len(wires)
        if density:
            total += 2 * 8 * d * 4**n  # U rho, then (U rho) U^dag
            total += len(wires) * kraus * 2 * 8 * 2 * 4**n
        else:
            total += 8 * d * 2**n
    return total
