"""Circuit rendering backends: ASCII text, matplotlib, TikZ, pulse schedules.

The text and TikZ backends give the JAX package's output character for
character.  A gate parameter may be a tensor on the card (``float`` reads
it back) or a batch of angles (labelled "θ", as a non-scalar is in the JAX
package).  Matplotlib is imported only by :func:`draw_mpl` and
:func:`draw_pulse_schedule`, so the package imports without it; pulse
envelopes are evaluated on the CPU in float64 for plotting.

Counterpart of ``qml_essentials_tpu/utils/drawing.py``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np
import torch

from qml_essentials_tpu_torch.utils.pulse_events import LEAF_META, PulseEvent  # noqa: F401


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def format_pi_fraction(value: float, latex: bool = False) -> str:
    """Format an angle as a fraction of pi when close, else as a decimal."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return str(value)
    frac = Fraction(v / np.pi).limit_denominator(12)
    if abs(float(frac) * np.pi - v) < 1e-9 and frac != 0:
        pi = r"\pi" if latex else "π"
        num, den = frac.numerator, frac.denominator
        sign = "-" if num < 0 else ""
        num = abs(num)
        if den == 1:
            core = pi if num == 1 else f"{num}{pi}"
        else:
            core = f"{pi}/{den}" if num == 1 else f"{num}{pi}/{den}"
        return sign + core
    if v == 0:
        return "0"
    return f"{v:.2f}"


def _gate_label(op, gate_values: bool, theta_idx: List[int], latex: bool = False) -> str:
    """Short label for a gate box, with angles or symbolic theta subscripts."""
    params = op.parameters
    if not params:
        return op.name
    if gate_values:
        parts = []
        for p in params:
            try:
                value = p.detach() if isinstance(p, torch.Tensor) else p
                parts.append(format_pi_fraction(float(value), latex=latex))
            except (TypeError, ValueError, RuntimeError):
                parts.append("θ")
        return f"{op.name}({','.join(parts)})"
    labels = []
    for _ in params:
        idx = theta_idx[0]
        theta_idx[0] += 1
        labels.append(rf"\theta_{{{idx}}}" if latex else f"θ_{idx}")
    return f"{op.name}({','.join(labels)})"


def _schedule(ops, n_qubits: int) -> List[List[Tuple]]:
    """Critical-path scheduling: each gate lands in the earliest free column."""
    from qml_essentials_tpu_torch.ops.operations import Barrier

    columns: List[List] = []
    wire_busy = [0] * n_qubits
    for op in ops:
        if isinstance(op, Barrier):
            # A barrier pushes every covered wire to the current max column.
            t = max((wire_busy[w] for w in op.wires if w < n_qubits), default=0)
            for w in op.wires:
                if w < n_qubits:
                    wire_busy[w] = t
            continue
        wires = [w for w in op.wires if w < n_qubits]
        start = max((wire_busy[w] for w in wires), default=0)
        while len(columns) <= start:
            columns.append([])
        columns[start].append(op)
        for w in wires:
            wire_busy[w] = start + 1
    return columns


# ---------------------------------------------------------------------------
# Text backend
# ---------------------------------------------------------------------------


def draw_text(ops, n_qubits: int, gate_values: bool = False) -> str:
    """ASCII-art rendering with critical-path column packing."""
    columns = _schedule(ops, n_qubits)
    theta_idx = [0]

    lines = [[f"q{q}: "] for q in range(n_qubits)]
    for col in columns:
        col_cells = ["─"] * n_qubits
        for op in col:
            wires = op.wires
            if op.is_controlled and len(wires) >= 2 and op.name in (
                "CX",
                "CY",
                "CZ",
                "CRX",
                "CRY",
                "CRZ",
                "CCX",
                "CSWAP",
                "ControlledPhaseShift",
            ):
                n_controls = getattr(op, "n_controls", 1)
                if op.name == "CCX":
                    n_controls = 2
                controls, targets = wires[:n_controls], wires[n_controls:]
                for c in controls:
                    col_cells[c] = "●"
                label = _gate_label(op, gate_values, theta_idx)
                target_label = {
                    "CX": "X",
                    "CCX": "X",
                    "CY": "Y",
                    "CZ": "Z",
                    "CSWAP": "SWAP",
                }.get(op.name, label.replace("C", "", 1))
                for t in targets:
                    col_cells[t] = target_label
                lo, hi = min(wires), max(wires)
                for q in range(lo + 1, hi):
                    if col_cells[q] == "─":
                        col_cells[q] = "│"
            else:
                label = _gate_label(op, gate_values, theta_idx)
                for w in wires:
                    col_cells[w] = label

        width = max(len(c) for c in col_cells) + 2
        for q in range(n_qubits):
            cell = col_cells[q]
            if cell in ("─",):
                lines[q].append("─" * width)
            elif cell == "│":
                pad = (width - 1) // 2
                lines[q].append("─" * pad + "│" + "─" * (width - 1 - pad))
            else:
                body = f"{cell}"
                pad = width - len(body)
                left = pad // 2
                lines[q].append("─" * left + body + "─" * (pad - left))

    return "\n".join("".join(line) for line in lines)


# ---------------------------------------------------------------------------
# Matplotlib backend
# ---------------------------------------------------------------------------


def draw_mpl(ops, n_qubits: int, gate_values: bool = False, **kwargs):
    """Matplotlib circuit diagram; returns ``(fig, ax)``."""
    import matplotlib.pyplot as plt

    columns = _schedule(ops, n_qubits)
    n_cols = max(len(columns), 1)
    fig, ax = plt.subplots(figsize=(1.2 * n_cols + 2, 0.8 * n_qubits + 1))
    theta_idx = [0]

    for q in range(n_qubits):
        ax.plot([-0.5, n_cols - 0.2], [q, q], color="black", lw=1, zorder=0)
        ax.text(-0.8, q, f"q{q}", ha="right", va="center")

    for x, col in enumerate(columns):
        for op in col:
            wires = op.wires
            if op.name in ("CX", "CY", "CZ", "CRX", "CRY", "CRZ", "CCX",
                           "ControlledPhaseShift", "CSWAP") and len(wires) >= 2:
                n_controls = 2 if op.name == "CCX" else getattr(op, "n_controls", 1)
                controls, targets = wires[:n_controls], wires[n_controls:]
                ax.plot([x, x], [min(wires), max(wires)], color="black", lw=1)
                for c in controls:
                    ax.scatter([x], [c], s=40, color="black", zorder=3)
                label = _gate_label(op, gate_values, theta_idx)
                for t in targets:
                    ax.add_patch(
                        plt.Rectangle(
                            (x - 0.3, t - 0.25), 0.6, 0.5,
                            facecolor="white", edgecolor="black", zorder=2,
                        )
                    )
                    short = {"CX": "X", "CCX": "X", "CY": "Y", "CZ": "Z"}.get(
                        op.name, label.replace("C", "", 1)
                    )
                    ax.text(x, t, short, ha="center", va="center", zorder=4, fontsize=8)
            else:
                label = _gate_label(op, gate_values, theta_idx)
                for w in wires:
                    ax.add_patch(
                        plt.Rectangle(
                            (x - 0.35, w - 0.25), 0.7, 0.5,
                            facecolor="#cfe8ff", edgecolor="black", zorder=2,
                        )
                    )
                    ax.text(x, w, label, ha="center", va="center", zorder=4, fontsize=8)

    ax.set_ylim(n_qubits - 0.5, -0.5)
    ax.set_xlim(-1.2, n_cols)
    ax.axis("off")
    fig.tight_layout()
    return fig, ax


# ---------------------------------------------------------------------------
# TikZ backend
# ---------------------------------------------------------------------------


class TikzFigure:
    """Container for quantikz LaTeX code with save/str helpers.

    Signature parity with ref drawing.py:14-74 (``quantikz_str`` ctor kwarg,
    ``export(destination, full_document, mode)``); ``code`` is kept as an
    alias for this build's internal callers.
    """

    def __init__(self, quantikz_str: str) -> None:
        self.quantikz_str = quantikz_str

    @property
    def code(self) -> str:
        return self.quantikz_str

    def __str__(self) -> str:
        return self.quantikz_str

    def __repr__(self) -> str:
        return self.quantikz_str

    def wrap_figure(self) -> str:
        """Wrap the quantikz body in a LaTeX ``figure`` environment
        (centered, scaled tikzpicture node — matches ref drawing.py:26-44
        so downstream documents can ``\\input`` the export unchanged)."""
        return (
            "\n\\begin{figure}\n"
            "    \\centering\n"
            "    \\begin{tikzpicture}\n"
            "        \\node[scale=0.85] {\n"
            "            \\begin{quantikz}\n"
            f"                {self.quantikz_str}\n"
            "            \\end{quantikz}\n"
            "        };\n"
            "    \\end{tikzpicture}\n"
            "\\end{figure}"
        )

    def export(
        self, destination: str, full_document: bool = False, mode: str = "w"
    ) -> None:
        """Write the TikZ code to a file.

        ``full_document=True`` emits a compilable article-class document
        with the quantikz/tikz preamble and a landscape A3 geometry
        (matching the reference export, ref drawing.py:46-73); otherwise
        just the quantikz body plus a trailing newline.
        """
        if full_document:
            payload = (
                "\n\\documentclass{article}\n"
                "\\usepackage{quantikz}\n"
                "\\usepackage{tikz}\n"
                "\\usetikzlibrary{quantikz2}\n"
                "\\usepackage{quantikz}\n"
                "\\usepackage[a3paper, landscape, margin=0.5cm]{geometry}\n"
                "\\begin{document}\n"
                f"{self.wrap_figure()}\n"
                "\\end{document}"
            )
        else:
            payload = self.quantikz_str + "\n"
        with open(destination, mode) as f:
            f.write(payload)


class QuanTikz:
    """Back-compat namespace for the TikZ exporter (ref drawing.py:79-80)."""

    TikzFigure = TikzFigure


def draw_tikz(ops, n_qubits: int, gate_values: bool = False, **kwargs) -> TikzFigure:
    """quantikz rendering; returns a :class:`TikzFigure`."""
    columns = _schedule(ops, n_qubits)
    theta_idx = [0]
    cells = [["" for _ in columns] for _ in range(n_qubits)]

    for x, col in enumerate(columns):
        for op in col:
            wires = op.wires
            if op.name in ("CX", "CY", "CZ", "CRX", "CRY", "CRZ", "CCX",
                           "ControlledPhaseShift") and len(wires) >= 2:
                n_controls = 2 if op.name == "CCX" else getattr(op, "n_controls", 1)
                controls, targets = wires[:n_controls], wires[n_controls:]
                for c in controls:
                    cells[c][x] = f"\\ctrl{{{targets[0] - c}}}"
                if op.name in ("CX", "CCX"):
                    for t in targets:
                        cells[t][x] = "\\targ{}"
                elif op.name == "CZ":
                    for t in targets:
                        cells[t][x] = "\\control{}"
                else:
                    label = _gate_label(op, gate_values, theta_idx, latex=True)
                    body = label.replace("C", "", 1)
                    for t in targets:
                        cells[t][x] = f"\\gate{{{body}}}"
            else:
                label = _gate_label(op, gate_values, theta_idx, latex=True)
                for w in wires:
                    cells[w][x] = f"\\gate{{{label}}}"

    rows = []
    for q in range(n_qubits):
        row = [f"\\lstick{{$q_{q}$}}"]
        for x in range(len(columns)):
            row.append(cells[q][x] if cells[q][x] else "\\qw")
        rows.append(" & ".join(row) + " & \\qw")
    body = " \\\\\n".join(rows)
    code = "\\begin{quantikz}\n" + body + "\n\\end{quantikz}"
    return TikzFigure(code)


# ---------------------------------------------------------------------------
# Pulse schedule backend
# ---------------------------------------------------------------------------


def collect_pulse_events(script, *args, **kwargs) -> list:
    """Record the circuit in pulse mode and return its PulseEvents."""
    return script.pulse_events(*args, **kwargs)


def _event_label(ev: PulseEvent) -> str:
    """Event label, qualified by the composite it decomposes ("RZ (H)")."""
    if ev.parent and ev.parent != ev.gate:
        return f"{ev.gate} ({ev.parent})"
    return ev.gate


def _envelope_args(ev: PulseEvent) -> torch.Tensor:
    """The envelope's argument vector ``[*envelope_params, w]`` on the CPU in
    float64 (the event's parameters may live on the card)."""
    params = torch.as_tensor(ev.envelope_params).detach().to("cpu", torch.float64)
    return torch.cat([params.reshape(-1), torch.tensor([float(ev.w)], dtype=torch.float64)])


def _envelope_display_span(ev: PulseEvent, envelope_width: float):
    """Local time span ``(t_lo, t_hi)`` over which to render an envelope.

    ``envelope_width == 0`` clamps the span to the evolution window
    ``[0, duration]``.  Positive values widen the span when the envelope
    has not decayed at the window edge (e.g. wide gaussians): the
    half-width grows, by bisection, until the amplitude falls to
    ``edge_ratio**10`` of its center value, and the extra extension is
    then scaled by ``envelope_width``.  Mirrors the display semantics of
    the reference (drawing.py:653-707).
    """
    dur = float(ev.duration)
    if envelope_width == 0 or ev.envelope_fn is None:
        return 0.0, dur
    p = _envelope_args(ev)
    t_c = dur / 2

    def amp(t: float) -> float:
        return abs(float(ev.envelope_fn(p, torch.tensor(t, dtype=p.dtype), t_c)))

    center = amp(t_c)
    if center < 1e-12:
        return 0.0, dur
    edge_ratio = amp(0.0) / center
    if edge_ratio < 0.01:  # already decayed inside the window
        return 0.0, dur
    target = edge_ratio**10
    lo, hi = t_c, dur * 50
    for _ in range(30):
        mid = (lo + hi) / 2
        if amp(t_c + mid) / center > target:
            lo = mid
        else:
            hi = mid
    half = t_c + (hi - t_c) * envelope_width
    return t_c - half, t_c + half


def draw_pulse_schedule(
    events: List[PulseEvent],
    n_qubits: int,
    show_carrier: bool = True,
    n_samples: int = 200,
    show_envelope: bool = True,
    envelope_width: float = 0.0,
    max_events: Optional[int] = None,
    **kwargs,
):
    """Per-qubit pulse schedule plot; returns ``(fig, axes)``.

    Physical drives render their envelope (optionally with the carrier
    overlaid); virtual-Z frame rotations render as slim hatched markers
    (they consume no drive time in hardware but are shown with their
    nominal duration for alignment); multi-qubit coupling blocks span
    every involved wire.  ``max_events`` clips long schedules to a display
    window (an ellipsis marks the cut).

    ``show_envelope=False`` reduces physical drives to plain duration
    blocks; ``envelope_width`` widens the rendered envelope beyond the
    evolution window (0 clamps to it — see
    :func:`_envelope_display_span`).
    """
    import matplotlib.pyplot as plt

    clipped = False
    if max_events is not None and len(events) > max_events:
        events = events[:max_events]
        clipped = True

    fig, axes = plt.subplots(
        n_qubits, 1, sharex=True, figsize=(10, 1.6 * n_qubits), squeeze=False
    )
    axes = axes[:, 0]

    t_cursor = [0.0] * n_qubits
    seen_labels = [set() for _ in range(n_qubits)]
    from qml_essentials_tpu_torch.pulse.pulses import PulseGates

    for ev in events:
        start = max(t_cursor[w] for w in ev.wires)
        label = _event_label(ev)
        if ev.envelope_fn is not None and not show_envelope:
            # Physical drive with envelopes suppressed: duration block only.
            for w in ev.wires:
                show = label if label not in seen_labels[w] else None
                seen_labels[w].add(label)
                axes[w].axvspan(
                    start, start + ev.duration, alpha=0.25, label=show
                )
        elif ev.envelope_fn is not None:
            # Physical drive: envelope (+ optional carrier).
            t_lo, t_hi = _envelope_display_span(ev, envelope_width)
            ts = np.linspace(t_lo, t_hi, n_samples)
            p = _envelope_args(ev)
            env = ev.envelope_fn(p, torch.from_numpy(ts), ev.duration / 2).numpy()
            for w in ev.wires:
                show = label if label not in seen_labels[w] else None
                seen_labels[w].add(label)
                axes[w].plot(start + ts, env, lw=1.2, label=show)
                axes[w].fill_between(start + ts, env, alpha=0.25)
                if show_carrier:
                    carrier = env * np.cos(
                        PulseGates.omega_c * ts + ev.carrier_phase
                    )
                    axes[w].plot(start + ts, carrier, lw=0.5, alpha=0.6)
        elif len(ev.wires) == 1:
            # Virtual-Z frame rotation: slim hatched marker, angle annotated.
            w = ev.wires[0]
            axes[w].axvspan(
                start,
                start + ev.duration,
                alpha=0.30,
                color="tab:orange",
                hatch="//",
                lw=0,
            )
            axes[w].annotate(
                f"{label}\n{format_pi_fraction(float(ev.w))}",
                (start + ev.duration / 2, 0.0),
                ha="center",
                va="center",
                fontsize=7,
            )
        else:
            # Multi-qubit coupling block (e.g. the CZ ZZ interaction).
            for w in ev.wires:
                axes[w].axvspan(start, start + ev.duration, alpha=0.15, color="gray")
                axes[w].text(
                    start + ev.duration / 2,
                    0.0,
                    label,
                    ha="center",
                    va="center",
                    fontsize=7,
                )
        for w in ev.wires:
            t_cursor[w] = start + ev.duration

    t_end = max(t_cursor) if t_cursor else 1.0
    for q in range(n_qubits):
        axes[q].set_ylabel(f"q{q}")
        axes[q].set_xlim(-0.02 * t_end, 1.02 * t_end)
        if seen_labels[q]:
            axes[q].legend(loc="upper right", fontsize=6, ncol=2)
    if clipped:
        axes[0].set_title("… schedule clipped to the first "
                          f"{len(events)} events …", fontsize=8)
    axes[-1].set_xlabel("time")
    fig.tight_layout()
    return fig, axes
