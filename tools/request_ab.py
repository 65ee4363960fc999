"""Single-request times of one checkout of the port, for A/B runs.

Times the single requests that phase 6 of ``chip_smoke.py`` times, through
the entry point a user calls (``Model(...)(inputs=x)``), on the checkout
whose root is ``--root``:

* a forward request of the 22q and 24q Circuit_19 models (2 layers);
* forward + gradient (mean <Z>, bf16 lambda) of those under ``auto``, the
  24q one with the adjoint backward forced, and the 26q one with the
  adjoint and the saved backward forced;
* the 24q forward's record (the circuit function on the card) and its plan
  (``scheduled_plan``, no cache), and the 13q noisy density model's record
  and plan (the interleaved lowering and plan).

Each time is the median of ``--reps`` host-clock runs ending in a
synchronise, after one warm-up.  Prints one JSON line.  To compare two
checkouts, unpack one beside the other and run this script once per
checkout in turns (a, b, b, a, ...) in one session on one card:

    python tools/request_ab.py --root build/ab/parent --label parent
    python tools/request_ab.py --root . --label change

``--device cpu --widths 6 8 --wide 10 --density 3`` runs it at a size the
CPU takes, as a check of the script.  ``--summarize FILE`` reads the JSON
lines of such runs and prints, per label and request, the median, least and
largest of its runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

SEED = 7
N_LAYERS = 2
X = 0.37


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="root of the checkout to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--widths", type=int, nargs="+", default=[22, 24])
    ap.add_argument("--wide", type=int, default=26)
    ap.add_argument("--density", type=int, default=13)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--summarize", metavar="FILE")
    args = ap.parse_args()
    if args.summarize:
        return summarize(args.summarize)

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import saved, simulation

    pkg = Path(sys.modules["qml_essentials_tpu_torch"].__file__).resolve()
    if root not in pkg.parents:
        raise SystemExit(f"imported {pkg}, not the checkout at {root}")
    dev = args.device

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def median_ms(fn):
        fn()
        sync()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def model(n, noise=None):
        m = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19", random_seed=SEED,
                  device=dev)
        m.noise_params = noise
        return m

    def forward(m):
        def fn():
            with torch.inference_mode():
                return m(inputs=X)
        return fn

    def grad(m, mode):
        def fn():
            simulation.set_backward_mode(mode)
            try:
                m.params.grad = None
                m(inputs=X).mean().backward()
            finally:
                simulation.set_backward_mode("auto")
        return fn

    saved.set_lambda_mode("bf16")
    out = {}
    models = {n: model(n) for n in args.widths}
    for n, m in models.items():
        out[f"forward {n}q"] = median_ms(forward(m))
        out[f"fwd+grad {n}q auto"] = median_ms(grad(m, "auto"))
    top = args.widths[-1]
    out[f"fwd+grad {top}q adjoint"] = median_ms(grad(models[top], "adjoint"))
    wide = model(args.wide)
    out[f"fwd+grad {args.wide}q adjoint"] = median_ms(grad(wide, "adjoint"))
    out[f"fwd+grad {args.wide}q saved"] = median_ms(grad(wide, "autodiff"))
    del wide

    m = models[top]
    inputs = torch.tensor([[X]], device=dev)
    with torch.inference_mode():
        tape = m.script._record(m.params, inputs, enc_params=m.enc_params)
        out[f"record {top}q"] = median_ms(lambda: m.script._record(m.params, inputs, enc_params=m.enc_params))
        out[f"plan {top}q"] = median_ms(lambda: simulation.scheduled_plan(tape, top, device=dev))

    d = model(args.density, {"Depolarizing": 0.01})

    def drecord():
        return d.script._record(d.params, inputs, enc_params=d.enc_params,
                                random_key=torch.Generator().manual_seed(SEED),
                                noise_params=d.noise_params)

    def dplan(t):
        lowered = simulation._lower_interleaved_tape(t, args.density)
        return simulation.interleaved_plan(lowered, 2 * args.density, torch.float32, dev)

    with torch.inference_mode():
        dtape = drecord()
        out[f"record {args.density}q density"] = median_ms(drecord)
        out[f"plan {args.density}q density"] = median_ms(lambda: dplan(dtape))
        out[f"forward {args.density}q density"] = median_ms(forward(d))

    print(json.dumps({"label": args.label, "device": dev, "ms": out}))
    return 0


def summarize(path: str) -> int:
    runs = [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    names = list(dict.fromkeys(k for r in runs for k in r["ms"]))
    print("request | " + " | ".join(f"{lab} median (min-max, n)" for lab in labels))
    for name in names:
        cells = []
        for lab in labels:
            v = [r["ms"][name] for r in runs if r["label"] == lab and name in r["ms"]]
            cells.append(f"{statistics.median(v):.1f} ({min(v):.1f}-{max(v):.1f}, {len(v)})")
        print(f"{name} | " + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
